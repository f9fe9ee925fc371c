"""Distributed kernels over the port's mesh — the counterpart of
``adam_tpu/parallel/dist.py``.

The Spark-primitive -> collective mapping of the JAX module, over the
mesh interface of ``parallel/mesh.py`` (:class:`~adam_tpu_torch.parallel.mesh.LocalMesh`
over pool slots in one process, or
:class:`~adam_tpu_torch.parallel.mesh.ProcessMesh` over ``torch.distributed``
ranks):

* a Spark job's ``aggregate`` (flagstat, the BQSR observation table) ->
  ``psum`` of per-shard counts (i64);
* ``reduceByKey`` over k-mers -> a hash-routed ``all_to_all`` with a
  per-destination capacity (4x the uniform share + 64; an overflow is
  counted, ``psum``-ed, and the exchange reruns at the exact worst-case
  capacity), then a local sort and run-length count of each shard's key
  slice;
* ``sortByKey`` -> sample splitters (``all_gather``) + the same routed
  ``all_to_all`` + a local stable sort;
* fragment flanking -> ``ppermute`` to the left neighbour.

Every function takes the whole host batch (or key array), pads its rows
to a multiple of the shard count and gives shard ``k`` the ``k``-th row
block; each local shard's body runs inside its slot's scope, so the same
code drives two CPU slots, two slots on one card and N processes.  A
result every shard holds (a ``psum``) comes back once; a result sharded
by destination comes back as host arrays, one row per *local* shard (all
``n`` of them in a ``LocalMesh``).  The single-device lexsort of this
family is ``pipelines/markdup.device_lexsort``.
"""

from __future__ import annotations

import numpy as np
import torch

from adam_tpu_torch.formats import schema
from adam_tpu_torch.formats.batch import ReadBatch
from adam_tpu_torch.ops import flagstat as fs
from adam_tpu_torch.ops import kmer as kmer_ops
from adam_tpu_torch.parallel.device_pool import putter
from adam_tpu_torch.pipelines.markdup import device_lexsort  # noqa: F401  (the family's single-device member)
from adam_tpu_torch.utils.transfer import device_fetch

_I64_MAX = np.iinfo(np.int64).max


def default_mesh():
    """A :class:`LocalMesh` over one slot per visible card."""
    from adam_tpu_torch.parallel.device_pool import make_slots
    from adam_tpu_torch.parallel.mesh import LocalMesh

    n = max(1, torch.cuda.device_count())
    return LocalMesh(make_slots([torch.device("cuda", k) for k in range(n)]))


def pad_batch_for_mesh(batch: ReadBatch, n_shards: int) -> ReadBatch:
    """Pad rows so the leading axis divides evenly across shards."""
    n = batch.n_rows
    return batch.pad_rows(-(-max(n, 1) // n_shards) * n_shards)


def _block(x: np.ndarray, k: int, n: int) -> np.ndarray:
    r = x.shape[0] // n
    return np.ascontiguousarray(x[k * r:(k + 1) * r])


def _shard_cols(mesh, b: ReadBatch, k: int, names) -> list:
    """Shard ``k``'s row block of batch ``b``'s columns ``names`` on its slot."""
    put = putter(mesh.slot(k))
    return [put(_block(np.asarray(getattr(b, f)), k, mesh.n)) for f in names]


def _fetch(x, mesh, k):
    return device_fetch(x, mesh.slot(k))


# --------------------------------------------------------------------------
# Aggregates (psum)
# --------------------------------------------------------------------------
def distributed_flagstat(batch: ReadBatch, mesh=None):
    """flagstat over a row-sharded batch; the cross-shard combine is one
    ``psum`` of the i64 count rows -> (failed, passed) metrics."""
    mesh = mesh or default_mesh()
    b = pad_batch_for_mesh(batch.to_numpy(), mesh.n)
    counts = []
    for k in mesh.local_shards():
        cols = _shard_cols(mesh, b, k, ("flags", "contig_idx", "mate_contig_idx",
                                        "mapq", "valid"))
        with mesh.slot(k).scope():
            counts.append(fs.flagstat_device(*cols))
    k0 = mesh.local_shards()[0]
    total = _fetch(mesh.psum(counts)[0], mesh, k0)
    return fs.to_metrics(total[0]), fs.to_metrics(total[1])


def distributed_observe(batch: ReadBatch, residue_ok, is_mismatch, read_ok,
                        n_rg: int, mesh=None):
    """BQSR observation histograms (i64 ``[n_rg, 94, 2*lmax+1, 17]``, kernel
    1 per shard on the card) with the cross-shard ``psum`` -> host (total,
    mism), at the batch's own ``lmax``."""
    from adam_tpu_torch.pipelines.bqsr import observe_kernel

    mesh = mesh or default_mesh()
    b = pad_batch_for_mesh(batch.to_numpy(), mesh.n)
    lmax = b.lmax

    def pad(x):
        x = np.asarray(x)
        return np.pad(x, [(0, b.n_rows - x.shape[0])] + [(0, 0)] * (x.ndim - 1))

    masks = (pad(residue_ok), pad(is_mismatch), pad(read_ok))
    totals, misms = [], []
    for k in mesh.local_shards():
        put = putter(mesh.slot(k))
        cols = _shard_cols(mesh, b, k, ("bases", "quals", "lengths", "flags",
                                        "read_group_idx"))
        ms = [put(_block(m, k, mesh.n)) for m in masks]
        with mesh.slot(k).scope():
            t, m = observe_kernel(*cols, *ms, n_rg, lmax)
        totals.append(t)
        misms.append(m)
    k0 = mesh.local_shards()[0]
    return (_fetch(mesh.psum(totals)[0], mesh, k0),
            _fetch(mesh.psum(misms)[0], mesh, k0))


# --------------------------------------------------------------------------
# Routed all-to-all with a capacity bound
# --------------------------------------------------------------------------
def _route(mesh, per_shard: list, cap: int) -> tuple:
    """Send each local shard's rows to their destination shards.

    ``per_shard[i]`` is ``(dest i64[m], leaves)`` for local shard ``i``:
    the rows are ordered by destination (a stable sort), and at most
    ``cap`` rows go from one shard to one destination; the rest are
    dropped and counted.  Returns (received leaves per local shard, each
    the concatenation of what every source sent in source order; the
    ``psum``-ed drop count)."""
    n = mesh.n
    sends, dropped = [], []
    for i, k in enumerate(mesh.local_shards()):
        dest, leaves = per_shard[i]
        with mesh.slot(k).scope():
            order = torch.sort(dest, stable=True).indices
            d_sorted = dest[order]
            counts = torch.bincount(d_sorted, minlength=n)
            starts = torch.cumsum(counts, 0) - counts
            slot_in = torch.arange(d_sorted.numel(), device=dest.device) - starts[d_sorted]
            fits = slot_in < cap
            dropped.append((~fits).sum().to(torch.int64).reshape(1))
            kept = order[fits]
            kept_counts = torch.clamp(counts, max=cap).cpu().tolist()
            moved = [leaf[kept] for leaf in leaves]
        sends.append([
            [list(torch.split(mv, kept_counts, 0))[j] for mv in moved]
            for j in range(n)
        ])
    n_leaves = len(per_shard[0][1])
    received = [[] for _ in mesh.local_shards()]
    for li in range(n_leaves):
        got = mesh.all_to_all([[s[j][li] for j in range(n)] for s in sends])
        for i, k in enumerate(mesh.local_shards()):
            with mesh.slot(k).scope():
                received[i].append(torch.cat(got[i], 0))
    k0 = mesh.local_shards()[0]
    n_dropped = int(_fetch(mesh.psum(dropped)[0], mesh, k0)[0])
    return received, n_dropped


def _mix_hash(keys: torch.Tensor) -> torch.Tensor:
    """Bit-mix i64 keys before modular sharding (JAX's constant: the 3-bit
    base packing puts only codes 0..4 in the low bits)."""
    h = keys * torch.tensor(-7046029254386353131, dtype=torch.int64, device=keys.device)
    return (h >> 32) & 0x7FFFFFFF


def _slack_cap(m: int, n: int) -> int:
    return min(m, 4 * m // n + 64)


def distributed_count_kmers(batch: ReadBatch, k: int, mesh=None,
                            cap: int | None = None) -> dict[str, int]:
    """Exact global k-mer counts over a row-sharded batch: local
    extraction, hash-routed all-to-all (each shard owns a disjoint key
    slice; an overflow of the slack capacity reruns at the exact one),
    local sort and count, the shards' lists gathered to every shard.
    ``cap`` overrides the slack capacity (tests)."""
    if batch.n_rows == 0:
        return {}
    mesh = mesh or default_mesh()
    n = mesh.n
    b = pad_batch_for_mesh(batch.to_numpy(), n)
    m = (b.n_rows // n) * max(b.lmax - k + 1, 1)
    per_shard = []
    for kk in mesh.local_shards():
        bases, lengths, valid = _shard_cols(mesh, b, kk, ("bases", "lengths", "valid"))
        with mesh.slot(kk).scope():
            packed, win_valid = kmer_ops.extract_kmers(bases, lengths, valid, k)
            keys = torch.where(win_valid, packed, torch.full_like(packed, -1)).reshape(-1)
            dest = torch.where(keys >= 0, _mix_hash(keys) % n, torch.zeros_like(keys))
        per_shard.append((dest, [keys]))
    received, dropped = _route(mesh, per_shard, _slack_cap(m, n) if cap is None else cap)
    if dropped > 0:  # rare: pathological key skew
        received, dropped = _route(mesh, per_shard, m)
    uniq, cnts = [], []
    for i, kk in enumerate(mesh.local_shards()):
        (mine,) = received[i]
        with mesh.slot(kk).scope():
            u, c = torch.unique(mine[mine >= 0], sorted=True, return_counts=True)
        uniq.append(u)
        cnts.append(c.to(torch.int64))
    out: dict[str, int] = {}
    k0 = mesh.local_shards()[0]
    for keys_all, counts_all in zip(mesh.all_gather(uniq)[0], mesh.all_gather(cnts)[0]):
        ks, cs = _fetch(keys_all, mesh, k0), _fetch(counts_all, mesh, k0)
        out.update(zip(kmer_ops._unpack_kmers(ks, k), cs.tolist()))
    return out


def _splitters(mesh, local_sorted: list) -> list:
    """Per local shard, the ``n - 1`` splitters from every shard's
    quantile sample (identical on every shard)."""
    n = mesh.n
    samples = []
    for i, kk in enumerate(mesh.local_shards()):
        s = local_sorted[i]
        with mesh.slot(kk).scope():
            qidx = (torch.arange(n, device=s.device) * s.numel()) // n
            samples.append(s[qidx])
    gathered = mesh.all_gather(samples)
    out = []
    for i, kk in enumerate(mesh.local_shards()):
        with mesh.slot(kk).scope():
            allsamp = torch.sort(torch.cat(gathered[i])).values
            idx = (torch.arange(1, n, device=allsamp.device) * allsamp.numel()) // n
            out.append(allsamp[idx])
    return out


def _sort_route(mesh, keys: np.ndarray, payload: dict, cap: int | None):
    n = mesh.n
    keys = np.asarray(keys, np.int64).reshape(-1)
    m = keys.shape[0] // n
    local = []
    for kk in mesh.local_shards():
        put = putter(mesh.slot(kk))
        local.append((put(_block(keys, kk, n)),
                      [put(_block(np.asarray(v), kk, n)) for v in payload.values()]))
    sorted_local = []
    for i, kk in enumerate(mesh.local_shards()):
        with mesh.slot(kk).scope():
            sorted_local.append(torch.sort(local[i][0]).values)
    spl = _splitters(mesh, sorted_local)
    per_shard = []
    for i, kk in enumerate(mesh.local_shards()):
        with mesh.slot(kk).scope():
            dest = torch.searchsorted(spl[i], local[i][0], right=True)
        per_shard.append((dest, [local[i][0]] + local[i][1]))
    received, dropped = _route(mesh, per_shard, _slack_cap(m, n) if cap is None else cap)
    if dropped > 0:  # degenerate splitters: retry at the exact capacity
        cap = m
        received, dropped = _route(mesh, per_shard, m)
    elif cap is None:
        cap = _slack_cap(m, n)
    return received, n * cap


def distributed_sort_keys(keys, mesh=None, cap: int | None = None) -> np.ndarray:
    """Globally sort an i64 key array sharded across the mesh: sample
    splitters, route each key to its splitter bucket (slack capacity,
    exact-capacity retry), sort locally -> ``[local shards, n * cap]``
    keys padded with i64 max, whose rows concatenated in shard order are
    globally sorted."""
    mesh = mesh or default_mesh()
    received, width = _sort_route(mesh, np.asarray(keys), {}, cap)
    out = np.full((len(received), width), _I64_MAX, np.int64)
    for i, kk in enumerate(mesh.local_shards()):
        (rk,) = received[i]
        with mesh.slot(kk).scope():
            s = torch.sort(rk).values
        got = _fetch(s, mesh, kk)
        out[i, : got.shape[0]] = got
    return out


def distributed_sort_rows(keys, payload: dict, mesh=None, cap: int | None = None):
    """Globally sort rows by i64 key across the mesh, moving the rows
    (sortByKey with payloads).  ``payload`` is a dict of arrays whose
    leading axis is ``len(keys)``.  Returns (keys ``[local shards,
    n * cap]``, rows dict ``[local shards, n * cap, ...]``, valid mask):
    each shard's row holds its splitter bucket, stably sorted, padding
    (key i64 max, zero rows) last."""
    mesh = mesh or default_mesh()
    names = list(payload)
    received, width = _sort_route(mesh, np.asarray(keys), payload, cap)
    k_out = np.full((len(received), width), _I64_MAX, np.int64)
    rows = {nm: np.zeros((len(received), width) + np.asarray(payload[nm]).shape[1:],
                         np.asarray(payload[nm]).dtype) for nm in names}
    for i, kk in enumerate(mesh.local_shards()):
        rk, *leaves = received[i]
        with mesh.slot(kk).scope():
            order = torch.sort(rk, stable=True).indices
        got = _fetch(rk[order], mesh, kk)
        k_out[i, : got.shape[0]] = got
        for nm, leaf in zip(names, leaves):
            v = _fetch(leaf[order], mesh, kk)
            rows[nm][i, : v.shape[0]] = v
    return k_out, rows, k_out != _I64_MAX


# --------------------------------------------------------------------------
# Duplicate marking, flanking, telemetry
# --------------------------------------------------------------------------
def distributed_markdup(ds, mesh=None):
    """Duplicate marking over a row-sharded batch: the [N, L] reductions
    (5' keys, quality scores) run per shard; the per-row columns are
    gathered to every shard for the group cascade, whose lexsort runs on
    the first local slot.  Marks are bitwise the one-device
    ``pipelines/markdup.mark_duplicates``'."""
    from adam_tpu_torch.formats.batch import grid_cigar_cols
    from adam_tpu_torch.pipelines import markdup as md

    mesh = mesh or default_mesh()
    b = ds.batch.to_numpy()
    n = b.n_rows
    p = pad_batch_for_mesh(b, mesh.n)
    gc = grid_cigar_cols(p.cigar_ops.shape[1] if p.cigar_ops.ndim == 2 else 1)
    fives, scores = [], []
    for kk in mesh.local_shards():
        put = putter(mesh.slot(kk))
        cols = [put(_block(np.asarray(getattr(p, f)), kk, mesh.n))
                for f in ("start", "end", "flags")]
        ops = put(_block(np.pad(p.cigar_ops, [(0, 0), (0, gc - p.cigar_ops.shape[1])],
                                constant_values=schema.CIGAR_PAD), kk, mesh.n))
        lens = put(_block(np.pad(p.cigar_lens, [(0, 0), (0, gc - p.cigar_lens.shape[1])]),
                          kk, mesh.n))
        n_ops, quals, lengths = (put(_block(np.asarray(getattr(p, f)), kk, mesh.n))
                                 for f in ("cigar_n", "quals", "lengths"))
        with mesh.slot(kk).scope():
            five, score = md.markdup_columns_local(*cols, ops, lens, n_ops, quals, lengths)
        fives.append(five)
        scores.append(score)
    k0 = mesh.local_shards()[0]
    five = np.concatenate([_fetch(x, mesh, k0) for x in mesh.all_gather(fives)[0]])[:n]
    score = np.concatenate([_fetch(x, mesh, k0) for x in mesh.all_gather(scores)[0]])[:n]
    s = md.row_summary(ds, five, score)
    dup = md.resolve_duplicates(s, device=mesh.slot(k0))
    return ds.with_batch(b.replace(flags=md.apply_duplicate_flags(np.asarray(b.flags), dup)))


def halo_exchange_right(chunks, mesh=None, flank: int = 0) -> np.ndarray:
    """Append each shard's first ``flank`` bases to its LEFT neighbour's
    chunk (``ppermute``; FlankReferenceFragments' extension of a fragment
    by the start of the next).  ``chunks`` u8[n_shards, width] -> the local
    shards' rows, u8[local, width + flank]; the last shard's halo is
    ``BASE_PAD``."""
    mesh = mesh or default_mesh()
    chunks = np.asarray(chunks)
    n = mesh.n
    local = [putter(mesh.slot(kk))(chunks[kk:kk + 1]) for kk in mesh.local_shards()]
    heads = []
    for i, kk in enumerate(mesh.local_shards()):
        with mesh.slot(kk).scope():
            heads.append(local[i][:, :flank].contiguous())
    perm = [(i, (i - 1) % n) for i in range(n)]
    got = mesh.ppermute(heads, perm)
    recv = [got[kk] if len(got) == n else got[0] for kk in mesh.local_shards()]
    out = []
    for i, kk in enumerate(mesh.local_shards()):
        with mesh.slot(kk).scope():
            halo = recv[i]
            if kk == n - 1:
                halo = torch.full_like(halo, schema.BASE_PAD)
            out.append(_fetch(torch.cat([local[i], halo], 1), mesh, kk))
    return np.concatenate(out, 0)


def gather_host_telemetry(snapshot: dict | None = None) -> list[dict]:
    """Every process's telemetry snapshot at a merge barrier ->
    ``[snapshot of rank 0, ..., of rank n-1]`` (an ``all_gather_object``
    over the initialized process group; one process returns
    ``[snapshot]``).  A collective: every rank must call it."""
    import torch.distributed as dist

    from adam_tpu_torch.utils import telemetry

    if snapshot is None:
        snapshot = telemetry.TRACE.snapshot()
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return [snapshot]
    out: list = [None] * dist.get_world_size()
    dist.all_gather_object(out, snapshot)
    return out
