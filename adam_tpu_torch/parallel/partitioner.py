"""Genome-coordinate partitioning — the host half of
``adam_tpu/parallel/partitioner.py`` (the semantics of the reference's
``rdd/GenomicPartitioners.scala``), kept in numpy as in the JAX package:
these are per-read integer maps on the host.

* :class:`GenomeBins` — fixed-size coordinate bins stacked per contig in
  dictionary order (the static genome -> bin map of the shuffle region
  join and the out-of-core interval spill).
* :func:`position_partition` — GenomicPositionPartitioner.getPartition
  (:63-85): (contig, pos) to one of N partitions by cumulative genome
  offset, with one extra partition for unmapped reads (partition N).
* :func:`region_partition` — GenomicRegionPartitioner (:102-121).
* :func:`shard_rows_by_position` — row indices per shard.

And the mesh half, the streamed run's second execution mode
(``--partitioner mesh`` / ``ADAM_TPU_PARTITIONER``; the default ``pool``
round-robins whole windows over the pool's slots):

* :func:`resolve_execution_mode`, :func:`healthy_subset`;
* :class:`MeshPartitioner`: every window's rows split into ``n`` row
  blocks, one per slot (``parallel/mesh.LocalMesh``).  Where JAX runs a
  ``shard_map`` jit per pass (``partitioner.py:259-500``), each shard runs
  the port's own single-device body over its block on its slot: the
  markdup reductions, the observe (covariate keys and kernel 1) and the
  apply with both packs (kernel 2, twice).  The shards' observe
  histograms are summed in **i64** into a device-resident accumulator on
  slot 0, one per grid width, so barrier 2 fetches one
  table per width instead of one per window.  A window's packed outputs
  are each shard's real bytes concatenated in shard order, which is row
  order: the single-device pack, byte for byte;
* :func:`mesh_resident_window` and the ``mesh_*_prewarm_entry``
  functions.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Sequence

import numpy as np
import torch

from adam_tpu_torch.models.dictionaries import SequenceDictionary


@dataclass(frozen=True)
class GenomeBins:
    """Fixed-size genome binning (ShuffleRegionJoin.scala:140-193).

    Bin ids stack per contig in dictionary order; ``invert`` recovers the
    bin's region."""

    bin_size: int
    seq_dict: SequenceDictionary

    @cached_property
    def bins_per_contig(self) -> np.ndarray:
        # every contig owns at least one bin, so contigs with undeclared
        # (0) length still have a home in the bin-id space
        return np.maximum(-(-self.seq_dict.lengths // self.bin_size), 1)

    @cached_property
    def bin_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.bins_per_contig)])

    @property
    def num_bins(self) -> int:
        return int(self.bin_offsets[-1])

    def start_bin(self, contig_idx, start):
        ci = np.asarray(contig_idx)
        local = np.asarray(start) // self.bin_size
        return self.bin_offsets[ci] + np.minimum(local, self.bins_per_contig[ci] - 1)

    def end_bin(self, contig_idx, end):
        """Bin of the last covered base (end is exclusive), clamped to
        the contig's last bin so intervals overhanging a declared contig
        length never spill into the next contig's bin-id range."""
        ci = np.asarray(contig_idx)
        local = np.maximum(np.asarray(end) - 1, 0) // self.bin_size
        return self.bin_offsets[ci] + np.minimum(local, self.bins_per_contig[ci] - 1)

    def invert(self, bin_id: int):
        """bin id -> (contig_idx, start, end) region of the bin."""
        contig = int(np.searchsorted(self.bin_offsets, bin_id, "right") - 1)
        local = bin_id - int(self.bin_offsets[contig])
        start = local * self.bin_size
        end = max(min(start + self.bin_size, int(self.seq_dict.lengths[contig])), start)
        return contig, start, end

    def dedupe_region(self, bin_id: int):
        """Like :meth:`invert`, but the last bin of each contig extends to
        the i64 maximum: overhanging intervals clamp into that bin, and
        their starts must still satisfy the at-least-one-side-starts-here
        join rule."""
        contig, start, end = self.invert(bin_id)
        if bin_id == int(self.bin_offsets[contig + 1]) - 1:
            end = np.iinfo(np.int64).max
        return contig, start, end


def position_partition(seq_dict: SequenceDictionary, contig_idx, pos,
                       num_partitions: int) -> np.ndarray:
    """Partition id per read; unmapped (contig_idx < 0) -> num_partitions.

    Mapped reads land in int(num_partitions * flattened / total_length),
    the cumulative-offset binning of the reference."""
    contig_idx = np.asarray(contig_idx)
    pos = np.asarray(pos)
    offsets = seq_dict.offsets
    total = max(seq_dict.total_length, 1)
    safe_idx = np.clip(contig_idx, 0, max(len(seq_dict) - 1, 0))
    flat = offsets[safe_idx] + np.maximum(pos, 0)
    part = (num_partitions * flat) // total
    part = np.clip(part, 0, num_partitions - 1)
    return np.where(contig_idx < 0, num_partitions, part).astype(np.int64)


def region_partition(seq_dict: SequenceDictionary, contig_idx, pos,
                     partition_size: int) -> np.ndarray:
    """Fixed-size bin id, unique across contigs (bins stack per contig);
    -1 for unmapped rows."""
    contig_idx = np.asarray(contig_idx)
    pos = np.asarray(pos)
    bins = GenomeBins(partition_size, seq_dict)
    safe_idx = np.clip(contig_idx, 0, max(len(seq_dict) - 1, 0))
    out = bins.start_bin(safe_idx, np.maximum(pos, 0))
    return np.where(contig_idx < 0, -1, out).astype(np.int64)


def shard_rows_by_position(seq_dict: SequenceDictionary, contig_idx, pos,
                           n_shards: int) -> list[np.ndarray]:
    """Row indices per shard (unmapped rows appended to the last shard)."""
    part = position_partition(seq_dict, contig_idx, pos, n_shards)
    part = np.where(part >= n_shards, n_shards - 1, part)
    return [np.flatnonzero(part == s) for s in range(n_shards)]


def partition_by_contig(contig_idx, n_partitions: Optional[int] = None) -> np.ndarray:
    """Partition rows by contig (the reference's ReferencePartitioner):
    every row of a contig lands on the same partition.

    -> i32[N] partition ids in [0, n_partitions); unplaced rows (-1
    contig) go to the last partition. Defaults to one partition per
    contig present, plus that last one."""
    contig_idx = np.asarray(contig_idx)
    uniq = np.unique(contig_idx[contig_idx >= 0])
    if n_partitions is None:
        n_partitions = max(1, len(uniq)) + 1
    # contig ids may be sparse: the modulo takes their ranks, so distinct
    # contigs do not collide while partitions sit empty
    rank = np.searchsorted(uniq, np.clip(contig_idx, 0, None))
    part = np.where(contig_idx >= 0, rank % max(1, n_partitions - 1),
                    n_partitions - 1)
    return part.astype(np.int32)


def shard_rows_by_contig(contig_idx, n_shards: int) -> list[np.ndarray]:
    """Row indices per shard under contig partitioning."""
    part = partition_by_contig(contig_idx, n_shards)
    return [np.flatnonzero(part == s) for s in range(n_shards)]


# --------------------------------------------------------------------------
# The mesh half: the streamed run's SPMD execution mode
# --------------------------------------------------------------------------
log = logging.getLogger(__name__)

EXECUTION_MODES = ("pool", "mesh")


def resolve_execution_mode(override: Optional[str] = None) -> str:
    """The streamed run's partitioner: ``override`` (the ``--partitioner``
    flag; an invalid value raises), then ``ADAM_TPU_PARTITIONER`` (an
    invalid value warns and gives ``pool``), then ``pool``."""
    v = (override or "").strip().lower()
    if v:
        if v not in EXECUTION_MODES:
            raise ValueError(f"--partitioner={v!r}: expected one of {EXECUTION_MODES}")
        return v
    v = os.environ.get("ADAM_TPU_PARTITIONER", "").strip().lower()
    if v and v not in EXECUTION_MODES:
        log.warning("ADAM_TPU_PARTITIONER=%r is not one of %s; using 'pool'",
                    v, EXECUTION_MODES)
        v = ""
    return v or "pool"


def healthy_subset(slots: Sequence, board=None) -> list:
    """The slots a mesh should span: the health board's probation and
    evicted slots left out (a collective spans every shard, so one bad
    slot would spoil every window), unless that empties the set."""
    if board is None:
        from adam_tpu_torch.utils.health import BOARD as board
    slots = list(slots)
    ok = [s for s in slots if not board.blocked(s)]
    if ok and len(ok) < len(slots):
        log.warning("mesh construction left out %d health-blocked slot(s); "
                    "spanning the %d healthy one(s)", len(slots) - len(ok), len(ok))
    return ok if ok else slots


class MeshPartitioner:
    """The mesh execution mode over a slot set (module docstring).

    Placement goes through :meth:`put_rows` (a host array split into row
    blocks, one per slot, each booked in the h2d ledger against its slot)
    and :meth:`put_replicated` (one copy per slot).  Dispatch spans carry
    ``device="mesh"``: a collective occupies every slot at once."""

    def __init__(self, slots: Sequence):
        from adam_tpu_torch.parallel.mesh import LocalMesh

        self.mesh = LocalMesh(slots)
        self.devices = self.mesh.slots
        self._acc: dict = {}

    @property
    def n(self) -> int:
        return self.mesh.n

    def ledger_key(self) -> str:
        """The compile ledger's key of mesh launches: one per mesh width."""
        return f"mesh:{self.n}"

    def route(self) -> str:
        from adam_tpu_torch.utils.compile_ledger import route_of

        return route_of(self.devices[0])

    def rows_for(self, g: int) -> int:
        """``g`` rows padded up to a multiple of the shard count."""
        return -(-int(g) // self.n) * self.n

    def block(self, gm: int) -> int:
        """Rows per shard of a ``gm``-row window."""
        return gm // self.n

    def put_rows(self, x) -> list:
        """Host array ``x`` (leading axis a multiple of ``n``) -> one row
        block per shard, on its slot."""
        from adam_tpu_torch.parallel.device_pool import putter

        r = x.shape[0] // self.n
        return [putter(s)(x[k * r:(k + 1) * r]) for k, s in enumerate(self.devices)]

    def put_replicated(self, x) -> list:
        """Host array ``x`` -> one copy per slot."""
        from adam_tpu_torch.parallel.device_pool import putter

        return [putter(s)(x) for s in self.devices]

    def shard_map(self, body, *per_shard):
        """Run ``body(k, *args_k)`` for each shard ``k`` inside its slot's
        scope, where each of ``per_shard`` is a list of per-shard values
        (or one value shared by every shard) -> the list of results."""
        out = []
        for k, s in enumerate(self.devices):
            args = [a[k] if isinstance(a, (list, tuple)) else a for a in per_shard]
            with s.scope():
                out.append(body(k, *args))
        return out

    def accumulate(self, total, mism, gl: int) -> None:
        """Fold one window's histograms (one tensor, or one per shard) into
        the accumulator of its grid width on slot 0, in i64 (bitwise the
        pool's host-side window-order merge)."""
        totals = total if isinstance(total, (list, tuple)) else [total]
        misms = mism if isinstance(mism, (list, tuple)) else [mism]
        s0 = self.devices[0]
        acc = self._acc.get(int(gl))
        for k, (t, m) in enumerate(zip(totals, misms)):
            src = self.devices[k] if len(totals) == self.n else s0
            t = self.mesh._move(t, self.devices.index(src), 0)
            m = self.mesh._move(m, self.devices.index(src), 0)
            with s0.scope():
                if acc is None:
                    acc = [t.to(torch.int64).clone(), m.to(torch.int64).clone()]
                else:
                    acc[0] += t
                    acc[1] += m
        self._acc[int(gl)] = acc

    def has_accumulated(self) -> bool:
        return bool(self._acc)

    def fetch_accumulated(self, tracer=None) -> list:
        """Barrier 2: the merged tables home, one ``(total, mism, gl)`` per
        grid width, each fetch a ``device.fetch.observe`` span with
        ``device="mesh"``.  Clears the accumulator."""
        from adam_tpu_torch.utils import telemetry as tele
        from adam_tpu_torch.utils.transfer import device_fetch

        tr = tracer if tracer is not None else tele.TRACE
        s0 = self.devices[0]
        out = []
        try:
            for gl in sorted(self._acc):
                total, mism = self._acc[gl]
                with tr.span(tele.SPAN_OBS_FETCH, device="mesh"):
                    out.append((device_fetch(total, s0), device_fetch(mism, s0), gl))
        finally:
            self._acc.clear()
        return out

    def reset_accumulator(self) -> None:
        self._acc.clear()

    def fetch_rows(self, parts: list, n: Optional[int] = None) -> np.ndarray:
        """Per-shard row blocks home, concatenated in shard order (the first
        ``n`` rows)."""
        from adam_tpu_torch.utils.transfer import device_fetch

        got = np.concatenate([device_fetch(p, s) for p, s in zip(parts, self.devices)])
        return got if n is None else got[:n]

    def prewarm(self, entries: Sequence[tuple], tracer=None) -> int:
        """Run each mesh entry ``(key, fn)`` (``fn(self)`` launches the
        per-shard bodies on every slot) once per process per mesh width,
        sharing the pool's dedupe cache -> the entries run."""
        from adam_tpu_torch.parallel import device_pool as dp
        from adam_tpu_torch.utils import compile_ledger
        from adam_tpu_torch.utils import telemetry as tele

        tr = tracer if tracer is not None else tele.TRACE
        todo = []
        with dp._PREWARM_LOCK:
            for key, fn in entries:
                cache_key = (key, self.ledger_key(), self.route())
                if cache_key not in dp._PREWARMED:
                    dp._PREWARMED.add(cache_key)
                    todo.append((key, fn, cache_key))
                else:
                    compile_ledger.claim(key, self.ledger_key(), self.route())
        done = 0
        for key, fn, cache_key in todo:
            try:
                with tr.span(tele.SPAN_POOL_PREWARM_COMPILE, device="mesh",
                             kernel=str(key[0])), compile_ledger.prewarm_scope(), \
                        tele.pass_scope("prewarm"), \
                        compile_ledger.track(key, self.ledger_key(), self.route()):
                    fn(self)
                    for s in self.devices:
                        s.synchronize()
            except Exception:
                with dp._PREWARM_LOCK:
                    dp._PREWARMED.discard(cache_key)
                log.warning("mesh prewarm of %s failed; the shape runs cold at "
                            "its first dispatch instead", key, exc_info=True)
                continue
            tr.count(tele.C_POOL_PREWARM_COMPILES)
            done += 1
        return done


def mesh_resident_window(b, window: int, part: MeshPartitioner):
    """Place one window's resident payload as per-shard row blocks (the
    mesh counterpart of ``ResidentWindow.place``): rows padded to the
    mesh width, each field a list of one tensor per slot."""
    from adam_tpu_torch.formats.batch import grid_cols, grid_rows
    from adam_tpu_torch.parallel.device_pool import ResidentWindow

    gm = part.rows_for(grid_rows(b.n_rows))
    gl = grid_cols(b.lmax)
    host = ResidentWindow.host_arrays(b, gm, gl)
    return ResidentWindow(window, "mesh", {k: part.put_rows(a) for k, a in host.items()},
                          gm, gl, sum(int(a.nbytes) for a in host.values()))


def _mesh_entry(name: str, pool_entry: tuple, gm: int) -> tuple:
    key, warm = pool_entry

    def run(part):
        for s in part.devices:
            with s.scope():
                warm(s)

    return ((name, gm) + tuple(key[2:]), run)


def _mesh_rows(b, part) -> int:
    from adam_tpu_torch.formats.batch import grid_rows

    return part.rows_for(grid_rows(b.n_rows))


def mesh_markdup_prewarm_entry(b, part: MeshPartitioner) -> tuple:
    """Prewarm entry of the mesh markdup reductions at batch ``b``'s grid."""
    from adam_tpu_torch.parallel.device_pool import markdup_prewarm_entry

    gm = _mesh_rows(b, part)
    return _mesh_entry("mesh.markdup", markdup_prewarm_entry(b, g=part.block(gm)), gm)


def mesh_observe_prewarm_entry(b, n_rg: int, part: MeshPartitioner) -> tuple:
    """Prewarm entry of the mesh observe at batch ``b``'s grid."""
    from adam_tpu_torch.parallel.device_pool import observe_prewarm_entry

    gm = _mesh_rows(b, part)
    return _mesh_entry("mesh.observe_packed",
                       observe_prewarm_entry(b, n_rg, g=part.block(gm)), gm)


def mesh_apply_prewarm_entry(b, n_rg: int, n_cyc: int, part: MeshPartitioner) -> tuple:
    """Prewarm entry of the mesh apply + packs at the solved table's width."""
    from adam_tpu_torch.parallel.device_pool import apply_prewarm_entry

    gm = _mesh_rows(b, part)
    return _mesh_entry("mesh.apply_pack2",
                       apply_prewarm_entry(b, n_rg, n_cyc, g=part.block(gm)), gm)
