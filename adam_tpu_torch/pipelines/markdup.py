"""Duplicate marking — the port's counterpart of
``adam_tpu/pipelines/markdup.py``.

Picard-style semantics (the reference's ``MarkDuplicates.scala:66-128``):
reads bucket by (read group, name); each bucket keys on its 5'-clipped
position pair; within a (library, left position) group and right-position
subgroup the highest-scoring pair bucket stays unmarked.  The per-window
[N, L] reductions (5' key, quality score) run on the device in pass A;
the global group-subgroup-argmax cascade runs at barrier 1 over the
compact per-row summaries, with its 9-key lexsort on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from adam_tpu_torch.api.datasets import AlignmentDataset
from adam_tpu_torch.formats import schema
from adam_tpu_torch.formats.batch import pad_rows_np
from adam_tpu_torch.formats.strings import StringColumn
from adam_tpu_torch.ops import cigar as cigar_ops


def markdup_columns_local(start, end, flags, ops, lens, n_ops, quals,
                          lengths):
    """[N, L] duplicate-marking reductions on tensors -> (five_prime
    i64[N], score i32[N]): the 5'-clipped key by the CIGAR walk and the
    bucket score as the sum of in-read quals >= 15."""
    five = cigar_ops.five_prime_position(start, end, flags, ops, lens, n_ops)
    in_read = (
        torch.arange(quals.shape[1], device=quals.device)[None, :]
        < lengths[:, None]
    )
    q = quals.to(torch.int32)
    score = torch.where(in_read & (q >= 15), q, 0).sum(
        dim=1, dtype=torch.int32
    )
    return five, score


def markdup_columns(batch, resident, mesh=None):
    """Dispatch one window's reductions against its resident window
    (quals, lengths and flags already on the slot; only start, end and the
    cigar columns ship, padded to the ``[g, gc]`` grid) -> lazy (five,
    score) tensors on the window's slot for its real rows.  Under ``mesh``
    (``rw`` its ``mesh_resident_window``) each shard reduces its row block
    on its slot and (five, score) are the per-shard lists of the padded
    rows, for :func:`fetch_columns`."""
    from adam_tpu_torch.formats.batch import grid_cigar_cols
    from adam_tpu_torch.pipelines.bqsr import _dispatch, _placer, _site_attrs
    from adam_tpu_torch.utils import telemetry as tele

    rw = resident
    with tele.TRACE.span(tele.SPAN_MD_COLUMNS, backend="device",
                         reads=int(batch.n_rows), **_site_attrs(rw, mesh)):
        b = batch.to_numpy()
        n, g, gl = b.n_rows, rw.g, rw.gl
        gc = grid_cigar_cols(b.cigar_ops.shape[1] if b.cigar_ops.ndim == 2 else 1)
        host = (pad_rows_np(b.start, g, -1), pad_rows_np(b.end, g, -1),
                pad_rows_np(b.cigar_ops, g, schema.CIGAR_PAD, cols=gc),
                pad_rows_np(b.cigar_lens, g, 0, cols=gc),
                pad_rows_np(b.cigar_n, g, 0))
        put = _placer(rw, mesh)

        def run():
            start, end, ops, lens, n_ops = (put(a) for a in host)
            if mesh is None:
                five, score = markdup_columns_local(
                    start, end, rw.get("flags"), ops, lens, n_ops, rw.get("quals"),
                    rw.get("lengths"))
                return five[:n], score[:n]
            outs = mesh.shard_map(
                lambda k, *a: markdup_columns_local(*a),
                start, end, rw.get("flags"), ops, lens, n_ops, rw.get("quals"),
                rw.get("lengths"))
            return [o[0] for o in outs], [o[1] for o in outs]

        name = "mesh.markdup" if mesh is not None else "markdup.columns"
        return _dispatch((name, g, gc, gl), rw, mesh, run)


def fetch_columns(cols, n: int, slot=None, mesh=None) -> tuple:
    """A window's dispatched (five, score) home -> host (five i64[n],
    score i32[n]), through ``utils/transfer.device_fetch`` (from the slot
    that holds them; under ``mesh``, each shard's block, in row order)."""
    from adam_tpu_torch.utils.transfer import device_fetch

    five, score = cols
    if mesh is not None:
        return mesh.fetch_rows(five, n), mesh.fetch_rows(score, n)
    return device_fetch(five, slot), device_fetch(score, slot)


def device_lexsort(keys, device) -> np.ndarray:
    """``np.lexsort(keys)`` on ``device`` (a device or a pool slot) -> i64[n]
    permutation.

    ``keys`` follows the np.lexsort convention (last key primary).  The
    keys ship as one i64 stack padded to the row grid, with a last,
    most significant validity key that sorts the padding after every real
    row (JAX's layout).  A cascade of stable sorts from the least
    significant key up, ``perm = perm[sort(k[perm], stable=True)]``,
    reproduces THE unique stable permutation, so ``perm[:n]`` is bitwise
    ``np.lexsort``'s."""
    from adam_tpu_torch.formats.batch import grid_rows
    from adam_tpu_torch.parallel.device_pool import as_slot, putter
    from adam_tpu_torch.utils.transfer import device_fetch

    keys = [np.ascontiguousarray(k, np.int64) for k in keys]
    n = keys[0].shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    g = grid_rows(n)
    stack = np.zeros((len(keys) + 1, g), np.int64)
    for i, k in enumerate(keys):
        stack[i, :n] = k
    stack[len(keys), n:] = 1
    slot = as_slot(device)
    ks = putter(slot)(stack)
    with slot.scope():
        perm = torch.arange(g, device=slot.device)
        for i in range(len(keys) + 1):
            perm = perm[torch.sort(ks[i][perm], stable=True).indices]
    return np.asarray(device_fetch(perm[:n], slot), np.int64)


def _sequence_hashes(bases: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Deterministic per-read sequence hash (unmapped-read grouping key).

    Polynomial over base codes; identical sequences (incl. length) hash
    equal — the role of the reference's sequence hashCode key for
    unplaced pairs (models/ReferencePositionPair.scala:43-51).
    """
    n, L = bases.shape
    rng = np.random.default_rng(0xADA5)
    w = rng.integers(1, 2**62, size=L, dtype=np.int64) | 1
    codes = bases.astype(np.int64) + 1
    h = (codes * w[None, :]).sum(axis=1)
    h = h ^ (lengths.astype(np.int64) * np.int64(0x9E3779B97F4A7C15 - (1 << 64)))
    return h & 0x7FFFFFFFFFFFFFFF


def row_summary(ds: AlignmentDataset, five_prime: np.ndarray,
                score: np.ndarray) -> dict:
    """Compact per-row duplicate-marking summary (host numpy).

    Everything :func:`resolve_duplicates` needs, and nothing [N, L]-
    shaped: the 5'-clipped position and quality score (from
    :func:`markdup_columns`), the row key columns, the bucket key
    inputs (read-group, name bytes), and the library id.  Windows of a
    streamed ingest each produce one of these; :func:`concat_summaries`
    splices them for the global resolve.
    """
    b = ds.batch.to_numpy()
    n = b.n_rows

    flags = np.asarray(b.flags)
    valid = np.asarray(b.valid)
    mapped = (flags & schema.FLAG_UNMAPPED) == 0

    # per-row candidate keys (ReferencePositionPair.apply):
    # (kind, contig_or_hash, pos, strand); kind 0 = none, 1 = mapped
    # position, 2 = sequence-keyed (unmapped).  Only unmapped rows
    # consume the sequence hash — skip the O(N*L) polynomial for the
    # (typical) mostly-mapped batch.
    seq_hash = np.zeros(n, dtype=np.int64)
    um = np.flatnonzero(~mapped)
    if len(um):
        seq_hash[um] = _sequence_hashes(
            np.asarray(b.bases)[um], np.asarray(b.lengths)[um]
        )
    reverse = (flags & schema.FLAG_REVERSE) != 0
    row_key = np.zeros((n, 4), dtype=np.int64)
    row_key[:, 0] = np.where(mapped, 1, 2)
    row_key[:, 1] = np.where(mapped, np.asarray(b.contig_idx), seq_hash)
    row_key[:, 2] = np.where(mapped, five_prime, 0)
    row_key[:, 3] = np.where(mapped, reverse.astype(np.int64), 0)

    lib_ids = (
        ds.read_groups.library_ids()
        if len(ds.read_groups)
        else np.array([], np.int32)
    )
    rgidx = np.asarray(b.read_group_idx)
    lib_per_row = np.where(
        rgidx >= 0,
        lib_ids[np.clip(rgidx, 0, None)] if len(lib_ids) else -1,
        -1,
    ).astype(np.int64)

    return dict(
        flags=flags,
        valid=valid,
        score=score,
        row_key=row_key,
        rg_idx=rgidx.astype(np.int64),
        lib_per_row=lib_per_row,
        name_bytes=StringColumn.of(ds.sidecar.names).to_fixed_bytes(),
    )


def concat_summaries(parts: list[dict]) -> dict:
    """Splice window summaries into one global summary (names re-padded
    to a common byte width so the fixed-width unique stays exact)."""
    if len(parts) == 1:
        return parts[0]
    w = max(p["name_bytes"].dtype.itemsize for p in parts)
    dt = np.dtype(f"S{max(w, 1)}")
    out = {}
    for k in parts[0]:
        cols = [p[k] for p in parts]
        if k == "name_bytes":
            cols = [c.astype(dt) for c in cols]
        out[k] = np.concatenate(cols)
    return out


def _unique_inverse_fixed_bytes(names: np.ndarray) -> np.ndarray:
    """``np.unique(names, return_inverse=True)[1]`` for fixed-width byte
    names, via big-endian integer views when the width allows.

    memcmp order on null-padded fixed-width bytes == numeric order of
    the big-endian word(s), so the inverse ids are IDENTICAL to the
    S-dtype unique's — just ~4x faster (integer radix-ish sort instead
    of string compares; this was the single hottest step of the global
    duplicate resolve on a 1M-read input)."""
    n = len(names)
    w = names.dtype.itemsize
    if n == 0 or w > 16:
        return np.unique(names, return_inverse=True)[1]
    nw = 8 if w <= 8 else 16
    padded = np.zeros((n, nw), np.uint8)
    padded[:, :w] = names.view(np.uint8).reshape(n, w)
    words = padded.view(">u8").astype(np.uint64)
    if nw == 8:
        return np.unique(words[:, 0], return_inverse=True)[1]
    hi, lo = words[:, 0], words[:, 1]
    order = np.lexsort((lo, hi))
    sh, sl = hi[order], lo[order]
    new = np.ones(n, bool)
    new[1:] = (sh[1:] != sh[:-1]) | (sl[1:] != sl[:-1])
    inv = np.empty(n, np.int64)
    inv[order] = np.cumsum(new) - 1
    return inv


def resolve_duplicates(s: dict, device="cuda") -> np.ndarray:
    """Global group-subgroup-argmax cascade over row summaries -> bool[N]
    duplicate mask.  One lexsort over the bucket table; row order across
    windows is the tie-break order, matching the reference's partition
    concatenation.

    The 9-key lexsort runs on ``device`` (:func:`device_lexsort`, a
    cascade of stable torch sorts: bitwise ``np.lexsort``'s
    permutation)."""
    flags = s["flags"]
    valid = s["valid"]
    n = len(flags)
    if n == 0:
        return np.zeros(0, dtype=bool)

    # ----- bucket ids: dense (rg, name) -> id (SingleReadBucket) -------
    names = s["name_bytes"]
    name_inv = _unique_inverse_fixed_bytes(names)
    rg = s["rg_idx"]
    key = (rg + 1) * (name_inv.max() + 1 if len(name_inv) else 1) + name_inv
    key = np.where(valid, key, -1)
    vrows = np.flatnonzero(valid)
    uniq, inv = np.unique(key[vrows], return_inverse=True)
    bucket_of = np.full(n, -1, dtype=np.int64)
    bucket_of[vrows] = inv
    n_buckets = len(uniq)
    if n_buckets == 0:
        return np.zeros(n, dtype=bool)

    mapped = (flags & schema.FLAG_UNMAPPED) == 0
    primary = (flags & (schema.FLAG_SECONDARY | schema.FLAG_SUPPLEMENTARY)) == 0
    first = (flags & schema.FLAG_FIRST_OF_PAIR) != 0
    second = (flags & schema.FLAG_SECOND_OF_PAIR) != 0
    row_key = s["row_key"]
    read_score = s["score"]

    in_bucket = bucket_of >= 0
    candidate = in_bucket & (((mapped & primary)) | ~mapped)

    # ordering inside a bucket: mapped-primary candidates first, then row
    # order (the reference's primaryMapped ++ unmapped concatenation)
    prio = (~mapped).astype(np.int64) * n + np.arange(n, dtype=np.int64)
    BIG = np.int64(2) * n * n + n

    def first_row(mask: np.ndarray) -> np.ndarray:
        """Per-bucket row with minimal prio among masked rows (-1 none)."""
        sel = np.full(n_buckets, BIG, dtype=np.int64)
        rows = np.flatnonzero(mask)
        np.minimum.at(sel, bucket_of[rows], prio[rows])
        out = np.where(sel < BIG, sel % n, -1)
        return out

    first_sel = first_row(candidate & first)
    second_sel = first_row(candidate & second)
    frag_sel = first_row(candidate)

    # bucket score: sum of primary-mapped read scores
    bucket_score = np.zeros(n_buckets, dtype=np.int64)
    sc_rows = np.flatnonzero(in_bucket & valid & mapped & primary)
    np.add.at(bucket_score, bucket_of[sc_rows], read_score[sc_rows].astype(np.int64))

    # library per bucket (library of the first read, in row order)
    lib_per_row = s["lib_per_row"]
    lead = first_row(in_bucket)
    bucket_lib = np.where(lead >= 0, lib_per_row[np.clip(lead, 0, None)], -1)

    # ----- per-bucket left/right keys ----------------------------------
    has_pair = (first_sel >= 0) | (second_sel >= 0)
    left_arr = np.zeros((n_buckets, 4), dtype=np.int64)
    right_arr = np.zeros((n_buckets, 4), dtype=np.int64)
    lk_rows = np.where(has_pair, first_sel, frag_sel)
    use_lk = lk_rows >= 0
    left_arr[use_lk] = row_key[lk_rows[use_lk]]
    rk_rows = np.where(has_pair, second_sel, -1)
    use_rk = rk_rows >= 0
    right_arr[use_rk] = row_key[rk_rows[use_rk]]

    # ----- group by (library, left), subgroup by right, mark -----------
    # lexicographic order (lib, L0..L3, R0..R3) with adjacent small-range
    # fields packed into shared words: kind < 4, strand < 2, and
    # |pos| < 2^40, so (lib<<2)|kind, (Lpos<<3)|(Lstrand<<2)|Rkind and
    # (Rpos<<1)|Rstrand preserve the 9-key order in 5 stable sorts
    # (full-range int64 hash keys L1/R1 stay unpacked)
    k1 = (bucket_lib << 2) | left_arr[:, 0]
    k3 = (left_arr[:, 2] << 3) | (left_arr[:, 3] << 2) | right_arr[:, 0]
    k5 = (right_arr[:, 2] << 1) | right_arr[:, 3]
    sort_keys = (k5, right_arr[:, 1], k3, left_arr[:, 1], k1)
    group_order = device_lexsort(sort_keys, device)
    go = group_order
    sl = np.concatenate([bucket_lib[go, None], left_arr[go]], axis=1)
    sr = right_arr[go]
    new_left = np.ones(len(go), dtype=bool)
    new_left[1:] = (sl[1:] != sl[:-1]).any(axis=1)
    new_right = new_left.copy()
    new_right[1:] |= (sr[1:] != sr[:-1]).any(axis=1)

    left_id = np.cumsum(new_left) - 1       # per sorted bucket
    sub_id = np.cumsum(new_right) - 1
    n_left = int(left_id[-1]) + 1
    n_sub = int(sub_id[-1]) + 1
    sub_starts = np.flatnonzero(new_right)
    # left group of each subgroup / subgroup count per left group
    sub_left = left_id[sub_starts]
    subs_per_left = np.bincount(sub_left, minlength=n_left)

    group_skip = np.zeros(n_left, dtype=bool)
    group_skip[left_id[new_left]] = sl[new_left, 1] == 0  # left kind None

    sub_is_frag = sr[sub_starts, 0] == 0
    sub_only_frag = sub_is_frag & (subs_per_left[sub_left] == 1)
    sub_keep_best = (sub_only_frag | ~sub_is_frag) & ~group_skip[sub_left]
    sub_mark_all = sub_is_frag & (subs_per_left[sub_left] > 1) & ~group_skip[sub_left]

    # best bucket per subgroup: max score, first (stable order) wins
    score_sorted = bucket_score[go]
    max_sc = np.maximum.reduceat(score_sorted, sub_starts)
    pos = np.arange(len(go), dtype=np.int64)
    is_max = score_sorted == max_sc[sub_id]
    first_best = np.full(n_sub, len(go), dtype=np.int64)
    rows_max = np.flatnonzero(is_max)
    np.minimum.at(first_best, sub_id[rows_max], pos[rows_max])

    marked_sub = sub_keep_best | sub_mark_all
    primary_dup_sorted = marked_sub[sub_id]
    secondary_dup_sorted = primary_dup_sorted.copy()
    # unmark the best bucket of keep-best subgroups (primaries only)
    best_pos = first_best[np.flatnonzero(sub_keep_best)]
    primary_dup_sorted[best_pos] = False

    primary_dup = np.zeros(n_buckets, dtype=bool)
    secondary_dup = np.zeros(n_buckets, dtype=bool)
    primary_dup[go] = primary_dup_sorted
    secondary_dup[go] = secondary_dup_sorted

    # ----- back to rows ------------------------------------------------
    row_bucket = np.clip(bucket_of, 0, None)
    dup = np.where(
        mapped & primary,
        primary_dup[row_bucket],
        np.where(mapped, secondary_dup[row_bucket], False),
    )
    dup &= valid & (bucket_of >= 0)
    return dup


def apply_duplicate_flags(flags: np.ndarray, dup: np.ndarray) -> np.ndarray:
    return np.where(
        dup, flags | schema.FLAG_DUPLICATE, flags & ~schema.FLAG_DUPLICATE
    ).astype(np.int32)


def mark_duplicates(ds: AlignmentDataset, device: str = "cuda") -> AlignmentDataset:
    """Duplicate marking over one whole dataset (the JAX package's
    ``mark_duplicates``): the [N, L] reductions (5' keys, scores) run on
    ``device`` over the dataset placed there once, then the row summary,
    the global resolve (its lexsort on ``device``) and the flags."""
    from adam_tpu_torch.device import resolve_device
    from adam_tpu_torch.parallel.device_pool import ResidentWindow

    b = ds.batch.to_numpy()
    if b.n_rows == 0:
        return ds
    dev = resolve_device(device)
    five, score = markdup_columns(b, ResidentWindow.place(b, dev))
    s = row_summary(ds, five.cpu().numpy(), score.cpu().numpy())
    dup = resolve_duplicates(s, device=dev)
    return ds.with_batch(b.replace(flags=apply_duplicate_flags(np.asarray(b.flags), dup)))
