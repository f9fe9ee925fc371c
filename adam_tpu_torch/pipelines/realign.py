"""GATK-style local indel realignment — the port's counterpart of
``adam_tpu/pipelines/realign.py``.

Semantics of the reference's ``rdd/read/realignment/`` +
``algorithms/consensus/`` packages, as the JAX package implements them:

1. **Target discovery** (RealignmentTargetFinder, IndelRealignmentTarget):
   every I/D CIGAR op (length <= maxIndelSize) yields a target (variation
   region, read span); targets sort by read span, merge while
   overlapping, dedupe on equal read spans and drop spans >
   maxTargetSize.
2. **Read -> target mapping** (RealignIndels.mapToTarget), vectorized.
3. **Per-target realignment** (RealignIndels.realignTargetGroup): rebuild
   the reference from MD tags, left-normalize single-indel reads, take
   each indel read's alternate consensus, sweep every read over every
   consensus, accept the best consensus when the LOD improvement beats
   the threshold, and rewrite start/CIGAR/MD (+10 mapq, OC/OP tags).
4. The **sweep** (sweepReadOverReferenceForQuality) is a batched f32
   ``torch.bmm``: mismatch-quality(b, o) = totalQual(b) - the one-hot
   match correlation of read b at offset o.  Every product is a 0/1
   one-hot times a quality <= 93 and every sum is below 2^24, so f32
   is exact (the JAX package used bf16 inputs with f32 accumulation;
   ``torch.bmm`` on bf16 returns bf16, which rounds sums above 256).

Two implementations serve :func:`realign_indels`, as in the JAX package:
the native path (per-read string work in ``native/realign.cpp``) for the
``reads`` and ``knowns`` consensus models (under ``knowns`` with a
known-indel table the consensuses are the table's indels overlapping the
target), and the Python path for ``smithwaterman``, whose preprocessing
aligns every read to its target's reference with
:mod:`adam_tpu_torch.ops.smith_waterman` (the ``sw_fill`` kernel on the
card), batched across all targets.

**One departure from the JAX package** (a fault of the reference):
``adam_tpu/pipelines/realign.py:_sw_preprocess`` rewrites a read's start,
CIGAR and MD but keeps the implied reference (``_Read.ref``) of the read's
*old* alignment; the left-normalization that follows then walks the new
CIGAR over the stale reference and can raise ``IndexError`` from
``MdTag.move_alignment`` (it does on WGS-shaped input).  Here the
preprocessing refreshes ``ref`` from the rewritten read's new MD, as the
upstream ``MdTag.moveAlignment(read, cigar)`` derives the reference from
the read's current MD.  Everything else is bit-for-bit the JAX package's.

``realign_indels(overlap_work=)`` runs the caller's host work (the
streamed run's observe pass) between the sweeps' dispatch and their
fetch, timed as "Realign: overlapped host work"; ``sweep_devices=`` fans
the sweep chunks over pool slots (``parallel/device_pool.SweepSchedule``),
each chunk on its slot's stream, fetched once per slot.  Neither changes a
result.
"""

from __future__ import annotations

import contextlib
import logging
import random
from dataclasses import dataclass, replace as dc_replace
from typing import Optional

import numpy as np
import torch

from adam_tpu_torch.api.datasets import AlignmentDataset
from adam_tpu_torch.device import resolve_device
from adam_tpu_torch.formats import schema
from adam_tpu_torch.formats.batch import ReadBatch
from adam_tpu_torch.formats.strings import StringColumn, with_overrides
from adam_tpu_torch.models.positions import ReferenceRegion
from adam_tpu_torch.ops.mdtag import MdTag, batch_md_arrays, parse_cigar
from adam_tpu_torch.ops.smith_waterman import smith_waterman_many
from adam_tpu_torch.utils import telemetry as _tele

MAX_INDEL_SIZE = 500
MAX_CONSENSUS_NUMBER = 30
LOD_THRESHOLD = 5.0
MAX_TARGET_SIZE = 3000
CONSENSUS_MODELS = ("reads", "smithwaterman", "knowns")


# --------------------------------------------------------------------------
# CIGAR list helpers (host)
# --------------------------------------------------------------------------
def cigar_to_string(elems: list[tuple[int, str]]) -> str:
    return "".join(f"{n}{op}" for n, op in elems)


def cigar_read_len(elems) -> int:
    return sum(n for n, op in elems if op in "MIS=X")


def cigar_ref_len(elems) -> int:
    return sum(n for n, op in elems if op in "MDN=X")


def cigar_num_alignment_blocks(elems) -> int:
    return sum(1 for _, op in elems if op == "M")


def _cigar_total_len(elems) -> int:
    """Sum of ALL element lengths (RichCigar.getLength — includes D)."""
    return sum(n for n, _ in elems)


def move_cigar_left(elems: list[tuple[int, str]], index: int):
    """RichCigar.moveLeft semantics (rich/RichCigar.scala:140-186):
    trim one base from the element before ``index``, grow (or create, as
    1M) the element after it.  Replicates the reference's slicing,
    including dropping a 4th element when exactly 4 remain after the
    indel context."""
    if index == 0 or len(elems) < 2:
        return list(elems)
    head = list(elems[: index - 1])
    rest = list(elems[index - 1 :])
    trim = rest[0]
    move = rest[1] if len(rest) > 1 else None
    pad = rest[2] if len(rest) > 2 else None
    after_pad = rest[3:] if len(rest) > 4 else []
    out = list(head)
    if trim[0] > 1:
        out.append((trim[0] - 1, trim[1]))
    if move is not None:
        out.append(move)
    if pad is not None:
        out.append((pad[0] + 1, pad[1]))
    else:
        out.append((1, "M"))
    out += after_pad
    return out


def shift_indel(elems, position: int, shifts: int):
    """NormalizationUtils.shiftIndel (:142-153).

    The reference's well-formedness guard only compares total element
    length (RichCigar.isWellFormed:123-125 against the OLD total), so
    once the element before the indel is fully consumed, further moves
    start trimming the indel itself — the total can stay equal while the
    READ span (S+M+I) grows, and the reference then crashes in
    MdTag.moveAlignment on the out-of-range read index (a walk its
    suite never reaches; observed here on WGS-shaped data as an M span
    overrunning the read).  We additionally pin the read span AND the
    reference span, declining the corrupting move instead of
    reproducing the crash: a trimmed deletion changes the read span at
    constant total, while a trimmed insertion keeps both total and read
    span and silently erases the indel into M, growing the reference
    walk (tests: test_shift_indel_declines_read_length_corruption /
    _insertion_erasure)."""

    cur = list(elems)
    total = _cigar_total_len(cur)
    rlen = cigar_read_len(cur)
    reflen = cigar_ref_len(cur)
    while True:
        new = move_cigar_left(cur, position)
        if (
            shifts == 0
            or _cigar_total_len(new) != total
            or cigar_read_len(new) != rlen
            or cigar_ref_len(new) != reflen
        ):
            return cur
        cur = new
        shifts -= 1


def positions_to_shift(variant: str, preceding: str) -> int:
    """NormalizationUtils.numberOfPositionsToShiftIndel (:115-131)."""
    acc = 0
    v, p = variant, preceding
    while p and v and p[-1] == v[-1]:
        v = v[-1] + v[:-1]
        p = p[:-1]
        acc += 1
    return acc


def left_align_indel(seq: str, cigar: list, md: Optional[MdTag]):
    """NormalizationUtils.leftAlignIndel (:35-100): shift the single indel
    left through repeated sequence.  Returns a new cigar list."""
    indel_pos = -1
    indel_len = 0
    read_pos = ref_pos = 0
    is_insert = False
    for pos, (n, op) in enumerate(cigar):
        if op == "I":
            if indel_pos != -1:
                return list(cigar)
            indel_pos, indel_len, is_insert = pos, n, True
        elif op == "D":
            if indel_pos != -1:
                return list(cigar)
            indel_pos, indel_len = pos, n
        else:
            if indel_pos == -1:
                if op in "MIS=X":
                    read_pos += n
                if op in "MDN=X":
                    ref_pos += n
    if indel_pos == -1:
        return list(cigar)
    if is_insert:
        variant = seq[read_pos : read_pos + indel_len]
    else:
        if md is None:
            return list(cigar)
        ref = md.get_reference(seq, cigar_to_string(cigar))
        variant = ref[ref_pos : ref_pos + indel_len]
    preceding = seq[:read_pos]
    shift = positions_to_shift(variant, preceding)
    return shift_indel(cigar, indel_pos, shift)


# --------------------------------------------------------------------------
# Targets
# --------------------------------------------------------------------------
@dataclass
class RealignmentTarget:
    contig_idx: int
    var_start: int  # -1/-1 when no variation
    var_end: int
    range_start: int
    range_end: int

    @property
    def has_variation(self) -> bool:
        return self.var_start >= 0


def extract_indel_event_arrays(
    b, max_indel_size: int = MAX_INDEL_SIZE
) -> np.ndarray:
    """Per-read I/D events as an ``[n_events, 5]`` i64 array of
    (contig_idx, var_start, var_end, range_start, range_end) — no
    per-event Python objects (the WGS-scale hot path; ~13%% of reads
    carry an indel, so object churn here cost seconds per 1M reads).

    Event order matches the object path: column-major over the cigar
    slots, insertions then deletions per column, row-ascending."""
    n, C = b.cigar_ops.shape
    ops = np.asarray(b.cigar_ops)
    lens = np.asarray(b.cigar_lens).astype(np.int64)
    flags = np.asarray(b.flags)
    active = np.asarray(b.valid) & ((flags & schema.FLAG_UNMAPPED) == 0)
    starts = np.asarray(b.start).astype(np.int64)
    ends = np.asarray(b.end).astype(np.int64)
    contigs = np.asarray(b.contig_idx).astype(np.int64)
    # reference position at each cigar slot = start + exclusive cumsum of
    # ref-consuming op lengths
    r_consume = schema.CIGAR_CONSUMES_REF[np.minimum(ops, 15)].astype(np.int64)
    ref_adv = lens * r_consume
    ref_at = starts[:, None] + np.cumsum(ref_adv, axis=1) - ref_adv
    parts = []
    for k in range(C):
        op = ops[:, k]
        ln = lens[:, k]
        for is_ins in (True, False):
            code = schema.CIGAR_I if is_ins else schema.CIGAR_D
            rows = np.flatnonzero(
                active & (op == code) & (ln <= max_indel_size)
            )
            if not len(rows):
                continue
            vs = ref_at[rows, k]
            ve = vs + 1 if is_ins else vs + ln[rows]
            parts.append(np.stack(
                [contigs[rows], vs, ve, starts[rows], ends[rows]], axis=1
            ))
    if not parts:
        return np.zeros((0, 5), np.int64)
    return np.concatenate(parts, axis=0)


def extract_indel_events(b, max_indel_size: int = MAX_INDEL_SIZE
                         ) -> list[RealignmentTarget]:
    """Per-read I/D targets (IndelRealignmentTarget.apply) as objects, in
    the order of :func:`extract_indel_event_arrays`, the array form the
    pipelines use."""
    return [
        RealignmentTarget(int(c), int(vs), int(ve), int(rs), int(re))
        for c, vs, ve, rs, re in extract_indel_event_arrays(b, max_indel_size).tolist()
    ]


def find_targets(
    ds: AlignmentDataset,
    max_target_size: int = MAX_TARGET_SIZE,
    max_indel_size: int = MAX_INDEL_SIZE,
):
    """Sorted, merged, deduped target list."""
    b = ds.batch.to_numpy()
    events = extract_indel_event_arrays(b, max_indel_size)
    return merge_events(events, ds.seq_dict.names, max_target_size)


def resolve_tuning(
    max_indel_size=None, max_consensus_number=None,
    lod_threshold=None, max_target_size=None,
) -> tuple[int, int, float, int]:
    """None-coalesce the realignment tuning knobs against the module
    defaults."""
    return (
        MAX_INDEL_SIZE if max_indel_size is None else max_indel_size,
        MAX_CONSENSUS_NUMBER if max_consensus_number is None
        else max_consensus_number,
        LOD_THRESHOLD if lod_threshold is None else lod_threshold,
        MAX_TARGET_SIZE if max_target_size is None else max_target_size,
    )


def merge_events(
    events,
    names: list[str],
    max_target_size: int = MAX_TARGET_SIZE,
):
    """Sort + overlap-merge + dedupe per-read indel events (the ``[n, 5]``
    i64 array of :func:`extract_indel_event_arrays`, or a list of
    :class:`RealignmentTarget` from :func:`extract_indel_events`) into
    targets (the global barrier of the streamed path: per-window event
    arrays concatenate here, so targets spanning window edges merge
    exactly as in the single-batch path)."""
    ev = events
    if not isinstance(ev, np.ndarray):
        ev = np.array([[t.contig_idx, t.var_start, t.var_end, t.range_start,
                        t.range_end] for t in ev], np.int64).reshape(-1, 5)
    if not len(ev):
        return []
    # sort by (contig NAME, range_start, range_end) — the reference
    # orders by referenceName string, not index; lexsort is stable like
    # Python's sorted
    rank_of = {nm: i for i, nm in enumerate(sorted(names))}
    rank = np.array([rank_of[nm] for nm in names], np.int64)
    order = np.lexsort((ev[:, 4], ev[:, 3], rank[ev[:, 0]]))
    rows = ev[order].tolist()

    merged: list[list] = []  # [contig, vs, ve, rs, re] (vs=-1: none)
    for c, vs, ve, rs, re in rows:
        if merged:
            m = merged[-1]
            m_var = m[1] >= 0
            t_var = vs >= 0
            # TargetOrdering.overlap: either variation overlaps the
            # other's read span
            if m[0] == c and (
                (m_var and m[2] > rs and re > m[1])
                or (t_var and ve > m[3] and m[4] > vs)
            ):
                m[1] = (
                    min(m[1], vs) if m_var and t_var
                    else (m[1] if m_var else vs)
                )
                m[2] = (
                    max(m[2], ve) if m_var and t_var
                    else (m[2] if m_var else ve)
                )
                m[3] = min(m[3], rs)
                m[4] = max(m[4], re)
                continue
            if m[0] == c and m[3] == rs and m[4] == re:
                continue  # TreeSet equality on readRange: duplicate drop
        merged.append([c, vs, ve, rs, re])
    return [
        RealignmentTarget(int(c), int(vs), int(ve), int(rs), int(re))
        for c, vs, ve, rs, re in merged
        if re - rs <= max_target_size
    ]


def map_reads_to_targets(
    read_contig_rank, read_start, read_end, mapped_mask,
    target_rank, target_start, target_end,
) -> np.ndarray:
    """Vectorized replica of RealignIndels.mapToTarget's set-halving
    search (:72-94), including its pruning rule and the
    ``-1 - start/3000`` empty-target spreading."""
    n = len(read_start)
    nt = len(target_start)
    lo = np.zeros(n, dtype=np.int64)
    hi = np.full(n, nt, dtype=np.int64)
    while True:
        size = hi - lo
        if (size <= 1).all():
            break
        mult = size > 1
        mid = lo + size // 2
        m = np.clip(mid, 0, nt - 1)
        # lt(targets[mid], read): target orders before read (name,start,end)
        t_key_lt = (
            (target_rank[m] < read_contig_rank)
            | ((target_rank[m] == read_contig_rank) & (target_start[m] < read_start))
            | ((target_rank[m] == read_contig_rank) & (target_start[m] == read_start)
               & (target_end[m] < read_end))
        ) & mapped_mask
        hi = np.where(mult & t_key_lt, mid, hi)
        lo = np.where(mult & ~t_key_lt, mid, lo)
    t = np.clip(lo, 0, nt - 1)
    contains = (
        mapped_mask
        & (target_rank[t] == read_contig_rank)
        & (target_end[t] > read_start)
        & (read_end > target_start[t])
    )
    # Scala's `/` truncates toward zero, so the reference's unmapped
    # (start = -1) sentinel is -1 - 0 = -1; Python's floor division
    # would give -1 - (-1) = 0, a *valid* target index
    empty = np.where(
        read_start >= 0, -1 - read_start // 3000, -1
    ).astype(np.int64)
    return np.where(contains, t, empty)


def map_reads_to_targets_overlap(
    read_contig_rank, read_start, read_end, mapped_mask,
    target_rank, target_start, target_end,
) -> np.ndarray:
    """Interval mapping: each read goes to the *first target whose read
    range it overlaps* (GATK's IntervalListReferenceOrderedData walk;
    the default ``mode="overlap"``).  The reference's set-halving search
    (:func:`map_reads_to_targets`, RealignIndels.scala:72-94) keeps the
    head half when the probe orders before the read, so with more than
    one target most overlapping reads fall out of realignment; its own
    suite exercises only single-target sets.  This mode restores the
    stated semantics; ``mode="faithful"`` keeps the reference's, quirks
    included.

    Vectorized: targets sorted by (rank, start); with a composite
    coordinate and a running max of target ends, the first overlapping
    target is one searchsorted (cummax is monotone) + one bounds check.
    """
    nt = len(target_start)
    n = len(read_start)
    if nt == 0:
        return np.where(
            read_start >= 0, -1 - read_start // 3000, -1
        ).astype(np.int64)
    BIG = np.int64(1) << 40
    t_s = target_rank * BIG + target_start
    t_e = target_rank * BIG + target_end
    order = np.argsort(t_s, kind="stable")
    t_s, t_e = t_s[order], t_e[order]
    cummax_e = np.maximum.accumulate(t_e)
    r_s = read_contig_rank * BIG + read_start
    r_e = read_contig_rank * BIG + read_end
    j = np.searchsorted(cummax_e, r_s, side="right")
    jc = np.clip(j, 0, nt - 1)
    contains = (
        mapped_mask & (j < nt) & (t_s[jc] < r_e) & (t_e[jc] > r_s)
    )
    # Scala's `/` truncates toward zero, so the reference's unmapped
    # (start = -1) sentinel is -1 - 0 = -1; Python's floor division
    # would give -1 - (-1) = 0, a *valid* target index
    empty = np.where(
        read_start >= 0, -1 - read_start // 3000, -1
    ).astype(np.int64)
    return np.where(contains, order[jc], empty)


TARGET_MAPPINGS = ("overlap", "faithful")


def map_batch_to_targets(b, targets, names, mode: str = "overlap") -> np.ndarray:
    """Target index per row of a batch (-k spreading for unmatched rows).
    The candidate filter of the streamed path: rows with tidx >= 0 are
    gathered for realignment, everything else passes through untouched.

    ``mode="overlap"`` (default) maps every read to the first target it
    overlaps (:func:`map_reads_to_targets_overlap`); ``mode="faithful"``
    replicates the reference's set-halving search bit for bit
    (:func:`map_reads_to_targets`)."""
    if mode not in TARGET_MAPPINGS:
        raise ValueError(f"target mapping {mode!r}: one of {TARGET_MAPPINGS}")
    if not targets:
        return np.full(b.n_rows, -1, dtype=np.int64)
    rank_of_name = {nm: i for i, nm in enumerate(sorted(names))}
    contig_rank = np.array([rank_of_name[nm] for nm in names], dtype=np.int64)
    t_rank = np.array(
        [contig_rank[t.contig_idx] for t in targets], dtype=np.int64
    )
    t_start = np.array([t.range_start for t in targets], dtype=np.int64)
    t_end = np.array([t.range_end for t in targets], dtype=np.int64)
    flags = np.asarray(b.flags)
    mapped = ((flags & schema.FLAG_UNMAPPED) == 0) & np.asarray(b.valid)
    read_rank = np.where(
        mapped,
        contig_rank[np.clip(np.asarray(b.contig_idx), 0, len(names) - 1)],
        -1,
    )
    fn = map_reads_to_targets_overlap if mode == "overlap" else map_reads_to_targets
    return fn(
        read_rank, np.asarray(b.start).astype(np.int64),
        np.asarray(b.end).astype(np.int64), mapped, t_rank, t_start, t_end,
    )


# --------------------------------------------------------------------------
# Batched sweep (device)
# --------------------------------------------------------------------------
def _pow2(n: int, minimum: int) -> int:
    return max(minimum, 1 << (max(int(n), 1) - 1).bit_length())


@contextlib.contextmanager
def _highest_matmul_precision():
    """Full f32 for the sweep's products (no TF32), restored after."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def sweep_gemm(read_codes, read_quals, read_len, read_mask, cons, cons_len,
               off: int, rt: int, lr: int):
    """The sweep as batched f32 matmuls over (target, consensus) pairs:
    ``[P, rt, lr*6] x [P, lr*6, off]`` (the JAX package's
    ``sweep_gemm_kernel``).

    Pair slot ``p`` sweeps reads ``read_codes[p*rt:(p+1)*rt]`` (u8
    ``[P*rt, lr]``, quals u8 alike, lengths ``[P*rt]``, ``read_mask``
    False on padded slots) against ``cons[p]`` (u8 ``[P, lc]``, lc >=
    off + lr, true length ``cons_len[p]``, 0 for padded pairs) at offsets
    ``o < min(off, cons_len - read_len)``.  Returns (best_q f32[P, rt],
    best_o i32[P, rt]): the least mismatch quality and the smallest
    offset attaining it; inf / -1 where no offset is valid."""
    P = cons.shape[0]
    dev = cons.device
    codes = torch.arange(6, device=dev)
    rc = read_codes.reshape(P, rt, lr).to(torch.int64)
    rl = read_len.reshape(P, rt).to(torch.int64)
    pos = torch.arange(lr, device=dev)
    qf = torch.where(
        (pos[None, None, :] < rl[..., None]) & read_mask.reshape(P, rt)[..., None],
        read_quals.reshape(P, rt, lr).to(torch.int32), 0,
    )
    A = ((rc[..., None] == codes).to(torch.float32)
         * qf[..., None].to(torch.float32)).reshape(P, rt, lr * 6)
    oh = (cons.to(torch.int64)[..., None] == codes).to(torch.float32)  # [P, lc, 6]
    # B[p, i*6 + c, o] = oh[p, o + i, c]
    B = oh.unfold(1, lr, 1)[:, :off].permute(0, 3, 2, 1).reshape(P, lr * 6, off)
    with _highest_matmul_precision():
        match = torch.bmm(A, B)
    total_q = qf.sum(-1, dtype=torch.int64)[..., None].to(torch.float32)
    mismatch = total_q - match
    valid = (
        torch.arange(off, device=dev)[None, None, :]
        < (cons_len.to(torch.int64)[:, None] - rl)[..., None]
    )
    inf = torch.full((), float("inf"), device=dev)
    masked = torch.where(valid, mismatch, inf)
    best_o = torch.argmin(masked, -1).to(torch.int32)
    best_q = masked.amin(-1)
    has = valid.any(-1)
    return torch.where(has, best_q, inf), torch.where(has, best_o, -1)


def sweep_kernel(read_codes, read_quals, read_len, cons_codes, cons_len,
                 lr: int, lc: int, chunk: int = 256):
    """Per-task sweep (the JAX package's ``sweep_kernel``): read b against
    its own consensus ``cons_codes[b]`` at offsets ``o < cons_len -
    read_len`` (among the lc - lr + 1 a ``[lc]`` row holds) -> (best_q
    f32[B], best_o i32[B]); the same values as :func:`sweep_gemm`, which
    computes them (one pair per task, ``chunk`` tasks per product)."""
    B = read_codes.shape[0]
    off = lc - lr + 1
    qs, os_ = [], []
    for s in range(0, B, chunk):
        e = min(B, s + chunk)
        q, o = sweep_gemm(
            read_codes[s:e], read_quals[s:e], read_len[s:e],
            torch.ones(e - s, dtype=torch.bool, device=read_codes.device),
            cons_codes[s:e], cons_len[s:e], off, 1, lr,
        )
        qs.append(q[:, 0])
        os_.append(o[:, 0])
    return torch.cat(qs), torch.cat(os_)


def sweep_kernel_gather(read_codes, read_quals, read_len, cons_tbl,
                        clen_tbl, cons_idx, lr: int, lc: int):
    """:func:`sweep_kernel` over a deduplicated consensus table."""
    return sweep_kernel(read_codes, read_quals, read_len, cons_tbl[cons_idx],
                        clen_tbl[cons_idx], lr, lc)


# pair-batch size per (off, rt) tier: bounds the im2col temporary
# [P, lr, off, 6] bf16 while keeping ~4k tasks per dispatch
def _sweep_gemm_P(off: int, rt: int) -> int:
    base = max(8, (1 << 17) // off)  # 256 at off=512, halving upward
    return max(2, base // (rt // 16)) if rt > 16 else base


def _sweep_tiles(bases, quals, lengths, tiles, cons_mat, cons_lens, device,
                 phase=None, overlap=None, sweep_devices=None):
    """Sweep pair tiles -> one (best_q f32[n], best_o i32[n]) per tile.

    ``tiles`` is a list of (batch rows, consensus id): each tile sweeps
    at most 128 reads of one target (rows of the host ``bases``/``quals``
    matrices) against one consensus (a row of ``cons_mat`` with true
    length ``cons_lens[id]``).  Tiles group into the JAX package's
    ``(off, rt)`` tiers (rt = 16 or 128 read slots, off = the padded
    offset count the tile needs) and each tier runs as
    :func:`sweep_gemm` products of at most ``_sweep_gemm_P(off, rt)``
    pairs.  Every read's result depends only on its own tile, so tiers
    and chunks change nothing but the padding.  Every chunk is dispatched
    before any is fetched; ``phase(label)``, when given, is called once
    the dispatches are queued (the JAX package's sweep-dispatch timer),
    then ``overlap(in_dispatch)`` runs the caller's host work under the
    queued sweeps, timed as "Realign: overlapped host work".  With
    ``sweep_devices`` (two or more pool slots) each chunk goes to the next
    slot of a :class:`~adam_tpu_torch.parallel.device_pool.SweepSchedule`
    and each slot's results come home in one fetch per output."""
    from adam_tpu_torch.parallel.device_pool import SweepSchedule, as_slot, putter
    from adam_tpu_torch.utils.transfer import device_fetch
    if not tiles:
        return []
    sched = (SweepSchedule(sweep_devices)
             if sweep_devices is not None and len(sweep_devices) > 1 else None)
    solo = as_slot(device)
    lengths = np.asarray(lengths).astype(np.int64)
    L = bases.shape[1]
    lr = _pow2(max(int(lengths.max()), 1), 32)
    cols = min(L, lr)
    p_n = np.array([len(rows) for rows, _ in tiles], np.int64)
    p_cid = np.array([cid for _, cid in tiles], np.int64)
    need = np.array(
        [int(cons_lens[cid]) - int(lengths[rows].min()) for rows, cid in tiles],
        np.int64,
    )
    p_rt = np.where(p_n <= 16, 16, 128)
    p_offb = _pow2_vec(np.maximum(need, 1), 512)
    # intermediate 384 tier: WGS-shaped targets need 250-330 offsets
    p_offb = np.where((p_offb == 512) & (need <= 384), 384, p_offb)
    out: list = [None] * len(tiles)
    pending = []  # (pair indices, slot, lazy (best_q, best_o) on the slot)
    key = p_offb * 1024 + p_rt
    border = np.argsort(key, kind="stable")
    ukeys, ustarts = np.unique(key[border], return_index=True)
    ustarts = np.append(ustarts, len(border))
    for u in range(len(ukeys)):
        seg = border[ustarts[u]:ustarts[u + 1]]
        off = int(ukeys[u] // 1024)
        rt = int(ukeys[u] % 1024)
        lc = off + lr
        P_max = _sweep_gemm_P(off, rt)
        for s in range(0, len(seg), P_max):
            part = seg[s:s + P_max]
            P = len(part)
            rc = np.full((P * rt, lr), schema.BASE_PAD, np.uint8)
            rq = np.zeros((P * rt, lr), np.uint8)
            rl = np.zeros(P * rt, np.int32)
            pm = np.zeros(P * rt, bool)
            ct = np.full((P, lc), schema.BASE_PAD, np.uint8)
            cl = np.zeros(P, np.int32)
            for j, pi in enumerate(part):
                rows_t, cid = tiles[pi]
                nrt = len(rows_t)
                rc[j * rt: j * rt + nrt, :cols] = bases[rows_t, :cols]
                rq[j * rt: j * rt + nrt, :cols] = quals[rows_t, :cols]
                rl[j * rt: j * rt + nrt] = lengths[rows_t]
                pm[j * rt: j * rt + nrt] = True
                cc = min(int(cons_lens[cid]), lc)
                ct[j, :cc] = cons_mat[cid, :cc]
                cl[j] = cons_lens[cid]
            slot = sched.next_device() if sched is not None else solo
            put = putter(slot)
            args = [put(a) for a in (rc, rq, rl, pm, ct, cl)]
            with slot.scope():
                pending.append((part, slot, sweep_gemm(*args, off, rt, lr)))
    if phase is not None:
        phase("Realign: sweep dispatch (host assembly)")
    if overlap is not None:
        overlap(bool(pending))
        if phase is not None:
            phase("Realign: overlapped host work")
    # one fetch per slot and output: each slot's chunks concatenated there
    by_slot: dict = {}
    for k, (_part, slot, _out) in enumerate(pending):
        by_slot.setdefault(id(slot), (slot, []))[1].append(k)
    fetched: dict = {}
    for slot, idxs in by_slot.values():
        with slot.scope():
            cat_q = torch.cat([pending[k][2][0].reshape(-1) for k in idxs])
            cat_o = torch.cat([pending[k][2][1].reshape(-1) for k in idxs])
        gq, go = device_fetch(cat_q, slot), device_fetch(cat_o, slot)
        pos = 0
        for k in idxs:
            pc, rtc = pending[k][2][0].shape
            fetched[k] = (gq[pos:pos + pc * rtc].reshape(pc, rtc),
                          go[pos:pos + pc * rtc].reshape(pc, rtc))
            pos += pc * rtc
    for k, (part, _slot, _out) in enumerate(pending):
        q, o = fetched[k]
        for j, pi in enumerate(part):
            nrt = int(p_n[pi])
            out[pi] = (q[j, :nrt], o[j, :nrt])
    return out


def _encode_consensuses(cons_strs: list) -> tuple[np.ndarray, np.ndarray]:
    """Spliced consensus strings -> (u8 code matrix, i64 lengths)."""
    cons_lens = np.array([len(s) for s in cons_strs], np.int64)
    max_cl = int(cons_lens.max()) if len(cons_strs) else 1
    cons_mat = np.full((len(cons_strs), max(max_cl, 1)), schema.BASE_PAD, np.uint8)
    for k, s in enumerate(cons_strs):
        cons_mat[k, : len(s)] = schema.encode_bases(s)
    return cons_mat, cons_lens


def _writable(b) -> ReadBatch:
    """Writable host copies of every column of a batch."""
    return ReadBatch(**{k: np.array(v) for k, v in b.to_numpy().arrays().items()})


def _group_candidates(b, tidx, mapped):
    """Candidate rows grouped by target, position-sorted within a group
    (the reference sorts the RDD before target mapping).

    Returns ``(srows, goff, gtid)``: flat row indices, group offsets
    (``goff[g]:goff[g+1]`` slices ``srows``), and the target id per
    group.  Shared by the Python and native paths — group iteration
    order drives the rng.sample call sequence, so both paths MUST use
    this exact construction for bit-identical output."""
    sel = np.flatnonzero(mapped & (tidx >= 0))
    if not len(sel):
        z = np.zeros(0, np.int64)
        return z, np.zeros(1, np.int64), z
    order = np.lexsort(
        (sel, np.asarray(b.start)[sel].astype(np.int64), tidx[sel])
    )
    srows = sel[order]
    stid = tidx[srows]
    bounds = np.flatnonzero(np.diff(stid) != 0) + 1
    goff = np.concatenate(
        [np.zeros(1, np.int64), bounds.astype(np.int64),
         np.array([len(srows)], np.int64)]
    )
    gtid = stid[goff[:-1]].astype(np.int64)
    return srows, goff, gtid


def _sum_mismatch_quality(seq: str, ref: str, quals) -> int:
    """sumMismatchQualityIgnoreCigar: positional zip, truncating to the
    shorter string (RealignIndels.scala:429-440) — vectorized byte
    compare instead of a per-char generator."""
    n = min(len(seq), len(ref), len(quals))
    if n == 0:
        return 0
    a = np.frombuffer(seq.encode("ascii"), np.uint8, n)
    b = np.frombuffer(ref.encode("ascii"), np.uint8, n)
    q = np.asarray(quals[:n], np.int64)
    return int(q[a != b].sum())


# --------------------------------------------------------------------------
# Per-target realignment (host orchestration)
# --------------------------------------------------------------------------
@dataclass
class _Read:
    """Host view of one read under realignment.

    ``md`` is parsed lazily — only reads whose CIGAR is not a single M
    run need it (left-alignment, reference slices through indels); for
    the pure-M majority the precomputed ``ref`` string (from the
    vectorized MD tokenizer) and per-row mismatch-qual sums replace all
    per-read MD work.  ``dirty`` marks reads whose alignment changed in
    preprocessing (left-align / SW), which must be written back even
    when the consensus pass leaves them alone.
    """

    row: int
    seq: str
    quals: np.ndarray
    start: int
    cigar: list  # [(len, op)]
    md: Optional[MdTag]
    mapq: int
    ref: Optional[str] = None  # implied reference over the aligned span
    pure: bool = False  # single-M CIGAR
    dirty: bool = False
    codes: Optional[np.ndarray] = None  # base codes (sweep input, cached)

    @property
    def end(self) -> int:
        return self.start + cigar_ref_len(self.cigar)


def _get_reference_from_reads(reads: list[_Read], extra_refs=()):
    """RealignIndels.getReferenceFromReads (:185-215).

    ``extra_refs`` carries (ref, start, end) tuples for reads that exist
    only as columnar rows (the pure clean majority never materialized as
    ``_Read`` objects); they splice into the window exactly as reads do.
    """
    refs = list(extra_refs)
    for r in reads:
        ref = r.ref
        if ref is None and r.md is not None:  # directly-built _Reads
            ref = r.md.get_reference(r.seq, cigar_to_string(r.cigar))
        if ref is not None:
            refs.append((ref, r.start, r.end))
    if not refs:
        raise ValueError("no reads with MD tags in target group")
    refs.sort(key=lambda x: x[1])
    ref, cur = "", refs[0][1]
    ref_start = refs[0][1]
    for s, start, end in refs:
        if end < cur:
            continue
        if cur >= start:
            ref += s[cur - start :]
            cur = end
        else:
            raise ValueError(f"gap at {cur} with {start},{end} rebuilding reference")
    return ref, ref_start, cur


@dataclass(frozen=True)
class Consensus:
    """models/Consensus.scala: an alternate allele to splice into the
    reference — insertion when index spans 1bp."""

    consensus: str
    contig_idx: int
    index_start: int
    index_end: int

    def insert_into_reference(self, reference: str, ref_start: int, ref_end: int) -> str:
        if (self.index_start < ref_start or self.index_start > ref_end
                or self.index_end - 1 < ref_start or self.index_end - 1 > ref_end):
            raise ValueError("consensus and reference do not overlap")
        return (
            reference[: self.index_start - ref_start]
            + self.consensus
            + reference[self.index_end - 1 - ref_start :]
        )


def generate_alternate_consensus(seq: str, start: int, contig_idx: int,
                                 cigar: list) -> Optional[Consensus]:
    """Consensus.generateAlternateConsensus (:25-52)."""
    read_pos = 0
    ref_pos = start
    if sum(1 for _, op in cigar if op in "ID") != 1:
        return None
    for n, op in cigar:
        if op == "I":
            return Consensus(seq[read_pos : read_pos + n], contig_idx,
                             ref_pos, ref_pos + 1)
        if op == "D":
            return Consensus("", contig_idx, ref_pos, ref_pos + n + 1)
        if op in "M=X":
            read_pos += n
            ref_pos += n
        else:
            return None
    return None


def realign_indels(
    ds: AlignmentDataset,
    consensus_model: str = "reads",
    known_indels=None,
    max_indel_size: int = MAX_INDEL_SIZE,
    max_consensus_number: int = MAX_CONSENSUS_NUMBER,
    lod_threshold: float = LOD_THRESHOLD,
    max_target_size: int = MAX_TARGET_SIZE,
    sw_weights: tuple = (1.0, -0.333, -0.5, -0.5),
    rng: Optional[random.Random] = None,
    target_mapping: str = "overlap",
    device: str = "cuda",
    overlap_work=None,
    sweep_devices=None,
) -> AlignmentDataset:
    """GATK-style local realignment (RealignIndels.realignTargetGroup).

    The ``reads`` and ``knowns`` consensus models run the native-prep
    path (C++ per-read string walks + the tiled sweep); under ``knowns``
    with a ``known_indels`` table (``models.snp_table.IndelTable``) each
    target's consensuses are the table's indels that overlap it, and
    without a table they come from the reads.  The ``smithwaterman``
    model runs the Python path, whose preprocessing
    Smith-Waterman-aligns every read to its target's reference.  The
    sweeps and the Smith-Waterman fill run on ``device`` (default: the
    card).  ``target_mapping`` is :func:`map_batch_to_targets`' mode:
    ``"overlap"`` (default) or the reference's ``"faithful"`` search.

    ``overlap_work``: a zero-argument callable run once, after the sweeps
    are dispatched and before their results are fetched (the streamed
    run's observe pass hides there); whether it really ran under queued
    sweeps is set on it as ``overlap_ran_in_dispatch`` (on the
    ``smithwaterman`` path and the early outs it runs alone).
    ``sweep_devices``: pool slots to fan the sweep chunks over (the
    streamed run's pool or mesh slots); the output is the same."""
    if overlap_work is not None:
        orig_overlap = overlap_work
        state = {"done": False}

        def overlap_work(in_dispatch: bool = False):
            if not state["done"]:
                state["done"] = True
                orig_overlap.overlap_ran_in_dispatch = bool(in_dispatch)
                orig_overlap()

    if target_mapping not in TARGET_MAPPINGS:
        raise ValueError(f"target mapping {target_mapping!r}: one of {TARGET_MAPPINGS}")
    if consensus_model not in CONSENSUS_MODELS:
        raise ValueError(f"consensus_model {consensus_model!r}: one of {CONSENSUS_MODELS}")
    dev = resolve_device(device)
    if consensus_model == "smithwaterman":
        if overlap_work is not None:
            overlap_work()  # no queued sweeps to hide it under on this path
        return _realign_indels_py(
            ds, consensus_model, known_indels, max_indel_size,
            max_consensus_number, lod_threshold, max_target_size, sw_weights,
            rng, target_mapping, device=dev, sweep_devices=sweep_devices,
        )
    out = _realign_indels_native(
        ds, consensus_model, known_indels, max_indel_size,
        max_consensus_number, lod_threshold, max_target_size, rng, target_mapping,
        device=dev, overlap_work=overlap_work, sweep_devices=sweep_devices,
    )
    if overlap_work is not None:
        overlap_work()  # a no-op unless an early out returned before it ran
    return out


def _known_consensuses(known_indels, name: str, ref_start: int, ref_end: int) -> list:
    """The known indels overlapping a target's reference span, in table
    order -> [(consensus, index_start, index_end)]."""
    region = ReferenceRegion(name, ref_start, ref_end)
    return [(rec.consensus, rec.region.start, rec.region.end)
            for rec in known_indels.get_indels_in_region(region)]


def _score_consensuses(q: np.ndarray, orig: np.ndarray):
    """One target's consensus decision, shared by both paths: per cell
    min(sweep, orig) (the sweep value truncated to int, as the reference's
    Int sum does), column totals, best = min with the LATER consensus
    winning ties (list-prepend + left fold).  ``q`` is the ``[reads,
    consensuses]`` sweep quality, ``orig`` the reads' i64 mismatch-quality
    sums.  Returns (use, best_ci, best_total, pre_total, lod)."""
    pre_total = int(orig.sum())
    use = q < orig[:, None]
    qi = np.zeros_like(q, dtype=np.int64)
    qi[use] = q[use].astype(np.int64)
    totals = np.where(use, qi, orig[:, None]).sum(axis=0)
    best_ci = int(q.shape[1] - 1 - np.argmin(totals[::-1]))
    best_total = int(totals[best_ci])
    return use, best_ci, best_total, pre_total, (pre_total - best_total) / 10.0


def _realign_indels_py(
    ds: AlignmentDataset,
    consensus_model: str = "reads",
    known_indels=None,
    max_indel_size: int = MAX_INDEL_SIZE,
    max_consensus_number: int = MAX_CONSENSUS_NUMBER,
    lod_threshold: float = LOD_THRESHOLD,
    max_target_size: int = MAX_TARGET_SIZE,
    sw_weights: tuple = (1.0, -0.333, -0.5, -0.5),
    rng: Optional[random.Random] = None,
    target_mapping: str = "overlap",
    *,
    device: torch.device,
    sweep_devices=None,
) -> AlignmentDataset:
    """The Python realignment path (the JAX package's
    ``_realign_indels_py``), in three phases: (1) per target, rebuild the
    reference and gather the reads to clean — then, under the
    ``smithwaterman`` model, Smith-Waterman-align all of them in one
    batched pass — then, per target in order, preprocess, left-normalize
    and draw the consensuses (the rng sees the JAX package's call
    sequence); (2) sweep every read over every consensus; (3) score and
    rewrite each target."""
    b = ds.batch.to_numpy()
    n = b.n_rows
    if n == 0:
        return ds
    targets = find_targets(ds, max_target_size, max_indel_size)
    if not targets:
        return ds
    names = ds.seq_dict.names
    flags = np.asarray(b.flags)
    mapped = ((flags & schema.FLAG_UNMAPPED) == 0) & np.asarray(b.valid)
    tidx = map_batch_to_targets(b, targets, names, mode=target_mapping)

    # group rows by target, position-sorted within the group — the shared
    # vectorized construction (see _group_candidates for why shared)
    srows, goff, gtid = _group_candidates(b, tidx, mapped)
    groups: dict[int, list[int]] = {
        int(gtid[g]): [int(i) for i in srows[goff[g]:goff[g + 1]]]
        for g in range(len(gtid))
    }

    new_batch = _writable(b)
    side = ds.sidecar

    # vectorized per-row MD columns: mismatch mask -> to_clean membership
    # + positional orig-qual sums; ref codes -> implied reference for
    # every single-M read
    is_mm, ref_codes, has_md_vec = batch_md_arrays(b, side, need_ref_codes=True)
    row_has_mm = is_mm.any(axis=1)
    mm_qual = np.where(is_mm, np.asarray(b.quals), 0).sum(axis=1)
    # sparse overrides: only realigned rows get new MD/attrs
    new_md: dict[int, Optional[str]] = {}
    new_attrs: dict[int, str] = {}
    rng = rng or random.Random(0)

    all_rows = (np.concatenate([np.asarray(r) for r in groups.values()])
                if groups else np.zeros(0, np.int64))
    seq_of: dict[int, str] = {}
    ref_of: dict[int, str] = {}
    if len(all_rows):
        purev = (
            (np.asarray(b.cigar_n)[all_rows] == 1)
            & (np.asarray(b.cigar_ops)[all_rows, 0] == schema.CIGAR_M)
            & has_md_vec[all_rows]
        )
        prows = all_rows[purev]
        if len(prows):
            ref_of = dict(zip(
                (int(i) for i in prows),
                schema.decode_bases_bulk(ref_codes[prows], np.asarray(b.lengths)[prows]),
            ))
        # sequences are only needed for rows that materialize a _Read
        heavy = all_rows[~(purev & ~row_has_mm[all_rows])]
        if len(heavy):
            seq_of = dict(zip(
                (int(i) for i in heavy),
                schema.decode_bases_bulk(np.asarray(b.bases)[heavy],
                                         np.asarray(b.lengths)[heavy]),
            ))
    _CC = schema.CIGAR_CHARS

    # ---- phase 1a: per target, the reads to clean and the reference ----
    prepared = []  # (t, to_clean, reference, ref_start, ref_end)
    for t, rows in groups.items():
        reads = []
        extra_refs = []
        for i in rows:
            if i in ref_of and not row_has_mm[i]:
                # pure clean majority: never swept, never rewritten —
                # contributes only its reference slice to the rebuild
                s0 = int(b.start[i])
                extra_refs.append((ref_of[i], s0, s0 + int(b.lengths[i])))
                continue
            L = int(b.lengths[i])
            seq = seq_of[i]
            nc = int(b.cigar_n[i])
            cig = [(int(b.cigar_lens[i, k]), _CC[b.cigar_ops[i, k]]) for k in range(nc)]
            pure = nc == 1 and b.cigar_ops[i, 0] == schema.CIGAR_M
            has_md_i = bool(has_md_vec[i])
            md = None if (pure or not has_md_i) else MdTag.parse(side.md[i], int(b.start[i]))
            if not has_md_i:
                ref = None
            elif pure:
                ref = ref_of[i]
            else:
                ref = md.get_reference(seq, cig)
            reads.append(_Read(
                row=i, seq=seq, quals=np.asarray(b.quals[i][:L], np.int32),
                start=int(b.start[i]), cigar=cig, md=md, mapq=int(b.mapq[i]),
                ref=ref, pure=pure, codes=np.asarray(b.bases[i][:L]),
            ))
        # reads that already match the reference pass through untouched
        to_clean = [r for r in reads if not has_md_vec[r.row] or row_has_mm[r.row]]
        if not to_clean:
            continue
        try:
            reference, ref_start, ref_end = _get_reference_from_reads(reads, extra_refs)
        except ValueError:
            continue
        prepared.append((t, to_clean, reference, ref_start, ref_end))
    del seq_of, ref_of

    # ---- phase 1b: Smith-Waterman over every read of every target -----
    sw_alns = [None] * len(prepared)
    if consensus_model == "smithwaterman" and prepared:
        pairs = []
        for _t, to_clean, reference, _s, _e in prepared:
            ref_codes_t = schema.encode_bases(reference)
            pairs.extend((schema.encode_bases(r.seq), ref_codes_t) for r in to_clean)
        alns = smith_waterman_many(pairs, *sw_weights, device=device,
                                   sweep_devices=sweep_devices)
        k = 0
        for g, (_t, to_clean, _r, _s, _e) in enumerate(prepared):
            sw_alns[g] = alns[k:k + len(to_clean)]
            k += len(to_clean)

    # ---- phase 1c: per target in order — preprocess + consensuses ------
    group_ctx = {}
    tiles = []       # (batch rows, consensus id)
    tile_dst = []    # (target, consensus index, first read index)
    cons_strs = []
    for (t, to_clean, reference, ref_start, ref_end), alns_t in zip(prepared, sw_alns):
        contig_idx = targets[t].contig_idx
        if alns_t is not None:
            to_clean = _sw_preprocess(to_clean, reference, ref_start, alns_t)
        processed = []
        for r in to_clean:
            if cigar_num_alignment_blocks(r.cigar) == 2:
                new_cigar = left_align_indel(r.seq, r.cigar, r.md)
                if new_cigar != r.cigar:
                    md = MdTag.move_alignment(
                        r.ref, r.seq, cigar_to_string(new_cigar), r.start,
                    ) if r.md is not None else None
                    processed.append(dc_replace(r, cigar=new_cigar, md=md, dirty=True))
                else:
                    processed.append(r)
            else:
                processed.append(r)
        to_clean = processed

        consensuses: list[Consensus] = []
        if consensus_model == "knowns" and known_indels is not None:
            for cs, cis, cie in _known_consensuses(
                known_indels, names[contig_idx], ref_start, ref_end
            ):
                consensuses.append(Consensus(cs, contig_idx, cis, cie))
        else:
            for r in to_clean:
                if r.md is None:
                    continue
                c = generate_alternate_consensus(r.seq, r.start, contig_idx, r.cigar)
                if c is not None:
                    consensuses.append(c)
        seen = set()
        uniq = []
        for c in consensuses:
            key = (c.consensus, c.index_start, c.index_end)
            if key not in seen:
                seen.add(key)
                uniq.append(c)
        consensuses = uniq
        if len(consensuses) > max_consensus_number:
            consensuses = rng.sample(consensuses, max_consensus_number)
        if not consensuses:
            # still keep preprocessing results (readsToClean ++ realigned)
            _write_back(new_batch, side, new_md, new_attrs, to_clean, realigned={})
            continue
        group_ctx[t] = (
            to_clean, consensuses, reference, ref_start, ref_end,
            np.full((len(to_clean), len(consensuses)), np.inf, np.float32),
            np.full((len(to_clean), len(consensuses)), -1, np.int32),
        )
        rows_t = np.array([r.row for r in to_clean], np.int64)
        for ci, c in enumerate(consensuses):
            cid = len(cons_strs)
            cons_strs.append(c.insert_into_reference(reference, ref_start, ref_end))
            for lo in range(0, len(to_clean), 128):
                tiles.append((rows_t[lo:lo + 128], cid))
                tile_dst.append((t, ci, lo))

    # ---- phase 2: the sweeps -------------------------------------------
    cons_mat, cons_lens = _encode_consensuses(cons_strs)
    swept = _sweep_tiles(np.asarray(b.bases), np.asarray(b.quals), b.lengths,
                         tiles, cons_mat, cons_lens, device,
                         sweep_devices=sweep_devices)
    for (t, ci, lo), (q, o) in zip(tile_dst, swept):
        res_q, res_o = group_ctx[t][5], group_ctx[t][6]
        res_q[lo:lo + len(q), ci] = q
        res_o[lo:lo + len(o), ci] = o

    # ---- phase 3: score each target and rewrite ------------------------
    for t, (to_clean, consensuses, reference, ref_start, ref_end, q, o) in group_ctx.items():

        def _orig_qual(r):
            if r.dirty and r.md is not None:
                return _sum_mismatch_quality(
                    r.seq, r.md.get_reference(r.seq, cigar_to_string(r.cigar)), r.quals,
                )
            if r.pure:  # positional mismatch-qual sum, precomputed
                return int(mm_qual[r.row])
            return _sum_mismatch_quality(r.seq, r.ref or "", r.quals)

        orig = np.asarray([_orig_qual(r) for r in to_clean], np.int64)
        use, best_ci, best_total, pre_total, lod = _score_consensuses(q, orig)
        best_map = np.where(use[:, best_ci], o[:, best_ci], -1)
        logging.getLogger(__name__).debug(
            "On target %d [%d, %d), before realignment, sum was %d; "
            "best consensus %d has sum %d (LOD %.2f)",
            t, ref_start, ref_start + len(reference), pre_total,
            best_ci, best_total, lod,
        )
        realigned = {}
        if lod > lod_threshold:
            cons = consensuses[best_ci]
            for ri, r in enumerate(to_clean):
                off = best_map[ri]
                if off == -1:
                    continue
                new_start = ref_start + off
                if cons.index_start == cons.index_end - 1:  # insertion
                    id_elem = (len(cons.consensus), "I")
                    end_len = len(r.seq) - len(cons.consensus) - (cons.index_start - new_start)
                    end_penalty = -len(cons.consensus)
                else:  # deletion
                    id_elem = (cons.index_end - 1 - cons.index_start, "D")
                    end_len = len(r.seq) - (cons.index_start - new_start)
                    end_penalty = len(cons.consensus)
                head_len = cons.index_start - new_start
                if head_len > 0 and end_len > 0:
                    new_cigar = [(head_len, "M"), id_elem, (end_len, "M")]
                    new_end = new_start + len(r.seq) + end_penalty
                else:
                    # the swept position doesn't span the consensus indel:
                    # a plain gapless alignment at the new offset (the
                    # reference emits a negative-length M here)
                    new_cigar = [(len(r.seq), "M")]
                    new_end = new_start + len(r.seq)
                # an offset near the region edge can consume more reference
                # than the rebuilt window holds: leave the read unrealigned
                if off + (new_end - new_start) > len(reference):
                    continue
                md = MdTag.move_alignment(
                    reference[off:], r.seq, cigar_to_string(new_cigar), new_start
                )
                realigned[ri] = dc_replace(
                    r, start=new_start, cigar=new_cigar, md=md, mapq=r.mapq + 10
                ), new_end
        _write_back(new_batch, side, new_md, new_attrs, to_clean, realigned)

    new_side = dc_replace(
        side,
        md=with_overrides(StringColumn.of(side.md), new_md),
        attrs=with_overrides(StringColumn.of(side.attrs), new_attrs),
    )
    return ds.with_batch(new_batch, new_side)


def _sw_preprocess(reads, reference, ref_start, alignments):
    """ConsensusGeneratorFromSmithWaterman.preprocessReadsForRealignment:
    given each read's Smith-Waterman alignment against the region, accept
    it when it has <= 2 alignment blocks, rewriting start/cigar/MD (start
    from the reference's own xStart+regionStart rule).

    Unlike the JAX package, a rewritten read's implied reference ``ref``
    is refreshed from its new MD (see the module docstring): the
    left-normalization that follows walks the new CIGAR over it."""
    out = []
    for r, aln in zip(reads, alignments):
        cigar = parse_cigar(aln.cigar_x)
        if cigar_num_alignment_blocks(cigar) <= 2:
            md = MdTag.from_alignment(r.seq, reference[aln.x_start:], aln.cigar_x, ref_start)
            out.append(dc_replace(
                r, start=aln.x_start + ref_start, cigar=cigar, md=md, dirty=True,
                ref=md.get_reference(r.seq, cigar),
            ))
        else:
            out.append(r)
    return out


def _write_back(new_batch, side, new_md, new_attrs, to_clean, realigned):
    """Apply (possibly realigned) host reads back into the batch.

    MD/attr updates land in the sparse ``new_md``/``new_attrs`` override
    dicts (row -> str), merged into the sidecar columns in one pass at
    the end of realign_indels."""
    cmax = new_batch.cmax
    for ri, r in enumerate(to_clean):
        if ri in realigned:
            rr, new_end = realigned[ri]
            old_start = int(new_batch.start[rr.row])
            old_cigar = schema.decode_cigar(
                new_batch.cigar_ops[rr.row], new_batch.cigar_lens[rr.row],
                int(new_batch.cigar_n[rr.row]),
            )
            tag = f"OC:Z:{old_cigar}\tOP:i:{old_start + 1}"
            cur = new_attrs.get(rr.row, side.attrs[rr.row]) or ""
            new_attrs[rr.row] = cur + "\t" + tag if cur else tag
        elif not r.dirty:
            continue  # alignment untouched: nothing to write
        else:
            rr, new_end = r, None
        cig = cigar_to_string(rr.cigar)
        ops, lens, ncig = schema.encode_cigar(cig, max(cmax, len(rr.cigar)))
        if ncig > cmax:
            raise ValueError("realigned cigar exceeds batch cmax")
        new_batch.cigar_ops[rr.row] = ops[:cmax]
        new_batch.cigar_lens[rr.row] = lens[:cmax]
        new_batch.cigar_n[rr.row] = ncig
        new_batch.start[rr.row] = rr.start
        new_batch.mapq[rr.row] = rr.mapq
        if new_end is not None:
            new_batch.end[rr.row] = new_end
        else:
            new_batch.end[rr.row] = rr.end
        if rr.md is not None:
            new_md[rr.row] = rr.md.to_string()


# --------------------------------------------------------------------------
# Native-prep realignment path
# --------------------------------------------------------------------------
def _pow2_vec(n: np.ndarray, minimum: int) -> np.ndarray:
    """Vectorized ``_pow2``: next power of two, floored at ``minimum``."""
    table = np.int64(1) << np.arange(40, dtype=np.int64)
    idx = np.searchsorted(table, np.maximum(np.asarray(n, np.int64), 1))
    return np.maximum(table[idx], minimum)


#: The span each phase's wall joins beside its named-timer row (the
#: overlapped host work is pass B's, which records its own spans).
_PHASE_SPANS = {
    "Realign: target map/group": _tele.SPAN_REALIGN_PREP,
    "Realign: native prep": _tele.SPAN_REALIGN_PREP,
    "Realign: consensus + tiles": _tele.SPAN_REALIGN_PREP,
    "Realign: sweep dispatch (host assembly)": _tele.SPAN_REALIGN_SWEEP,
    "Realign: sweep fetch": _tele.SPAN_REALIGN_SWEEP,
    "Realign: decisions + rewrite": _tele.SPAN_REALIGN_DECIDE,
}


def _realign_indels_native(
    ds: AlignmentDataset,
    consensus_model: str,
    known_indels,
    max_indel_size: int,
    max_consensus_number: int,
    lod_threshold: float,
    max_target_size: int,
    rng: Optional[random.Random],
    target_mapping: str = "overlap",
    *,
    device: torch.device,
    overlap_work=None,
    sweep_devices=None,
):
    """Same decisions as :func:`_realign_indels_py` under the ``reads``
    and ``knowns`` models (the JAX package's ``_realign_indels_native``),
    with the per-read host work (MD parse / reference rebuild /
    left-normalization / consensus generation / MD rewrite) in C++
    (``native/realign.cpp``) and the sweep tiles batched on ``device``.
    Each phase wall is measured once and goes both to the named-timer
    registry under the JAX package's label and to ``TRACE`` as the span
    of :data:`_PHASE_SPANS` (no-ops unless recording is on)."""
    import time

    from adam_tpu_torch import native
    from adam_tpu_torch.utils import instrumentation as _ins

    t_phase = time.monotonic_ns()

    def _phase(label):
        nonlocal t_phase
        now = time.monotonic_ns()
        _ins.TIMERS.add(label, now - t_phase)
        span = _PHASE_SPANS.get(label)
        if span is not None:
            _tele.TRACE.add_span(span, t_phase, now - t_phase)
        t_phase = now

    b = ds.batch.to_numpy()
    n = b.n_rows
    if n == 0:
        return ds
    targets = find_targets(ds, max_target_size, max_indel_size)
    if not targets:
        return ds
    names = ds.seq_dict.names
    flags = np.asarray(b.flags)
    mapped = ((flags & schema.FLAG_UNMAPPED) == 0) & np.asarray(b.valid)
    tidx = map_batch_to_targets(b, targets, names, mode=target_mapping)
    srows, goff, gtid = _group_candidates(b, tidx, mapped)
    if not len(srows):
        return ds
    G = len(goff) - 1

    side = ds.sidecar
    md_col = StringColumn.of(side.md)
    if len(md_col) >= n:
        md_buf, md_off = md_col.buf, md_col.offsets[: n + 1]
        md_valid = md_col.valid[:n] & np.asarray(b.valid)
    else:
        md_buf = np.zeros(0, np.uint8)
        md_off = np.zeros(n + 1, np.int64)
        md_valid = np.zeros(n, bool)

    # consensuses come from the indel table under the knowns model with a
    # table; otherwise the prep generates them from the reads
    known = consensus_model == "knowns" and known_indels is not None
    _phase("Realign: target map/group")
    prep = native.realign_prep(
        b, md_buf, md_off, md_valid.astype(np.uint8), srows, goff, not known,
    )
    _phase("Realign: native prep")
    t_status = prep["t_status"]
    t_ref_off = prep["t_ref_off"]
    t_ref_start = prep["t_ref_start"]
    t_ref_end = prep["t_ref_end"]
    ref_all = prep["t_ref_buf"].tobytes().decode("ascii", "replace")
    r_group = prep["r_group"]
    r_row = prep["r_row"]
    r_dirty = prep["r_dirty"].astype(bool)
    r_md_set = prep["r_md_set"].astype(bool)
    r_orig = prep["r_orig_qual"]
    R = len(r_row)
    rg_off = np.searchsorted(r_group, np.arange(G + 1))
    c_group = prep["c_group"]
    cg_off = np.searchsorted(c_group, np.arange(G + 1))
    c_off = prep["c_seq_off"]
    c_all = prep["c_seq_buf"].tobytes().decode("ascii", "replace")
    c_is = prep["c_is"]
    c_ie = prep["c_ie"]

    rng = rng or random.Random(0)
    lengths = np.asarray(b.lengths).astype(np.int64)
    _log = logging.getLogger(__name__)

    # ---- per-group consensus finalize (sampling order == Python path) --
    # grp_cons[g] = list of (cons_str, index_start, index_end)
    grp_cons: list = [None] * G
    for g in range(G):
        if t_status[g] != 0:
            continue
        if rg_off[g + 1] == rg_off[g]:
            continue
        if known:
            cons = _known_consensuses(
                known_indels, names[targets[int(gtid[g])].contig_idx],
                int(t_ref_start[g]), int(t_ref_end[g]),
            )
        else:
            cons = [
                (c_all[c_off[k]:c_off[k + 1]], int(c_is[k]), int(c_ie[k]))
                for k in range(cg_off[g], cg_off[g + 1])
            ]
        # distinct (the native prep pre-dedupes the reads model; the
        # knowns model and the Python path share this exact dedup)
        seen = set()
        uniq = []
        for c in cons:
            if c not in seen:
                seen.add(c)
                uniq.append(c)
        cons = uniq
        if len(cons) > max_consensus_number:
            # random.sample on an index range picks the same positions
            # as sampling the list itself, preserving rng-state parity
            cons = [cons[j] for j in
                    rng.sample(range(len(cons)), max_consensus_number)]
        grp_cons[g] = cons

    # ---- build the spliced consensus sequences + (target, cons) tiles --
    cons_strs: list = []   # spliced full sequences, global ids
    grp_cons_base = np.zeros(G + 1, np.int64)
    for g in range(G):
        cons = grp_cons[g]
        grp_cons_base[g + 1] = grp_cons_base[g] + (len(cons) if cons else 0)
        if not cons:
            continue
        ref_start = int(t_ref_start[g])
        ref_end = int(t_ref_end[g])
        reference = ref_all[t_ref_off[g]:t_ref_off[g + 1]]
        for cs, cis, cie in cons:
            # Consensus.insert_into_reference
            if (cis < ref_start or cis > ref_end
                    or cie - 1 < ref_start or cie - 1 > ref_end):
                raise ValueError("consensus and reference do not overlap")
            cons_strs.append(
                reference[: cis - ref_start] + cs + reference[cie - 1 - ref_start:]
            )

    # flat result layout: per group, ci-major [nc, nr]
    grp_task_base = np.zeros(G + 1, np.int64)
    for g in range(G):
        nr = int(rg_off[g + 1] - rg_off[g])
        nc = int(grp_cons_base[g + 1] - grp_cons_base[g])
        grp_task_base[g + 1] = grp_task_base[g] + nr * nc
    NT = int(grp_task_base[G])
    res_q = np.full(NT, np.inf, np.float32)
    res_o = np.full(NT, -1, np.int32)
    if NT:
        cons_mat, cons_lens = _encode_consensuses(cons_strs)
        # one tile per (target, consensus, run of <= 128 reads)
        tiles, tile_res = [], []
        for g in range(G):
            cons = grp_cons[g]
            if not cons:
                continue
            nr = int(rg_off[g + 1] - rg_off[g])
            for ci in range(len(cons)):
                cid = int(grp_cons_base[g]) + ci
                base = int(grp_task_base[g]) + ci * nr
                for lo in range(0, nr, 128):
                    nrt = min(128, nr - lo)
                    tiles.append((r_row[rg_off[g] + lo: rg_off[g] + lo + nrt], cid))
                    tile_res.append(base + lo)
        _phase("Realign: consensus + tiles")
        swept = _sweep_tiles(np.asarray(b.bases), np.asarray(b.quals), lengths,
                             tiles, cons_mat, cons_lens, device, phase=_phase,
                             overlap=overlap_work, sweep_devices=sweep_devices)
        for rb, (q, o) in zip(tile_res, swept):
            res_q[rb:rb + len(q)] = q
            res_o[rb:rb + len(o)] = o
    _phase("Realign: sweep fetch")

    # ---- scoring + rewrite decisions (numpy, one pass per group) -------
    new_batch = _writable(b)
    new_md: dict[int, Optional[str]] = {}
    new_attrs: dict[int, str] = {}
    cmax = new_batch.cmax

    # realigned-read accumulators (one native MD-move call at the end)
    ra_rows, ra_g, ra_off, ra_head, ra_midl, ra_mido, ra_end = (
        [], [], [], [], [], [], [])
    ra_start, ra_newend = [], []
    realigned_mask = np.zeros(R, bool)

    for g in range(G):
        cons = grp_cons[g]
        if not cons:
            continue
        nr = int(rg_off[g + 1] - rg_off[g])
        nc = len(cons)
        sl = slice(int(grp_task_base[g]), int(grp_task_base[g + 1]))
        # ci-major flat -> [nr, nc]
        q = res_q[sl].reshape(nc, nr).T
        o = res_o[sl].reshape(nc, nr).T
        orig = r_orig[rg_off[g]:rg_off[g + 1]].astype(np.int64)
        use, best_ci, best_total, pre_total, lod = _score_consensuses(q, orig)
        ref_start = int(t_ref_start[g])
        ref_len = int(t_ref_off[g + 1] - t_ref_off[g])
        _log.debug(
            "On target %d [%d, %d), before realignment, sum was %d; "
            "best consensus %d has sum %d (LOD %.2f)",
            int(gtid[g]), ref_start, ref_start + ref_len, pre_total,
            best_ci, best_total, lod,
        )
        if lod <= lod_threshold:
            continue
        cons_str, cis, cie = cons[best_ci]
        best_map = np.where(use[:, best_ci], o[:, best_ci], -1)
        okm = best_map >= 0
        if not okm.any():
            continue
        ridx = np.flatnonzero(okm) + int(rg_off[g])
        om = best_map[okm].astype(np.int64)
        rows_g = r_row[ridx]
        Lr = lengths[rows_g]
        new_start = ref_start + om
        if cis == cie - 1:  # insertion
            id_len = len(cons_str)
            id_op = ord("I")
            end_len = Lr - id_len - (cis - new_start)
            end_pen = -id_len
        else:  # deletion
            id_len = cie - 1 - cis
            id_op = ord("D")
            end_len = Lr - (cis - new_start)
            end_pen = len(cons_str)
        head_len = cis - new_start
        three = (head_len > 0) & (end_len > 0)
        new_end = np.where(three, new_start + Lr + end_pen, new_start + Lr)
        keep = om + (new_end - new_start) <= ref_len
        if not keep.any():
            continue
        k = np.flatnonzero(keep)
        realigned_mask[ridx[k]] = True
        ra_rows.append(rows_g[k])
        ra_g.append(np.full(len(k), g, np.int32))
        ra_off.append(om[k])
        ra_head.append(np.where(three[k], head_len[k], Lr[k]).astype(np.int32))
        ra_midl.append(np.where(three[k], id_len, 0).astype(np.int32))
        ra_mido.append(np.where(three[k], id_op, 0).astype(np.uint8))
        ra_end.append(np.where(three[k], end_len[k], 0).astype(np.int32))
        ra_start.append(new_start[k])
        ra_newend.append(new_end[k])

    # ---- write back: realigned rows ------------------------------------
    if ra_rows:
        rows_a = np.concatenate(ra_rows)
        g_a = np.concatenate(ra_g)
        off_a = np.concatenate(ra_off)
        head_a = np.concatenate(ra_head)
        midl_a = np.concatenate(ra_midl)
        mido_a = np.concatenate(ra_mido)
        end_a = np.concatenate(ra_end)
        start_a = np.concatenate(ra_start)
        newend_a = np.concatenate(ra_newend)
        mbuf, moff = native.md_move_batch(
            b, rows_a, prep["t_ref_buf"], t_ref_off, g_a, off_a,
            head_a, midl_a, mido_a, end_a, start_a,
        )
        mstr = mbuf.tobytes().decode("ascii")

        three_a = mido_a != 0
        if three_a.any() and cmax < 3:
            raise ValueError("realigned cigar exceeds batch cmax")
        # OC/OP provenance from the pre-realignment columns
        oc_buf, oc_off = native.cigar_strings(
            np.asarray(b.cigar_ops)[rows_a],
            np.asarray(b.cigar_lens)[rows_a],
            np.asarray(b.cigar_n)[rows_a],
        )
        oc_all = oc_buf.tobytes().decode("ascii")
        attrs_col = StringColumn.of(side.attrs)
        old_starts = np.asarray(b.start)[rows_a]
        for k, row in enumerate(rows_a):
            row = int(row)
            tag = f"OC:Z:{oc_all[oc_off[k]:oc_off[k + 1]]}\tOP:i:{int(old_starts[k]) + 1}"
            cur = attrs_col[row] or ""
            new_attrs[row] = cur + "\t" + tag if cur else tag
            new_md[row] = mstr[moff[k]:moff[k + 1]]
        ops_new = np.zeros((len(rows_a), cmax), np.uint8)
        ops_new[:] = schema.CIGAR_PAD
        lens_new = np.zeros((len(rows_a), cmax), np.int32)
        ncig_new = np.where(three_a, 3, 1).astype(np.int32)
        ops_new[:, 0] = schema.CIGAR_M
        lens_new[:, 0] = head_a
        if three_a.any() and cmax >= 3:
            ops_new[three_a, 1] = np.where(
                mido_a[three_a] == ord("I"), schema.CIGAR_I, schema.CIGAR_D
            )
            lens_new[three_a, 1] = midl_a[three_a]
            ops_new[three_a, 2] = schema.CIGAR_M
            lens_new[three_a, 2] = end_a[three_a]
        new_batch.cigar_ops[rows_a] = ops_new
        new_batch.cigar_lens[rows_a] = lens_new
        new_batch.cigar_n[rows_a] = ncig_new
        new_batch.start[rows_a] = start_a
        new_batch.end[rows_a] = newend_a
        new_batch.mapq[rows_a] = np.asarray(b.mapq)[rows_a] + 10

    # ---- write back: dirty (left-normalized) non-realigned rows --------
    dirty_idx = np.flatnonzero(r_dirty & ~realigned_mask)
    if len(dirty_idx):
        cig_off = prep["r_cigar_off"]
        cig_all = prep["r_cigar_buf"].tobytes().decode("ascii")
        md_off2 = prep["r_md_off"]
        md_all = prep["r_md_buf"].tobytes().decode("ascii")
        for i in dirty_idx:
            row = int(r_row[i])
            cig = cig_all[cig_off[i]:cig_off[i + 1]]
            elems = parse_cigar(cig)
            ops, lens_, ncig = schema.encode_cigar(cig, max(cmax, len(elems)))
            if ncig > cmax:
                raise ValueError("realigned cigar exceeds batch cmax")
            new_batch.cigar_ops[row] = ops[:cmax]
            new_batch.cigar_lens[row] = lens_[:cmax]
            new_batch.cigar_n[row] = ncig
            new_batch.end[row] = int(new_batch.start[row]) + cigar_ref_len(elems)
            if r_md_set[i]:
                new_md[row] = md_all[md_off2[i]:md_off2[i + 1]]

    new_side = dc_replace(
        side,
        md=with_overrides(StringColumn.of(side.md), new_md),
        attrs=with_overrides(StringColumn.of(side.attrs), new_attrs),
    )
    _phase("Realign: decisions + rewrite")
    return ds.with_batch(new_batch, new_side)


def candidate_mask(b, targets, names) -> np.ndarray:
    """bool[N]: rows mapped to a realignment target — THE membership
    rule every pipeline's split/re-split/observe must share."""
    return map_batch_to_targets(b, targets, names) >= 0


def mask_out_candidates(ds, targets, names, mask=None):
    """Remainder view of a window/shard: candidate rows masked invalid
    (no keep-side copy; the Parquet encoder and the observe walk both
    filter on ``valid``).  Pass a cached ``mask`` to skip recomputing
    the target mapping."""
    b = ds.batch.to_numpy()
    if mask is None:
        mask = candidate_mask(b, targets, names)
    if not mask.any():
        return ds
    return ds.with_batch(b.replace(valid=np.asarray(b.valid) & ~mask))


def split_realign_candidates(ds, targets, names):
    """Split a window/shard into (candidates, writable remainder).

    Candidate rows (mapped to a realignment target) gather into a new
    dataset; the ~87% keep-side majority is returned MASKED (valid
    cleared) rather than copied — the Parquet encoder's own row gather
    filters it once at write time.  Returns
    (candidates-or-None, remainder, n_remaining_valid)."""
    b = ds.batch.to_numpy()
    cand = candidate_mask(b, targets, names)
    if cand.any():
        candidates = ds.take_rows(np.flatnonzero(cand))
        ds = mask_out_candidates(ds, targets, names, mask=cand)
    else:
        candidates = None
    return candidates, ds, int(np.asarray(ds.batch.valid).sum())
