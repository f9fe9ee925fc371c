"""Base Quality Score Recalibration — the streamed path's subset of
``adam_tpu/pipelines/bqsr.py``.

* **Observe** (pass B): canonical reads (primary, mapped, not duplicate,
  qual present, 0 < mapq < 255, passed vendor QC, MD present) contribute
  one observation per residue with quality > 0, a regular ACGT base and
  a reference position.  The covariate key is (read group, reported
  quality, cycle, dinucleotide); the dense histogram over it is built on
  the device by :func:`adam_tpu_torch.ops.observe.observe_hist`.
* **Solve** (barrier 2): the merged histograms become the compact u8
  phred table on the host, in numpy float64, exactly as the JAX
  streamed run solves after its barrier-2 fetch.
* **Apply** (pass C): one gather from the table per residue (reported
  quality >= Q5 only), then the SANGER encode and the row-prefix pack of
  both the recalibrated quals and the decoded bases
  (:func:`apply_pack2_body`).

Integer widths follow the JAX package, which runs with x64 on: keys and
counts accumulate in i32 per window and widen to i64; merges sum in i64.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace

import numpy as np
import torch

from adam_tpu_torch.api.datasets import AlignmentDataset
from adam_tpu_torch.formats import schema
from adam_tpu_torch.ops import cigar as cigar_ops
from adam_tpu_torch.ops.colpack import pack_rows
from adam_tpu_torch.ops.observe import observe_hist
from adam_tpu_torch.ops.phred import PHRED_TO_ERROR

N_QUAL = 94  # valid phred range 0..93
N_DINUC = 17  # 16 (prev,cur) pairs + index 16 = None ("NN")
DINUC_NONE = 16
MIN_ACCEPTABLE_QUALITY = 5
MAX_QUAL = 50


# --------------------------------------------------------------------------
# Covariates (tensors)
# --------------------------------------------------------------------------
def compute_cycles(lengths, flags, lmax: int):
    """Sequencer cycle per residue -> i64[N, lmax].

    (initial, increment): forward/first (1, +1); forward/second (-1, -1);
    reverse/first (L, -1); reverse/second (-L, +1) (CycleCovariate.scala);
    'second' means paired && secondOfPair."""
    rev = (flags & schema.FLAG_REVERSE) != 0
    second = ((flags & schema.FLAG_PAIRED) != 0) & (
        (flags & schema.FLAG_SECOND_OF_PAIR) != 0
    )
    L = lengths.to(torch.int64)
    one = torch.ones_like(L)
    initial = torch.where(
        rev, torch.where(second, -L, L), torch.where(second, -one, one)
    )
    increment = torch.where(rev, torch.where(second, one, -one),
                            torch.where(second, -one, one))
    pos = torch.arange(lmax, dtype=torch.int64, device=L.device)[None, :]
    return initial[:, None] + increment[:, None] * pos


def compute_dinucs(bases, lengths, flags, lmax: int):
    """Dinucleotide index per residue -> i64[N, lmax] in [0, 16].

    Forward: (seq[i-1], seq[i]); reverse: (comp(seq[i+1]), comp(seq[i])),
    the machine-order previous base.  16 ("NN") at the machine-order
    first base or when either base is not a regular ACGT."""
    comp = torch.from_numpy(schema.BASE_COMPLEMENT.astype(np.int64)).to(
        bases.device
    )
    b = bases.to(torch.int64)  # widen: u8 has few ops on CUDA
    rev = ((flags & schema.FLAG_REVERSE) != 0)[:, None]
    prev_f = torch.nn.functional.pad(b[:, :-1], (1, 0), value=schema.BASE_N)
    next_b = torch.nn.functional.pad(b[:, 1:], (0, 1), value=schema.BASE_N)
    cur = torch.where(rev, comp[b], b)
    prev = torch.where(rev, comp[next_b], prev_f)
    i = torch.arange(lmax, device=b.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    in_read = i < lens
    first_machine = torch.where(rev, i == lens - 1, i == 0)
    regular = (cur < 4) & (prev < 4)
    ok = in_read & ~first_machine & regular
    return torch.where(ok, prev * 4 + cur, DINUC_NONE)


def _rg_bins(read_group_idx, n_rg: int):
    # reads without a read group get the last bin (the reference's null
    # readGroup key), index n_rg - 1 of the n_rg = len(groups) + 1 bins
    rg = read_group_idx.to(torch.int64)
    return torch.where(rg >= 0, rg, n_rg - 1)


# --------------------------------------------------------------------------
# Observe
# --------------------------------------------------------------------------
def observe_read_mask(b, has_md: np.ndarray) -> np.ndarray:
    """The canonical-read filter of the observe pass -> bool[N]."""
    flags = np.asarray(b.flags)
    return (
        np.asarray(b.valid)
        & ((flags & schema.FLAG_UNMAPPED) == 0)
        & ((flags & (schema.FLAG_SECONDARY | schema.FLAG_SUPPLEMENTARY)) == 0)
        & ((flags & schema.FLAG_DUPLICATE) == 0)
        & ((flags & schema.FLAG_FAILED_QC) == 0)
        & np.asarray(b.has_qual)
        & (np.asarray(b.mapq) > 0)
        & (np.asarray(b.mapq) != 255)
        & has_md
    )


def observe_residue_mask(b) -> np.ndarray:
    """The per-residue observe filter (q > 0, regular ACGT base, aligned
    to the reference) -> bool[N, L]."""
    ref_pos = cigar_ops.reference_positions_np(
        b.cigar_ops, b.cigar_lens, b.cigar_n, b.start, b.lmax
    )
    quals = np.asarray(b.quals)
    return (
        (quals > 0) & (quals < schema.QUAL_PAD)
        & (np.asarray(b.bases) < 4) & (ref_pos >= 0)
    )


def covariate_keys(bases, quals, lengths, flags, read_group_idx,
                   n_rg: int, lmax: int):
    """Fused covariate key per residue -> i32[N, lmax], always in
    ``[0, n_rg*94*(2*lmax+1)*17)``: every factor is bounded (the cycle
    axis is centred on ``lmax``)."""
    n_cyc = 2 * lmax + 1
    cycles = compute_cycles(lengths, flags, lmax)
    dinucs = compute_dinucs(bases, lengths, flags, lmax)
    q = torch.clamp(quals.to(torch.int64), 0, N_QUAL - 1)
    rg = _rg_bins(read_group_idx, n_rg)
    return (
        ((rg[:, None] * N_QUAL + q) * n_cyc + (cycles + lmax)) * N_DINUC
        + dinucs
    ).to(torch.int32)


def observe_packed_body(bases, quals, lengths, flags, read_group_idx,
                        res_bits, mm_bits, read_ok, n_rg: int, lmax: int):
    """Observe pass over bit-packed masks -> (total, mism)
    i64[n_rg, 94, 2*lmax+1, 17]: the covariate keys in torch, the
    scatter-add in :func:`observe_hist` (the CUDA kernel on the card),
    i32 counts widened to i64 as the JAX body does."""
    n_cyc = 2 * lmax + 1
    keys = covariate_keys(bases, quals, lengths, flags, read_group_idx,
                          n_rg, lmax)
    size = n_rg * N_QUAL * n_cyc * N_DINUC
    total, mism = observe_hist(keys, res_bits, mm_bits, read_ok, size,
                               n_cyc * N_DINUC)
    shape = (n_rg, N_QUAL, n_cyc, N_DINUC)
    return (total.reshape(shape).to(torch.int64),
            mism.reshape(shape).to(torch.int64))


class ObservationTable:
    """Dense covariate histogram + the reference's ObservationTable CSV."""

    def __init__(self, total, mismatches, rg_names: list[str], lmax: int):
        self.total = np.asarray(total)
        self.mismatches = np.asarray(mismatches)
        self.rg_names = rg_names
        self.lmax = lmax

    @staticmethod
    def _dinuc_str(idx: int) -> str:
        if idx == DINUC_NONE:
            return "NN"
        return "ACGT"[idx // 4] + "ACGT"[idx % 4]

    @staticmethod
    def empirical_quality(total, mismatches):
        """Bayes with Beta(1,1): (1+mm)/(2+total) -> phred with Scala
        math.round = floor(x+0.5)."""
        p = (1.0 + np.asarray(mismatches)) / (2.0 + np.asarray(total))
        return np.floor(-10.0 * np.log10(p) + 0.5).astype(np.int64)

    def to_csv(self) -> str:
        lines = ["ReadGroup,ReportedQ,Cycle,Dinuc,TotalCount,MismatchCount,EmpiricalQ,IsSkipped"]
        rg_idx, q_idx, c_idx, d_idx = np.nonzero(self.total)
        totals = self.total[rg_idx, q_idx, c_idx, d_idx]
        mms = self.mismatches[rg_idx, q_idx, c_idx, d_idx]
        emp = self.empirical_quality(totals, mms)
        for rg, q, c, d, t, m, e in zip(rg_idx, q_idx, c_idx, d_idx, totals, mms, emp):
            fields = [
                self.rg_names[rg], str(int(q)), str(int(c) - self.lmax),
                self._dinuc_str(int(d)), str(int(t)), str(int(m)), str(int(e)),
            ]
            if d == DINUC_NONE:
                fields.append("**")
            lines.append(",".join(fields))
        return "\n".join(lines)


def dump_observation_csv(total, mism, rg_names, lmax, path) -> None:
    """Write the merged observation histogram as the reference's CSV."""
    obs = ObservationTable(np.asarray(total), np.asarray(mism), rg_names, lmax)
    with open(path, "w") as fh:
        fh.write(obs.to_csv())


def merge_observations(parts: list[tuple]) -> tuple:
    """Sum per-window (total, mism, gl) histograms, in window order, into
    one host i64 (total, mism, gl).  Cycle slots are centred (index =
    cycle + gl), so a narrower window pads into the middle of the widest
    window's table.  Device parts are fetched here, at the barrier."""
    gl = max(p[2] for p in parts)
    s0 = tuple(parts[0][0].shape)
    shape = (s0[0], s0[1], 2 * gl + 1, s0[3])
    total = np.zeros(shape, np.int64)
    mism = np.zeros(shape, np.int64)
    for t, m, g in parts:
        off = gl - g
        total[:, :, off : off + 2 * g + 1, :] += t.cpu().numpy()
        mism[:, :, off : off + 2 * g + 1, :] += m.cpu().numpy()
    return total, mism, gl


# --------------------------------------------------------------------------
# Solve (host, f64)
# --------------------------------------------------------------------------
def recalibration_phred_table_np(total, mismatches) -> np.ndarray:
    """The recalibrated quality of every covariate cell -> i32[RG, Q, C, D]
    (the log-space delta stack of Recalibrator.scala, evaluated once per
    table cell; the same f64 math as the JAX package's host solve)."""
    err = np.asarray(PHRED_TO_ERROR)
    total = np.asarray(total, np.float64)
    mismatches = np.asarray(mismatches, np.float64)

    def emp_log(t, m):
        return np.log((1.0 + m) / (2.0 + t))

    g_t = total.sum(axis=(1, 2, 3))
    g_m = mismatches.sum(axis=(1, 2, 3))
    q_levels = np.arange(N_QUAL)
    q_t = total.sum(axis=(2, 3))
    q_m = mismatches.sum(axis=(2, 3))
    g_exp = (err[q_levels][None, :] * q_t).sum(axis=1)
    c_t = total.sum(axis=3)
    c_m = mismatches.sum(axis=3)
    d_t = total.sum(axis=2)
    d_m = mismatches.sum(axis=2)

    residue_logp = np.log(err[q_levels])
    g_present = g_t > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        global_delta = np.where(
            g_present,
            emp_log(g_t, g_m) - np.log(g_exp / np.maximum(g_t, 1)),
            0.0,
        )
        q_present = g_present[:, None] & (q_t > 0)
        offset1 = residue_logp[None, :] + global_delta[:, None]
        quality_delta = np.where(q_present, emp_log(q_t, q_m) - offset1, 0.0)
        offset2 = offset1 + quality_delta
        cyc_delta = np.where(
            q_present[:, :, None] & (c_t > 0),
            emp_log(c_t, c_m) - offset2[:, :, None],
            0.0,
        )
        din_delta = np.where(
            q_present[:, :, None] & (d_t > 0),
            emp_log(d_t, d_m) - offset2[:, :, None],
            0.0,
        )
    log_p = (
        offset2[:, :, None, None]
        + cyc_delta[:, :, :, None]
        + din_delta[:, :, None, :]
    )
    bounded = np.minimum(0.0, np.maximum(np.log(err[MAX_QUAL]), log_p))
    return np.floor(-10.0 * np.log10(np.exp(bounded)) + 0.5).astype(np.int32)


def solve_recalibration_table(total, mism) -> np.ndarray:
    """Merged histograms -> compact u8 phred table (barrier 2)."""
    return recalibration_phred_table_np(total, mism).astype(np.uint8)


# --------------------------------------------------------------------------
# Apply (tensors)
# --------------------------------------------------------------------------
def apply_table_body(bases, quals, lengths, flags, read_group_idx,
                     has_qual, valid, phred_table, lmax: int):
    """Recalibrated quals u8[N, lmax]: one gather from the u8 table per
    residue, applied where the reported quality is >= Q5 (in-read, qual
    present, valid row).  The table's cycle axis spans [-gl, gl] with
    gl >= lmax, so narrower windows gather from its middle."""
    n_rg, _, n_cyc, _ = phred_table.shape
    gl = (n_cyc - 1) // 2
    rg = _rg_bins(read_group_idx, n_rg)
    q = torch.clamp(quals.to(torch.int64), 0, N_QUAL - 1)
    cycles = compute_cycles(lengths, flags, lmax) + gl
    dinucs = compute_dinucs(bases, lengths, flags, lmax)
    flat = ((rg[:, None] * N_QUAL + q) * n_cyc + cycles) * N_DINUC + dinucs
    new_q = phred_table.reshape(-1)[flat]
    q32 = quals.to(torch.int32)
    in_read = (
        torch.arange(lmax, device=quals.device)[None, :]
        < lengths.to(torch.int64)[:, None]
    )
    apply_mask = (
        in_read
        & (q32 >= MIN_ACCEPTABLE_QUALITY)
        & (q32 < schema.QUAL_PAD)
        & has_qual[:, None]
        & valid[:, None]
    )
    return torch.where(apply_mask, new_q, quals).to(torch.uint8)


def apply_pack2_body(bases, quals, lengths, flags, read_group_idx,
                     has_qual, valid, phred_table, lmax: int, size: int):
    """Apply + both column packs -> (packed_quals, packed_bases), each
    u8[size]: the recalibrated quals SANGER-encoded and the decoded
    bases, each row's in-read prefix at its exclusive-cumsum offset
    (:func:`adam_tpu_torch.ops.colpack.pack_rows` with the encode fused
    in, the CUDA kernel on the card, launched twice)."""
    new_q = apply_table_body(bases, quals, lengths, flags, read_group_idx,
                             has_qual, valid, phred_table, lmax)
    lens = lengths.to(torch.int64)
    qual_lens = torch.where(valid & has_qual, lens, 0)
    base_lens = torch.where(valid, lens, 0)
    return (
        pack_rows(new_q, qual_lens, size, encode="sanger"),
        pack_rows(bases, base_lens, size, encode="base_decode"),
    )


def stash_orig_quals(ds: AlignmentDataset, b) -> AlignmentDataset:
    """Stash the pre-recalibration quals as OQ (setOrigQual) for rows
    that had none; the batch keeps its pre-recalibration quals (the
    recalibrated column travels packed)."""
    from adam_tpu_torch import native
    from adam_tpu_torch.formats.strings import StringColumn

    side = ds.sidecar
    old_oq = StringColumn.of(side.orig_quals)
    set_mask = np.asarray(b.valid) & np.asarray(b.has_qual) & ~old_oq.valid
    stash_lens = np.where(set_mask, np.asarray(b.lengths), 0)
    buf, off = native.lut_compact_rows(
        np.asarray(b.quals), stash_lens, schema.QUAL_SANGER_LUT256
    )
    stashed = StringColumn(buf, off, set_mask.copy())
    if not old_oq.valid.any():
        merged = stashed
    else:
        merged = StringColumn.where(set_mask, stashed, old_oq)
    return ds.with_batch(b, dc_replace(side, orig_quals=merged))
