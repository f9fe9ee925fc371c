"""Base Quality Score Recalibration — the port's counterpart of
``adam_tpu/pipelines/bqsr.py``: the streamed path's passes and the
dataset-level :func:`recalibrate_base_qualities`.

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
* **Fused B->C** (a table known before pass B): each window's observe
  and apply + pack run back to back over its resident tensors
  (:func:`fused_bc_dispatch`), and pass C only fetches.
* **Known SNPs** are masked out of the observe's residue filter
  (:func:`observe_residue_mask`), on the host.
* **Dataset level** (:func:`recalibrate_base_qualities`, the
  non-streaming ``transform``): the whole dataset is observed at its own
  ``[grid_rows(N), grid_cols(L)]`` grid in one kernel launch (in row
  chunks of :data:`CHUNK_ROWS` above that, every chunk at the dataset's
  lane grid, merged in i64), solved, and the table gathered back into
  the quals matrix, with no column pack (the JAX package's
  ``pack=False``).

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
from adam_tpu_torch.ops.observe import observe_hist, pack_bits
from adam_tpu_torch.ops.phred import PHRED_TO_ERROR
from adam_tpu_torch.utils import telemetry as _tele

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


def observe_residue_mask(ds: AlignmentDataset, b, known_snps=None) -> np.ndarray:
    """The per-residue observe filter (q > 0, regular ACGT base, aligned
    to the reference, not a known SNP) -> bool[N, L].  ``known_snps`` (a
    :class:`~adam_tpu_torch.models.snp_table.SnpTable`) is tested on the
    host against each residue's reference position."""
    ref_pos = cigar_ops.reference_positions_np(
        b.cigar_ops, b.cigar_lens, b.cigar_n, b.start, b.lmax
    )
    quals = np.asarray(b.quals)
    rok = (
        (quals > 0) & (quals < schema.QUAL_PAD)
        & (np.asarray(b.bases) < 4) & (ref_pos >= 0)
    )
    if known_snps is not None and len(known_snps):
        rok &= ~known_snps.mask_positions(
            ds.seq_dict.names, np.asarray(b.contig_idx), ref_pos
        )
    return rok


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


def observe_kernel(bases, quals, lengths, flags, read_group_idx,
                   residue_ok, is_mismatch, read_ok, n_rg: int, lmax: int):
    """Observe pass over boolean ``[N, lmax]`` residue masks -> (total,
    mism) i64[n_rg, 94, 2*lmax+1, 17] (the JAX package's
    ``observe_kernel``): the masks are bit-packed on their device and the
    histogram built by :func:`observe_packed_body`, so on the card it is
    kernel 1."""
    return observe_packed_body(bases, quals, lengths, flags, read_group_idx,
                               pack_bits(residue_ok), pack_bits(is_mismatch),
                               read_ok, n_rg, lmax)


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


def merge_observations(parts: list[tuple], window_ids=None,
                       on_part=None, tracer=None) -> tuple:
    """Sum per-window (total, mism, gl) histograms, in window order, into
    one host i64 (total, mism, gl).  Cycle slots are centred (index =
    cycle + gl), so a narrower window pads into the middle of the widest
    window's table.  A part is device tensors (fetched here, at the
    barrier) or host arrays (a sidecar loaded on resume).

    ``window_ids`` is the parallel list of each part's window index (the
    part position when None); ``on_part(window, total, mism, g)`` is
    called with each part's host histogram as it merges, which is where
    the run journal persists its observe sidecars.  With ``tracer`` (the
    streamed run's barrier 2) each device part's fetch is a
    ``device.fetch.observe`` span on it, attributed to its window and
    device; the dataset-level callers record none, as in JAX."""
    from adam_tpu_torch.device import device_key

    gl = max(p[2] for p in parts)
    s0 = tuple(parts[0][0].shape)
    shape = (s0[0], s0[1], 2 * gl + 1, s0[3])
    total = np.zeros(shape, np.int64)
    mism = np.zeros(shape, np.int64)
    for k, (t, m, g) in enumerate(parts):
        win = window_ids[k] if window_ids is not None else k
        if tracer is not None and isinstance(t, torch.Tensor):
            with tracer.span(_tele.SPAN_OBS_FETCH, window=win,
                             device=device_key(t.device)):
                tt, mm = _host(t), _host(m)
        else:  # a host part (a loaded sidecar) crosses no device link
            tt, mm = _host(t), _host(m)
        if on_part is not None:
            on_part(win, tt, mm, g)
        off = gl - g
        total[:, :, off : off + 2 * g + 1, :] += tt
        mism[:, :, off : off + 2 * g + 1, :] += mm
    return total, mism, gl


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


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


def recalibration_phred_table(total, mismatches) -> torch.Tensor:
    """The recalibrated quality of every covariate cell -> i32[RG, Q, C, D]
    on the histograms' device: the f64 host solve of
    :func:`recalibration_phred_table_np` (bit for bit the JAX package's
    ``recalibration_phred_table``, which its tests hold to the same host
    twin), placed back where the histograms live."""
    device = total.device if isinstance(total, torch.Tensor) else torch.device("cpu")
    table = recalibration_phred_table_np(_host(total), _host(mismatches))
    return torch.from_numpy(table).to(device)


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
    present, valid row).  The table's cycle axis spans [-gl, gl] (its own
    gl, which may exceed lmax: narrower windows gather from its
    middle)."""
    n_rg, _, n_cyc, _ = phred_table.shape
    gl = (n_cyc - 1) // 2
    # a known table may come from another cohort, with fewer read-group
    # bins or a narrower cycle axis than this window: its indices follow
    # the JAX gather, which counts a negative index from the end of its
    # axis and clamps what is still outside
    rg = torch.clamp(_rg_bins(read_group_idx, n_rg), 0, n_rg - 1)
    q = torch.clamp(quals.to(torch.int64), 0, N_QUAL - 1)
    cycles = compute_cycles(lengths, flags, lmax) + gl
    cycles = torch.clamp(torch.where(cycles < 0, cycles + n_cyc, cycles), 0, n_cyc - 1)
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


def recalibrate_kernel(bases, quals, lengths, flags, read_group_idx, has_qual,
                       valid, total, mismatches, lmax: int):
    """Apply the recalibration solved from (``total``, ``mismatches``) to
    every residue -> new quals u8[N, lmax] (the JAX package's
    ``recalibrate_kernel``): :func:`recalibration_phred_table`, then the
    table gather of :func:`apply_table_body`, reported quality >= Q5
    only."""
    table = recalibration_phred_table(total, mismatches).to(torch.uint8)
    return apply_table_body(bases, quals, lengths, flags, read_group_idx,
                            has_qual, valid, table, lmax)


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


# --------------------------------------------------------------------------
# Windows: observe, apply, and the fused B->C tier
# --------------------------------------------------------------------------
def _put(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(arr).to(device)


def _observe_masks(ds: AlignmentDataset, rw, known_snps) -> tuple:
    """Host side of one resident window's observe: the MD walk, the read
    and residue filters (known SNPs masked), bit-packed and shipped to
    the window's device -> (res_bits, mm_bits, read_ok)."""
    from adam_tpu_torch.formats.batch import pad_rows_np
    from adam_tpu_torch.ops.colpack import pack_mask_bits
    from adam_tpu_torch.ops.mdtag import batch_md_arrays

    b = ds.batch.to_numpy()
    is_mm, _, has_md = batch_md_arrays(b, ds.sidecar, need_ref_codes=False)
    read_ok = observe_read_mask(b, has_md)
    residue_ok = observe_residue_mask(ds, b, known_snps)
    g, gl, dev = rw.g, rw.gl, rw.device
    return (
        _put(pack_mask_bits(pad_rows_np(residue_ok, g, False, cols=gl)), dev),
        _put(pack_mask_bits(pad_rows_np(is_mm, g, False, cols=gl)), dev),
        _put(pad_rows_np(read_ok, g, False), dev),
    )


def _apply_masks(b, rw) -> tuple:
    """The post-split ``has_qual`` / ``valid`` bools of pass C, padded to
    the window's rows, on its device."""
    from adam_tpu_torch.formats.batch import pad_rows_np

    return (_put(pad_rows_np(b.has_qual, rw.g, False), rw.device),
            _put(pad_rows_np(b.valid, rw.g, False), rw.device))


def _apply_handle(ds: AlignmentDataset, b, pq, pb) -> tuple:
    from adam_tpu_torch.ops.colpack import pack_lengths

    return (ds, b, pq, pack_lengths(b.lengths, b.valid, b.has_qual),
            pb, pack_lengths(b.lengths, b.valid))


def observe_window(ds: AlignmentDataset, rw, known_snps=None) -> tuple:
    """Pass B for one resident window -> (total, mism, gl): lazy i64
    histograms on the window's device and its grid width."""
    with _tele.TRACE.span(_tele.SPAN_BQSR_OBSERVE, backend="device",
                          reads=int(ds.batch.n_rows)):
        total, mism = observe_packed_body(
            *rw.args(), *_observe_masks(ds, rw, known_snps),
            len(ds.read_groups) + 1, rw.gl,
        )
    return total, mism, rw.gl


def apply_dispatch(ds: AlignmentDataset, rw, table_dev) -> tuple:
    """Pass C dispatch for one resident window -> handle for
    :func:`apply_finish` (the packed columns are still being computed on
    the device)."""
    with _tele.TRACE.span(_tele.SPAN_BQSR_APPLY_DISPATCH, backend="device"):
        b = ds.batch.to_numpy()
        pq, pb = apply_pack2_body(*rw.args(), *_apply_masks(b, rw), table_dev,
                                  rw.gl, rw.g * rw.gl)
        return _apply_handle(ds, b, pq, pb)


def apply_finish(handle) -> tuple:
    """Fetch a dispatched window's packed columns (exactly
    ``sum(lengths)`` bytes each) and stash OQ -> (dataset, packed)."""
    from adam_tpu_torch.io.arrow_pack import PackedColumns, PackedQuals

    ds, b, pq, lens_q, pb, lens_b = handle
    with _tele.TRACE.span(_tele.SPAN_BQSR_APPLY_FETCH):
        packed = PackedColumns(
            quals=PackedQuals(pq[: int(lens_q.sum())].cpu().numpy(), lens_q),
            bases=PackedQuals(pb[: int(lens_b.sum())].cpu().numpy(), lens_b),
        )
    return stash_orig_quals(ds, b), packed


def fused_bc_enabled(default: bool = True) -> bool:
    """The ``ADAM_TPU_FUSED_BC`` toggle of the fused B->C tier, parsed as
    the JAX package parses it: ``auto``/unset -> ``default``,
    ``1/on/true`` and ``0/off/false`` force.  The off position is the
    unfused A/B leg."""
    from adam_tpu_torch.utils.retry import env_toggle

    return env_toggle("ADAM_TPU_FUSED_BC", default)


def fused_bc_body(bases, quals, lengths, flags, read_group_idx,
                  res_bits, mm_bits, read_ok, has_qual, valid,
                  phred_table, n_rg: int, lmax: int, size: int):
    """Fused pass B->C over one window's resident tensors, for a table
    known before pass B: :func:`observe_packed_body` (kernel 1, on the
    original quals, as in the unfused order) then
    :func:`apply_pack2_body` (kernel 2, SANGER and base decode) ->
    ``(total, mism, packed_quals, packed_bases)``, bitwise the separate
    passes' outputs."""
    total, mism = observe_packed_body(
        bases, quals, lengths, flags, read_group_idx,
        res_bits, mm_bits, read_ok, n_rg, lmax,
    )
    pq, pb = apply_pack2_body(
        bases, quals, lengths, flags, read_group_idx, has_qual, valid,
        phred_table, lmax, size,
    )
    return total, mism, pq, pb


def fused_bc_dispatch(ds: AlignmentDataset, table_dev, rw, known_snps=None):
    """One fused B->C dispatch for a resident window whose recalibration
    table is already known -> ``(handle, (total, mism, gl))`` — the
    handle is :func:`apply_dispatch`'s, finished by :func:`apply_finish`
    without a second dispatch — or None when the window is not eligible:
    the table must have the window's read-group bins and a cycle axis at
    least as wide as the window's grid (``n_cyc >= 2*gl + 1``).  An
    ineligible window takes the separate passes, as in the JAX package."""
    n_rg = len(ds.read_groups) + 1
    if table_dev.shape[0] != n_rg or table_dev.shape[2] < 2 * rw.gl + 1:
        return None
    with _tele.TRACE.span(_tele.SPAN_FUSED_BC, backend="device",
                          reads=int(ds.batch.n_rows)):
        b = ds.batch.to_numpy()
        total, mism, pq, pb = fused_bc_body(
            *rw.args(), *_observe_masks(ds, rw, known_snps), *_apply_masks(b, rw),
            table_dev, n_rg, rw.gl, rw.g * rw.gl,
        )
    return _apply_handle(ds, b, pq, pb), (total, mism, rw.gl)


# --------------------------------------------------------------------------
# Dataset level: observe, solve and apply over one whole dataset
# --------------------------------------------------------------------------
#: rows one observe or apply dispatch places on the device: a larger
#: dataset runs in chunks of these rows, each at the whole dataset's lane
#: grid, so that the i64 merge of their integer histograms equals one
#: launch over all rows
CHUNK_ROWS = 1 << 20


def _row_chunks(ds: AlignmentDataset) -> list:
    n = ds.batch.n_rows
    if n <= CHUNK_ROWS:
        return [ds]
    return [ds.take_rows(np.arange(s, min(s + CHUNK_ROWS, n)))
            for s in range(0, n, CHUNK_ROWS)]


def place_chunks(ds: AlignmentDataset, device) -> list:
    """The dataset in row chunks of at most :data:`CHUNK_ROWS`, each
    placed on ``device`` -> [(chunk, ResidentWindow)]."""
    from adam_tpu_torch.parallel.device_pool import ResidentWindow

    return [(c, ResidentWindow.place(c.batch.to_numpy(), device))
            for c in _row_chunks(ds)]


def observe_dataset(ds: AlignmentDataset, device, known_snps=None) -> tuple:
    """Pass B over a whole dataset (a shard, or all of the dataset-level
    transform's rows): one kernel-1 observe per row chunk ->
    (placed chunks, [(total, mism, gl)] lazy device histograms, one per
    chunk, for :func:`merge_observations`)."""
    placed = place_chunks(ds, device)
    return placed, [observe_window(c, rw, known_snps) for c, rw in placed]


def apply_placed(placed: list, table_dev) -> AlignmentDataset:
    """Gather a solved table into every placed chunk -> the recalibrated
    dataset (the chunks concatenated back in order)."""
    return AlignmentDataset.concat(
        [apply_recalibration(c, rw, table_dev) for c, rw in placed])


def apply_recalibration(ds: AlignmentDataset, rw, table_dev) -> AlignmentDataset:
    """Gather a solved table into one placed dataset's quals (reported
    quality >= Q5 only) and stash the pre-recalibration quals as OQ ->
    the recalibrated dataset."""
    with _tele.TRACE.span(_tele.SPAN_BQSR_APPLY_HOST, backend="device"):
        b = ds.batch.to_numpy()
        with _tele.TRACE.span(_tele.SPAN_BQSR_APPLY_DISPATCH, backend="device"):
            new_q = apply_table_body(*rw.args(), *_apply_masks(b, rw), table_dev, rw.gl)
        with _tele.TRACE.span(_tele.SPAN_BQSR_APPLY_FETCH):
            new_q = np.ascontiguousarray(new_q[: b.n_rows, : b.lmax].cpu().numpy())
        out = stash_orig_quals(ds, b)
        return out.with_batch(b.replace(quals=new_q))


def build_observation_table(ds: AlignmentDataset, known_snps=None,
                            device: str = "cuda") -> ObservationTable:
    """The observe pass over one whole dataset (kernel 1 on ``device``,
    known SNPs masked on the host) -> its :class:`ObservationTable`, the
    cycle axis at the dataset's lane grid."""
    from adam_tpu_torch.device import resolve_device

    _placed, parts = observe_dataset(ds, resolve_device(device), known_snps)
    total, mism, gl = merge_observations(parts)
    return ObservationTable(total, mism, ds.read_groups.names + ["null"], gl)


def recalibrate_base_qualities(
    ds: AlignmentDataset,
    known_snps=None,
    dump_observation_table: str | None = None,
    device: str = "cuda",
    stats: dict | None = None,
) -> AlignmentDataset:
    """BQSR over one whole dataset: observe (covariate keys and kernel 1
    on ``device``, known SNPs masked on the host), solve (host f64), apply
    (the table gather on ``device``, OQ stashed on the host).
    ``dump_observation_table`` writes the observations as the reference's
    CSV.  ``stats``, when given, receives the walls in seconds
    (``bqsr_observe_s``, ``bqsr_solve_s``, ``bqsr_apply_s``)."""
    import time

    from adam_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    stats = {} if stats is None else stats
    t0 = time.monotonic()
    placed, parts = observe_dataset(ds, dev, known_snps)
    total, mism, gl = merge_observations(parts)
    t1 = time.monotonic()
    if dump_observation_table:
        dump_observation_csv(total, mism, ds.read_groups.names + ["null"], gl,
                             dump_observation_table)
    table_dev = torch.from_numpy(solve_recalibration_table(total, mism)).to(dev)
    t2 = time.monotonic()
    out = apply_placed(placed, table_dev)
    stats.update(bqsr_observe_s=t1 - t0, bqsr_solve_s=t2 - t1,
                 bqsr_apply_s=time.monotonic() - t2)
    return out
