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
* **Known SNPs** are masked out of the observe's residue filter
  (:func:`observe_residue_mask`), on the host, by one native CIGAR walk
  per read over its contig's sorted sites.
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

from adam_tpu_torch import native
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
    :class:`~adam_tpu_torch.models.snp_table.SnpTable`) is masked on the
    host by :func:`~adam_tpu_torch.native.mask_known_sites`, which visits
    only the sites inside each read's aligned span (the residues on a
    site are counted under ``bqsr.observe.snp_masked``)."""
    ref_pos = cigar_ops.reference_positions_np(
        b.cigar_ops, b.cigar_lens, b.cigar_n, b.start, b.lmax
    )
    quals = np.asarray(b.quals)
    rok = (
        (quals > 0) & (quals < schema.QUAL_PAD)
        & (np.asarray(b.bases) < 4) & (ref_pos >= 0)
    )
    if known_snps is not None and len(known_snps):
        with _tele.TRACE.span(_tele.SPAN_OBSERVE_SNP_MASK):
            sites, offsets = known_snps.site_index(ds.seq_dict.names)
            masked = native.mask_known_sites(
                rok, b.cigar_ops, b.cigar_lens, b.cigar_n, b.start,
                b.contig_idx, sites, offsets,
            )
        _tele.TRACE.count(_tele.C_OBSERVE_SNP_MASKED, masked)
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
                       on_part=None, tracer=None, slots=None,
                       replays=None) -> tuple:
    """Sum per-window (total, mism, gl) histograms, in window order, into
    one host i64 (total, mism, gl).  Cycle slots are centred (index =
    cycle + gl), so a narrower window pads into the middle of the widest
    window's table.  A part is device tensors (fetched here, at the
    barrier) or host arrays (a sidecar loaded on resume).

    ``window_ids`` is the parallel list of each part's window index (the
    part position when None; a None entry marks a part with no single
    window, the mesh's fetched accumulator, which ``on_part`` skips);
    ``on_part(window, total, mism, g)`` is called with each part's host
    histogram as it merges, which is where the run journal persists its
    observe sidecars.  ``slots`` is the parallel list of the pool slot
    holding each device part (None: the single-device path): each part is
    fetched from its slot's stream (``utils/transfer.device_fetch``).
    ``replays`` is a parallel list of recovery hooks: when a part's fetch
    fails past the transfer layer's retries, ``replays[k](exc)`` returns
    its host ``(total, mism, g)`` recomputed on a surviving slot.  With
    ``tracer`` (the streamed run's barrier 2) each device part's fetch is
    a ``device.fetch.observe`` span on it, attributed to its window and
    device; the dataset-level callers record none, as in JAX."""
    from adam_tpu_torch.device import device_key
    from adam_tpu_torch.parallel.device_pool import span_attrs
    from adam_tpu_torch.utils.transfer import device_fetch

    gl = max(p[2] for p in parts)
    s0 = tuple(parts[0][0].shape)
    shape = (s0[0], s0[1], 2 * gl + 1, s0[3])
    total = np.zeros(shape, np.int64)
    mism = np.zeros(shape, np.int64)
    for k, (t, m, g) in enumerate(parts):
        win = window_ids[k] if window_ids is not None else k
        slot = slots[k] if slots is not None else None
        try:
            if tracer is not None and isinstance(t, torch.Tensor):
                attrs = (span_attrs(slot) if slot is not None and slot.attributed
                         else {"device": device_key(t.device)})
                with tracer.span(_tele.SPAN_OBS_FETCH, window=win, **attrs):
                    tt, mm = device_fetch(t, slot), device_fetch(m, slot)
            elif isinstance(t, torch.Tensor):
                tt, mm = device_fetch(t, slot), device_fetch(m, slot)
            else:  # a host part (a loaded sidecar) crosses no device link
                tt, mm = np.asarray(t), np.asarray(m)
        except Exception as e:
            replay = replays[k] if replays is not None else None
            if replay is None:
                raise
            tt, mm, g = replay(e)
        if on_part is not None and win is not None:
            on_part(win, tt, mm, g)
        off = gl - g
        total[:, :, off : off + 2 * g + 1, :] += tt
        mism[:, :, off : off + 2 * g + 1, :] += mm
    return total, mism, gl


def _host(a) -> np.ndarray:
    # adam-tpu: noqa[host-sync] reason=recalibrate_kernel's f64 host solve (bit for bit the JAX package's, which its tests hold to the same host twin): the JAX package solves on the device and fetches nothing here
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

    with _tele.TRACE.span(_tele.SPAN_OQ_STASH):
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
# Windows: observe and apply
# --------------------------------------------------------------------------
def _observe_masks(ds: AlignmentDataset, b, known_snps) -> tuple:
    """The MD walk and the read and residue filters (known SNPs masked) of
    host batch ``b`` -> (read_ok, residue_ok, is_mm)."""
    from adam_tpu_torch.ops.mdtag import batch_md_arrays

    with _tele.TRACE.span(_tele.SPAN_OBSERVE_MD_WALK):
        is_mm, _, has_md = batch_md_arrays(b, ds.sidecar, need_ref_codes=False)
        read_ok = observe_read_mask(b, has_md)
    return read_ok, observe_residue_mask(ds, b, known_snps), is_mm


def observe_inputs(ds: AlignmentDataset, known_snps=None) -> tuple:
    """Host-side observe inputs for one window -> ``(b, read_ok,
    residue_ok, is_mm, n_rg)``: the arrays kernel 1's keys and masks are
    built from (JAX's ``observe_inputs``)."""
    b = ds.batch.to_numpy()
    return (b, *_observe_masks(ds, b, known_snps), len(ds.read_groups) + 1)


def _observe_host_masks(ds: AlignmentDataset, b, g: int, gl: int,
                        known_snps) -> tuple:
    """Host side of one window's observe (:func:`_observe_masks`),
    bit-packed and padded to the ``[g, gl]`` grid -> (res_bits, mm_bits,
    read_ok) numpy arrays."""
    from adam_tpu_torch.formats.batch import pad_rows_np
    from adam_tpu_torch.ops.colpack import pack_mask_bits

    read_ok, residue_ok, is_mm = _observe_masks(ds, b, known_snps)
    return (pack_mask_bits(pad_rows_np(residue_ok, g, False, cols=gl)),
            pack_mask_bits(pad_rows_np(is_mm, g, False, cols=gl)),
            pad_rows_np(read_ok, g, False))


def _apply_host_masks(b, g: int) -> tuple:
    """The post-split ``has_qual`` / ``valid`` bools of pass C, padded to
    ``g`` rows."""
    from adam_tpu_torch.formats.batch import pad_rows_np

    return pad_rows_np(b.has_qual, g, False), pad_rows_np(b.valid, g, False)


def _placer(rw, mesh):
    """Where a window's per-pass inputs go: the mesh's row blocks, or the
    window's slot (booked in the h2d ledger either way)."""
    if mesh is not None:
        return mesh.put_rows
    from adam_tpu_torch.parallel.device_pool import putter

    return putter(rw.slot)


def _dispatch(site_key: tuple, rw, mesh, fn):
    """Run one window's device work ``fn()`` as the JAX dispatch sites do:
    the ``device.dispatch`` fault point (attributed to the slot's id)
    before any launch, the whole unit retried on a transient failure, and
    the compile ledger's hit or miss under ``site_key``.  On a slot, ``fn``
    runs inside its scope (device and stream)."""
    import contextlib

    from adam_tpu_torch.parallel.device_pool import _attr_id
    from adam_tpu_torch.utils import compile_ledger, faults
    from adam_tpu_torch.utils import retry as retry_mod

    if mesh is not None:
        def unit():
            faults.point("device.dispatch", device="mesh")
            return fn()

        ledger = compile_ledger.track(site_key, mesh.ledger_key(), mesh.route())
        scope = contextlib.nullcontext()
    else:
        slot = rw.slot

        def unit():
            faults.point("device.dispatch",
                         device=_attr_id(slot) if slot.attributed else None)
            return fn()

        ledger = compile_ledger.track(site_key, slot)
        scope = slot.scope()
    with ledger, scope:
        return retry_mod.retry_call(unit, site=str(site_key[0]))


def _site_attrs(rw, mesh) -> dict:
    from adam_tpu_torch.parallel.device_pool import span_attrs

    return {"device": "mesh"} if mesh is not None else span_attrs(rw.slot)


class ApplyHandle:
    """A dispatched pass-C window: the dataset and its numpy batch, the
    packed quals and bases (one tensor on the window's slot, or one per
    shard under the mesh) and their per-row lengths; finished by
    :func:`apply_finish`."""

    __slots__ = ("ds", "b", "pq", "lens_q", "pb", "lens_b", "slot", "mesh", "block")

    def __init__(self, ds, b, pq, pb, slot=None, mesh=None, block=0):
        from adam_tpu_torch.ops.colpack import pack_lengths

        self.ds, self.b, self.pq, self.pb = ds, b, pq, pb
        self.lens_q = pack_lengths(b.lengths, b.valid, b.has_qual)
        self.lens_b = pack_lengths(b.lengths, b.valid)
        self.slot, self.mesh = slot, mesh
        self.block = block  # rows per shard under the mesh


def apply_handle_dataset(handle: ApplyHandle) -> AlignmentDataset:
    """The pre-apply dataset of a dispatched window (its replay source)."""
    return handle.ds


def observe_window(ds: AlignmentDataset, rw, known_snps=None, mesh=None) -> tuple:
    """Pass B for one resident window -> (total, mism, gl): lazy i64
    histograms on the window's slot and its grid width.  Under ``mesh`` (a
    ``parallel/partitioner.MeshPartitioner``, ``rw`` its
    ``mesh_resident_window``) each shard observes its row block on its
    slot and ``total``/``mism`` are the per-shard lists, for
    ``MeshPartitioner.accumulate``."""
    with _tele.TRACE.span(_tele.SPAN_BQSR_OBSERVE, backend="device",
                          reads=int(ds.batch.n_rows), **_site_attrs(rw, mesh)):
        b = ds.batch.to_numpy()
        n_rg = len(ds.read_groups) + 1
        host = _observe_host_masks(ds, b, rw.g, rw.gl, known_snps)
        put = _placer(rw, mesh)

        def run():
            res, mm, rdok = (put(a) for a in host)
            if mesh is None:
                return observe_packed_body(*rw.args(), res, mm, rdok, n_rg, rw.gl)
            outs = mesh.shard_map(
                lambda k, *a: observe_packed_body(*a, n_rg, rw.gl),
                *rw.args(), res, mm, rdok)
            return [o[0] for o in outs], [o[1] for o in outs]

        name = "mesh.observe_packed" if mesh is not None else "bqsr.observe_packed"
        total, mism = _dispatch((name, rw.g, rw.gl, n_rg), rw, mesh, run)
    return total, mism, rw.gl


def apply_dispatch(ds: AlignmentDataset, rw, table_dev, mesh=None) -> ApplyHandle:
    """Pass C dispatch for one resident window -> handle for
    :func:`apply_finish` (the packed columns are still being computed on
    the slot).  ``table_dev`` is the table on the window's slot, or one
    copy per shard under ``mesh``."""
    with _tele.TRACE.span(_tele.SPAN_BQSR_APPLY_DISPATCH, backend="device",
                          **_site_attrs(rw, mesh)):
        b = ds.batch.to_numpy()
        host = _apply_host_masks(b, rw.g)
        put = _placer(rw, mesh)
        # one launch packs the whole window's grid, or one shard's block
        size = (mesh.block(rw.g) if mesh is not None else rw.g) * rw.gl
        n_rg, _, n_cyc, _ = (table_dev[0] if mesh is not None else table_dev).shape

        def run():
            hq, v = (put(a) for a in host)
            if mesh is None:
                return apply_pack2_body(*rw.args(), hq, v, table_dev, rw.gl, size)
            outs = mesh.shard_map(
                lambda k, *a: apply_pack2_body(*a, rw.gl, size),
                *rw.args(), hq, v, table_dev)
            return [o[0] for o in outs], [o[1] for o in outs]

        name = "mesh.apply_pack2" if mesh is not None else "bqsr.apply_pack2"
        pq, pb = _dispatch((name, rw.g, rw.gl, n_rg, n_cyc), rw, mesh, run)
        return ApplyHandle(ds, b, pq, pb, slot=None if mesh is not None else rw.slot,
                           mesh=mesh, block=mesh.block(rw.g) if mesh is not None else 0)


def _fetch_packed(h: ApplyHandle, packed, lens: np.ndarray) -> np.ndarray:
    """One packed column home: exactly ``sum(lens)`` bytes, or under the
    mesh each shard's real bytes concatenated in shard order."""
    from adam_tpu_torch.utils.transfer import device_fetch

    if h.mesh is None:
        return device_fetch(packed[: int(lens.sum())], h.slot)
    rows = h.block
    parts = []
    for k, (p, s) in enumerate(zip(packed, h.mesh.devices)):
        t_k = int(lens[k * rows:(k + 1) * rows].sum())
        if t_k:
            parts.append(device_fetch(p[:t_k], s))
    return np.concatenate(parts) if parts else np.zeros(0, np.uint8)


def apply_finish(handle: ApplyHandle) -> tuple:
    """Fetch a dispatched window's packed columns and stash OQ ->
    (dataset, packed)."""
    from adam_tpu_torch.io.arrow_pack import PackedColumns, PackedQuals

    h = handle
    with _tele.TRACE.span(_tele.SPAN_BQSR_APPLY_FETCH):
        packed = PackedColumns(
            quals=PackedQuals(_fetch_packed(h, h.pq, h.lens_q), h.lens_q),
            bases=PackedQuals(_fetch_packed(h, h.pb, h.lens_b), h.lens_b),
        )
    return stash_orig_quals(h.ds, h.b), packed


def apply_reference(ds: AlignmentDataset, table: np.ndarray):
    """The SDC audit's reference: one window's pass C (the table gather and
    both packs) by the plain PyTorch versions on the CPU, from the host
    copy of the window -> its ``PackedColumns``.  Used only to compare
    with the card's result; it is never published."""
    from adam_tpu_torch.formats.batch import grid_cols, grid_rows
    from adam_tpu_torch.io.arrow_pack import PackedColumns, PackedQuals
    from adam_tpu_torch.ops.colpack import pack_lengths
    from adam_tpu_torch.parallel.device_pool import ResidentWindow

    b = ds.batch.to_numpy()
    g, gl = grid_rows(b.n_rows), grid_cols(b.lmax)
    res = [torch.from_numpy(a) for a in ResidentWindow.host_arrays(b, g, gl).values()]
    hq, v = (torch.from_numpy(a) for a in _apply_host_masks(b, g))
    # adam-tpu: noqa[dispatch-ledger] reason=the SDC audit's CPU reference: every input is torch.from_numpy, so the plain versions run on the CPU and no card dispatch happens
    pq, pb = apply_pack2_body(*res, hq, v, torch.from_numpy(np.ascontiguousarray(table)),
                              gl, g * gl)
    lens_q = pack_lengths(b.lengths, b.valid, b.has_qual)
    lens_b = pack_lengths(b.lengths, b.valid)
    # adam-tpu: noqa[host-sync] reason=the audit reference's tensors are on the CPU (above): numpy() is a view, no d2h
    return PackedColumns(quals=PackedQuals(pq[: int(lens_q.sum())].numpy(), lens_q),
                         # adam-tpu: noqa[host-sync] reason=as for quals above: a CPU tensor's view
                         bases=PackedQuals(pb[: int(lens_b.sum())].numpy(), lens_b))


def packed_equal(a, b) -> bool:
    """Whether two windows' packed columns are the same bytes (the SDC
    audit's verdict)."""
    return all(np.array_equal(x.buf, y.buf) and np.array_equal(x.lens, y.lens)
               for x, y in ((a.quals, b.quals), (a.bases, b.bases)))


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
        [apply_recalibration_placed(c, rw, table_dev) for c, rw in placed])


def apply_recalibration(ds: AlignmentDataset, phred_table: np.ndarray, gl: int,
                        device: str = "cuda") -> AlignmentDataset:
    """Apply a solved host table (u8 ``[n_rg, 94, 2*gl+1, 17]``) to a
    dataset, JAX's call: the rows and the table are placed on ``device``
    (default: the card) here, then :func:`apply_placed` gathers.  ``gl``
    is the table's lane count; the gather centres on the table's own
    cycle axis, as JAX's device gather does."""
    from adam_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    table_dev = torch.from_numpy(np.ascontiguousarray(phred_table, np.uint8)).to(dev)
    return apply_placed(place_chunks(ds, dev), table_dev)


def apply_recalibration_placed(ds: AlignmentDataset, rw, table_dev) -> AlignmentDataset:
    """Gather a solved table into one placed dataset's quals (reported
    quality >= Q5 only) and stash the pre-recalibration quals as OQ ->
    the recalibrated dataset."""
    with _tele.TRACE.span(_tele.SPAN_BQSR_APPLY_HOST, backend="device"):
        b = ds.batch.to_numpy()
        from adam_tpu_torch.utils.transfer import device_fetch

        n_rg, _, n_cyc, _ = table_dev.shape
        with _tele.TRACE.span(_tele.SPAN_BQSR_APPLY_DISPATCH, backend="device"):
            # adam-tpu: noqa[dispatch-ledger] reason=the dataset-level apply runs without a device pool, so no prewarm precedes it and its first launch is in-window by design (the single-device path's "default" ledger key); the JAX package's bqsr.apply entry warms its streamed unpacked apply, which the port does not have
            new_q = _dispatch(
                ("bqsr.apply", rw.g, rw.gl, n_rg, n_cyc), rw, None,
                lambda: apply_table_body(
                    *rw.args(), *(_placer(rw, None)(a) for a in _apply_host_masks(b, rw.g)),
                    table_dev, rw.gl))
        with _tele.TRACE.span(_tele.SPAN_BQSR_APPLY_FETCH):
            new_q = np.ascontiguousarray(
                device_fetch(new_q[: b.n_rows, : b.lmax], rw.slot))
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
