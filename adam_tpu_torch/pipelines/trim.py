"""Read trimming, fixed-length and adaptive — the port's counterpart of
``adam_tpu/pipelines/trim.py`` (the host code copied).

* ``trim_reads(ds, trim_start, trim_end)`` — fixed trim of every read
  (the reference's ``TrimReads.apply``): drops bases and quals, rewrites
  the CIGAR with hard clips (excising deletions and reference skips that
  are trimmed through), shifts ``start``/``end`` when alignment-match
  bases are trimmed, and trims the MD tag.
* ``trim_low_quality_read_groups(ds, phred_threshold)`` — the adaptive
  variant: a mean quality profile per (read group, cycle), then the
  leading and trailing cycles whose mean phred is below the threshold are
  trimmed from that group's reads.

The quality profile runs on the device as an integer histogram of
(read group, cycle, quality) residue counts; the host folds it into the
sum of log success probabilities with f64 arithmetic in one fixed order,
so the card and the CPU give the same sums bit for bit (the JAX body
scatter-adds the f64 logs, in another order).  Base/qual trimming is a
vectorized shift of the batch columns; the CIGAR and MD rewrite runs on
the host, per trimmed row.
"""

from __future__ import annotations

import logging
from dataclasses import replace as dc_replace

import numpy as np
import torch

from adam_tpu_torch.api.datasets import AlignmentDataset
from adam_tpu_torch.device import resolve_device
from adam_tpu_torch.formats import schema
from adam_tpu_torch.formats.batch import ReadBatch
from adam_tpu_torch.ops.phred import PHRED_TO_SUCCESS

#: log success probability per phred value (f64; phred 0 gives -inf)
with np.errstate(divide="ignore"):
    _LOG_SUCCESS = np.log(PHRED_TO_SUCCESS)

# ------------------------------------------------------------------ profile


def quality_histogram(quals, lengths, read_group_idx, valid, has_qual, n_rg: int):
    """Residue counts per (read group, cycle, phred) -> i64[n_rg + 1, L, 256]
    on the tensors' device.  Only in-read residues of valid reads with a
    quality string count; reads with no read group land in bin ``n_rg``
    (the reference keys them by a null record-group name)."""
    n, lmax = quals.shape
    dev = quals.device
    pos_ok = (torch.arange(lmax, device=dev)[None, :] < lengths[:, None]) & (
        valid & has_qual)[:, None]
    rg = torch.where(read_group_idx < 0, n_rg, read_group_idx).to(torch.int64)
    bins = (rg[:, None] * lmax + torch.arange(lmax, device=dev)[None, :]) * 256 \
        + quals.to(torch.int64)
    counts = torch.bincount(bins[pos_ok], minlength=(n_rg + 1) * lmax * 256)
    return counts.reshape(n_rg + 1, lmax, 256)


def quality_profile(batch: ReadBatch, n_rg: int, device: str = "cuda"):
    """Sum of log success probabilities and residue counts per (read
    group, cycle) -> (f64[n_rg + 1, L], i64[n_rg + 1, L]).  The counts
    come from :func:`quality_histogram` on ``device``; the sums are
    ``sum_q count[q] * log(success(q))`` over q = 0..255 on the host."""
    dev = resolve_device(device)
    b = batch.to_numpy()

    def put(name):
        return torch.from_numpy(np.ascontiguousarray(getattr(b, name))).to(dev)

    hist = quality_histogram(put("quals"), put("lengths"), put("read_group_idx"),
                             put("valid"), put("has_qual"), n_rg).cpu().numpy()
    counts = hist.sum(axis=2)
    with np.errstate(invalid="ignore"):  # 0 * -inf where phred 0 never occurs
        terms = np.where(hist > 0, hist * _LOG_SUCCESS[None, None, :], 0.0)
    return terms.sum(axis=2), counts


def mean_quality_profile(batch: ReadBatch, n_rg: int, device: str = "cuda"):
    """Per-(rg, cycle) mean phred: successProbabilityToPhred(exp(sum/count))
    (TrimReads.scala), -1 where no residue counts."""
    sums, counts = quality_profile(batch, n_rg, device)
    means = np.full(sums.shape, -1, np.int64)
    nz = counts > 0
    succ = np.exp(sums[nz] / counts[nz])
    means[nz] = np.floor(-10.0 * np.log10(1.0 - succ) + 0.5).astype(np.int64)
    return means, counts


def trim_lengths(mean_quals: np.ndarray, counts: np.ndarray, threshold: int):
    """takeWhile(mean < threshold) from each end (TrimReads.scala)."""
    idx = np.flatnonzero(counts > 0)
    if idx.size == 0:
        return 0, 0
    quals = mean_quals[idx]
    below = quals < threshold
    if below.all():
        # every cycle fails the threshold: the whole read would go —
        # callers with strict=False then skip the group entirely
        logging.getLogger(__name__).warning(
            "trim: every cycle of a read group's quality profile is below "
            "threshold %d; reads in this group will be left untrimmed "
            "unless strict", threshold,
        )
        return len(quals), 0
    return int(np.argmin(below)), int(np.argmin(below[::-1]))


# ------------------------------------------------------------- cigar / md


def trim_cigar(
    ops: np.ndarray, lens: np.ndarray, n: int, trim_start: int, trim_end: int,
    start: int, end: int,
):
    """Trim a CIGAR -> ``(elems, new_start, new_end, aligned_front,
    aligned_back)``.

    TrimReads.trimCigar: D/N runs hit while trimming are excised whole
    (advancing the reference coordinate by their full length); trimmed
    segments are replaced with hard clips.  Existing H/P operators
    consume no read bases, so they never count against the trim budget:
    leading/trailing hard clips merge into the emitted clip run.
    ``aligned_front``/``aligned_back`` are the M/=/X bases trimmed from
    each end, the counts MD trimming needs.
    """
    elems = [(int(lens[i]), int(ops[i])) for i in range(n)]

    def trim_front(elems, trim, pos, step):
        out = list(elems)
        h = 0  # existing hard clips on this end, merged into the new clip
        aligned = 0
        while out and out[0][1] == schema.CIGAR_H:
            h += out.pop(0)[0]
        while trim > 0 and out:
            ln, op = out[0]
            if op in (schema.CIGAR_D, schema.CIGAR_N):
                out.pop(0)
                pos += step * ln
                continue
            if op in (schema.CIGAR_H, schema.CIGAR_P):
                out.pop(0)  # consumes no read bases; budget untouched
                continue
            if ln == 1:
                out.pop(0)
            else:
                out[0] = (ln - 1, op)
            if op in (schema.CIGAR_M, schema.CIGAR_EQ, schema.CIGAR_X):
                pos += step
                aligned += 1
            trim -= 1
        return out, pos, h, aligned

    elems, start, h_front, al_front = trim_front(elems, trim_start, start, +1)
    rev, end, h_back, al_back = trim_front(elems[::-1], trim_end, end, -1)
    elems = rev[::-1]
    if trim_start + h_front > 0:
        elems.insert(0, (trim_start + h_front, schema.CIGAR_H))
    if trim_end + h_back > 0:
        elems.append((trim_end + h_back, schema.CIGAR_H))
    return elems, start, end, al_front, al_back


def _md_tokens(md: str) -> list:
    """MD string -> [int match | 'A' mismatch | '^ACG' deletion] tokens."""
    toks, i = [], 0
    while i < len(md):
        c = md[i]
        if c.isdigit():
            j = i
            while j < len(md) and md[j].isdigit():
                j += 1
            toks.append(int(md[i:j]))
            i = j
        elif c == "^":
            j = i + 1
            while j < len(md) and md[j].isalpha():
                j += 1
            toks.append(md[i:j])
            i = j
        else:
            toks.append(c)
            i += 1
    return toks


def _md_string(toks: list) -> str:
    """Emit tokens with match counts (0 where absent) between events."""
    out, need_num = [], True
    for t in toks:
        if isinstance(t, int):
            out.append(str(t))
            need_num = False
        else:
            if need_num:
                out.append("0")
            out.append(t)
            need_num = True
    if need_num:
        out.append("0")
    return "".join(out)


def trim_md_tag(md: str, trim_start: int, trim_end: int) -> str:
    """Trim aligned bases off an MD tag (TrimReads.trimMdTag).  Deletions
    hit while trimming are excised without consuming trim length."""
    toks = _md_tokens(md)

    def trim_front(toks, trim):
        out = list(toks)
        while trim > 0 and out:
            t = out[0]
            if isinstance(t, str) and t.startswith("^"):
                out.pop(0)
            elif isinstance(t, str):
                out.pop(0)
                trim -= 1
            else:  # match run
                if t == 0:
                    out.pop(0)
                else:
                    out[0] = t - 1
                    trim -= 1
        return out

    toks = trim_front(toks, trim_start)
    toks = trim_front(toks[::-1], trim_end)[::-1]
    return _md_string(toks)


# ------------------------------------------------------------------- apply


def _shift_columns(b: ReadBatch, ts: int, te: int, rows: np.ndarray) -> ReadBatch:
    """Vectorized drop of ts leading / te trailing bases for ``rows``."""
    bases = np.array(b.bases)
    quals = np.array(b.quals)
    lengths = np.array(b.lengths)
    lmax = bases.shape[1]
    new_len = np.maximum(lengths[rows] - ts - te, 0)
    keep = np.arange(lmax)[None, :] < new_len[:, None]
    pad_cols = ((0, 0), (0, ts))
    g = np.pad(bases[rows][:, ts:], pad_cols, constant_values=schema.BASE_PAD)
    bases[rows] = np.where(keep, g, schema.BASE_PAD)
    gq = np.pad(quals[rows][:, ts:], pad_cols, constant_values=schema.QUAL_PAD)
    quals[rows] = np.where(keep, gq, schema.QUAL_PAD)
    lengths[rows] = new_len
    return b.replace(bases=bases, quals=quals, lengths=lengths)


def trim_reads(
    ds: AlignmentDataset, trim_start: int = -1, trim_end: int = -1,
    rg_idx: int | None = None, strict: bool = True,
) -> AlignmentDataset:
    """Fixed trim of ``trim_start``/``trim_end`` bases (negative = 0).

    ``rg_idx`` restricts the trim to one read group.  With
    ``strict=False``, reads too short for the trim are left untouched
    instead of raising (the adaptive path: a group's profile-derived trim
    must not be fatal for its shortest reads).
    """
    ts, te = max(trim_start, 0), max(trim_end, 0)
    if ts == 0 and te == 0:
        return ds
    b = ds.batch.to_numpy()
    side = ds.sidecar
    mask = np.asarray(b.valid).copy()
    if rg_idx is not None:
        mask &= np.asarray(b.read_group_idx) == rg_idx
    too_short = np.asarray(b.lengths) <= ts + te
    if strict and bool((mask & too_short).any()):
        raise ValueError("cannot trim more than the length of the read")
    mask &= ~too_short
    rows = np.flatnonzero(mask)
    if rows.size == 0:
        return ds

    b = _shift_columns(b, ts, te, rows)

    # CIGAR / start / end / MD rewrite, host-side per affected row
    cigar_ops = np.array(b.cigar_ops)
    cigar_lens = np.array(b.cigar_lens)
    cigar_n = np.array(b.cigar_n)
    start = np.array(b.start)
    end = np.array(b.end)
    new_md = side.md.to_list()
    new_elems: dict[int, list] = {}
    cmax = b.cmax
    for i in rows:
        i = int(i)
        if cigar_n[i] == 0:
            continue
        elems, s, e, al_front, al_back = trim_cigar(
            cigar_ops[i], cigar_lens[i], int(cigar_n[i]), ts, te,
            int(start[i]), int(end[i]),
        )
        new_elems[i] = elems
        start[i], end[i] = s, e
        if new_md[i] is not None:
            # MD covers aligned bases only: trim it by the M/=/X bases
            # removed, not by the raw read-base trim
            new_md[i] = trim_md_tag(new_md[i], al_front, al_back)
        cmax = max(cmax, len(elems))
    if cmax > b.cmax:
        b = b.widen(b.lmax, cmax)
        cigar_ops = np.array(b.cigar_ops)
        cigar_lens = np.array(b.cigar_lens)
    for i, elems in new_elems.items():
        cigar_ops[i] = schema.CIGAR_PAD
        cigar_lens[i] = 0
        for j, (ln, op) in enumerate(elems):
            cigar_ops[i, j] = op
            cigar_lens[i, j] = ln
        cigar_n[i] = len(elems)

    b = b.replace(
        cigar_ops=cigar_ops, cigar_lens=cigar_lens, cigar_n=cigar_n,
        start=start, end=end,
    )
    side = dc_replace(
        side,
        md=new_md,
        trimmed_from_start=side.trimmed_from_start + np.where(mask, ts, 0),
        trimmed_from_end=side.trimmed_from_end + np.where(mask, te, 0),
    )
    return ds.with_batch(b, side)


def trim_low_quality_read_groups(
    ds: AlignmentDataset, phred_threshold: int = 20, device: str = "cuda",
) -> AlignmentDataset:
    """Adaptive trim: per-read-group mean quality profile (on ``device``),
    trim the cycles below ``phred_threshold`` from each end."""
    n_rg = len(ds.header.read_groups.names)
    means, counts = mean_quality_profile(ds.batch, n_rg, device)
    out = ds
    for rg in range(n_rg + 1):
        ts, te = trim_lengths(means[rg], counts[rg], phred_threshold)
        if ts == 0 and te == 0:
            continue
        out = trim_reads(
            out, ts, te, rg_idx=rg if rg < n_rg else -1, strict=False
        )
    return out
