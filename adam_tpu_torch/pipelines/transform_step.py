"""The fused device "transform step" (the port's counterpart of
``adam_tpu/pipelines/transform_step.py``): the per-batch device work of
the flagship ``transform`` that needs no host-side strings, in one call
over tensors on one device.

1. markdup's device columns: the 5'-clipped positions and the phred >= 15
   scores;
2. BQSR observe: the covariate histogram, through kernel 1
   (``ops/observe.observe_hist``, ``csrc/observe_hist.cu``) on the card
   and its plain version on the CPU;
3. BQSR recalibrate: the table solved from those histograms, gathered
   into the quals;
4. the flagstat masked sums.

The JAX body is one ``jit``; here it is plain torch, with two host
syncs: the histograms come home for the f64 solve, as at the streamed
run's barrier 2, and the flagstat counts at the end.  The graft entry
(``__graft_entry__.py``) drives the JAX step with :func:`synthetic_batch`
and :func:`synthetic_masks`, which this module keeps as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from adam_tpu_torch.device import resolve_device
from adam_tpu_torch.formats import schema
from adam_tpu_torch.formats.batch import ReadBatch
from adam_tpu_torch.ops import cigar as cigar_ops
from adam_tpu_torch.ops import flagstat as fs
from adam_tpu_torch.pipelines import bqsr


def transform_step(batch: ReadBatch, residue_ok, is_mismatch, n_rg: int, lmax: int,
                   device: str = "cuda"):
    """-> (recalibrated ReadBatch on ``device``, aux dict): ``five_prime``
    and ``dup_score`` (i64[N]; JAX sums in i64 under x64), ``obs_total``
    and ``obs_mism`` (i64[n_rg, 94, 2*lmax+1, 17]) as tensors on ``device``, and
    ``flagstat``, the (failed, passed) :class:`FlagStatMetrics`.
    ``batch`` (host arrays or tensors) and the boolean ``[N, lmax]``
    residue masks move to ``device`` (default: the card) first."""
    dev = resolve_device(device)
    b = batch.to(dev)
    residue_ok = torch.as_tensor(residue_ok).to(dev)
    is_mismatch = torch.as_tensor(is_mismatch).to(dev)
    flags = b.flags
    read_ok = (
        b.valid
        & ((flags & schema.FLAG_UNMAPPED) == 0)
        & ((flags & (schema.FLAG_SECONDARY | schema.FLAG_SUPPLEMENTARY)) == 0)
        & ((flags & schema.FLAG_DUPLICATE) == 0)
        & ((flags & schema.FLAG_FAILED_QC) == 0)
        & b.has_qual
        & (b.mapq > 0)
        & (b.mapq != 255)
    )
    five_prime = cigar_ops.five_prime_position(
        b.start, b.end, flags, b.cigar_ops, b.cigar_lens, b.cigar_n)
    in_read = torch.arange(lmax, device=dev)[None, :] < b.lengths[:, None]
    q32 = b.quals.to(torch.int32)
    dup_score = torch.where(in_read & (q32 >= 15), q32, 0).sum(dim=1, dtype=torch.int64)
    total, mism = bqsr.observe_kernel(
        b.bases, b.quals, b.lengths, flags, b.read_group_idx,
        residue_ok, is_mismatch, read_ok, n_rg, lmax)
    new_quals = bqsr.recalibrate_kernel(
        b.bases, b.quals, b.lengths, flags, b.read_group_idx, b.has_qual, b.valid,
        total, mism, lmax)
    # adam-tpu: noqa[host-sync] reason=the JAX package's transform_step leaves the flagstat structs on device for its caller's to_ints (no device_fetch there either); one 2x18 count matrix per step
    counts = fs.flagstat_counts(flags, b.contig_idx, b.mate_contig_idx, b.mapq,
                                b.valid).cpu().numpy()
    aux = dict(
        five_prime=five_prime,
        dup_score=dup_score,
        obs_total=total,
        obs_mism=mism,
        flagstat=(fs.to_metrics(counts[0]), fs.to_metrics(counts[1])),
    )
    return b.replace(quals=new_quals), aux


def synthetic_batch(n_reads: int = 2048, read_len: int = 100,
                    n_contigs: int = 4, seed: int = 0) -> ReadBatch:
    """Random mapped reads (a host batch) for compile checks and
    benchmarks, the JAX package's, value for value."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(n_reads, read_len), dtype=np.uint8)
    quals = rng.integers(2, 41, size=(n_reads, read_len), dtype=np.uint8)
    lengths = np.full(n_reads, read_len, np.int32)
    flags = np.where(rng.random(n_reads) < 0.5, 0, 16).astype(np.int32)
    contig = rng.integers(0, n_contigs, n_reads).astype(np.int32)
    start = rng.integers(0, 1_000_000, n_reads).astype(np.int64)
    cigar_ops_arr = np.full((n_reads, 4), schema.CIGAR_PAD, np.uint8)
    cigar_lens = np.zeros((n_reads, 4), np.int32)
    cigar_ops_arr[:, 0] = schema.CIGAR_M
    cigar_lens[:, 0] = read_len
    return ReadBatch(
        bases=bases,
        quals=quals,
        lengths=lengths,
        flags=flags,
        contig_idx=contig,
        start=start,
        end=start + read_len,
        mapq=np.full(n_reads, 60, np.int32),
        cigar_ops=cigar_ops_arr,
        cigar_lens=cigar_lens,
        cigar_n=np.ones(n_reads, np.int32),
        mate_contig_idx=np.full(n_reads, -1, np.int32),
        mate_start=np.full(n_reads, -1, np.int64),
        tlen=np.zeros(n_reads, np.int32),
        read_group_idx=np.zeros(n_reads, np.int32),
        has_qual=np.ones(n_reads, bool),
        valid=np.ones(n_reads, bool),
    )


def synthetic_masks(batch: ReadBatch, mismatch_rate: float = 0.01, seed: int = 1):
    """Residue masks (host bool ``[N, L]``) standing in for the MD-derived
    columns."""
    rng = np.random.default_rng(seed)
    n, L = batch.bases.shape
    b = batch.to_numpy()
    residue_ok = (np.asarray(b.quals) > 0) & (np.asarray(b.bases) < 4)
    is_mm = rng.random((n, L)) < mismatch_rate
    return residue_ok, is_mm
