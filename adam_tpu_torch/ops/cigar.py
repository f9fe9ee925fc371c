"""Batched CIGAR walks — the subset of ``adam_tpu/ops/cigar.py`` the
streamed markdup + BQSR path needs: the 5' clipped position on tensors
(duplicate marking's key, computed on the device) and the per-base
reference positions on the host (the observe pass's aligned-residue
filter, through the native walk)."""

from __future__ import annotations

import numpy as np
import torch

from adam_tpu_torch.formats import schema


def five_prime_position(start, end, flags, cigar_ops, cigar_lens, cigar_n):
    """5' reference position with clipping -> i64[N]: the exclusive
    unclipped end for reverse-strand reads, the unclipped start
    otherwise (RichAlignmentRecord.fivePrimePosition semantics)."""
    C = cigar_ops.shape[-1]
    v = torch.arange(C, device=cigar_ops.device)[None, :] < cigar_n[:, None]
    ops = cigar_ops.to(torch.int32)
    clip = ((ops == schema.CIGAR_S) | (ops == schema.CIGAR_H)) & v
    lens = cigar_lens.to(torch.int64)
    lead = (lens * torch.cumprod(clip.to(torch.int64), dim=1)).sum(dim=1)
    run_pred = (clip | ~v).to(torch.int64)
    trail_run = torch.flip(torch.cumprod(torch.flip(run_pred, [1]), dim=1), [1])
    trail = (lens * clip.to(torch.int64) * trail_run).sum(dim=1)
    rev = (flags & schema.FLAG_REVERSE) != 0
    return torch.where(rev, end + trail, start - lead)


def reference_positions_np(cigar_ops, cigar_lens, cigar_n, start, lmax):
    """Per-base reference position of each read -> i64[N, lmax] (-1 for
    insertions, soft clips and padding lanes), by the native walk."""
    from adam_tpu_torch import native

    ops = np.asarray(cigar_ops)
    if ops.shape[1] == 0:
        return np.full((ops.shape[0], lmax), -1, np.int64)
    return native.ref_positions(cigar_ops, cigar_lens, cigar_n, start, lmax)
