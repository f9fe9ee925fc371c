"""Batched CIGAR walks on tensors — the port's counterpart of
``adam_tpu/ops/cigar.py`` (RichAlignmentRecord's referenceLengthFromCigar,
unclippedStart/End, fivePrimePosition and per-base referencePositions).

Every walk is a masked reduction over the ``[N, C]`` cigar columns, in
torch on the tensors' device; lengths and positions are i64 (the JAX
package runs with x64 on).  :func:`reference_positions_np` is the host
walk the observe pass's aligned-residue filter uses, through the native
library."""

from __future__ import annotations

import numpy as np
import torch

from adam_tpu_torch.formats import schema


def _table(table: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(table.astype(np.int64)).to(like.device)


def _valid_mask(cigar_ops, cigar_n):
    C = cigar_ops.shape[-1]
    return torch.arange(C, device=cigar_ops.device) < cigar_n[..., None]


def _is_clip(cigar_ops):
    ops = cigar_ops.to(torch.int32)
    return (ops == schema.CIGAR_S) | (ops == schema.CIGAR_H)


def reference_length(cigar_ops, cigar_lens, cigar_n):
    """Reference bases consumed by each read's CIGAR (M/D/N/=/X) -> i64[N]."""
    consumes = _table(schema.CIGAR_CONSUMES_REF, cigar_ops)[cigar_ops.long()]
    v = _valid_mask(cigar_ops, cigar_n)
    return (cigar_lens.to(torch.int64) * consumes * v).sum(dim=-1)


def query_length(cigar_ops, cigar_lens, cigar_n):
    """Query bases consumed (M/I/S/=/X) -> i32[N]."""
    consumes = _table(schema.CIGAR_CONSUMES_QUERY, cigar_ops)[cigar_ops.long()]
    v = _valid_mask(cigar_ops, cigar_n)
    return (cigar_lens.to(torch.int64) * consumes * v).sum(dim=-1).to(torch.int32)


def leading_clip(cigar_ops, cigar_lens, cigar_n):
    """Total clipped (S+H) length at the start of each read -> i64[N]."""
    clip = _is_clip(cigar_ops) & _valid_mask(cigar_ops, cigar_n)
    run = torch.cumprod(clip.to(torch.int64), dim=-1)  # 1 while still clipping
    return (cigar_lens.to(torch.int64) * run).sum(dim=-1)


def trailing_clip(cigar_ops, cigar_lens, cigar_n):
    """Total clipped (S+H) length at the end of each read -> i64[N].
    Padding lanes (past ``cigar_n``) do not break the trailing run; only
    real clip lanes count."""
    v = _valid_mask(cigar_ops, cigar_n)
    clip = _is_clip(cigar_ops) & v
    run_pred = (clip | ~v).to(torch.int64)
    run = torch.flip(torch.cumprod(torch.flip(run_pred, [-1]), dim=-1), [-1])
    return (cigar_lens.to(torch.int64) * clip.to(torch.int64) * run).sum(dim=-1)


def unclipped_start(start, cigar_ops, cigar_lens, cigar_n):
    """start - leading clips (RichAlignmentRecord.unclippedStart)."""
    return start - leading_clip(cigar_ops, cigar_lens, cigar_n)


def unclipped_end(end, cigar_ops, cigar_lens, cigar_n):
    """end + trailing clips; ``end`` is 0-based exclusive, and so is the
    result (the reference folds clip lengths onto the exclusive end)."""
    return end + trailing_clip(cigar_ops, cigar_lens, cigar_n)


def five_prime_position(start, end, flags, cigar_ops, cigar_lens, cigar_n):
    """5' reference position with clipping -> i64[N]: the exclusive
    unclipped end for reverse-strand reads, the unclipped start
    otherwise (RichAlignmentRecord.fivePrimePosition semantics)."""
    rev = (flags & schema.FLAG_REVERSE) != 0
    return torch.where(rev, unclipped_end(end, cigar_ops, cigar_lens, cigar_n),
                       unclipped_start(start, cigar_ops, cigar_lens, cigar_n))


def first_real_op(cigar_ops, cigar_n):
    """Code of each read's first non-clip op, ``CIGAR_PAD`` if none."""
    real = _valid_mask(cigar_ops, cigar_n) & ~_is_clip(cigar_ops)
    idx = torch.argmax(real.to(torch.int32), dim=-1)  # the first maximum
    got = torch.gather(cigar_ops, -1, idx[..., None])[..., 0]
    return torch.where(real.any(dim=-1), got,
                       torch.full_like(got, schema.CIGAR_PAD))


def reference_positions(cigar_ops, cigar_lens, cigar_n, start, lmax: int):
    """Per-base reference position of each read -> i64[N, lmax]: -1 for
    bases that do not map to the reference (insertions, soft clips) and
    for padding lanes (RichAlignmentRecord.referencePositions).  Each
    base finds its op by a binary search over the cumulative query spans
    (``torch.searchsorted``), so the working set stays ``[N, lmax]``."""
    ops = cigar_ops.long()
    consumes_q = _table(schema.CIGAR_CONSUMES_QUERY, cigar_ops)[ops]
    consumes_r = _table(schema.CIGAR_CONSUMES_REF, cigar_ops)[ops]
    v = _valid_mask(cigar_ops, cigar_n).to(torch.int64)
    lens = cigar_lens.to(torch.int64)
    qlen = lens * consumes_q * v
    rlen = lens * consumes_r * v
    q_end = torch.cumsum(qlen, dim=-1)
    q0 = q_end - qlen
    r0 = torch.cumsum(rlen, dim=-1) - rlen
    aligned = (consumes_q * consumes_r * v).bool()  # M/=/X
    n, C = ops.shape
    j = torch.arange(lmax, dtype=torch.int64, device=ops.device)
    if C == 0:
        return torch.full((n, lmax), -1, dtype=torch.int64, device=ops.device)
    # the first op whose query span ends after j (ops with no query span
    # share q_end with their predecessor, so right=True skips them)
    op_idx = torch.searchsorted(q_end.contiguous(), j.expand(n, lmax).contiguous(),
                                right=True)
    in_read = op_idx < C
    op_idx = torch.clamp(op_idx, max=C - 1)
    hit = torch.gather(aligned, 1, op_idx) & in_read
    pos = (start.to(torch.int64)[:, None] + torch.gather(r0, 1, op_idx)
           + (j[None, :] - torch.gather(q0, 1, op_idx)))
    return torch.where(hit, pos, -1)


def reference_positions_np(cigar_ops, cigar_lens, cigar_n, start, lmax):
    """Per-base reference position of each read -> i64[N, lmax] (-1 for
    insertions, soft clips and padding lanes), by the native walk."""
    from adam_tpu_torch import native

    ops = np.asarray(cigar_ops)
    if ops.shape[1] == 0:
        return np.full((ops.shape[0], lmax), -1, np.int64)
    return native.ref_positions(cigar_ops, cigar_lens, cigar_n, start, lmax)
