"""Interval primitives on tensors — the port of ``adam_tpu/ops/intervals.py``,
the engine under region joins, coverage and depth.

Intervals are columnar ``(contig, start, end)`` i64 tensors, and every
operation is a whole-array sort, scan or search on the tensors' device:
chained stable ``torch.sort`` for ``np.lexsort``, ``torch.cummax`` for
``np.maximum.accumulate``, ``torch.searchsorted``,
``torch.repeat_interleave`` for ``np.repeat`` and ``scatter_reduce("amax")``
for ``np.maximum.at``.  Every value is an integer, so the results equal
the JAX package's host numpy arrays element for element, in its order
(the sorts are stable wherever the order of ties shows).

Cross-contig totality uses :func:`~adam_tpu_torch.models.positions.
pack_position_key`: one flat sorted key array covers the whole genome
(the contig index dominates the position bits).

Inputs may be tensors or array-likes (numpy arrays land on the CPU);
outputs are i64 tensors on the inputs' device.
"""

from __future__ import annotations

import numpy as np
import torch

from adam_tpu_torch.models.positions import pack_position_key

_I64_MIN = torch.iinfo(torch.int64).min


def _i64(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64).contiguous()
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


def _empty(device) -> torch.Tensor:
    return torch.zeros(0, dtype=torch.int64, device=device)


def _lexsort(keys) -> torch.Tensor:
    """``np.lexsort(keys)`` (last key primary): stable sorts from the
    least significant key up, which is THE stable permutation."""
    perm = torch.arange(keys[0].numel(), device=keys[0].device)
    for k in keys:
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def sort_intervals(contig, start, end) -> torch.Tensor:
    """Permutation sorting intervals by (contig, start, end)."""
    contig = _i64(contig)
    return _lexsort((_i64(end, contig.device), _i64(start, contig.device), contig))


def merge_intervals(contig, start, end, adjacent: bool = True):
    """Union of intervals as one sort and running-max scan (the
    ``NonoverlappingRegions.mergeRegions`` / ``Coverage.collapseAdjacent``
    core, BroadcastRegionJoin.scala:191-211, Coverage.scala:133-166).

    With ``adjacent=True`` regions that touch end-to-start collapse too.
    Returns ``(m_contig, m_start, m_end, group_of_input)``:
    ``group_of_input[i]`` is the merged-group id of input interval ``i`` in
    input order; the merged groups are disjoint, non-adjacent and sorted
    by (contig, start)."""
    contig = _i64(contig)
    dev = contig.device
    start, end = _i64(start, dev), _i64(end, dev)
    n = start.numel()
    if n == 0:
        z = _empty(dev)
        return z, z, z, z
    perm = _lexsort((end, start, contig))
    c, s, e = contig[perm], start[perm], end[perm]
    # the running max of packed (contig, end) keys resets at contig
    # changes by itself (contig bits dominate): one flat cummax
    e_keys = pack_position_key(c, e)
    s_keys = pack_position_key(c, s)
    cummax_e = torch.cummax(e_keys, dim=0).values
    prev_reach = torch.cat([torch.full((1,), _I64_MIN, dtype=torch.int64, device=dev),
                            cummax_e[:-1]])
    boundary = s_keys > prev_reach if adjacent else s_keys >= prev_reach
    group_sorted = torch.cumsum(boundary, dim=0) - 1
    # adam-tpu: noqa[host-sync] reason=a data-dependent output size: torch sizes the merged intervals from a host int, where the JAX package merges on the host with numpy (no fetch to route)
    n_groups = int(group_sorted[-1]) + 1
    m_contig = c[boundary]
    m_start = s[boundary]
    m_end = torch.zeros(n_groups, dtype=torch.int64, device=dev).scatter_reduce(
        0, group_sorted, e, reduce="amax", include_self=True)
    group_of_input = torch.empty(n, dtype=torch.int64, device=dev)
    group_of_input[perm] = group_sorted
    return m_contig, m_start, m_end, group_of_input


def overlap_group_ranges(m_contig, m_start, m_end, q_contig, q_start, q_end):
    """For each query interval, the range ``[lo, hi)`` of merged
    (disjoint, sorted) groups it overlaps: two ``searchsorted`` over packed
    (contig, pos) keys (the reference's ``binaryPointSearch`` walk,
    BroadcastRegionJoin.scala:213-227)."""
    m_contig = _i64(m_contig)
    dev = m_contig.device
    end_keys = pack_position_key(m_contig, _i64(m_end, dev)).contiguous()
    start_keys = pack_position_key(m_contig, _i64(m_start, dev)).contiguous()
    q_contig = _i64(q_contig, dev)
    q_start_keys = pack_position_key(q_contig, _i64(q_start, dev)).contiguous()
    q_end_keys = pack_position_key(q_contig, _i64(q_end, dev)).contiguous()
    # first group with (contig, end) > (contig, q_start)
    lo = torch.searchsorted(end_keys, q_start_keys, right=True)
    # first group with (contig, start) >= (contig, q_end)
    hi = torch.searchsorted(start_keys, q_end_keys, right=False)
    return lo, torch.maximum(hi, lo)


def expand_ranges(lo, hi):
    """Flatten per-query ``[lo, hi)`` ranges into (query_idx, group_id)
    pairs (the reference's per-record flatMap over overlapped bins,
    ShuffleRegionJoin.scala:86-98)."""
    lo = _i64(lo)
    dev = lo.device
    hi = _i64(hi, dev)
    counts = hi - lo
    # adam-tpu: noqa[host-sync] reason=a data-dependent output size: repeat_interleave's output_size is a host int, where the JAX package expands the ranges on the host with numpy (no fetch to route)
    total = int(counts.sum()) if counts.numel() else 0
    if total == 0:
        return _empty(dev), _empty(dev)
    query_idx = torch.repeat_interleave(
        torch.arange(lo.numel(), device=dev), counts, output_size=total)
    # within-query offset: arange minus each query's starting cumsum
    starts = torch.cumsum(counts, dim=0) - counts
    offsets = torch.arange(total, device=dev) - torch.repeat_interleave(
        starts, counts, output_size=total)
    return query_idx, lo[query_idx] + offsets


def point_depth(contig, start, end, q_contig, q_pos) -> torch.Tensor:
    """Number of intervals covering each query point:
    count(start <= p) - count(end <= p) over packed keys (the counting
    core of the ``depth`` command, adam-cli CalculateDepth.scala:41)."""
    contig = _i64(contig)
    dev = contig.device
    skeys = torch.sort(pack_position_key(contig, _i64(start, dev))).values
    ekeys = torch.sort(pack_position_key(contig, _i64(end, dev))).values
    q = pack_position_key(_i64(q_contig, dev), _i64(q_pos, dev)).contiguous()
    return (torch.searchsorted(skeys, q, right=True)
            - torch.searchsorted(ekeys, q, right=True))


def overlap_join(l_contig, l_start, l_end, r_contig, r_start, r_end):
    """All (i, j) with left interval i overlapping right interval j, in
    the JAX package's order.

    Merge the left side into disjoint groups; each right overlaps a
    contiguous group range; expand the right ranges, group the lefts by
    group id (stable), emit each group's cross product and keep the
    pairs that really overlap."""
    l_contig = _i64(l_contig)
    dev = l_contig.device
    l_start, l_end = _i64(l_start, dev), _i64(l_end, dev)
    r_contig, r_start, r_end = _i64(r_contig, dev), _i64(r_start, dev), _i64(r_end, dev)
    if l_start.numel() == 0 or r_start.numel() == 0:
        return _empty(dev), _empty(dev)
    m_c, m_s, m_e, l_group = merge_intervals(l_contig, l_start, l_end)
    lo, hi = overlap_group_ranges(m_c, m_s, m_e, r_contig, r_start, r_end)
    rj, rg = expand_ranges(lo, hi)  # right rj participates in group rg
    if rj.numel() == 0:
        return _empty(dev), _empty(dev)
    l_group_sorted, l_order = torch.sort(l_group, stable=True)
    groups = torch.arange(m_s.numel(), device=dev)
    group_starts = torch.searchsorted(l_group_sorted, groups, right=False)
    group_ends = torch.searchsorted(l_group_sorted, groups, right=True)
    rep_r, slot = expand_ranges(group_starts[rg], group_ends[rg])
    li = l_order[slot]
    ri = rj[rep_r]
    keep = (l_end[li] > r_start[ri]) & (r_end[ri] > l_start[li])
    return li[keep], ri[keep]
