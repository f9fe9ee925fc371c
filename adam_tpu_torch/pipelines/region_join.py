"""Region joins, coverage and sorted pairing on tensors — the port of
``adam_tpu/pipelines/region_join.py``.

* :class:`NonoverlappingRegions` / :func:`broadcast_region_join` — the
  semantics of ``rdd/BroadcastRegionJoin.scala`` (:65-130): a merged-region
  index of the left side, each right interval keyed by binary search (one
  ``searchsorted`` over the whole batch), the join within groups.
* :func:`shuffle_region_join` — ``rdd/ShuffleRegionJoin.scala`` (:72-134):
  fixed-size genome bins, both sides replicated into every bin they
  overlap, a join per bin, and the dedupe rule that a pair is emitted only
  where at least one side *starts* in the bin.
* :func:`find_coverage_regions` — ``rdd/Coverage.scala:55-190``.
* :func:`sliding` / :func:`pair` / :func:`pair_with_ends` —
  ``rdd/PairingRDD.scala:54-130`` over sorted tensors.

The joins run on the device of their :class:`IntervalArrays`, whose
``of`` places the columns on ``device`` (default ``"cuda"``).  The JAX
package runs this module as host numpy; every value is an integer, so
the index pairs and counts are its arrays element for element.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from adam_tpu_torch.models.dictionaries import SequenceDictionary
from adam_tpu_torch.ops import intervals as iv
from adam_tpu_torch.parallel.partitioner import GenomeBins


@dataclass(frozen=True)
class IntervalArrays:
    """Columnar interval set: i64 tensors on one device, the argument and
    return type of the joins."""

    contig: torch.Tensor  # i64[N] contig index into a SequenceDictionary
    start: torch.Tensor   # i64[N]
    end: torch.Tensor     # i64[N]

    def __len__(self) -> int:
        return int(self.start.numel())

    @property
    def device(self) -> torch.device:
        return self.start.device

    @staticmethod
    def of(contig, start, end, device="cuda") -> "IntervalArrays":
        """Columns (tensors or array-likes) -> i64 tensors on ``device``
        (default the card; ``"cpu"`` is the only way onto the CPU)."""
        from adam_tpu_torch.device import resolve_device

        dev = resolve_device(device)

        def put(x):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.asarray(x, np.int64))
            return x.to(device=dev, dtype=torch.int64)

        return IntervalArrays(put(contig), put(start), put(end))

    def take(self, idx) -> "IntervalArrays":
        return IntervalArrays(self.contig[idx], self.start[idx], self.end[idx])


class NonoverlappingRegions:
    """Merged-region index over an interval set — the broadcast side
    (BroadcastRegionJoin.scala:197-227): sorted columnar groups, queried
    as contiguous group-id ranges by two vectorized searches."""

    def __init__(self, regions: IntervalArrays):
        if len(regions) == 0:
            raise ValueError("regions list must be non-empty")
        m_c, m_s, m_e, group = iv.merge_intervals(
            regions.contig, regions.start, regions.end)
        self.m_contig, self.m_start, self.m_end = m_c, m_s, m_e
        self.group_of_input = group

    def __len__(self) -> int:
        return int(self.m_start.numel())

    def regions_for(self, query: IntervalArrays):
        """Per-query [lo, hi) merged-group range (findOverlappingRegions)."""
        return iv.overlap_group_ranges(self.m_contig, self.m_start, self.m_end,
                                       query.contig, query.start, query.end)

    def has_regions_for(self, query: IntervalArrays) -> torch.Tensor:
        lo, hi = self.regions_for(query)
        return hi > lo


def broadcast_region_join(left: IntervalArrays, right: IntervalArrays):
    """(li, ri) index pairs of overlapping left/right intervals
    (BroadcastRegionJoin.partitionAndJoin, :65-130); callers gather their
    payloads with the returned indices."""
    return iv.overlap_join(left.contig, left.start, left.end,
                           right.contig, right.start, right.end)


def bin_ranges(bins: GenomeBins, ia: IntervalArrays):
    """[start_bin, end_bin + 1) of each interval, on its device
    (:meth:`GenomeBins.start_bin` / :meth:`GenomeBins.end_bin` on
    tensors)."""
    dev = ia.device
    off = torch.from_numpy(np.asarray(bins.bin_offsets, np.int64)).to(dev)
    last = torch.from_numpy(np.asarray(bins.bins_per_contig, np.int64) - 1).to(dev)
    base, cap = off[ia.contig], last[ia.contig]
    lo = base + torch.minimum(ia.start // bins.bin_size, cap)
    hi = base + torch.minimum(torch.clamp(ia.end - 1, min=0) // bins.bin_size, cap) + 1
    return lo, hi


def in_dictionary(ia: IntervalArrays, seq_dict: SequenceDictionary) -> torch.Tensor:
    """Row indices whose contig lies inside the dictionary."""
    return torch.nonzero((ia.contig >= 0) & (ia.contig < len(seq_dict.names))).flatten()


def shuffle_region_join(left: IntervalArrays, right: IntervalArrays,
                        seq_dict: SequenceDictionary, bin_size: int = 1_000_000):
    """(li, ri) overlap pairs by a genome-binned join
    (ShuffleRegionJoin.partitionAndJoin, :72-134): both sides replicated
    into every bin they overlap, each bin joined alone, and a pair kept
    only where at least one side starts inside the bin (the dedupe rule,
    ShuffleRegionJoin.scala:262-267)."""
    bins = GenomeBins(bin_size, seq_dict)
    dev = left.device
    # rows on contigs outside the dictionary cannot land in any genome
    # bin: excluded rather than crashing
    l_keep = in_dictionary(left, seq_dict)
    r_keep = in_dictionary(right, seq_dict)
    if l_keep.numel() < len(left) or r_keep.numel() < len(right):
        li, ri = shuffle_region_join(left.take(l_keep), right.take(r_keep),
                                     seq_dict, bin_size)
        return l_keep[li], r_keep[ri]

    li_rep, l_bin = iv.expand_ranges(*bin_ranges(bins, left))
    ri_rep, r_bin = iv.expand_ranges(*bin_ranges(bins, right))
    # per-bin independent joins over the bins both sides touch
    l_uniq = torch.unique(l_bin)
    active = l_uniq[torch.isin(l_uniq, r_bin)].cpu().tolist()
    l_bin_sorted, l_order = torch.sort(l_bin, stable=True)
    r_bin_sorted, r_order = torch.sort(r_bin, stable=True)
    probe = torch.tensor(active, dtype=torch.int64, device=dev)
    l_lo = torch.searchsorted(l_bin_sorted, probe).cpu().tolist()
    l_hi = torch.searchsorted(l_bin_sorted, probe, right=True).cpu().tolist()
    r_lo = torch.searchsorted(r_bin_sorted, probe).cpu().tolist()
    r_hi = torch.searchsorted(r_bin_sorted, probe, right=True).cpu().tolist()
    out_l, out_r = [], []
    for k, b in enumerate(active):
        lsel = li_rep[l_order[l_lo[k]:l_hi[k]]]
        rsel = ri_rep[r_order[r_lo[k]:r_hi[k]]]
        pl, pr = iv.overlap_join(left.contig[lsel], left.start[lsel], left.end[lsel],
                                 right.contig[rsel], right.start[rsel], right.end[rsel])
        if pl.numel() == 0:
            continue
        gl, gr = lsel[pl], rsel[pr]
        _, bstart, bend = bins.dedupe_region(int(b))
        ls, rs = left.start[gl], right.start[gr]
        keep = ((ls >= bstart) & (ls < bend)) | ((rs >= bstart) & (rs < bend))
        out_l.append(gl[keep])
        out_r.append(gr[keep])
    if not out_l:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z
    return torch.cat(out_l), torch.cat(out_r)


def find_coverage_regions(regions: IntervalArrays) -> IntervalArrays:
    """Minimal disjoint non-adjacent covering set (Coverage.scala:55-78)."""
    m_c, m_s, m_e, _ = iv.merge_intervals(regions.contig, regions.start,
                                          regions.end, adjacent=True)
    return IntervalArrays(m_c, m_s, m_e)


def depth_at(sites: IntervalArrays, reads: IntervalArrays) -> torch.Tensor:
    """Read depth at each site start (the ``depth`` command's core,
    adam-cli CalculateDepth.scala:41)."""
    return iv.point_depth(reads.contig, reads.start, reads.end,
                          sites.contig, sites.start)


# ------------------------------------------------------------- pairing

def sliding(sorted_values: torch.Tensor, width: int) -> torch.Tensor:
    """All width-length windows of a sorted tensor, in order
    (PairingRDD.sliding, rdd/PairingRDD.scala:54-68) -> ``[N-width+1,
    width]``, a view."""
    v = torch.as_tensor(sorted_values)
    if v.shape[0] < width:
        return v[:0].reshape(0, width)
    return v.unfold(0, width, 1)


def pair(sorted_values: torch.Tensor):
    """Consecutive pairs (PairingRDD.pair, :82-87)."""
    v = torch.as_tensor(sorted_values)
    return v[:-1], v[1:]


def pair_with_ends(sorted_values: torch.Tensor):
    """Consecutive pairs with None-padded ends (PairingRDD.pairWithEnds,
    :108-128) as host lists of optional values."""
    v = torch.as_tensor(sorted_values).tolist()
    if not v:
        return []
    padded = [None] + v + [None]
    return list(zip(padded[:-1], padded[1:]))
