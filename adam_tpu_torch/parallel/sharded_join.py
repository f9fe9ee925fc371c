"""Out-of-core region join and depth over genome-bin shards — the port of
``adam_tpu/parallel/sharded_join.py``.

The streamed (big) side goes through a per-genome-bin interval spill on
disk (host file I/O, as in the JAX package), and each bin is then loaded
and joined alone on the device of the resident side, so peak memory is
one ingest window plus one bin, never the dataset.

Halo handling: an interval spanning a bin edge is replicated into every
bin it overlaps (``start_bin..end_bin``), as the reference replicates
(ShuffleRegionJoin.scala:112-121); the pair-level dedupe is the
reference's "at least one side starts in this bin" rule, and a point
site's single owning bin counts every replica that reaches it.
"""

from __future__ import annotations

import os
import tempfile
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from adam_tpu_torch.models.dictionaries import SequenceDictionary
from adam_tpu_torch.ops import intervals as iv
from adam_tpu_torch.parallel.partitioner import GenomeBins
from adam_tpu_torch.pipelines.region_join import IntervalArrays, bin_ranges, in_dictionary


class BinnedIntervalSpill:
    """Append-only per-genome-bin spill of (contig, start, end, row_id)
    rows as raw little-endian i64 quadruples, one ``bin-NNNNNN.i64`` file
    per touched bin; appends replicate each interval into every bin it
    overlaps.  Only the appended batch is ever resident."""

    _ROW = 4  # i64 fields per spilled interval

    def __init__(self, bins: GenomeBins, workdir: Optional[str] = None):
        self.bins = bins
        self._own = workdir is None
        self._dir = workdir or tempfile.mkdtemp(prefix="adam_tpu_torch_binspill_")
        os.makedirs(self._dir, exist_ok=True)
        # appends open in "ab" mode: a crashed earlier run's bin files in
        # this workdir would corrupt the counts, so they go first
        for name in os.listdir(self._dir):
            if name.startswith("bin-") and name.endswith(".i64"):
                os.unlink(os.path.join(self._dir, name))
        self._counts: dict[int, int] = {}

    def _path(self, b: int) -> str:
        return os.path.join(self._dir, f"bin-{b:06d}.i64")

    def append(self, contig, start, end, row_id) -> None:
        contig = np.asarray(contig, np.int64)
        start = np.asarray(start, np.int64)
        end = np.asarray(end, np.int64)
        row_id = np.asarray(row_id, np.int64)
        if len(contig) == 0:
            return
        lo = self.bins.start_bin(contig, start)
        hi = self.bins.end_bin(contig, end) + 1
        rep, rbin = (t.numpy() for t in iv.expand_ranges(lo, hi))
        order = np.argsort(rbin, kind="stable")
        rep, rbin = rep[order], rbin[order]
        edges = np.flatnonzero(np.concatenate([[True], rbin[1:] != rbin[:-1]]))
        bounds = np.concatenate([edges, [len(rbin)]])
        for k in range(len(edges)):
            b = int(rbin[edges[k]])
            rows = rep[bounds[k]: bounds[k + 1]]
            mat = np.empty((len(rows), self._ROW), np.int64)
            mat[:, 0] = contig[rows]
            mat[:, 1] = start[rows]
            mat[:, 2] = end[rows]
            mat[:, 3] = row_id[rows]
            # open per write: a genome touches thousands of bins, and
            # persistent handles would exhaust the descriptor limit
            self._counts.setdefault(b, 0)
            with open(self._path(b), "ab") as fh:
                fh.write(mat.astype("<i8", copy=False).tobytes())
            self._counts[b] += len(rows)

    def touched_bins(self) -> list[int]:
        return sorted(self._counts)

    def read_bin(self, b: int, device) -> tuple[IntervalArrays, torch.Tensor]:
        """-> (intervals, row ids) of one bin's spilled rows, on ``device``."""
        with open(self._path(b), "rb") as fh:
            mat = np.frombuffer(fh.read(), "<i8").astype(np.int64).reshape(-1, self._ROW)
        ids = torch.from_numpy(mat[:, 3].copy()).to(device)
        return IntervalArrays.of(mat[:, 0], mat[:, 1], mat[:, 2], device=device), ids

    def cleanup(self) -> None:
        for b in list(self._counts):
            try:
                os.unlink(self._path(b))
            except OSError:
                pass
        if self._own:
            try:
                os.rmdir(self._dir)
            except OSError:
                pass


def _spill_batches(batches: Iterable, bins: GenomeBins,
                   workdir: Optional[str]) -> tuple[BinnedIntervalSpill, int]:
    """Stream (ReadBatch, sidecar, header) triples into a binned interval
    spill of their mapped reads -> (spill, total rows consumed).  Only the
    coordinate columns are read."""
    spill = BinnedIntervalSpill(bins, workdir)
    n_contigs = len(bins.seq_dict.names)
    offset = 0
    try:
        for b, _side, _header in batches:
            contig_idx = np.asarray(b.contig_idx)
            start = np.asarray(b.start)
            # start >= 0 guards records flagged mapped with POS=0
            # (start == -1), which start_bin would put one bin before
            # their contig's first
            keep = np.flatnonzero(
                np.asarray(b.valid) & np.asarray(b.is_mapped)
                & (contig_idx >= 0) & (contig_idx < n_contigs) & (start >= 0)
            )
            spill.append(contig_idx[keep], start[keep], np.asarray(b.end)[keep],
                         keep + offset)
            offset += b.n_rows
    except BaseException:
        # a failure mid-ingest must not strand the bin files
        spill.cleanup()
        raise
    return spill, offset


def streamed_depth(batches: Iterable, sites: IntervalArrays,
                   seq_dict: SequenceDictionary, bin_size: int = 1_000_000,
                   workdir: Optional[str] = None) -> torch.Tensor:
    """Read depth at each site start, out of core -> i64[len(sites)] on
    the sites' device: each bin's reads are joined there with the sites
    that bin owns.  Equal to the resident ``point_depth`` (a read that
    overlaps a site's position is, by the halo replication, in the site's
    owning bin, and each site is counted in exactly one bin)."""
    bins = GenomeBins(bin_size, seq_dict)
    dev = sites.device
    spill, _n = _spill_batches(batches, bins, workdir)
    depth = torch.zeros(len(sites), dtype=torch.int64, device=dev)
    rows = in_dictionary(sites, seq_dict)
    site_bin = torch.full((len(sites),), -1, dtype=torch.int64, device=dev)
    site_bin[rows] = bin_ranges(bins, sites.take(rows))[0]
    site_bin = site_bin.cpu().numpy()
    try:
        for b in spill.touched_bins():
            sel = np.flatnonzero(site_bin == b)
            if len(sel) == 0:
                continue
            reads, _ids = spill.read_bin(b, dev)
            sel_t = torch.from_numpy(sel).to(dev)
            depth[sel_t] = iv.point_depth(reads.contig, reads.start, reads.end,
                                          sites.contig[sel_t], sites.start[sel_t])
    finally:
        spill.cleanup()
    return depth


def streamed_overlap_join(batches: Iterable, right: IntervalArrays,
                          seq_dict: SequenceDictionary, bin_size: int = 1_000_000,
                          workdir: Optional[str] = None
                          ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """Out-of-core shuffle region join: streamed left batches x resident
    right intervals -> per-bin (left_row_id, right_index) overlap pairs,
    on the right side's device.  The per-bin join plus the reference's
    dedupe rule (a pair only in bins where at least one side starts,
    ShuffleRegionJoin.scala:262-267), so halo replicas never emit twice.
    Left row ids count over the whole stream."""
    bins = GenomeBins(bin_size, seq_dict)
    dev = right.device
    spill, _n = _spill_batches(batches, bins, workdir)
    r_keep = in_dictionary(right, seq_dict)
    rr, rbin = iv.expand_ranges(*bin_ranges(bins, right.take(r_keep)))
    rbin_sorted, r_order = torch.sort(rbin, stable=True)
    rr = rr[r_order]
    try:
        for b in spill.touched_bins():
            lo = int(torch.searchsorted(rbin_sorted, torch.tensor([b], device=dev)))
            hi = int(torch.searchsorted(rbin_sorted, torch.tensor([b], device=dev),
                                        right=True))
            if lo == hi:
                continue
            rsel = r_keep[rr[lo:hi]]
            reads, ids = spill.read_bin(b, dev)
            pl, pr = iv.overlap_join(reads.contig, reads.start, reads.end,
                                     right.contig[rsel], right.start[rsel], right.end[rsel])
            if pl.numel() == 0:
                continue
            gl, gr = ids[pl], rsel[pr]
            _, bstart, bend = bins.dedupe_region(int(b))
            ls, rs = reads.start[pl], right.start[gr]
            keep = ((ls >= bstart) & (ls < bend)) | ((rs >= bstart) & (rs < bend))
            if bool(keep.any()):
                yield gl[keep], gr[keep]
    finally:
        spill.cleanup()
