"""Genome-coordinate partitioning — the host half of
``adam_tpu/parallel/partitioner.py`` (the semantics of the reference's
``rdd/GenomicPartitioners.scala``), kept in numpy as in the JAX package:
these are per-read integer maps on the host.

* :class:`GenomeBins` — fixed-size coordinate bins stacked per contig in
  dictionary order (the static genome -> bin map of the shuffle region
  join and the out-of-core interval spill).
* :func:`position_partition` — GenomicPositionPartitioner.getPartition
  (:63-85): (contig, pos) to one of N partitions by cumulative genome
  offset, with one extra partition for unmapped reads (partition N).
* :func:`region_partition` — GenomicRegionPartitioner (:102-121).
* :func:`shard_rows_by_position` — row indices per shard.

The mesh partitioner of the JAX module (multi-device execution) is not
ported yet (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from adam_tpu_torch.models.dictionaries import SequenceDictionary


@dataclass(frozen=True)
class GenomeBins:
    """Fixed-size genome binning (ShuffleRegionJoin.scala:140-193).

    Bin ids stack per contig in dictionary order; ``invert`` recovers the
    bin's region."""

    bin_size: int
    seq_dict: SequenceDictionary

    @cached_property
    def bins_per_contig(self) -> np.ndarray:
        # every contig owns at least one bin, so contigs with undeclared
        # (0) length still have a home in the bin-id space
        return np.maximum(-(-self.seq_dict.lengths // self.bin_size), 1)

    @cached_property
    def bin_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.bins_per_contig)])

    @property
    def num_bins(self) -> int:
        return int(self.bin_offsets[-1])

    def start_bin(self, contig_idx, start):
        ci = np.asarray(contig_idx)
        local = np.asarray(start) // self.bin_size
        return self.bin_offsets[ci] + np.minimum(local, self.bins_per_contig[ci] - 1)

    def end_bin(self, contig_idx, end):
        """Bin of the last covered base (end is exclusive), clamped to
        the contig's last bin so intervals overhanging a declared contig
        length never spill into the next contig's bin-id range."""
        ci = np.asarray(contig_idx)
        local = np.maximum(np.asarray(end) - 1, 0) // self.bin_size
        return self.bin_offsets[ci] + np.minimum(local, self.bins_per_contig[ci] - 1)

    def invert(self, bin_id: int):
        """bin id -> (contig_idx, start, end) region of the bin."""
        contig = int(np.searchsorted(self.bin_offsets, bin_id, "right") - 1)
        local = bin_id - int(self.bin_offsets[contig])
        start = local * self.bin_size
        end = max(min(start + self.bin_size, int(self.seq_dict.lengths[contig])), start)
        return contig, start, end

    def dedupe_region(self, bin_id: int):
        """Like :meth:`invert`, but the last bin of each contig extends to
        the i64 maximum: overhanging intervals clamp into that bin, and
        their starts must still satisfy the at-least-one-side-starts-here
        join rule."""
        contig, start, end = self.invert(bin_id)
        if bin_id == int(self.bin_offsets[contig + 1]) - 1:
            end = np.iinfo(np.int64).max
        return contig, start, end


def position_partition(seq_dict: SequenceDictionary, contig_idx, pos,
                       num_partitions: int) -> np.ndarray:
    """Partition id per read; unmapped (contig_idx < 0) -> num_partitions.

    Mapped reads land in int(num_partitions * flattened / total_length),
    the cumulative-offset binning of the reference."""
    contig_idx = np.asarray(contig_idx)
    pos = np.asarray(pos)
    offsets = seq_dict.offsets
    total = max(seq_dict.total_length, 1)
    safe_idx = np.clip(contig_idx, 0, max(len(seq_dict) - 1, 0))
    flat = offsets[safe_idx] + np.maximum(pos, 0)
    part = (num_partitions * flat) // total
    part = np.clip(part, 0, num_partitions - 1)
    return np.where(contig_idx < 0, num_partitions, part).astype(np.int64)


def region_partition(seq_dict: SequenceDictionary, contig_idx, pos,
                     partition_size: int) -> np.ndarray:
    """Fixed-size bin id, unique across contigs (bins stack per contig);
    -1 for unmapped rows."""
    contig_idx = np.asarray(contig_idx)
    pos = np.asarray(pos)
    bins = GenomeBins(partition_size, seq_dict)
    safe_idx = np.clip(contig_idx, 0, max(len(seq_dict) - 1, 0))
    out = bins.start_bin(safe_idx, np.maximum(pos, 0))
    return np.where(contig_idx < 0, -1, out).astype(np.int64)


def shard_rows_by_position(seq_dict: SequenceDictionary, contig_idx, pos,
                           n_shards: int) -> list[np.ndarray]:
    """Row indices per shard (unmapped rows appended to the last shard)."""
    part = position_partition(seq_dict, contig_idx, pos, n_shards)
    part = np.where(part >= n_shards, n_shards - 1, part)
    return [np.flatnonzero(part == s) for s in range(n_shards)]
