"""Genomic coordinates (the port's copy of the value types of
``adam_tpu/models/positions.py``).

Host-side value types with the semantics of the reference's
``models/ReferencePosition.scala`` and ``models/ReferenceRegion.scala``
(overlaps / merge / hull / intersection).  All coordinates are 0-based,
end-exclusive.  The known-indel table and the realignment lookups use
them, and :func:`pack_position_key` gives the coordinate sort one i64 key
per read.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import total_ordering

import numpy as np
import torch

# 2^40 bp per contig is far above any real contig length; it leaves 23
# bits for the contig index inside a signed i64 key.
POS_BITS = 40
POS_MASK = (1 << POS_BITS) - 1


def pack_position_key(contig_idx, pos):
    """(contig_idx, pos) -> sortable i64 key ``(contig_idx + 1) << 40 |
    pos``, on torch tensors (on their device), numpy arrays or Python
    ints.  Unmapped rows (contig_idx < 0) pack below every mapped key; the
    sort pipeline sends them to the end itself (unmapped reads sort last,
    by name)."""
    if isinstance(contig_idx, torch.Tensor):
        c = contig_idx.to(torch.int64) + 1
        p = pos.to(torch.int64)
    elif hasattr(contig_idx, "astype"):
        c = contig_idx.astype(np.int64) + 1
        p = np.asarray(pos).astype(np.int64)
    else:
        c = np.int64(contig_idx) + 1
        p = np.int64(pos)
    return (c << POS_BITS) | (p & POS_MASK)


def unpack_position_key(key):
    return (key >> POS_BITS) - 1, key & POS_MASK


@total_ordering
@dataclass(frozen=True)
class ReferencePosition:
    """A point on a contig (reference name form, host side)."""

    referenceName: str
    pos: int

    def __lt__(self, other: "ReferencePosition"):
        return (self.referenceName, self.pos) < (other.referenceName, other.pos)


@total_ordering
@dataclass(frozen=True)
class ReferenceRegion:
    """Half-open interval [start, end) on a contig.

    ``merge`` requires overlap-or-adjacency, ``hull`` does not;
    ``distance`` is defined only on the same contig (1 for adjacent).
    """

    referenceName: str
    start: int
    end: int

    def __post_init__(self):
        if self.start < 0 or self.end < self.start:
            raise ValueError(f"malformed region {self}")

    @property
    def width(self) -> int:
        return self.end - self.start

    def contains_point(self, p: ReferencePosition) -> bool:
        return (
            self.referenceName == p.referenceName
            and self.start <= p.pos < self.end
        )

    def contains(self, other: "ReferenceRegion") -> bool:
        return (
            self.referenceName == other.referenceName
            and self.start <= other.start
            and self.end >= other.end
        )

    def overlaps(self, other: "ReferenceRegion") -> bool:
        return (
            self.referenceName == other.referenceName
            and self.end > other.start
            and other.end > self.start
        )

    def is_adjacent(self, other: "ReferenceRegion") -> bool:
        return self.distance(other) == 1

    def distance(self, other: "ReferenceRegion"):
        """Distance in bp; 0 if overlapping, 1 if adjacent, None cross-contig."""
        if self.referenceName != other.referenceName:
            return None
        if self.overlaps(other):
            return 0
        if other.start >= self.end:
            return other.start - self.end + 1
        return self.start - other.end + 1

    def merge(self, other: "ReferenceRegion") -> "ReferenceRegion":
        if not (self.overlaps(other) or self.is_adjacent(other)):
            raise ValueError(f"cannot merge non-adjacent {self} and {other}")
        return self.hull(other)

    def hull(self, other: "ReferenceRegion") -> "ReferenceRegion":
        if self.referenceName != other.referenceName:
            raise ValueError("hull requires same contig")
        return ReferenceRegion(
            self.referenceName,
            min(self.start, other.start),
            max(self.end, other.end),
        )

    def intersection(self, other: "ReferenceRegion") -> "ReferenceRegion":
        if not self.overlaps(other):
            raise ValueError(f"regions {self} and {other} do not overlap")
        return ReferenceRegion(
            self.referenceName,
            max(self.start, other.start),
            min(self.end, other.end),
        )

    def pad(self, by: int, max_end: int | None = None) -> "ReferenceRegion":
        end = self.end + by if max_end is None else min(self.end + by, max_end)
        return ReferenceRegion(self.referenceName, max(0, self.start - by), end)

    def __lt__(self, other: "ReferenceRegion"):
        return (self.referenceName, self.start, self.end) < (
            other.referenceName, other.start, other.end,
        )


def regions_from_arrays(names, starts, ends) -> list:
    """Parallel name/start/end columns -> list[ReferenceRegion]."""
    return [
        ReferenceRegion(n, int(s), int(e))
        for n, s, e in zip(names, np.asarray(starts), np.asarray(ends))
    ]
