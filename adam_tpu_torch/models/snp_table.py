"""Known-variant tables (the port's copy of ``adam_tpu/models/snp_table.py``).

``SnpTable``: per-contig sets of known SNP positions, masked out of the
BQSR observe pass.  ``IndelTable``: known indels, the consensuses of the
``knowns`` realignment model.

Positions are kept as sorted i64 arrays per contig, so masking a batch
is a vectorized ``searchsorted`` membership test on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from adam_tpu_torch.models.positions import ReferenceRegion

SITE_KEY_SHIFT = 40  # site key = contig index << 40 | position


class SnpTable:
    def __init__(self, table: dict[str, np.ndarray] | None = None):
        # contig name -> sorted unique i64 positions
        self.table = {
            k: np.unique(np.asarray(v, dtype=np.int64))
            for k, v in (table or {}).items()
        }

    @staticmethod
    def from_file(path: str) -> "SnpTable":
        """Sites-only VCF-ish file: TAB columns (contig, 1-based pos, id,
        ref, ...); every base of ref masks one site."""
        with open(path) as fh:
            return SnpTable.from_lines(fh)

    @staticmethod
    def from_lines(lines) -> "SnpTable":
        table: dict[str, list[int]] = {}
        for line in lines:
            if not line.strip() or line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            contig, pos, ref = parts[0], int(parts[1]) - 1, parts[3]
            if pos < 0 or not ref:
                raise ValueError(f"malformed known-sites line: {line!r}")
            for i in range(len(ref)):
                table.setdefault(contig, []).append(pos + i)
        return SnpTable(table)

    @staticmethod
    def from_variants(variants) -> "SnpTable":
        """From (contig, 0-based pos) pairs."""
        table: dict[str, list[int]] = {}
        for contig, pos in variants:
            table.setdefault(contig, []).append(pos)
        return SnpTable(table)

    def site_keys(self, contig_names: list[str]) -> np.ndarray:
        """Sorted composite ``contig_index << 40 | position`` site keys."""
        keys = []
        for ci, name in enumerate(contig_names):
            arr = self.table.get(name)
            if arr is not None and len(arr):
                keys.append((np.int64(ci) << SITE_KEY_SHIFT) | arr.astype(np.int64))
        if not keys:
            return np.zeros(0, np.int64)
        return np.sort(np.concatenate(keys))

    def contains(self, contig: str, pos: int) -> bool:
        arr = self.table.get(contig)
        if arr is None or not len(arr):
            return False
        i = np.searchsorted(arr, pos)
        return bool(i < len(arr) and arr[i] == pos)

    def mask_positions(self, contig_names: list[str], contig_idx, positions) -> np.ndarray:
        """Vectorized membership test -> bool mask of known-SNP sites.

        ``contig_idx`` is per-row i32[N] (one contig per read);
        ``positions`` is i64[N, L] per-base reference positions (< 0 =
        no position -> False).  Contigs absent from ``contig_names`` mask
        nothing."""
        contig_idx = np.asarray(contig_idx)
        positions = np.asarray(positions)
        out = np.zeros(positions.shape, dtype=bool)
        for ci, name in enumerate(contig_names):
            arr = self.table.get(name)
            if arr is None or not len(arr):
                continue
            rows = np.flatnonzero(contig_idx == ci)
            if not len(rows):
                continue
            pos = positions[rows]
            idx = np.searchsorted(arr, pos)
            idx_clipped = np.minimum(idx, len(arr) - 1)
            out[rows] = (arr[idx_clipped] == pos) & (pos >= 0)
        return out

    def __len__(self) -> int:
        return sum(len(v) for v in self.table.values())


@dataclass(frozen=True)
class IndelRecord:
    region: ReferenceRegion
    consensus: str  # inserted bases, or "" for deletion


class IndelTable:
    """Known indels per contig, in the order they were given."""

    def __init__(self, table: dict[str, list[IndelRecord]] | None = None):
        self.table = dict(table or {})

    @staticmethod
    def from_variants(variants) -> "IndelTable":
        """From (contig, 0-based pos, ref, alt) tuples: an insertion when
        len(ref) == 1 < len(alt) — consensus is alt minus the anchor base,
        region [pos, pos+1); a deletion when len(alt) == 1 < len(ref) —
        region [pos+1, pos+len(ref)), the deleted bases.  Other rows are
        skipped."""
        table: dict[str, list[IndelRecord]] = {}
        for contig, pos, ref, alt in variants:
            if len(ref) == 1 and len(alt) > 1:
                rec = IndelRecord(ReferenceRegion(contig, pos, pos + 1), alt[1:])
            elif len(alt) == 1 and len(ref) > 1:
                rec = IndelRecord(ReferenceRegion(contig, pos + 1, pos + len(ref)), "")
            else:
                continue
            table.setdefault(contig, []).append(rec)
        return IndelTable(table)

    def get_indels_in_region(self, region: ReferenceRegion) -> list[IndelRecord]:
        """The records overlapping ``region``, in table order."""
        return [
            r for r in self.table.get(region.referenceName, [])
            if r.region.overlaps(region)
        ]
