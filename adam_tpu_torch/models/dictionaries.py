"""Sequence and read-group dictionaries (the subset of
``adam_tpu/models/dictionaries.py`` the port uses).

Host-side metadata parsed from the SAM header: contig *names* become
dense ``contig_idx`` i32 values and read-group names dense
``read_group_idx`` values, as in the JAX package; the Parquet writer
stores both dictionaries in the part's schema metadata.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np


def _header_fields(line: str) -> dict:
    return dict(
        f.split(":", 1) for f in line.rstrip("\n").split("\t")[1:] if ":" in f
    )


@dataclass(frozen=True)
class SequenceRecord:
    name: str
    length: int
    url: Optional[str] = None
    md5: Optional[str] = None
    assembly: Optional[str] = None
    species: Optional[str] = None


@dataclass(frozen=True)
class SequenceDictionary:
    records: tuple[SequenceRecord, ...] = ()

    @staticmethod
    def from_sam_header_lines(lines: Iterable[str]) -> "SequenceDictionary":
        recs = []
        for line in lines:
            if not line.startswith("@SQ"):
                continue
            fields = _header_fields(line)
            recs.append(
                SequenceRecord(
                    name=fields["SN"],
                    length=int(fields["LN"]),
                    url=fields.get("UR"),
                    md5=fields.get("M5"),
                    assembly=fields.get("AS"),
                    species=fields.get("SP"),
                )
            )
        return SequenceDictionary(tuple(recs))

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self):
        return iter(self.records)

    @property
    def names(self) -> list[str]:
        return [r.name for r in self.records]


@dataclass(frozen=True)
class RecordGroup:
    name: str
    sample: Optional[str] = None
    library: Optional[str] = None
    platform: Optional[str] = None
    platform_unit: Optional[str] = None

    @staticmethod
    def from_sam_header_line(line: str) -> "RecordGroup":
        fields = _header_fields(line)
        return RecordGroup(
            name=fields["ID"],
            sample=fields.get("SM"),
            library=fields.get("LB"),
            platform=fields.get("PL"),
            platform_unit=fields.get("PU"),
        )


@dataclass(frozen=True)
class RecordGroupDictionary:
    """Read groups, indexed densely; library lookup used by markdup
    (MarkDuplicates groups by library, MarkDuplicates.scala:78-80)."""

    groups: tuple[RecordGroup, ...] = ()

    @staticmethod
    def from_sam_header_lines(lines: Iterable[str]) -> "RecordGroupDictionary":
        return RecordGroupDictionary(
            tuple(
                RecordGroup.from_sam_header_line(line)
                for line in lines
                if line.startswith("@RG")
            )
        )

    def __len__(self):
        return len(self.groups)

    def __iter__(self):
        return iter(self.groups)

    @property
    def names(self) -> list[str]:
        return [g.name for g in self.groups]

    def library_ids(self) -> np.ndarray:
        """Dense library id per read group (same library -> same id).

        -1-free; reads with read_group_idx == -1 get library id -1 at use
        sites.
        """
        libs: dict[Optional[str], int] = {}
        out = np.zeros(len(self.groups), dtype=np.int32)
        for i, g in enumerate(self.groups):
            key = g.library
            if key not in libs:
                libs[key] = len(libs)
            out[i] = libs[key]
        return out
