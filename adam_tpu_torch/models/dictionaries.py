"""Sequence and read-group dictionaries (copied from
``adam_tpu/models/dictionaries.py``).

Host-side metadata parsed from the SAM/BAM header: contig *names* become
dense ``contig_idx`` i32 values and read-group names dense
``read_group_idx`` values, as in the JAX package; the Parquet writer
stores both dictionaries in the part's schema metadata, the BAM writer
writes them back as header lines, and a multi-file load merges them.
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
    refseq: Optional[str] = None
    genbank: Optional[str] = None
    assembly: Optional[str] = None
    species: Optional[str] = None

    def compatible_with(self, other: "SequenceRecord") -> bool:
        """Same name -> must agree on length."""
        return self.name != other.name or self.length == other.length


@dataclass(frozen=True)
class SequenceDictionary:
    records: tuple[SequenceRecord, ...] = ()

    @staticmethod
    def from_lists(names, lengths) -> "SequenceDictionary":
        return SequenceDictionary(
            tuple(SequenceRecord(name=n, length=int(ln)) for n, ln in zip(names, lengths))
        )

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

    def __contains__(self, name: str) -> bool:
        return any(r.name == name for r in self.records)

    def __getitem__(self, name: str) -> SequenceRecord:
        for r in self.records:
            if r.name == name:
                return r
        raise KeyError(name)

    def index(self, name: str) -> int:
        """Dense contig index; raises KeyError if absent."""
        for i, r in enumerate(self.records):
            if r.name == name:
                return i
        raise KeyError(name)

    def index_or(self, name: str, default: int = -1) -> int:
        try:
            return self.index(name)
        except KeyError:
            return default

    @property
    def names(self) -> list[str]:
        return [r.name for r in self.records]

    @property
    def lengths(self) -> np.ndarray:
        return np.array([r.length for r in self.records], dtype=np.int64)

    @property
    def offsets(self) -> np.ndarray:
        """Flattened-genome coordinate of each contig's base 0, then the
        total length (the genome-bin partitioners' cumulative lengths)."""
        return np.concatenate([[0], np.cumsum(self.lengths)])

    @property
    def total_length(self) -> int:
        return int(self.lengths.sum()) if len(self.records) else 0

    def is_compatible_with(self, other: "SequenceDictionary") -> bool:
        mine = {r.name: r for r in self.records}
        return all(
            mine[o.name].compatible_with(o) for o in other.records if o.name in mine
        )

    def merge(self, other: "SequenceDictionary") -> "SequenceDictionary":
        """Union in first-seen order; a same-name record of another length
        raises."""
        if not self.is_compatible_with(other):
            raise ValueError("incompatible sequence dictionaries")
        seen = {r.name for r in self.records}
        extra = tuple(r for r in other.records if r.name not in seen)
        return SequenceDictionary(self.records + extra)

    def to_sam_header_lines(self) -> list[str]:
        out = []
        for r in self.records:
            fields = ["@SQ", f"SN:{r.name}", f"LN:{r.length}"]
            if r.url:
                fields.append(f"UR:{r.url}")
            if r.md5:
                fields.append(f"M5:{r.md5}")
            if r.assembly:
                fields.append(f"AS:{r.assembly}")
            if r.species:
                fields.append(f"SP:{r.species}")
            out.append("\t".join(fields))
        return out


@dataclass(frozen=True)
class RecordGroup:
    name: str
    sample: Optional[str] = None
    library: Optional[str] = None
    platform: Optional[str] = None
    platform_unit: Optional[str] = None
    sequencing_center: Optional[str] = None
    description: Optional[str] = None
    run_date: Optional[str] = None
    flow_order: Optional[str] = None
    key_sequence: Optional[str] = None
    predicted_insert_size: Optional[int] = None

    @staticmethod
    def from_sam_header_line(line: str) -> "RecordGroup":
        fields = _header_fields(line)
        return RecordGroup(
            name=fields["ID"],
            sample=fields.get("SM"),
            library=fields.get("LB"),
            platform=fields.get("PL"),
            platform_unit=fields.get("PU"),
            sequencing_center=fields.get("CN"),
            description=fields.get("DS"),
            run_date=fields.get("DT"),
            flow_order=fields.get("FO"),
            key_sequence=fields.get("KS"),
            predicted_insert_size=(
                int(fields["PI"]) if "PI" in fields else None
            ),
        )

    def to_sam_header_line(self) -> str:
        pairs = [("ID", self.name), ("SM", self.sample), ("LB", self.library),
                 ("PL", self.platform), ("PU", self.platform_unit),
                 ("CN", self.sequencing_center), ("DS", self.description),
                 ("DT", self.run_date), ("FO", self.flow_order),
                 ("KS", self.key_sequence),
                 ("PI", str(self.predicted_insert_size)
                  if self.predicted_insert_size is not None else None)]
        return "\t".join(["@RG"] + [f"{k}:{v}" for k, v in pairs if v is not None])


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

    def index(self, name: str) -> int:
        for i, g in enumerate(self.groups):
            if g.name == name:
                return i
        raise KeyError(name)

    def index_or(self, name: str, default: int = -1) -> int:
        try:
            return self.index(name)
        except KeyError:
            return default

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

    def merge(self, other: "RecordGroupDictionary") -> "RecordGroupDictionary":
        """Union in first-seen order; a same-name group that differs
        raises."""
        seen = {g.name for g in self.groups}
        for g in other.groups:
            if g.name in seen:
                mine = next(x for x in self.groups if x.name == g.name)
                if mine != g:
                    raise ValueError(f"conflicting read group {g.name}")
        extra = tuple(g for g in other.groups if g.name not in seen)
        return RecordGroupDictionary(self.groups + extra)
