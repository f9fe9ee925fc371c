"""Columnar genomic features: the GTF/BED/narrowPeak data model (the
port's copy of ``adam_tpu/formats/features.py``).

Coordinates, strand and score are columns (numpy on the host); ids,
types, parents and attribute maps stay in a host sidecar.  Features often
come without a sequence dictionary, so a batch carries its own contig
table, and :meth:`FeatureBatch.intervals` maps rows into another's for
the region joins.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

STRAND_FORWARD = 1
STRAND_REVERSE = -1
STRAND_INDEPENDENT = 0


def strand_code(s: str) -> int:
    """'+'/'-'/other -> Forward/Reverse/Independent."""
    return {"+": STRAND_FORWARD, "-": STRAND_REVERSE}.get(s, STRAND_INDEPENDENT)


@dataclass
class FeatureSidecar:
    feature_id: list = field(default_factory=list)  # str ('' if absent)
    feature_type: list = field(default_factory=list)  # 'gene'/'exon'/peak name/...
    source: list = field(default_factory=list)  # str
    parent_ids: list = field(default_factory=list)  # list[str] per row
    attributes: list = field(default_factory=list)  # dict per row

    def take(self, idx) -> "FeatureSidecar":
        idx = np.asarray(idx)
        return FeatureSidecar(
            [self.feature_id[i] for i in idx],
            [self.feature_type[i] for i in idx],
            [self.source[i] for i in idx],
            [self.parent_ids[i] for i in idx],
            [self.attributes[i] for i in idx],
        )


@dataclass
class FeatureBatch:
    contig_idx: np.ndarray  # i32[N] into `contig_names`
    start: np.ndarray  # i64[N], 0-based
    end: np.ndarray  # i64[N], exclusive
    strand: np.ndarray  # i8[N] of STRAND_* codes
    score: np.ndarray  # f32[N], nan when absent ('.')
    contig_names: list = field(default_factory=list)
    sidecar: FeatureSidecar = field(default_factory=FeatureSidecar)

    def __len__(self):
        return len(self.start)

    def take(self, idx) -> "FeatureBatch":
        idx = np.asarray(idx)
        return FeatureBatch(
            self.contig_idx[idx], self.start[idx], self.end[idx],
            self.strand[idx], self.score[idx], self.contig_names,
            self.sidecar.take(idx),
        )

    def intervals(self, contig_names=None, device: str = "cuda"):
        """The rows as an :class:`IntervalArrays` on ``device``.

        Pass the target ``contig_names`` (e.g. a SequenceDictionary's) to
        remap the batch's own contig table into them; rows on contigs the
        target lacks become empty intervals on contig -1, which overlap
        nothing, not even each other.  With no argument the batch's own
        table is used, which is right only when both join sides share it.
        """
        from adam_tpu_torch.pipelines.region_join import IntervalArrays

        if contig_names is None:
            return IntervalArrays.of(self.contig_idx, self.start, self.end, device=device)
        target = {n: i for i, n in enumerate(contig_names)}
        remap = np.array([target.get(n, -1) for n in self.contig_names], np.int64)
        contig = remap[self.contig_idx]
        unknown = contig < 0
        return IntervalArrays.of(contig, np.where(unknown, 0, self.start),
                                 np.where(unknown, 0, self.end), device=device)

    def filter_by_overlapping_region(self, contig_name: str, start: int,
                                     end: int) -> "FeatureBatch":
        """The rows overlapping [start, end) on ``contig_name``."""
        if contig_name not in self.contig_names:
            return self.take(np.zeros(0, np.int64))
        ci = self.contig_names.index(contig_name)
        keep = (self.contig_idx == ci) & (self.start < end) & (self.end > start)
        return self.take(np.flatnonzero(keep))


class FeatureBatchBuilder:
    """Row-at-a-time accumulator used by the parsers."""

    def __init__(self, contig_names=None):
        self.names = list(contig_names or [])
        self._idx = {n: i for i, n in enumerate(self.names)}
        self.rows = dict(contig=[], start=[], end=[], strand=[], score=[])
        self.side = FeatureSidecar()

    def contig_id(self, name: str) -> int:
        if name not in self._idx:
            self._idx[name] = len(self.names)
            self.names.append(name)
        return self._idx[name]

    def add(self, contig, start, end, strand=STRAND_INDEPENDENT,
            score=np.nan, feature_id="", feature_type="", source="",
            parent_ids=(), attributes=None):
        self.rows["contig"].append(self.contig_id(contig))
        self.rows["start"].append(start)
        self.rows["end"].append(end)
        self.rows["strand"].append(strand)
        self.rows["score"].append(score)
        self.side.feature_id.append(feature_id)
        self.side.feature_type.append(feature_type)
        self.side.source.append(source)
        self.side.parent_ids.append(list(parent_ids))
        self.side.attributes.append(dict(attributes or {}))

    def build(self) -> FeatureBatch:
        return FeatureBatch(
            np.asarray(self.rows["contig"], np.int32),
            np.asarray(self.rows["start"], np.int64),
            np.asarray(self.rows["end"], np.int64),
            np.asarray(self.rows["strand"], np.int8),
            np.asarray(self.rows["score"], np.float32),
            self.names,
            self.side,
        )
