"""Gene / Transcript / Exon hierarchy assembled from flat features (the
port's copy of ``adam_tpu/models/genes.py``).

Exons and CDS/UTR blocks group by transcript id, transcripts join their
blocks and group by gene id, genes join their transcripts: dictionary
maps on the host, as gene models are small metadata.

Strand follows the reference: a bool, Forward and Independent -> True,
Reverse -> False.
"""

from __future__ import annotations

from dataclasses import dataclass

from adam_tpu_torch.formats.features import FeatureBatch, STRAND_REVERSE
from adam_tpu_torch.models.positions import ReferenceRegion

_COMPLEMENT = str.maketrans("ACGTNacgtn", "TGCANtgcan")


def reverse_complement(seq: str) -> str:
    return seq.translate(_COMPLEMENT)[::-1]


@dataclass(frozen=True)
class Exon:
    id: str
    transcript_id: str
    strand: bool
    region: ReferenceRegion

    def extract_sequence(self, reference: str) -> str:
        s = reference[self.region.start : self.region.end]
        return s if self.strand else reverse_complement(s)


@dataclass(frozen=True)
class CDS:
    transcript_id: str
    strand: bool
    region: ReferenceRegion

    def extract_sequence(self, reference: str) -> str:
        s = reference[self.region.start : self.region.end]
        return s if self.strand else reverse_complement(s)


@dataclass(frozen=True)
class UTR:
    transcript_id: str
    strand: bool
    region: ReferenceRegion


@dataclass(frozen=True)
class Transcript:
    id: str
    names: tuple
    gene_id: str
    strand: bool
    exons: tuple
    cds: tuple = ()
    utrs: tuple = ()

    @property
    def region(self) -> ReferenceRegion:
        regions = [e.region for e in self.exons]
        out = regions[0]
        for r in regions[1:]:
            out = out.hull(r)
        return out

    def extract_transcribed_rna_sequence(self, reference: str) -> str:
        """Contiguous min-start..max-end slice, reverse-complemented on
        the reverse strand (Gene.scala:96-106)."""
        lo = min(e.region.start for e in self.exons)
        hi = max(e.region.end for e in self.exons)
        s = reference[lo:hi]
        return s if self.strand else reverse_complement(s)

    def extract_spliced_mrna_sequence(self, reference: str) -> str:
        """Exon sequences concatenated 5'->3' (Gene.scala:137-147)."""
        exs = sorted(self.exons, key=lambda e: e.region.start)
        if not self.strand:
            exs = exs[::-1]
        return "".join(e.extract_sequence(reference) for e in exs)

    def extract_coding_sequence(self, reference: str) -> str:
        """CDS blocks concatenated 5'->3' (Gene.scala:117-126)."""
        blocks = sorted(self.cds, key=lambda c: c.region.start)
        if not self.strand:
            blocks = blocks[::-1]
        return "".join(c.extract_sequence(reference) for c in blocks)


@dataclass(frozen=True)
class Gene:
    id: str
    names: tuple
    strand: bool
    transcripts: tuple

    @property
    def regions(self) -> list:
        """Union of the transcript spans (a merge on the host)."""
        import numpy as np
        import torch

        from adam_tpu_torch.ops import intervals as iv

        if not self.transcripts:
            return []
        regs = [t.region for t in self.transcripts]
        names = sorted({r.referenceName for r in regs})
        idx = {n: i for i, n in enumerate(names)}
        m_c, m_s, m_e, _ = iv.merge_intervals(
            torch.from_numpy(np.array([idx[r.referenceName] for r in regs], np.int64)),
            torch.from_numpy(np.array([r.start for r in regs], np.int64)),
            torch.from_numpy(np.array([r.end for r in regs], np.int64)),
        )
        return [
            ReferenceRegion(names[c], int(s), int(e))
            for c, s, e in zip(m_c.tolist(), m_s.tolist(), m_e.tolist())
        ]


def _strand(code: int) -> bool:
    return bool(code != STRAND_REVERSE)


def as_genes(feats: FeatureBatch) -> list[Gene]:
    """Assemble gene models from typed GTF features
    (GeneFeatureRDDFunctions.asGenes, :35-125)."""
    side = feats.sidecar
    names = feats.contig_names

    def region(i: int) -> ReferenceRegion:
        return ReferenceRegion(
            names[feats.contig_idx[i]], int(feats.start[i]), int(feats.end[i])
        )

    exons_by_tx: dict[str, list[Exon]] = {}
    cds_by_tx: dict[str, list[CDS]] = {}
    utrs_by_tx: dict[str, list[UTR]] = {}
    tx_rows: list[int] = []
    gene_rows: list[int] = []

    for i in range(len(feats)):
        ftype = side.feature_type[i]
        if ftype == "exon":
            for tid in side.parent_ids[i]:
                exons_by_tx.setdefault(tid, []).append(
                    Exon(side.feature_id[i], tid, _strand(feats.strand[i]),
                         region(i))
                )
        elif ftype == "CDS":
            for tid in side.parent_ids[i]:
                cds_by_tx.setdefault(tid, []).append(
                    CDS(tid, _strand(feats.strand[i]), region(i))
                )
        elif ftype == "UTR":
            for tid in side.parent_ids[i]:
                utrs_by_tx.setdefault(tid, []).append(
                    UTR(tid, _strand(feats.strand[i]), region(i))
                )
        elif ftype == "transcript":
            tx_rows.append(i)
        elif ftype == "gene":
            gene_rows.append(i)

    # transcripts join exons (inner join: transcripts without exons drop,
    # matching the reference's .join(exonsByTranscript))
    tx_by_gene: dict[str, list[Transcript]] = {}
    for i in tx_rows:
        tid = side.feature_id[i]
        if tid not in exons_by_tx:
            continue
        for gid in side.parent_ids[i]:
            tx_by_gene.setdefault(gid, []).append(
                Transcript(
                    tid, (tid,), gid, _strand(feats.strand[i]),
                    tuple(exons_by_tx[tid]),
                    tuple(cds_by_tx.get(tid, ())),
                    tuple(utrs_by_tx.get(tid, ())),
                )
            )

    # genes left-join transcripts
    return [
        Gene(
            side.feature_id[i],
            (side.feature_id[i],),
            _strand(feats.strand[i]),
            tuple(tx_by_gene.get(side.feature_id[i], ())),
        )
        for i in gene_rows
    ]
