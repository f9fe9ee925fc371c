"""The dataset handles: a read batch, its sidecar and its header
(the counterpart of ``adam_tpu/api/datasets.AlignmentDataset``, with the
pieces the streamed transform uses, the load dispatcher and the k-mer
and q-mer counts), and the VCF's variants and
genotypes (``GenotypeDataset``, the source of the known-sites tables)."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import TYPE_CHECKING, Optional

import numpy as np

from adam_tpu_torch.formats.batch import ReadBatch, ReadSidecar

if TYPE_CHECKING:  # avoid an io <-> api import cycle at run time
    from adam_tpu_torch.io.sam import SamHeader


@dataclass
class AlignmentDataset:
    batch: ReadBatch
    sidecar: ReadSidecar
    header: "SamHeader"

    def __len__(self) -> int:
        return self.batch.n_valid()

    @staticmethod
    def load(path: str, **kw) -> "AlignmentDataset":
        """Load reads by extension (:func:`adam_tpu_torch.io.context.load_alignments`)."""
        from adam_tpu_torch.io import context

        return context.load_alignments(path, **kw)

    @property
    def seq_dict(self):
        return self.header.seq_dict

    @property
    def read_groups(self):
        return self.header.read_groups

    def with_batch(
        self, batch: ReadBatch, sidecar: Optional[ReadSidecar] = None
    ) -> "AlignmentDataset":
        return replace(
            self, batch=batch,
            sidecar=sidecar if sidecar is not None else self.sidecar,
        )

    def take_rows(self, idx) -> "AlignmentDataset":
        idx = np.asarray(idx)
        return replace(
            self, batch=self.batch.to_numpy().take(idx),
            sidecar=self.sidecar.take(idx),
        )

    @staticmethod
    def concat(parts: list["AlignmentDataset"]) -> "AlignmentDataset":
        """Splice datasets sharing a header (window reassembly)."""
        if not parts:
            from adam_tpu_torch.io.sam import SamHeader

            return AlignmentDataset(ReadBatch.empty(), ReadSidecar(), SamHeader())
        if len(parts) == 1:
            return parts[0]
        return AlignmentDataset(
            ReadBatch.concat([p.batch for p in parts]),
            ReadSidecar.concat([p.sidecar for p in parts]),
            parts[0].header,
        )

    def realign_indels(self, **kw) -> "AlignmentDataset":
        from adam_tpu_torch.pipelines.realign import realign_indels

        return realign_indels(self, **kw)

    def count_kmers(self, k: int, device: str = "cuda") -> dict:
        from adam_tpu_torch.ops import kmer

        return kmer.count_kmers(self.batch, k, device=device)

    def count_qmers(self, k: int, device: str = "cuda") -> dict:
        from adam_tpu_torch.ops import kmer

        return kmer.count_qmers(self.batch, k, device=device)


@dataclass
class GenotypeDataset:
    """Variant sites + per-sample calls (the counterpart of
    ``adam_tpu/api/datasets.GenotypeDataset``, with the VCF load and the
    two known-sites tables).  Variants and genotypes stay columnar
    (:mod:`adam_tpu_torch.formats.variants`), linked by
    ``genotypes.variant_idx``."""

    variants: "object"  # formats.variants.VariantBatch
    genotypes: "object"  # formats.variants.GenotypeBatch
    seq_dict: "object"  # SequenceDictionary

    @staticmethod
    def load(path: str, **kw) -> "GenotypeDataset":
        """.vcf / .vcf.gz -> the VCF reader (``contig_names=`` fixes the
        contig index space, e.g. to the SAM header's)."""
        p = str(path)
        if not p.endswith((".vcf", ".vcf.gz")):
            raise ValueError(
                f"{p!r}: the port loads genotypes from .vcf or .vcf.gz only "
                "(the genotype Parquet reader is not ported)"
            )
        from adam_tpu_torch.io import vcf as vcf_io

        return GenotypeDataset(*vcf_io.read_vcf(p, **kw))

    def __len__(self) -> int:
        return len(self.variants)

    @property
    def contig_names(self) -> list:
        return [r.name for r in self.seq_dict.records]

    def snp_table(self):
        """Known-sites table for BQSR: every ref position of every variant
        masks.  gVCF reference-model rows (alt None) are skipped: their
        END-extended spans are non-variant sequence, not known sites."""
        from adam_tpu_torch.models.snp_table import SnpTable

        names = self.contig_names
        side = self.variants.sidecar
        pairs = []
        for i in range(len(self.variants)):
            if side.alt_allele[i] is None:
                continue
            c = names[self.variants.contig_idx[i]]
            start = int(self.variants.start[i])
            for p in range(start, start + int(self.variants.ref_len[i])):
                pairs.append((c, p))
        return SnpTable.from_variants(pairs)

    def indel_table(self):
        """Known-indels table for the ``knowns`` realignment model."""
        from adam_tpu_torch.models.snp_table import IndelTable

        names = self.contig_names
        side = self.variants.sidecar
        return IndelTable.from_variants([
            (names[self.variants.contig_idx[i]], int(self.variants.start[i]),
             side.ref_allele[i], side.alt_allele[i])
            for i in range(len(self.variants))
            if side.alt_allele[i]
        ])
