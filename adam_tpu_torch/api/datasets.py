"""The dataset handles: a read batch, its sidecar and its header
(the counterpart of ``adam_tpu/api/datasets.AlignmentDataset``: load and
save by extension, the Arrow seam, the dataset-level transforms behind
the non-streaming ``transform``, flagstat and the k-mer and q-mer
counts), and the VCF's variants and genotypes (``GenotypeDataset``, the
source of the known-sites tables).

Transforms return new datasets.  Each method that does tensor work takes
``device`` (default ``"cuda"``; ``"cpu"`` runs the plain versions)."""

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

    def save(self, path: str, sort_order: Optional[str] = None,
             compression: str = "zstd") -> None:
        """Write by extension: ``.sam``, ``.bam``, else one Parquet file.
        FASTQ output is not ported yet and raises."""
        p = str(path)
        if p.endswith(".sam"):
            from adam_tpu_torch.io import sam

            sam.write_sam(p, self.batch, self.sidecar, self.header, sort_order)
        elif p.endswith(".bam"):
            from adam_tpu_torch.io import sam

            sam.write_bam(p, self.batch, self.sidecar, self.header, sort_order)
        elif p.endswith((".fq", ".fastq")):
            from adam_tpu_torch.io.context import _not_ported

            raise _not_ported(p, "FASTQ output")
        else:
            from adam_tpu_torch.io import parquet

            parquet.save_alignments(p, self.batch, self.sidecar, self.header,
                                    compression=compression)

    def to_arrow(self):
        """-> pyarrow Table (AlignmentRecord layout, header in metadata)."""
        from adam_tpu_torch.io import parquet

        return parquet.to_arrow_alignments(self.batch, self.sidecar, self.header)

    @staticmethod
    def from_arrow(table_or_batches) -> "AlignmentDataset":
        """pyarrow Table / RecordBatch(es) -> AlignmentDataset."""
        import pyarrow as pa

        from adam_tpu_torch.io import parquet

        t = table_or_batches
        if isinstance(t, pa.RecordBatch):
            t = pa.Table.from_batches([t])
        elif isinstance(t, (list, tuple)):
            t = pa.Table.from_batches(list(t))
        return AlignmentDataset(*parquet.from_arrow_alignments(t))

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

    def compact(self) -> "AlignmentDataset":
        """Drop invalid (padding or filtered) rows."""
        return self.take_rows(np.flatnonzero(np.asarray(self.batch.valid)))

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

    def sort_by_reference_position(self) -> "AlignmentDataset":
        """Coordinate sort (host numpy, as in the JAX package)."""
        from adam_tpu_torch.pipelines import sort

        return sort.sort_by_reference_position(self)

    def mark_duplicates(self, device: str = "cuda") -> "AlignmentDataset":
        from adam_tpu_torch.pipelines import markdup

        return markdup.mark_duplicates(self, device=device)

    def realign_indels(self, **kw) -> "AlignmentDataset":
        from adam_tpu_torch.pipelines.realign import realign_indels

        return realign_indels(self, **kw)

    def recalibrate_base_qualities(self, known_snps=None, device: str = "cuda",
                                   **kw) -> "AlignmentDataset":
        """BQSR over the dataset (``dump_observation_table=``, ``stats=``:
        :func:`adam_tpu_torch.pipelines.bqsr.recalibrate_base_qualities`)."""
        from adam_tpu_torch.pipelines.bqsr import recalibrate_base_qualities

        return recalibrate_base_qualities(self, known_snps=known_snps,
                                          device=device, **kw)

    def trim_reads(self, trim_start: int = -1, trim_end: int = -1) -> "AlignmentDataset":
        """Fixed trim of every read (host numpy)."""
        from adam_tpu_torch.pipelines import trim

        return trim.trim_reads(self, trim_start, trim_end)

    def trim_low_quality_read_groups(self, phred_threshold: int = 20,
                                     device: str = "cuda") -> "AlignmentDataset":
        from adam_tpu_torch.pipelines import trim

        return trim.trim_low_quality_read_groups(self, phred_threshold, device=device)

    def flagstat(self, device: str = "cuda"):
        """-> (failed_vendor_quality, passed_vendor_quality) metrics."""
        from adam_tpu_torch.ops import flagstat

        return flagstat.flagstat(self.batch, device=device)

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
