"""The dataset handles: a read batch, its sidecar and its header
(the counterpart of ``adam_tpu/api/datasets.AlignmentDataset``: load and
save by extension, the Arrow seam, the dataset-level transforms behind
the non-streaming ``transform``, flagstat and the k-mer and q-mer
counts), genomic features (``FeatureDataset``), and variants and
genotypes from a VCF or a genotype Parquet store (``GenotypeDataset``,
also the source of the known-sites tables).

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
        """Write by extension: ``.sam``, ``.bam``, ``.fq``/``.fastq``, else
        one Parquet file."""
        p = str(path)
        if p.endswith(".sam"):
            from adam_tpu_torch.io import sam

            sam.write_sam(p, self.batch, self.sidecar, self.header, sort_order)
        elif p.endswith(".bam"):
            from adam_tpu_torch.io import sam

            sam.write_bam(p, self.batch, self.sidecar, self.header, sort_order)
        elif p.endswith((".fq", ".fastq")):
            from adam_tpu_torch.io import fastq

            fastq.write_fastq(p, self.batch, self.sidecar)
        else:
            from adam_tpu_torch.io import parquet

            parquet.save_alignments(p, self.batch, self.sidecar, self.header,
                                    compression=compression)

    def save_paired_fastq(self, path1: str, path2: str, stringency="lenient") -> None:
        """First-of-pair reads to ``path1``, second-of-pair to ``path2``
        (:func:`adam_tpu_torch.io.fastq.write_paired_fastq`)."""
        from adam_tpu_torch.io import fastq

        fastq.write_paired_fastq(path1, path2, self.batch, self.sidecar,
                                 stringency=stringency)

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
class FeatureDataset:
    """Genomic features (GTF/BED/narrowPeak), the counterpart of
    ``adam_tpu/api/datasets.FeatureDataset``: host columns
    (:mod:`adam_tpu_torch.formats.features`)."""

    batch: "object"  # formats.features.FeatureBatch

    @staticmethod
    def load(path: str, fmt=None) -> "FeatureDataset":
        from adam_tpu_torch.io import features as fio

        return FeatureDataset(fio.read_features(path, fmt))

    def save(self, path: str) -> None:
        from adam_tpu_torch.io import features as fio

        fio.write_bed(path, self.batch)

    def __len__(self) -> int:
        return len(self.batch)

    def filter_by_overlapping_region(self, contig, start, end):
        return FeatureDataset(self.batch.filter_by_overlapping_region(contig, start, end))

    def as_genes(self):
        from adam_tpu_torch.models.genes import as_genes

        return as_genes(self.batch)

    def intervals(self, contig_names=None, device: str = "cuda"):
        return self.batch.intervals(contig_names, device=device)


@dataclass
class GenotypeDataset:
    """Variant sites + per-sample calls (the counterpart of
    ``adam_tpu/api/datasets.GenotypeDataset``): VCF and genotype-Parquet
    load and save, the callset samples, the variant-keyed annotation
    join, the allele count and the two known-sites tables.  Variants and
    genotypes stay columnar (:mod:`adam_tpu_torch.formats.variants`),
    linked by ``genotypes.variant_idx``."""

    variants: "object"  # formats.variants.VariantBatch
    genotypes: "object"  # formats.variants.GenotypeBatch
    seq_dict: "object"  # SequenceDictionary

    @staticmethod
    def load(path: str, **kw) -> "GenotypeDataset":
        """.vcf / .vcf.gz -> the VCF reader, anything else -> a genotype
        Parquet directory (``contig_names=`` fixes the contig index space,
        e.g. to a SAM header's)."""
        p = str(path)
        if p.endswith((".vcf", ".vcf.gz")):
            from adam_tpu_torch.io import vcf as vcf_io

            return GenotypeDataset(*vcf_io.read_vcf(p, **kw))
        from adam_tpu_torch.io import parquet

        return GenotypeDataset(*parquet.load_genotypes(p, **kw))

    def save(self, path: str, sort_on_save: bool = False) -> None:
        """.vcf / .vcf.gz -> VCF text, anything else -> a genotype Parquet
        directory; ``sort_on_save`` orders the sites by (contig, start)."""
        p = str(path)
        if p.endswith((".vcf", ".vcf.gz")):
            from adam_tpu_torch.io import vcf as vcf_io

            vcf_io.write_vcf(p, self.variants, self.genotypes, self.seq_dict, sort_on_save)
        else:
            from adam_tpu_torch.io import parquet

            ds = self.sorted_by_position() if sort_on_save else self
            parquet.save_genotypes(p, ds.variants, ds.genotypes, ds.seq_dict)

    def __len__(self) -> int:
        return len(self.variants)

    def sorted_by_position(self) -> "GenotypeDataset":
        """Variants ordered by (contig, start), genotype links remapped."""
        order = np.lexsort((self.variants.start, self.variants.contig_idx))
        inverse = np.empty(len(order), np.int32)
        inverse[order] = np.arange(len(order), dtype=np.int32)
        genotypes = replace(self.genotypes, variant_idx=inverse[self.genotypes.variant_idx])
        return GenotypeDataset(self.variants.take(order), genotypes, self.seq_dict)

    @property
    def contig_names(self) -> list:
        return [r.name for r in self.seq_dict.records]

    def callset_samples(self) -> list:
        """The distinct sample ids."""
        return list(self.genotypes.samples)

    def variant_keys(self) -> np.ndarray:
        return self.variants.variant_keys(self.contig_names)

    def join_annotations(self, ann_keys, ann_values) -> list:
        """Left outer join on the variant key: each site's annotation
        value, None where unmatched."""
        table = dict(zip(list(ann_keys), list(ann_values)))
        return [table.get(k) for k in self.variant_keys()]

    def allele_count(self):
        from adam_tpu_torch.formats.variants import allele_counts

        return allele_counts(self.variants, self.genotypes, self.contig_names)

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
