"""Columnar variant and genotype batches (the port's copy of the data
model of ``adam_tpu/formats/variants.py``).

* :class:`VariantBatch` — coordinate/size columns plus a host
  :class:`VariantSidecar` for allele strings, ids, filters and INFO.
* :class:`GenotypeBatch` — one row per (variant, sample) call;
  ``variant_idx`` joins back to the VariantBatch row.

Sites are always bi-allelic rows: the VCF reader splits multi-allelic
records at ingest (``adam_tpu_torch/io/vcf.py``).  These are the columns
the known-sites tables (``models/snp_table.py``) are built from, with the
site statistics and the allele count at the end.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

# GenotypeAllele enum codes
ALLELE_REF = 0
ALLELE_ALT = 1
ALLELE_OTHER_ALT = 2
ALLELE_NO_CALL = 3

PL_MISSING = -1


@dataclass
class VariantSidecar:
    """Host-only variable-width columns for a VariantBatch."""

    ref_allele: list = field(default_factory=list)  # str per row
    alt_allele: list = field(default_factory=list)  # str or None (gVCF ref block)
    names: list = field(default_factory=list)  # rs id / VCF ID ('' if '.')
    filters: list = field(default_factory=list)  # list[str] per row ([] = PASS/unfiltered)
    info: list = field(default_factory=list)  # dict per row (INFO annotations)

    def take(self, idx) -> "VariantSidecar":
        idx = np.asarray(idx)
        return VariantSidecar(
            [self.ref_allele[i] for i in idx],
            [self.alt_allele[i] for i in idx],
            [self.names[i] for i in idx],
            [self.filters[i] for i in idx],
            [self.info[i] for i in idx],
        )


@dataclass
class VariantBatch:
    """Bi-allelic variant sites as columnar arrays."""

    contig_idx: np.ndarray  # i32[N], index into SequenceDictionary
    start: np.ndarray  # i64[N], 0-based
    end: np.ndarray  # i64[N], exclusive (start + len(ref))
    ref_len: np.ndarray  # i32[N]
    alt_len: np.ndarray  # i32[N], 0 when alt is None (reference model row)
    qual: np.ndarray  # f32[N], phred-scaled site quality (QUAL; nan if '.')
    filters_applied: np.ndarray  # bool[N]
    passing: np.ndarray  # bool[N] (meaningful when filters_applied)
    sidecar: VariantSidecar = field(default_factory=VariantSidecar)

    def __len__(self):
        return len(self.start)

    @property
    def is_snp(self) -> np.ndarray:
        return (self.ref_len == 1) & (self.alt_len == 1)

    @property
    def is_indel(self) -> np.ndarray:
        return (self.alt_len > 0) & (self.ref_len != self.alt_len)

    def take(self, idx) -> "VariantBatch":
        idx = np.asarray(idx)
        return VariantBatch(
            self.contig_idx[idx], self.start[idx], self.end[idx],
            self.ref_len[idx], self.alt_len[idx], self.qual[idx],
            self.filters_applied[idx], self.passing[idx],
            self.sidecar.take(idx),
        )

    def variant_keys(self, contig_names) -> np.ndarray:
        """Join key per site: ``contig:start:ref:alt``."""
        return np.array(
            [
                f"{contig_names[c]}:{s}:{r}:{a or ''}"
                for c, s, r, a in zip(
                    self.contig_idx, self.start,
                    self.sidecar.ref_allele, self.sidecar.alt_allele,
                )
            ]
        )


@dataclass
class GenotypeBatch:
    """Per-sample calls, one row per (variant, sample): alleles pair, GQ,
    DP, AD (ref/alt split), phasing, the genotype likelihood triple, the
    gVCF non-reference likelihood triple and the split-from-multi-allelic
    marker."""

    variant_idx: np.ndarray  # i32[M] row in the VariantBatch
    sample_idx: np.ndarray  # i32[M] index into `samples`
    alleles: np.ndarray  # i8[M, 2] of ALLELE_* codes
    gq: np.ndarray  # i16[M], -1 missing
    dp: np.ndarray  # i32[M], -1 missing
    ref_depth: np.ndarray  # i32[M], -1 missing (AD[0])
    alt_depth: np.ndarray  # i32[M], -1 missing (AD[1])
    phased: np.ndarray  # bool[M]
    pl: np.ndarray  # i32[M, 3], PL_MISSING where absent
    nonref_pl: np.ndarray  # i32[M, 3], gVCF <NON_REF> likelihoods
    split_from_multiallelic: np.ndarray  # bool[M]
    samples: list = field(default_factory=list)  # sample names
    genotype_filters: list = field(default_factory=list)  # str per row (FT)

    def __len__(self):
        return len(self.variant_idx)

    def take(self, idx) -> "GenotypeBatch":
        idx = np.asarray(idx)
        return replace(
            self,
            variant_idx=self.variant_idx[idx],
            sample_idx=self.sample_idx[idx],
            alleles=self.alleles[idx],
            gq=self.gq[idx],
            dp=self.dp[idx],
            ref_depth=self.ref_depth[idx],
            alt_depth=self.alt_depth[idx],
            phased=self.phased[idx],
            pl=self.pl[idx],
            nonref_pl=self.nonref_pl[idx],
            split_from_multiallelic=self.split_from_multiallelic[idx],
            genotype_filters=[self.genotype_filters[i] for i in idx],
        )


# ------------------------------------------------------------------ stats

def rms_doubles(values: np.ndarray) -> float:
    """Root mean square."""
    v = np.asarray(values, np.float64)
    return float(np.sqrt(np.mean(v**2))) if v.size else 0.0


def rms_phred(phreds: np.ndarray) -> int:
    """RMS over phred scores via success-probability space
    (GenotypesToVariantsConverter.rms(Seq[Int]), :46-52)."""
    p = np.asarray(phreds, np.float64)
    if p.size == 0:
        return 0
    succ = 1.0 - 10.0 ** (-p / 10.0)
    r = rms_doubles(succ)
    err = max(1.0 - r, 1e-300)
    return int(round(-10.0 * np.log10(err)))


def variant_quality_from_genotypes(genotype_probs: np.ndarray) -> float:
    """P(at least one variant) = 1 - prod(1 - Pg)
    (GenotypesToVariantsConverter.variantQualityFromGenotypes, :69-70)."""
    v = np.asarray(genotype_probs, np.float64)
    return float(1.0 - np.prod(v))


def allele_counts(
    variants: VariantBatch, genotypes: GenotypeBatch, contig_names
):
    """Observed allele counts per site: for every called allele, Ref maps
    to the reference allele string, Alt to the alternate; OtherAlt/NoCall
    are dropped (AlleleCountHelper.chooseAllele semantics,
    adam-cli AlleleCount.scala:46-64).

    Returns a list of (contig_name, position, allele, count) sorted by
    position then allele.
    """
    vi = np.repeat(genotypes.variant_idx, 2)
    codes = genotypes.alleles.reshape(-1)
    keep = (codes == ALLELE_REF) | (codes == ALLELE_ALT)
    vi, codes = vi[keep], codes[keep]
    out: dict = {}
    side = variants.sidecar
    for v, c in zip(vi, codes):
        allele = side.ref_allele[v] if c == ALLELE_REF else side.alt_allele[v]
        if allele is None:
            continue
        key = (
            contig_names[variants.contig_idx[v]],
            int(variants.start[v]),
            allele,
        )
        out[key] = out.get(key, 0) + 1
    return sorted((k[0], k[1], k[2], n) for k, n in out.items())
