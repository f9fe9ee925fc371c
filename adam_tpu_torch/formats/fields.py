"""Projection field sets per record type (copied from
``adam_tpu/formats/fields.py``).

Each set names the Parquet columns a store writes, so a projection can be
pushed into the read; :func:`validate_projection` raises on an unknown
name, so a typo fails at the call instead of reading everything.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

# io/parquet.py to_arrow_alignments column set (AlignmentRecord fields)
ALIGNMENT_FIELDS = frozenset({
    "readName", "sequence", "qual", "flags", "contig", "start", "end",
    "mapq", "cigar", "mateContig", "mateAlignmentStart",
    "inferredInsertSize", "recordGroupName", "attributes",
    "mismatchingPositions", "origQual", "basesTrimmedFromStart",
    "basesTrimmedFromEnd",
})

# save_genotypes variants.parquet columns (VariantField + annotations)
VARIANT_FIELDS = frozenset({
    "contig", "start", "end", "referenceAllele", "alternateAllele",
    "name", "filters", "annotations", "qual", "filtersApplied",
    "filtersPassed", "variantIdx",
})

# save_genotypes genotypes.parquet columns (GenotypeField)
GENOTYPE_FIELDS = frozenset({
    "variantIdx", "sampleId", "allele0", "allele1", "genotypeQuality",
    "readDepth", "referenceReadDepth", "alternateReadDepth", "isPhased",
    "genotypeLikelihoods", "nonReferenceLikelihoods",
    "splitFromMultiAllelic", "genotypeFilters",
})

# save_features columns (FeatureField)
FEATURE_FIELDS = frozenset({
    "contig", "start", "end", "strand", "score", "featureId",
    "featureType", "source", "parentIds", "attributes",
})

# save_fragments columns (NucleotideContigFragmentField)
FRAGMENT_FIELDS = frozenset({
    "contig", "description", "fragmentSequence", "fragmentStartPosition",
    "fragmentNumber", "numberOfFragmentsInContig",
})


def validate_projection(
    projection: Optional[Sequence[str]],
    allowed: Iterable[str],
    essential: Iterable[str],
    what: str,
) -> Optional[list[str]]:
    """-> sorted column list (projection + essentials), or None for all.

    Unknown field names raise ValueError."""
    if projection is None:
        return None
    allowed = set(allowed)
    bad = sorted(set(projection) - allowed)
    if bad:
        raise ValueError(
            f"unknown {what} projection field(s) {bad}; "
            f"valid: {sorted(allowed)}"
        )
    return sorted(set(projection) | set(essential))
