"""Typed variant-annotation INFO fields (the port's copy of
``adam_tpu/formats/annotations.py``).

A named set of VCF INFO keys becomes typed Parquet columns
(``ann_<adamKey>``) in the variants store: floats as float64 (so a VCF
value survives the round trip), ints as int64, flags as bool, so that
predicates push down on them; ``adam2vcf`` restores the VCF keys.
Unknown INFO keys stay in the generic string map.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# vcf INFO key -> (adam field name, element type).  Types follow the
# reference's attrAs{Int,Long,Float,String,Boolean} converters.
# VariantCallingAnnotations (INFO_KEYS, :97-111)
INFO_KEYS: dict[str, tuple[str, type]] = {
    "ClippingRankSum": ("clippingRankSum", float),
    "DP": ("readDepth", int),
    "FS": ("fisherStrandBiasPValue", float),
    "HaplotypeScore": ("haplotypeScore", float),
    "InbreedingCoeff": ("inbreedingCoefficient", float),
    "MQ": ("rmsMapQ", float),
    "MQ0": ("mapq0Reads", int),
    "MQRankSum": ("mqRankSum", float),
    "NEGATIVE_TRAIN_SITE": ("usedForNegativeTrainingSet", bool),
    "POSITIVE_TRAIN_SITE": ("usedForPositiveTrainingSet", bool),
    "QD": ("variantQualityByDepth", float),
    "ReadPosRankSum": ("readPositionRankSum", float),
    "VQSLOD": ("vqslod", float),
    "culprit": ("culprit", str),
}

# DatabaseVariantAnnotation (OMIM + CLINVAR + DBNSFP, :85-96).  The
# reference's CLINVAR dbSNP header line literally registers the key
# "dbSNP ID" (spaces included); kept verbatim for parity.
DB_KEYS: dict[str, tuple[str, type]] = {
    "VAR": ("omimId", str),
    "dbSNP ID": ("dbSnpId", int),
    "GENEINFO": ("geneSymbol", str),
    "PHYLOP": ("phylop", float),
    "SIFT_PRED": ("siftPred", str),
    "SIFT_SCORE": ("siftScore", float),
    "AA": ("ancestralAllele", str),
}

ANNOTATION_KEYS: dict[str, tuple[str, type]] = {**INFO_KEYS, **DB_KEYS}
_ADAM_TO_VCF = {adam: vcf for vcf, (adam, _t) in ANNOTATION_KEYS.items()}


def _convert(value, typ):
    """attrAs{Int,Float,Boolean,String} semantics: strings parse, flags
    (True) pass through; unparseable values raise like the reference's
    match errors."""
    if typ is bool:
        if isinstance(value, bool):
            return value
        return str(value).lower() in ("true", "1")
    if value is True:  # a flag key observed where a value was expected
        raise ValueError("flag value for non-flag annotation key")
    if typ is int:
        return int(float(value)) if "." in str(value) else int(value)
    if typ is float:
        return float(value)
    return str(value)


def split_typed(info_dicts) -> tuple[dict[str, list], list[dict]]:
    """Partition INFO maps into typed columns + leftover generic maps.

    -> (``{adamKey: [value-or-None per variant]}`` for every known key
    observed at least once, leftover dicts holding only unknown keys).
    """
    observed: dict[str, list] = {}
    leftover: list[dict] = []
    n = len(info_dicts)
    for i, d in enumerate(info_dicts):
        rest = {}
        for k, v in (d or {}).items():
            hit = ANNOTATION_KEYS.get(k)
            # VCF missing marker / unparseable values stay in the
            # generic map verbatim (the reference skips
            # MISSING_VALUE_v4 the same way, VariantAnnotation-
            # Converter.scala:130-134) so round trips stay lossless
            if hit is None or v == ".":
                rest[k] = v
                continue
            adam, typ = hit
            try:
                converted = _convert(v, typ)
            except (ValueError, TypeError):
                rest[k] = v
                continue
            col = observed.get(adam)
            if col is None:
                col = observed[adam] = [None] * n
            col[i] = converted
        leftover.append(rest)
    return observed, leftover


def merge_typed(typed: Optional[dict], info_dicts: list[dict]) -> list[dict]:
    """Inverse of :func:`split_typed`: typed columns -> VCF INFO keys
    layered over the generic maps (typed values win on key collision)."""
    if not typed:
        return info_dicts
    out = [dict(d or {}) for d in info_dicts]
    for adam, col in typed.items():
        vcf_key = _ADAM_TO_VCF.get(adam, adam)
        _a, typ = ANNOTATION_KEYS.get(vcf_key, (adam, str))
        for i, v in enumerate(col):
            if v is None or (
                isinstance(v, (float, np.floating)) and np.isnan(v)
            ):
                continue
            if typ is bool:
                if v:
                    out[i][vcf_key] = True
                continue
            if typ is float:
                # shortest value-exact digits, exponent form where
                # appropriate ('%g' truncated to 6 significant digits:
                # VQSLOD 1234.5678 -> "1234.57").  Integer-valued floats
                # print without the trailing ".0" (MQ=60 stays "60", as
                # '%g' printed it); numpy scalars format at their own
                # width so legacy float32 columns don't emit widening
                # noise.
                fv = float(v)
                if fv.is_integer() and abs(fv) < 1e16:
                    out[i][vcf_key] = str(int(fv))
                else:
                    out[i][vcf_key] = (
                        str(v) if isinstance(v, np.floating) else repr(fv)
                    )
            else:
                out[i][vcf_key] = str(v)
    return out


def arrow_type(adam_key: str):
    """Arrow storage type for a typed annotation column."""
    import pyarrow as pa

    vcf_key = _ADAM_TO_VCF.get(adam_key)
    typ = ANNOTATION_KEYS[vcf_key][1] if vcf_key else str
    if typ is bool:
        return pa.bool_()
    if typ is int:
        return pa.int64()
    if typ is float:
        # float64 so the VCF string -> column -> VCF string round trip
        # is value-exact (float32 storage dropped digits past ~7)
        return pa.float64()
    return pa.string()
