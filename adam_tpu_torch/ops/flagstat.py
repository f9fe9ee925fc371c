"""samtools-flagstat metrics — the port's counterpart of
``adam_tpu/ops/flagstat.py``.

The metric definitions are the reference's ``rdd/read/FlagStat.scala``
(FlagStatMetrics / DuplicateMetrics, split by the vendor-quality flag).
Each metric is a masked i64 sum over the batch's flag columns, computed
on ``device`` (the JAX package's ``flagstat_device`` jit body as torch);
:func:`flagstat` brings all of them home in one fetch.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from adam_tpu_torch.device import resolve_device
from adam_tpu_torch.formats import schema
from adam_tpu_torch.formats.batch import ReadBatch


@dataclass(frozen=True)
class DuplicateMetrics:
    total: int
    both_mapped: int
    only_read_mapped: int
    cross_chromosome: int

    def __add__(self, other):
        return _add(self, other)


@dataclass(frozen=True)
class FlagStatMetrics:
    total: int
    duplicates_primary: DuplicateMetrics
    duplicates_secondary: DuplicateMetrics
    mapped: int
    paired_in_sequencing: int
    read1: int
    read2: int
    properly_paired: int
    with_self_and_mate_mapped: int
    singleton: int
    with_mate_mapped_to_diff_chromosome: int
    with_mate_mapped_to_diff_chromosome_mapq5: int

    def __add__(self, other):
        return _add(self, other)

    def to_ints(self) -> "FlagStatMetrics":
        """Every count as a Python int (the counts of
        :func:`flagstat_device` come home in one fetch)."""
        leaves = _leaves(self)
        if any(isinstance(x, torch.Tensor) for x in leaves):
            # adam-tpu: noqa[host-sync] reason=the JAX package's to_ints fetches its metric structs outside device_fetch too; 36 scalars in one copy
            leaves = torch.stack([torch.as_tensor(x) for x in leaves]).cpu().tolist()
        return to_metrics(leaves)


def _add(a, b):
    """Field-wise sum of two metric structs (nested structs recurse)."""
    return type(a)(*(getattr(a, f.name) + getattr(b, f.name) for f in fields(a)))


def _leaves(m) -> list:
    """The 18 counts of one FlagStatMetrics, in field order."""
    out = []
    for f in fields(m):
        v = getattr(m, f.name)
        out.extend(_leaves(v) if isinstance(v, DuplicateMetrics) else [v])
    return out


def _metric_masks(flags, contig_idx, mate_contig_idx, mapq) -> list:
    """The 18 row masks of one FlagStatMetrics, in field order (the
    duplicate blocks flattened where they stand)."""
    def has(bit):
        return (flags & bit) != 0

    mapped = ~has(schema.FLAG_UNMAPPED)
    mate_mapped = ~has(schema.FLAG_MATE_UNMAPPED)
    paired = has(schema.FLAG_PAIRED)
    primary = ~has(schema.FLAG_SECONDARY)
    dup = has(schema.FLAG_DUPLICATE)
    # isSameContig(contig, mateContig): name equality, null == null
    # included — index equality reproduces it (-1 == -1)
    same_contig = contig_idx == mate_contig_idx
    diff_chrom = paired & mapped & mate_mapped & ~same_contig

    def dup_masks(which):
        m = dup & which
        return [m, m & mapped & mate_mapped, m & mapped & ~mate_mapped,
                m & ~same_contig]

    return [
        torch.ones_like(mapped),
        *dup_masks(primary),
        *dup_masks(~primary),
        mapped,
        paired,
        paired & has(schema.FLAG_FIRST_OF_PAIR),
        paired & has(schema.FLAG_SECOND_OF_PAIR),
        paired & has(schema.FLAG_PROPER_PAIR),
        paired & mapped & mate_mapped,
        paired & mapped & ~mate_mapped,
        diff_chrom,
        diff_chrom & (mapq >= 5),
    ]


def to_metrics(counts) -> FlagStatMetrics:
    """One row of :func:`flagstat_counts` -> its metrics."""
    c = [int(x) for x in counts]
    return _struct(c)


def _struct(c) -> FlagStatMetrics:
    return FlagStatMetrics(c[0], DuplicateMetrics(*c[1:5]), DuplicateMetrics(*c[5:9]),
                           *c[9:])


def flagstat_counts(flags, contig_idx, mate_contig_idx, mapq, valid):
    """Tensors of one batch -> i64[2, 18] counts: row 0 over the reads that
    failed vendor QC, row 1 over those that passed (valid rows only)."""
    failed = (flags & schema.FLAG_FAILED_QC) != 0
    select = torch.stack([failed & valid, ~failed & valid])
    masks = torch.stack(_metric_masks(flags, contig_idx, mate_contig_idx, mapq))
    return (masks[None, :, :] & select[:, None, :]).sum(dim=2, dtype=torch.int64)


def flagstat_device(b: ReadBatch, device: str = "cuda"
                    ) -> tuple[FlagStatMetrics, FlagStatMetrics]:
    """-> (failed_vendor_quality, passed_vendor_quality) metric structs
    whose counts are 0-d i64 tensors on ``device`` (default: the card),
    as JAX's ``flagstat_device`` leaves them on its device. They sum with
    ``+``; ``to_ints()`` brings them home."""
    dev = resolve_device(device)
    cols = [getattr(b, f) for f in ("flags", "contig_idx", "mate_contig_idx", "mapq",
                                    "valid")]
    cols = [(c if isinstance(c, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(c)))
            .to(dev) for c in cols]
    counts = flagstat_counts(*cols)
    return _struct(list(counts[0])), _struct(list(counts[1]))


def flagstat(b: ReadBatch, device: str = "cuda") -> tuple[FlagStatMetrics, FlagStatMetrics]:
    """-> (failed_vendor_quality, passed_vendor_quality) metrics, counted
    on ``device`` (default: the card)."""
    dev = resolve_device(device)
    b = b.to_numpy()
    cols = [torch.from_numpy(np.ascontiguousarray(getattr(b, f))).to(dev)
            for f in ("flags", "contig_idx", "mate_contig_idx", "mapq", "valid")]
    # adam-tpu: noqa[host-sync] reason=the JAX package's flagstat fetches its counts outside device_fetch too (FlagStatMetrics.to_ints); one 2x18 count matrix per report
    counts = flagstat_counts(*cols).cpu().numpy()
    return to_metrics(counts[0]), to_metrics(counts[1])


def format_flagstat(failed: FlagStatMetrics, passed: FlagStatMetrics) -> str:
    """samtools-flagstat-style text report, the reference CLI's format
    string: all percentages are over ``total``, and a zero denominator
    prints 0.00%."""
    def pct(num, den):
        return f"{100.0 * num / den:.2f}%" if den else "0.00%"

    p, f = passed, failed
    lines = [
        f"{p.total} + {f.total} in total (QC-passed reads + QC-failed reads)",
        f"{p.duplicates_primary.total} + {f.duplicates_primary.total} primary duplicates",
        f"{p.duplicates_primary.both_mapped} + {f.duplicates_primary.both_mapped} "
        "primary duplicates - both read and mate mapped",
        f"{p.duplicates_primary.only_read_mapped} + {f.duplicates_primary.only_read_mapped} "
        "primary duplicates - only read mapped",
        f"{p.duplicates_primary.cross_chromosome} + {f.duplicates_primary.cross_chromosome} "
        "primary duplicates - cross chromosome",
        f"{p.duplicates_secondary.total} + {f.duplicates_secondary.total} secondary duplicates",
        f"{p.duplicates_secondary.both_mapped} + {f.duplicates_secondary.both_mapped} "
        "secondary duplicates - both read and mate mapped",
        f"{p.duplicates_secondary.only_read_mapped} + {f.duplicates_secondary.only_read_mapped} "
        "secondary duplicates - only read mapped",
        f"{p.duplicates_secondary.cross_chromosome} + {f.duplicates_secondary.cross_chromosome} "
        "secondary duplicates - cross chromosome",
        f"{p.mapped} + {f.mapped} mapped ({pct(p.mapped, p.total)}:{pct(f.mapped, f.total)})",
        f"{p.paired_in_sequencing} + {f.paired_in_sequencing} paired in sequencing",
        f"{p.read1} + {f.read1} read1",
        f"{p.read2} + {f.read2} read2",
        f"{p.properly_paired} + {f.properly_paired} properly paired "
        f"({pct(p.properly_paired, p.total)}:{pct(f.properly_paired, f.total)})",
        f"{p.with_self_and_mate_mapped} + {f.with_self_and_mate_mapped} "
        "with itself and mate mapped",
        f"{p.singleton} + {f.singleton} singletons "
        f"({pct(p.singleton, p.total)}:{pct(f.singleton, f.total)})",
        f"{p.with_mate_mapped_to_diff_chromosome} + "
        f"{f.with_mate_mapped_to_diff_chromosome} with mate mapped to a different chr",
        f"{p.with_mate_mapped_to_diff_chromosome_mapq5} + "
        f"{f.with_mate_mapped_to_diff_chromosome_mapq5} "
        "with mate mapped to a different chr (mapQ>=5)",
    ]
    return "\n".join(lines)
