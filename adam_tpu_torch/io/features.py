"""Feature file parsers: GTF/GFF, BED, narrowPeak, wigFix (the port's
copy of ``adam_tpu/io/features.py``).

* GTF (and GFF3's ``ID=``/``Parent=``, ``mRNA`` read as ``transcript``):
  1-based closed ranges -> 0-based half-open, ``key "value";``
  attributes, feature id and parent per type, the exon id falling back
  to ``transcriptId_exonNumber``.
* BED: 0-based, optional name/score/strand columns, the rest kept as
  thickStart/thickEnd/itemRgb/blockCount/blockSizes/blockStarts.
* narrowPeak: BED3+ with signalValue/pValue/qValue/peak.
* wigFix -> BED: each fixedStep value one BED row.

The writer emits BED.  All of it is host Python, line by line.
"""

from __future__ import annotations

import re
import uuid
from typing import Optional

import numpy as np

from adam_tpu_torch.formats.features import FeatureBatch, FeatureBatchBuilder, strand_code

_GTF_ATTR = re.compile(r'\s*([^\s]+)\s"([^"]+)"')


def parse_gtf_attrs(attr_field: str) -> dict:
    out = {}
    for token in attr_field.split(";"):
        m = _GTF_ATTR.search(token)
        if m:
            out[m.group(1)] = m.group(2)
        elif "=" in token:  # GFF3 style key=value
            k, v = token.strip().split("=", 1)
            out[k] = v
    return out


def _gtf_line(builder: FeatureBatchBuilder, line: str) -> None:
    if line.startswith("#") or not line.strip():
        return
    f = line.rstrip("\n").split("\t")
    seqname, source, ftype, start, end, score, strand, _frame, attr = f[:9]
    attrs = parse_gtf_attrs(attr)

    # GFF3 spells transcripts 'mRNA' and wires the hierarchy with
    # ID=/Parent=: one vocabulary for the gene assembly
    if ftype == "mRNA":
        attrs.setdefault("original_type", ftype)
        ftype = "transcript"
    gff3_id, gff3_parent = attrs.get("ID"), attrs.get("Parent")

    exon_id = attrs.get("exon_id")
    if exon_id is None and "transcript_id" in attrs and "exon_number" in attrs:
        exon_id = attrs["transcript_id"] + "_" + attrs["exon_number"]

    if ftype == "gene":
        fid, parent = attrs.get("gene_id") or gff3_id, None
    elif ftype == "transcript":
        fid = attrs.get("transcript_id") or gff3_id
        parent = attrs.get("gene_id") or gff3_parent
    elif ftype == "exon":
        fid = exon_id or gff3_id
        parent = attrs.get("transcript_id") or gff3_parent
    elif ftype in ("CDS", "UTR"):
        fid = attrs.get("id") or gff3_id
        parent = attrs.get("transcript_id") or gff3_parent
    else:
        fid, parent = attrs.get("id") or gff3_id, gff3_parent

    builder.add(
        seqname,
        int(start) - 1,  # 1-based closed -> 0-based half-open
        int(end),
        strand_code(strand),
        float(score) if score not in (".", "") else np.nan,
        feature_id=fid or "",
        feature_type=ftype,
        source=source,
        parent_ids=[parent] if parent else [],
        attributes=attrs,
    )


def _bed_like_line(builder: FeatureBatchBuilder, line: str, extras) -> None:
    """The shared BED3+ layout; BED and narrowPeak differ only in what
    the columns past strand mean."""
    f = line.rstrip("\n").split("\t")
    if len(f) < 3 or line.startswith(("#", "track", "browser")):
        return
    attrs = {k: f[6 + i] for i, k in enumerate(extras) if len(f) > 6 + i}
    builder.add(
        f[0], int(f[1]), int(f[2]),
        strand_code(f[5]) if len(f) > 5 else 0,
        float(f[4]) if len(f) > 4 and f[4] != "." else np.nan,
        feature_id=str(uuid.uuid4()),
        feature_type=f[3] if len(f) > 3 else "",
        attributes=attrs,
    )


def _bed_line(builder: FeatureBatchBuilder, line: str) -> None:
    _bed_like_line(builder, line, ["thickStart", "thickEnd", "itemRgb",
                                   "blockCount", "blockSizes", "blockStarts"])


def _narrow_peak_line(builder: FeatureBatchBuilder, line: str) -> None:
    _bed_like_line(builder, line, ["signalValue", "pValue", "qValue", "peak"])


_PARSERS = {
    "gtf": _gtf_line,
    "gff": _gtf_line,
    "gff3": _gtf_line,
    "bed": _bed_line,
    "narrowpeak": _narrow_peak_line,
}


def read_features(path: str, fmt: Optional[str] = None) -> FeatureBatch:
    """Parse a feature file, its format taken from the extension unless
    ``fmt`` names it.  An unknown extension raises: guessing a parser
    turns a format mistake into a crash in the middle of the file."""
    import gzip

    base = path[:-3] if path.endswith(".gz") else path
    if fmt is None:
        ext = base.rsplit(".", 1)[-1].lower()
        if ext not in _PARSERS:
            raise ValueError(
                f"cannot infer feature format from {path!r}; pass fmt= "
                f"one of {sorted(_PARSERS)}"
            )
        fmt = ext
    parse = _PARSERS[fmt.lower()]
    builder = FeatureBatchBuilder()
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        for line in fh:
            parse(builder, line)
    return builder.build()


def write_bed(path: str, feats: FeatureBatch) -> None:
    with open(path, "w") as fh:
        side = feats.sidecar
        for i in range(len(feats)):
            score = feats.score[i]
            fh.write("\t".join([
                feats.contig_names[feats.contig_idx[i]],
                str(int(feats.start[i])),
                str(int(feats.end[i])),
                side.feature_type[i],
                "." if np.isnan(score) else f"{float(score):g}",
                {1: "+", -1: "-", 0: "."}[int(feats.strand[i])],
            ]) + "\n")


_WIG_DECL = re.compile(
    r"^fixedStep\s+chrom=(.+?)\s+start=([0-9]+)\s+step=([0-9]+)"
    r"\s*(?:$|span=([0-9]+).*$)"
)


def wigfix_to_bed_lines(lines):
    """Expand a fixedStep wiggle stream to BED rows.  Every non-blank,
    non-declaration line must be a number (scientific notation included);
    anything else raises, since skipping a line would shift every later
    coordinate."""
    contig, current, step, span = "", 0, 0, 1
    for line in lines:
        m = _WIG_DECL.match(line)
        if m:
            contig = m.group(1)
            current = int(m.group(2)) - 1  # to BED coords
            step = int(m.group(3))
            span = int(m.group(4)) if m.group(4) else span
            continue
        s = line.strip()
        if not s or s.startswith(("#", "track", "browser")):
            continue
        float(s)  # raises ValueError on malformed data lines
        yield "\t".join([contig, str(current), str(current + span), "", s])
        current += step


def wigfix_to_bed(wig_path: str, bed_path: str) -> None:
    with open(wig_path) as fin, open(bed_path, "w") as fout:
        for row in wigfix_to_bed_lines(fin):
            fout.write(row + "\n")
