"""Derive a known-indel VCF from an aligned SAM.

Every distinct indel (contig, position, insertion or deletion, allele)
that at least ``min_reads`` mapped reads carry becomes one VCF record:

* a deletion of reference bases ``XYZ`` after reference position ``p``
  (0-based, the last aligned base before it) is ``POS = p + 1``,
  ``REF = aXYZ``, ``ALT = a``, the deleted bases read from the MD tag's
  ``^XYZ``;
* an insertion of read bases ``XYZ`` after reference position ``p`` is
  ``POS = p + 1``, ``REF = a``, ``ALT = aXYZ``.

The anchor base ``a`` is the read's base before the event (as the
known-indel table reads only REF's length and ALT's inserted bases, the
anchor's value does not matter there).  Events with no aligned base
before them in the read are skipped.  Records are written per contig in
the SAM header's order, sorted by position, then deletions before
insertions, then allele.  ``make_wgs_sam.make_wgs`` writes known SNPs
only; this is the known-indel input of the ``knowns`` realignment model.

    python tools/make_known_indels_vcf.py IN.sam OUT.vcf [--min-reads 2]
"""

from __future__ import annotations

import argparse
import gzip
import re
from collections import Counter

_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")
_MD_DEL = re.compile(r"\^([A-Za-z]+)")


def _open_text(path: str):
    return gzip.open(path, "rt") if path.endswith(".gz") else open(path)


def _read_events(cigar: str, seq: str, pos0: int, md: str | None):
    """(kind, anchor ref pos, anchor base, allele) of each indel of one
    read; allele is the inserted read bases or the deleted reference
    bases (None when the read has no MD to name them)."""
    dels = _MD_DEL.findall(md) if md is not None else []
    n_del = 0
    rpos, qpos = pos0, 0
    out = []
    for ln, op in _CIGAR.findall(cigar):
        ln = int(ln)
        if op in "M=X":
            rpos += ln
            qpos += ln
        elif op == "I":
            if qpos > 0 and rpos > pos0:
                out.append(("I", rpos - 1, seq[qpos - 1], seq[qpos:qpos + ln]))
            qpos += ln
        elif op == "D":
            allele = dels[n_del] if n_del < len(dels) else None
            n_del += 1
            if qpos > 0 and rpos > pos0 and allele is not None and len(allele) == ln:
                out.append(("D", rpos - 1, seq[qpos - 1], allele.upper()))
            rpos += ln
        elif op == "N":
            rpos += ln
        elif op == "S":
            qpos += ln
    return out


def make_known_indels_vcf(sam_path: str, vcf_out: str, min_reads: int = 2) -> int:
    """Write the indels of ``sam_path`` carried by >= ``min_reads`` reads
    to ``vcf_out`` -> the number of records written."""
    contigs: list[tuple[str, int]] = []
    counts: Counter = Counter()
    anchors: dict = {}
    with _open_text(sam_path) as fh:
        for line in fh:
            if line.startswith("@"):
                if line.startswith("@SQ"):
                    f = dict(x.split(":", 1) for x in line.rstrip("\n").split("\t")[1:]
                             if ":" in x)
                    contigs.append((f["SN"], int(f.get("LN", 0))))
                continue
            cols = line.rstrip("\n").split("\t")
            cigar = cols[5]
            if ("I" not in cigar and "D" not in cigar) or int(cols[1]) & 0x4:
                continue
            md = next((t[5:] for t in cols[11:] if t.startswith("MD:Z:")), None)
            for kind, apos, abase, allele in _read_events(
                cigar, cols[9], int(cols[3]) - 1, md
            ):
                key = (cols[2], apos, kind, allele)
                counts[key] += 1
                anchors.setdefault(key, abase)
    order = {name: i for i, (name, _) in enumerate(contigs)}
    keep = sorted(
        (k for k, n in counts.items() if n >= min_reads and k[0] in order),
        key=lambda k: (order[k[0]], k[1], k[2], k[3]),
    )
    with open(vcf_out, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        for name, ln in contigs:
            fh.write(f"##contig=<ID={name},length={ln}>\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for k in keep:
            contig, apos, kind, allele = k
            a = anchors[k]
            ref, alt = (a + allele, a) if kind == "D" else (a, a + allele)
            fh.write(f"{contig}\t{apos + 1}\t.\t{ref}\t{alt}\t50\tPASS\tRC={counts[k]}\n")
    return len(keep)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sam")
    ap.add_argument("vcf")
    ap.add_argument("--min-reads", type=int, default=2)
    args = ap.parse_args()
    n = make_known_indels_vcf(args.sam, args.vcf, args.min_reads)
    print(f"wrote {args.vcf}: {n} known indels")
