"""VCF reader with bi-allelic splitting, and the writer (the port's copy
of ``adam_tpu/io/vcf.py``).

Every emitted site is bi-allelic: multi-allelic records are split per
ALT allele with genotype punch-out (AD reduced to [ref, alt], PL reduced
to the diploid (0/0, 0/alt, alt/alt) triple re-normalized to min 0,
genotypes marked phased + split-from-multi-allelic).  The gVCF symbolic
``<NON_REF>`` allele maps to ``alt=None`` with its likelihoods in
``nonref_pl``.  ``.vcf.gz`` files are read through gzip.  The columns
fill :mod:`adam_tpu_torch.formats.variants`.
"""

from __future__ import annotations

import gzip
from typing import Optional

import numpy as np

from adam_tpu_torch.formats import variants as vf
from adam_tpu_torch.models.dictionaries import SequenceDictionary, SequenceRecord

NON_REF = "<NON_REF>"


def _diploid_pl_indices(idx: int) -> list[int]:
    """PL indices of genotypes over alleles {0, idx} in VCF genotype
    ordering: index(j,k) = k(k+1)/2 + j for j<=k."""
    return [0, idx * (idx + 1) // 2, idx * (idx + 1) // 2 + idx]


def _parse_gt(gt: str):
    """GT string -> (allele ints with -1 for '.', phased flag)."""
    phased = "|" in gt
    parts = gt.replace("|", "/").split("/")
    return [(-1 if p in (".", "") else int(p)) for p in parts], phased


def _code_allele(a: int, alt_idx: int) -> int:
    if a < 0:
        return vf.ALLELE_NO_CALL
    if a == 0:
        return vf.ALLELE_REF
    if a == alt_idx:
        return vf.ALLELE_ALT
    return vf.ALLELE_OTHER_ALT


def _parse_info(s: str) -> dict:
    out = {}
    if s == ".":
        return out
    for item in s.split(";"):
        if "=" in item:
            k, v = item.split("=", 1)
            out[k] = v
        else:
            out[item] = True
    return out


def _open_text(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def read_vcf(path: str, contig_names: Optional[list] = None):
    """Parse a VCF (``.vcf`` or ``.vcf.gz``) into (VariantBatch,
    GenotypeBatch, SequenceDictionary).

    ``contig_names`` optionally fixes the contig index space (e.g. from
    the SAM header); contigs it lacks are appended in first-seen order
    (``##contig`` header lines, then records).
    """
    header_contigs: list[tuple[str, int]] = []
    samples: list[str] = []
    names = list(contig_names) if contig_names else []
    name_to_idx = {n: i for i, n in enumerate(names)}

    rows = dict(contig=[], start=[], end=[], ref_len=[], alt_len=[],
                qual=[], applied=[], passing=[])
    side = vf.VariantSidecar()
    g_rows = dict(vi=[], si=[], alleles=[], gq=[], dp=[], rd=[], ad=[],
                  phased=[], pl=[], nrpl=[], split=[], ft=[])

    def contig_id(name: str) -> int:
        if name not in name_to_idx:
            name_to_idx[name] = len(names)
            names.append(name)
        return name_to_idx[name]

    def emit_site(chrom, pos1, vid, ref, alt, qual, filt, info,
                  fmt_keys, sample_fields, alt_idx, n_alts):
        """Append one bi-allelic site (+ genotypes). alt may be None."""
        vi = len(rows["start"])
        rows["contig"].append(contig_id(chrom))
        rows["start"].append(pos1 - 1)
        # INFO END (1-based inclusive) extends gVCF reference blocks past
        # len(ref)
        end0 = pos1 - 1 + len(ref)
        if alt is None and "END" in info:
            end0 = max(end0, int(info["END"]))
        rows["end"].append(end0)
        rows["ref_len"].append(len(ref))
        rows["alt_len"].append(len(alt) if alt else 0)
        rows["qual"].append(float(qual) if qual != "." else np.nan)
        applied = filt != "."
        rows["applied"].append(applied)
        rows["passing"].append(filt in ("PASS", "."))
        side.ref_allele.append(ref)
        side.alt_allele.append(alt)
        side.names.append("" if vid == "." else vid)
        side.filters.append([] if filt in (".", "PASS") else filt.split(";"))
        side.info.append(info)

        split = n_alts > 1
        for si, f in enumerate(sample_fields):
            vals = dict(zip(fmt_keys, f.split(":")))
            gt = vals.get("GT", ".")
            raw_alleles, phased = _parse_gt(gt)
            # pad haploid calls to a pair with no-call (ploidy <= 2)
            while len(raw_alleles) < 2:
                raw_alleles.append(-1)
            coded = [_code_allele(a, alt_idx) for a in raw_alleles[:2]]

            ad = vals.get("AD", "")
            rd_v, ad_v = -1, -1
            if ad and ad != ".":
                # keep positions: '.' entries are missing, not removable
                parts = [
                    (int(x) if x not in (".", "") else None)
                    for x in ad.split(",")
                ]
                if parts and parts[0] is not None:
                    rd_v = parts[0]
                if alt_idx < len(parts) and parts[alt_idx] is not None:
                    ad_v = parts[alt_idx]
            pl_v = [vf.PL_MISSING] * 3
            nrpl_v = [vf.PL_MISSING] * 3
            pl = vals.get("PL", "")
            if pl and pl != ".":
                all_pls = [int(x) for x in pl.split(",")]
                if alt is None and n_alts == 1:
                    # pure reference model row (sole ALT was <NON_REF>):
                    # likelihoods describe ref vs any-nonref
                    nrpl_v = (all_pls + [vf.PL_MISSING] * 3)[:3]
                else:
                    idxs = [
                        i for i in _diploid_pl_indices(alt_idx)
                        if i < len(all_pls)
                    ]
                    sub = [all_pls[i] for i in idxs]
                    if sub:
                        m = min(sub)
                        sub = [p - m for p in sub]  # renormalize
                    pl_v = (sub + [vf.PL_MISSING] * 3)[:3]

            g_rows["vi"].append(vi)
            g_rows["si"].append(si)
            g_rows["alleles"].append(coded)
            g_rows["gq"].append(int(vals["GQ"]) if vals.get("GQ", ".") not in (".", "") else -1)
            g_rows["dp"].append(int(vals["DP"]) if vals.get("DP", ".") not in (".", "") else -1)
            g_rows["rd"].append(rd_v)
            g_rows["ad"].append(ad_v)
            g_rows["phased"].append(phased or split)
            g_rows["pl"].append(pl_v)
            g_rows["nrpl"].append(nrpl_v)
            g_rows["split"].append(split)
            g_rows["ft"].append(vals.get("FT", ""))

    with _open_text(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("##"):
                if line.startswith("##contig="):
                    body = line[len("##contig=<"):].rstrip(">")
                    kv = dict(
                        p.split("=", 1) for p in body.split(",") if "=" in p
                    )
                    if "ID" in kv:
                        header_contigs.append((kv["ID"], int(kv.get("length", 0))))
                continue
            if line.startswith("#CHROM"):
                cols = line.split("\t")
                samples = cols[9:]
                for n, _l in header_contigs:
                    contig_id(n)
                continue
            cols = line.split("\t")
            chrom, pos1, vid, ref, alt_s, qual, filt = cols[:7]
            info = _parse_info(cols[7]) if len(cols) > 7 else {}
            fmt_keys = cols[8].split(":") if len(cols) > 8 else []
            sample_fields = cols[9:]
            alts = alt_s.split(",") if alt_s != "." else []

            real_alts = [a for a in alts if a != NON_REF]
            if not real_alts:
                # gVCF reference block: single symbolic <NON_REF> alt
                emit_site(chrom, int(pos1), vid, ref, None, qual, filt,
                          info, fmt_keys, sample_fields, 1, 1)
            else:
                n = len(real_alts)
                for alt in real_alts:
                    emit_site(chrom, int(pos1), vid, ref, alt, qual, filt,
                              info, fmt_keys, sample_fields,
                              alts.index(alt) + 1, n)

    contig_lens = dict(header_contigs)
    seq_dict = SequenceDictionary(tuple(
        SequenceRecord(name=n, length=contig_lens.get(n, 0)) for n in names
    ))
    variants = vf.VariantBatch(
        np.asarray(rows["contig"], np.int32),
        np.asarray(rows["start"], np.int64),
        np.asarray(rows["end"], np.int64),
        np.asarray(rows["ref_len"], np.int32),
        np.asarray(rows["alt_len"], np.int32),
        np.asarray(rows["qual"], np.float32),
        np.asarray(rows["applied"], bool),
        np.asarray(rows["passing"], bool),
        side,
    )
    genotypes = vf.GenotypeBatch(
        np.asarray(g_rows["vi"], np.int32),
        np.asarray(g_rows["si"], np.int32),
        np.asarray(g_rows["alleles"], np.int8).reshape(-1, 2),
        np.asarray(g_rows["gq"], np.int16),
        np.asarray(g_rows["dp"], np.int32),
        np.asarray(g_rows["rd"], np.int32),
        np.asarray(g_rows["ad"], np.int32),
        np.asarray(g_rows["phased"], bool),
        np.asarray(g_rows["pl"], np.int32).reshape(-1, 3),
        np.asarray(g_rows["nrpl"], np.int32).reshape(-1, 3),
        np.asarray(g_rows["split"], bool),
        samples,
        g_rows["ft"],
    )
    return variants, genotypes, seq_dict


def write_vcf(
    path: str,
    variants: vf.VariantBatch,
    genotypes: vf.GenotypeBatch,
    seq_dict: SequenceDictionary,
    sort_on_save: bool = False,
) -> None:
    """Emit VCF 4.1: 1-based coordinates, every genotype as
    GT:AD:DP:GQ:PL:FT, the rows optionally coordinate-sorted
    (``sort_on_save``)."""
    names = [r.name for r in seq_dict.records]
    order = np.arange(len(variants))
    if sort_on_save:
        order = np.lexsort(
            (variants.start, variants.contig_idx)
        )

    # genotype rows grouped by variant
    by_variant: dict[int, list[int]] = {}
    for gi, vi in enumerate(genotypes.variant_idx):
        by_variant.setdefault(int(vi), []).append(gi)

    gt_sep = {True: "|", False: "/"}
    code_to_num = {vf.ALLELE_REF: "0", vf.ALLELE_ALT: "1",
                   vf.ALLELE_OTHER_ALT: ".", vf.ALLELE_NO_CALL: "."}

    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.1\n")
        for r in seq_dict.records:
            if r.length:
                fh.write(f"##contig=<ID={r.name},length={r.length}>\n")
        fh.write(
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
            '##FORMAT=<ID=AD,Number=.,Type=Integer,Description="Allelic depths">\n'
            '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">\n'
            '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">\n'
            '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred likelihoods">\n'
            '##FORMAT=<ID=FT,Number=1,Type=String,Description="Genotype-level filter">\n'
        )
        fh.write(
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
            + ("\tFORMAT\t" + "\t".join(genotypes.samples)
               if genotypes.samples else "")
            + "\n"
        )
        for vi in order:
            vi = int(vi)
            side = variants.sidecar
            chrom = names[variants.contig_idx[vi]]
            pos1 = int(variants.start[vi]) + 1
            vid = side.names[vi] or "."
            ref = side.ref_allele[vi]
            alt = side.alt_allele[vi] or NON_REF
            q = variants.qual[vi]
            qual = "." if np.isnan(q) else f"{float(q):.2f}"
            if not variants.filters_applied[vi]:
                filt = "."
            elif variants.passing[vi]:
                filt = "PASS"
            else:
                filt = ";".join(side.filters[vi]) or "PASS"
            info_d = side.info[vi]
            info_s = (
                ";".join(
                    k if v is True else f"{k}={v}"
                    for k, v in info_d.items()
                )
                if info_d
                else "."
            )
            cols = [chrom, str(pos1), vid, ref, alt, qual, filt, info_s]
            gis = by_variant.get(vi, [])
            if genotypes.samples:
                cols.append("GT:AD:DP:GQ:PL:FT")
                per_sample = {int(genotypes.sample_idx[g]): g for g in gis}
                ref_block = side.alt_allele[vi] is None
                for si in range(len(genotypes.samples)):
                    g = per_sample.get(si)
                    if g is None:
                        cols.append("./.")
                        continue
                    sep = gt_sep[bool(genotypes.phased[g])]
                    gt = sep.join(
                        code_to_num[int(a)] for a in genotypes.alleles[g]
                    )
                    ad = (
                        f"{genotypes.ref_depth[g]},{genotypes.alt_depth[g]}"
                        if genotypes.ref_depth[g] >= 0
                        and genotypes.alt_depth[g] >= 0
                        else "."
                    )
                    dp = str(genotypes.dp[g]) if genotypes.dp[g] >= 0 else "."
                    gq = str(genotypes.gq[g]) if genotypes.gq[g] >= 0 else "."
                    # reference-model rows round-trip their likelihoods
                    # through the PL column (read_vcf routes them back to
                    # nonref_pl when ALT is <NON_REF>)
                    pls = (
                        genotypes.nonref_pl[g] if ref_block
                        else genotypes.pl[g]
                    )
                    pl = (
                        ",".join(str(int(p)) for p in pls if p != vf.PL_MISSING)
                        if pls[0] != vf.PL_MISSING
                        else "."
                    )
                    ft = genotypes.genotype_filters[g] or "."
                    cols.append(":".join([gt, ad, dp, gq, pl, ft]))
            fh.write("\t".join(cols) + "\n")
