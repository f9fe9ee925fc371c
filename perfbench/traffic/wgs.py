"""WGS-shaped reads sampled from a simulated genome, made from a seed.

A frozen, vectorised copy of the generator the repository's tools use
for chip runs (``make_wgs``): the same distributions, drawn in bulk.

* contigs of uniform random sequence;
* heterozygous indels (insertions and deletions alternating, 1-8 bp)
  every ``indel_every`` bp on average: half the pairs carry the variant
  haplotype, and half of the reads over a site are emitted as an
  indel-unaware aligner would map them (all-M CIGAR, the indel smeared
  into mismatches);
* SNPs every ``snp_every`` bp on average, carried by the same haplotype,
  written out as the known-sites VCF;
* quality-correlated sequencing errors, read-length variation, soft
  clips on the 5' side, unmapped pairs, PCR duplicates sharing their
  fragment, two libraries (read groups ``rg1`` and ``rg2``);
* exact MD and NM tags, coordinate order.

Two departures from the copied generator, both listed in the
configuration files: fragments are drawn so that every read lies inside
its contig (the copy could emit a CIGAR longer than the sequence within
a read length of a contig's end), and the random stream differs.

The reads come back as columns (:class:`Reads`); :mod:`.bam` writes
them as a BAM, :func:`write_vcf` writes the known sites.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

OP_M, OP_I, OP_D, OP_S = 0, 1, 2, 4  # BAM CIGAR op codes
MAX_OPS = 4  # clip + M + indel + M
PAD = 5  # base code of the padding lanes

DEFAULTS = dict(
    read_len=100, contigs=4, contig_len=800_000, indel_every=2_000,
    snp_every=900, error_rate=0.004, dup_frac=0.10, clip_frac=0.05,
    unmapped_frac=0.01, trimmed_frac=0.0, trimmed_min=22, trimmed_max=32,
)


@dataclass
class Reads:
    """Reads in file (coordinate) order, and the genome they came from."""

    names: np.ndarray       # i64 pair index: the read name is f"r{name}"
    flags: np.ndarray       # i32
    contig: np.ndarray      # i32, -1 unmapped
    start: np.ndarray       # i64 0-based alignment start, -1 unmapped
    mapq: np.ndarray        # i32
    cig_ops: np.ndarray     # u8 [n, MAX_OPS]
    cig_lens: np.ndarray    # i32 [n, MAX_OPS]
    n_ops: np.ndarray       # i32
    lengths: np.ndarray     # i32
    bases: np.ndarray       # u8 [n, read_len], codes ACGT = 0..3, PAD past the end
    quals: np.ndarray       # u8 [n, read_len] phred, 0 past the end
    rg: np.ndarray          # i8 read group: 0 = rg1, 1 = rg2
    mate_contig: np.ndarray  # i32
    mate_start: np.ndarray  # i64
    tlen: np.ndarray        # i32
    md: list                # str, None when unmapped
    nm: np.ndarray          # i32, -1 when unmapped
    genome: np.ndarray      # u8 [contigs, contig_len]
    snps: list              # per contig: sorted i64 positions of the known SNPs
    snp_alts: list          # per contig: the alternate base codes
    contig_names: list
    read_groups: list       # [(id, library)]

    @property
    def n(self) -> int:
        return len(self.flags)


def _rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([abs(int(seed)), int(seed < 0), salt]))


def _md_string(mism: np.ndarray, ref_codes: np.ndarray, length: int) -> str:
    out, last = [], 0
    for m in mism.tolist():
        out.append(str(m - last))
        out.append("ACGT"[ref_codes[m]])
        last = m + 1
    out.append(str(length - last))
    return "".join(out)


def _planted(rng, refs, p):
    """Indel and SNP sites per contig, as the copied generator plants them."""
    nc, clen = refs.shape
    L = p["read_len"]
    indels = []  # per contig: dict pos -> (is_ins, payload)
    for _c in range(nc):
        d = {}
        pos = int(rng.integers(500, p["indel_every"]))
        k = 0
        while pos < clen - 2 * L:
            ln = int(rng.integers(1, 9))
            d[pos] = (True, rng.integers(0, 4, ln).astype(np.uint8)) if k % 2 == 0 else (False, ln)
            pos += int(rng.integers(p["indel_every"] // 2, p["indel_every"] * 3 // 2))
            k += 1
        indels.append(d)
    snps, alts = [], []
    for c in range(nc):
        ps, al = [], []
        pos = int(rng.integers(100, p["snp_every"]))
        while pos < clen - L:
            ps.append(pos)
            al.append((int(refs[c, pos]) + int(rng.integers(1, 4))) % 4)
            pos += int(rng.integers(p["snp_every"] // 2, p["snp_every"] * 3 // 2))
        snps.append(np.asarray(ps, np.int64))
        alts.append(np.asarray(al, np.uint8))
    return indels, snps, alts


def make_reads(params: dict, seed: int) -> Reads:
    """The traffic of one seed: ``params`` holds ``reads`` and any of
    :data:`DEFAULTS`."""
    p = {**DEFAULTS, **params}
    n_req, L = int(p["reads"]), int(p["read_len"])
    nc, clen = int(p["contigs"]), int(p["contig_len"])
    rng = _rng(seed, 0xADA)
    refs = rng.integers(0, 4, (nc, clen), dtype=np.uint8)
    indels, snps, alts = _planted(rng, refs, p)
    hapg = refs.copy()  # the variant haplotype's SNPs
    for c in range(nc):
        hapg[c, snps[c]] = alts[c]
    ipos = [np.asarray(sorted(d), np.int64) for d in indels]

    # ---- pairs ----------------------------------------------------------
    n_pairs = n_req // 2
    n = 2 * n_pairs
    n_sites = max(1, int(n_pairs * (1.0 - p["dup_frac"])))
    site_contig = rng.integers(0, nc, n_sites)
    site_start = rng.integers(0, clen - 5 * L, n_sites)
    site_of_pair = np.concatenate(
        [np.arange(n_sites), rng.integers(0, n_sites, n_pairs - n_sites)])
    rng.shuffle(site_of_pair)
    site_isize = rng.integers(int(L * 2.2), int(L * 4), n_sites)
    hap = rng.random(n_pairs) < 0.5
    misalign = rng.random(n) < 0.5
    lens = np.where(rng.random(n) < 0.88, L, rng.integers(int(L * 0.6), L, n)).astype(np.int32)
    if p["trimmed_frac"] > 0.0:
        lens = np.where(rng.random(n) < p["trimmed_frac"],
                        rng.integers(p["trimmed_min"], p["trimmed_max"] + 1, n),
                        lens).astype(np.int32)
    clip = np.where(rng.random(n) < p["clip_frac"], rng.integers(3, 12, n), 0).astype(np.int32)
    unmapped_pair = rng.random(n_pairs) < p["unmapped_frac"]
    pos_l = np.arange(L, dtype=np.float32)
    base_q = 38.0 - 12.0 * (pos_l / max(L - 1, 1)) ** 2
    qf = base_q[None, :] + rng.standard_normal((n, L), dtype=np.float32) * 3.0
    quals = np.clip(qf, 2, 40).astype(np.uint8)
    del qf
    # P(error) = rate * 10^((25 - q) / 30), tabled over the 39 quality levels
    err_tab = (p["error_rate"] * np.power(10.0, (25.0 - np.arange(41)) / 30.0)).astype(np.float32)
    err_mask = rng.random((n, L), dtype=np.float32) < err_tab[quals]
    junk = rng.integers(0, 4, (n, 12), dtype=np.uint8)
    rand_seq = rng.integers(0, 4, (n, L), dtype=np.uint8)  # unmapped reads' bases

    # ---- per read ---------------------------------------------------------
    ri = np.arange(n, dtype=np.int64)
    pair = ri // 2
    first = (ri % 2) == 0  # the forward read is first of pair
    sp = site_of_pair[pair]
    c = site_contig[sp].astype(np.int64)
    s1 = site_start[sp].astype(np.int64)
    tl = site_isize[sp].astype(np.int64)
    um = unmapped_pair[pair]
    aln = (lens - clip).astype(np.int64)
    start = np.where(first, s1 + clip, s1 + tl - lens)
    mate_start = np.where(first, s1 + tl - lens[ri ^ 1], s1 + clip[ri ^ 1])
    big = np.int64(clen) * 4
    gkeys = np.concatenate([ci * big + ipos[ci] for ci in range(nc)])
    lo = np.searchsorted(gkeys, c * big + start + 1)
    lo_c = np.minimum(lo, max(len(gkeys) - 1, 0))
    use_indel = (hap[pair] & ~um & (lo < len(gkeys))
                 & (gkeys[lo_c] < c * big + start + aln - 1)) if len(gkeys) else np.zeros(n, bool)
    indel_at = np.where(use_indel, gkeys[lo_c] - c * big, -1) if len(gkeys) else np.full(n, -1)

    bases = np.full((n, L), PAD, np.uint8)
    qout = np.zeros((n, L), np.uint8)
    cig_ops = np.zeros((n, MAX_OPS), np.uint8)
    cig_lens = np.zeros((n, MAX_OPS), np.int32)
    n_ops = np.zeros(n, np.int32)
    md = [None] * n
    nm = np.full(n, -1, np.int32)
    col = np.arange(L, dtype=np.int64)[None, :]
    in_read = col < lens[:, None]
    qout[in_read] = quals[in_read]

    # unmapped pairs: random bases
    bases[um] = np.where(in_read[um], rand_seq[um], PAD)

    # the mapped reads without an indel: one gather from the haplotype
    plain = ~um & ~use_indel
    rows = np.flatnonzero(plain)
    a_len = aln[rows]
    inside = col < a_len[:, None]
    gidx = c[rows, None] * clen + np.minimum(start[rows, None] + col, clen - 1)
    refsl = refs.reshape(-1)[gidx]
    src = np.where(hap[pair[rows]][:, None], hapg.reshape(-1)[gidx], refsl)
    del gidx
    err = err_mask[rows] & inside
    bump = ((rows[:, None] + col) % 3 + 1).astype(np.uint8)
    src = np.where(err, (src + bump) & 3, src)
    mm = (src != refsl) & inside
    fwd = first[rows]
    cl = clip[rows].astype(np.int64)
    # forward reads carry the clip before the aligned bases, reverse after
    shift = np.where(fwd, cl, 0)[:, None]
    rowlen = (a_len + cl)[:, None]
    src_col = np.clip(col - shift, 0, L - 1)
    jcol = np.clip(np.where(fwd[:, None], col, col - a_len[:, None]), 0, 11)
    in_aln = (col >= shift) & (col < shift + a_len[:, None])
    bases[rows] = np.where(
        in_aln, np.take_along_axis(src, src_col, axis=1),
        np.where(col < rowlen, np.take_along_axis(junk[rows], jcol, axis=1), PAD))
    # CIGAR: [clip S] aln M or aln M [clip S]
    has_clip = cl > 0
    k_m = np.where(fwd & has_clip, 1, 0)
    cig_ops[rows, 0] = np.where(fwd & has_clip, OP_S, OP_M)
    cig_lens[rows, 0] = np.where(fwd & has_clip, cl, a_len)
    cig_ops[rows, k_m] = OP_M
    cig_lens[rows, k_m] = a_len
    rc = rows[~fwd & has_clip]
    cig_ops[rc, 1] = OP_S
    cig_lens[rc, 1] = clip[rc]
    n_ops[rows] = 1 + has_clip
    nm[rows] = err.sum(axis=1)
    has_mm = mm.any(axis=1)
    for j in np.flatnonzero(~has_mm):
        md[rows[j]] = str(int(a_len[j]))
    for j in np.flatnonzero(has_mm):
        md[rows[j]] = _md_string(np.flatnonzero(mm[j]), refsl[j], int(a_len[j]))

    # the mapped reads over a planted indel: the copied per-read walk
    for r in np.flatnonzero(use_indel).tolist():
        _indel_read(r, int(c[r]), int(start[r]), int(lens[r]), int(clip[r]), bool(first[r]),
                    int(indel_at[r]), bool(misalign[r]), refs, indels, snps, alts,
                    err_mask, junk, bases, cig_ops, cig_lens, n_ops, md, nm)

    flags = np.where(first, 0x1 | 0x20 | 0x40 | 0x2, 0x1 | 0x10 | 0x80 | 0x2).astype(np.int32)
    flags = np.where(um, np.where(first, 77, 141), flags).astype(np.int32)
    rg = np.where(sp % 3 != 0, 0, 1).astype(np.int8)
    rg = np.where(um, 0, rg).astype(np.int8)
    contig = np.where(um, -1, c).astype(np.int32)
    start = np.where(um, -1, start)
    mate_start = np.where(um, -1, mate_start)
    tlen = np.where(um, 0, np.where(first, tl, -tl)).astype(np.int32)
    mapq = np.where(um, 0, 60).astype(np.int32)
    n_ops = np.where(um, 0, n_ops).astype(np.int32)

    # coordinate order, unmapped last; ties keep pair order (a stable sort)
    order = np.lexsort((ri, np.where(um, 0, start), np.where(um, nc, c)))
    pick = lambda a: a[order]  # noqa: E731
    return Reads(
        names=pick(pair), flags=pick(flags), contig=pick(contig), start=pick(start),
        mapq=pick(mapq), cig_ops=pick(cig_ops), cig_lens=pick(cig_lens), n_ops=pick(n_ops),
        lengths=pick(lens), bases=pick(bases), quals=pick(qout), rg=pick(rg),
        mate_contig=pick(contig), mate_start=pick(mate_start), tlen=pick(tlen),
        md=[md[i] for i in order.tolist()], nm=pick(nm), genome=refs, snps=snps,
        snp_alts=alts, contig_names=[f"chr{i + 17}" for i in range(nc)],
        read_groups=[("rg1", "lib1"), ("rg2", "lib2")],
    )


def _indel_read(r, c, start, L, cl, fwd, ip, misalign, refs, indels, snps, alts,
                err_mask, junk, bases, cig_ops, cig_lens, n_ops, md, nm):
    """One read over a planted indel on the variant haplotype (the copied
    generator's walk, including its SNP placement by read offset)."""
    ref = refs[c]
    aln_len = L - cl
    a = ip - start
    is_ins, payload = indels[c][ip]
    if is_ins:
        b = min(len(payload), aln_len - a - 1)
        rest = aln_len - a - b
        seq = np.concatenate([ref[start:start + a], payload[:b], ref[start + a:start + a + rest]])
        cig = [(a, OP_M), (b, OP_I), (rest, OP_M)]
    else:
        dl = int(payload)
        rest = aln_len - a
        seq = np.concatenate([ref[start:start + a], ref[start + a + dl:start + a + dl + rest]])
        cig = [(a, OP_M), (dl, OP_D), (rest, OP_M)]
    sp, sa = snps[c], alts[c]
    for k in range(np.searchsorted(sp, start), np.searchsorted(sp, start + len(seq))):
        off = int(sp[k]) - start
        if 0 <= off < len(seq):
            seq[off] = sa[k]
    errs = np.flatnonzero(err_mask[r][:len(seq)])
    for e in errs.tolist():
        seq[e] = (int(seq[e]) + int(1 + (r + e) % 3)) % 4
    if misalign:
        cig = [(len(seq), OP_M)]
        rs = ref[start:start + len(seq)]
        tag = _md_string(np.flatnonzero(rs != seq), rs, len(seq))
    elif is_ins:
        rd = np.concatenate([seq[:a], seq[a + b:]])
        rs = ref[start:start + len(rd)]
        tag = _md_string(np.flatnonzero(rs != rd), rs, len(rd))
    else:
        ra = ref[start:start + a]
        rr = ref[start + a + dl:start + a + dl + rest]
        md_a = _md_string(np.flatnonzero(ra != seq[:a]), ra, a)
        md_r = _md_string(np.flatnonzero(rr != seq[a:]), rr, rest)
        tag = f"{md_a}^{''.join('ACGT'[x] for x in ref[start + a:start + a + dl])}{md_r}"
    if cl:
        if fwd:
            seq = np.concatenate([junk[r, :cl], seq])
            cig = [(cl, OP_S)] + cig
        else:
            seq = np.concatenate([seq, junk[r, :cl]])
            cig = cig + [(cl, OP_S)]
    bases[r, :len(seq)] = seq
    for k, (ln, op) in enumerate(cig):
        cig_ops[r, k] = op
        cig_lens[r, k] = ln
    n_ops[r] = len(cig)
    md[r] = tag
    nm[r] = int(len(errs))


def write_vcf(path: str, reads: Reads) -> None:
    """The known SNPs as a VCF (the dbSNP stand-in), contig order."""
    nc, clen = reads.genome.shape
    lines = ["##fileformat=VCFv4.2"]
    lines += [f"##contig=<ID={nm},length={clen}>" for nm in reads.contig_names]
    lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO")
    for c in range(nc):
        nm = reads.contig_names[c]
        ps = reads.snps[c]
        refb = reads.genome[c, ps]
        for p_, r_, a_ in zip(ps.tolist(), refb.tolist(), reads.snp_alts[c].tolist()):
            lines.append(f"{nm}\t{p_ + 1}\t.\t{'ACGT'[r_]}\t{'ACGT'[a_]}\t50\tPASS\t.")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
