"""Plain reference of the streamed flagship: duplicate marking, indel
realignment (the ``reads`` consensus model) and base quality score
recalibration, worked out again from the generated reads and the genome
they were sampled from.  NumPy and the standard library only.

It follows ADAM's documented semantics, as the program states them:

* **MarkDuplicates**: a pair's bucket keys on the 5' unclipped position
  and strand of its first and of its second read; within one library and
  key pair the bucket with the largest sum of base qualities >= 15 stays,
  ties going to the smaller read name (byte order); all other mapped
  reads of the group are duplicates.
* **RealignIndels**: targets from every I/D CIGAR op, merged while they
  overlap; each mapped read joins the first target whose read span it
  overlaps; per target the reference is rebuilt from the reads (a gap
  skips the target), reads with a mismatch are cleaned: a single indel
  is shifted left through repeats, each cleaned read with one indel and
  no leading clip gives a consensus, every cleaned read is swept over
  every consensus for the least sum of mismatching qualities, and the
  best consensus is taken when its log-odds gain exceeds 5.
* **BQSR**: canonical reads (mapped, primary, not duplicate, 0 < mapq <
  255) observe each aligned residue with quality > 0 outside the known
  SNPs, keyed by (read group, quality, cycle, dinucleotide); the table is
  solved in float64 with the hierarchical log-space deltas and applied to
  every residue of quality >= 5; the original qualities are kept as OQ.

The mismatches come from the genome itself (the reads' MD tags are
derived from the same genome), never from anything the program made.
"""

from __future__ import annotations

import random

import numpy as np

from perfbench.traffic.wgs import OP_D, OP_I, OP_M, OP_S, Reads

MAX_INDEL = 500
MAX_TARGET = 3000
MAX_CONSENSUS = 30
LOD = 5.0
N_QUAL = 94
MIN_Q = 5
MAX_QUAL = 50
OPC = "MIDNSHP=X"
_COMP = np.array([3, 2, 1, 0, 4, 5], np.int64)


def read_keys(r: Reads) -> np.ndarray:
    """One key per read: the pair index and which of the pair it is."""
    return r.names.astype(np.int64) * 2 + ((r.flags & 0x80) != 0)


def _ref_len(ops, lens, n_ops) -> np.ndarray:
    live = np.arange(ops.shape[1])[None, :] < n_ops[:, None]
    return np.where(live & np.isin(ops, (OP_M, OP_D)), lens, 0).sum(axis=1)


# --------------------------------------------------------------------------
# MarkDuplicates
# --------------------------------------------------------------------------
def mark_duplicates(r: Reads) -> np.ndarray:
    """-> bool[n]: the duplicate flag of every read."""
    mapped = (r.flags & 0x4) == 0
    ops, lens, n_ops = r.cig_ops, r.cig_lens.astype(np.int64), r.n_ops
    lead = np.where((n_ops > 0) & (ops[:, 0] == OP_S), lens[:, 0], 0)
    last = np.take_along_axis(ops, np.maximum(n_ops - 1, 0)[:, None].astype(np.int64), 1)[:, 0]
    last_len = np.take_along_axis(lens, np.maximum(n_ops - 1, 0)[:, None].astype(np.int64), 1)[:, 0]
    trail = np.where((n_ops > 1) & (last == OP_S), last_len, 0)
    rev = (r.flags & 0x10) != 0
    end = r.start + _ref_len(ops, lens, n_ops)
    five = np.where(rev, end + trail, r.start - lead)
    second = (r.flags & 0x80) != 0
    score = np.where(r.quals >= 15, r.quals, 0).astype(np.int64).sum(axis=1)

    pair_rows = np.flatnonzero(mapped)
    order = np.lexsort((second[pair_rows], r.names[pair_rows]))
    rows = pair_rows[order]
    a, b = rows[0::2], rows[1::2]  # first and second read of each mapped pair
    if not (np.array_equal(r.names[a], r.names[b]) and not second[a].any() and second[b].all()):
        raise ValueError("the reference expects whole mapped pairs")
    lib = r.rg[a].astype(np.int64)
    bscore = score[a] + score[b]
    name_b = np.array([f"r{p}".encode() for p in r.names[a].tolist()])
    keys = (name_b, -bscore, rev[b], five[b], r.contig[b], rev[a], five[a], r.contig[a], lib)
    srt = np.lexsort(keys)
    grp = np.stack([k[srt] for k in keys[2:]], axis=1)
    new = np.ones(len(srt), bool)
    new[1:] = (grp[1:] != grp[:-1]).any(axis=1)
    dup_pair = np.zeros(len(a), bool)
    dup_pair[srt] = ~new
    dup = np.zeros(r.n, bool)
    dup[a] = dup_pair
    dup[b] = dup_pair
    return dup


# --------------------------------------------------------------------------
# RealignIndels
# --------------------------------------------------------------------------
def _targets(r: Reads, rank: np.ndarray) -> list:
    """Merged targets [contig, var_start, var_end, range_start, range_end]."""
    mapped = (r.flags & 0x4) == 0
    ops, lens = r.cig_ops.astype(np.int64), r.cig_lens.astype(np.int64)
    live = np.arange(ops.shape[1])[None, :] < r.n_ops[:, None]
    adv = np.where(live & np.isin(ops, (OP_M, OP_D)), lens, 0)
    ref_at = r.start[:, None] + np.cumsum(adv, axis=1) - adv
    end = r.start + adv.sum(axis=1)
    parts = []
    for k in range(ops.shape[1]):
        for code in (OP_I, OP_D):
            rows = np.flatnonzero(mapped & live[:, k] & (ops[:, k] == code) & (lens[:, k] <= MAX_INDEL))
            vs = ref_at[rows, k]
            ve = vs + 1 if code == OP_I else vs + lens[rows, k]
            parts.append(np.stack([r.contig[rows].astype(np.int64), vs, ve, r.start[rows], end[rows]], 1))
    ev = np.concatenate(parts) if parts else np.zeros((0, 5), np.int64)
    ev = ev[np.lexsort((ev[:, 4], ev[:, 3], rank[ev[:, 0]]))]
    merged: list = []
    for c, vs, ve, rs, re in ev.tolist():
        if merged:
            m = merged[-1]
            if m[0] == c and ((m[2] > rs and re > m[1]) or (ve > m[3] and m[4] > vs)):
                m[1], m[2] = min(m[1], vs), max(m[2], ve)
                m[3], m[4] = min(m[3], rs), max(m[4], re)
                continue
            if m[0] == c and m[3] == rs and m[4] == re:
                continue
        merged.append([c, vs, ve, rs, re])
    return [t for t in merged if t[4] - t[3] <= MAX_TARGET]


def _map_to_targets(r: Reads, targets: list, rank: np.ndarray) -> np.ndarray:
    """Each mapped read -> the first target whose read span it overlaps, else -1."""
    out = np.full(r.n, -1, np.int64)
    if not targets:
        return out
    t = np.asarray(targets, np.int64)
    big = np.int64(1) << 40
    ts, te = rank[t[:, 0]] * big + t[:, 3], rank[t[:, 0]] * big + t[:, 4]
    order = np.argsort(ts, kind="stable")
    ts, te = ts[order], te[order]
    cm = np.maximum.accumulate(te)
    mapped = (r.flags & 0x4) == 0
    end = r.start + _ref_len(r.cig_ops, r.cig_lens.astype(np.int64), r.n_ops)
    rr = rank[np.clip(r.contig, 0, None)]
    rs, re = rr * big + r.start, rr * big + end
    j = np.searchsorted(cm, rs, side="right")
    jc = np.clip(j, 0, len(ts) - 1)
    hit = mapped & (j < len(ts)) & (ts[jc] < re) & (te[jc] > rs)
    out[hit] = order[jc[hit]]
    return out


def _shift_indel(cig: list, pos: int, shifts: int) -> list:
    def total(c):
        return sum(n for n, _ in c)

    def rlen(c):
        return sum(n for n, o in c if o in "MIS=X")

    def flen(c):
        return sum(n for n, o in c if o in "MDN=X")

    def move_left(c, index):
        if index == 0 or len(c) < 2:
            return list(c)
        head, rest = list(c[:index - 1]), list(c[index - 1:])
        trim, move = rest[0], rest[1] if len(rest) > 1 else None
        pad = rest[2] if len(rest) > 2 else None
        out = list(head)
        if trim[0] > 1:
            out.append((trim[0] - 1, trim[1]))
        if move is not None:
            out.append(move)
        out.append((pad[0] + 1, pad[1]) if pad is not None else (1, "M"))
        return out + (rest[3:] if len(rest) > 4 else [])

    cur, t0, r0, f0 = list(cig), total(cig), rlen(cig), flen(cig)
    while True:
        new = move_left(cur, pos)
        if shifts == 0 or total(new) != t0 or rlen(new) != r0 or flen(new) != f0:
            return cur
        cur, shifts = new, shifts - 1


def _left_align(seq: str, cig: list, ref: str) -> list:
    """Shift a read's single indel left through repeated sequence."""
    pos, ilen, ins, read_pos, ref_pos = -1, 0, False, 0, 0
    for k, (n, op) in enumerate(cig):
        if op in "ID":
            if pos != -1:
                return list(cig)
            pos, ilen, ins = k, n, op == "I"
        elif pos == -1:
            read_pos += n if op in "MIS=X" else 0
            ref_pos += n if op in "MDN=X" else 0
    if pos == -1:
        return list(cig)
    variant = seq[read_pos:read_pos + ilen] if ins else ref[ref_pos:ref_pos + ilen]
    pre, shift = seq[:read_pos], 0
    while pre and variant and pre[-1] == variant[-1]:
        variant, pre, shift = variant[-1] + variant[:-1], pre[:-1], shift + 1
    return _shift_indel(cig, pos, shift)


def _consensus(seq: str, start: int, cig: list):
    if sum(1 for _, op in cig if op in "ID") != 1:
        return None
    read_pos, ref_pos = 0, start
    for n, op in cig:
        if op == "I":
            return (seq[read_pos:read_pos + n], ref_pos, ref_pos + 1)
        if op == "D":
            return ("", ref_pos, ref_pos + n + 1)
        if op in "M=X":
            read_pos += n
            ref_pos += n
        else:
            return None
    return None


def _mm_qual(seq: str, ref: str, quals: np.ndarray) -> int:
    """Sum of the qualities where the read and a reference string differ
    position by position, CIGAR ignored, to the shorter of the two."""
    n = min(len(seq), len(ref), len(quals))
    a = np.frombuffer(seq.encode(), np.uint8, n)
    b = np.frombuffer(ref.encode(), np.uint8, n)
    return int(quals[:n][a != b].sum())


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round to bfloat16 (8 significant bits, to nearest even)."""
    import torch

    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).to(torch.float32).numpy()


def realign(r: Reads, sweep_bf16: bool = False) -> dict:
    """-> {row: (start, cigar [(len, op)], mapq)} for every read whose
    alignment changes.  ``sweep_bf16`` (the control) rounds each sweep's
    match sum to bfloat16, as a bf16 matmul would return it."""
    rng = random.Random(0)  # draws only past MAX_CONSENSUS consensuses
    names = r.contig_names
    rank_of = {nm: i for i, nm in enumerate(sorted(names))}
    rank = np.array([rank_of[nm] for nm in names], np.int64)
    targets = _targets(r, rank)
    tidx = _map_to_targets(r, targets, rank)
    sel = np.flatnonzero(tidx >= 0)
    sel = sel[np.lexsort((sel, r.start[sel], tidx[sel]))]
    bounds = np.flatnonzero(np.diff(tidx[sel]) != 0) + 1
    groups = np.split(sel, bounds) if len(sel) else []
    lens64 = r.cig_lens.astype(np.int64)
    end_all = r.start + _ref_len(r.cig_ops, lens64, r.n_ops)
    g = r.genome
    out: dict = {}

    def gstr(c, a, b):
        return g[c, a:b].tobytes().translate(_ACGT)

    for rows in groups:
        t = targets[int(tidx[rows[0]])]
        c = t[0]
        reads, spans = [], []
        for i in rows.tolist():
            L = int(r.lengths[i])
            no = int(r.n_ops[i])
            cig = [(int(r.cig_lens[i, k]), OPC[r.cig_ops[i, k]]) for k in range(no)]
            s0, e0 = int(r.start[i]), int(end_all[i])
            spans.append((s0, e0))
            codes = r.bases[i, :L]
            # mismatches at aligned positions, against the genome
            rp = _ref_positions(cig, s0, L)
            al = rp >= 0
            mism = bool((codes[al] != g[c, rp[al]]).any())
            if not mism:
                continue
            seq = codes.tobytes().translate(_ACGT).decode()
            reads.append({"row": i, "seq": seq, "quals": r.quals[i, :L].astype(np.int64),
                          "start": s0, "cig": cig, "mapq": int(r.mapq[i]), "dirty": False,
                          "pure": no == 1 and cig[0][1] == "M", "codes": codes, "rp": rp})
        if not reads:
            continue
        # the reference rebuilt from the reads: a gap skips the target
        srt = sorted(spans, key=lambda s: s[0])
        ref_start, cur, gap = srt[0][0], srt[0][0], False
        for s0, e0 in srt:
            if e0 < cur:
                continue
            if cur >= s0:
                cur = e0
            else:
                gap = True
                break
        if gap:
            continue
        ref_end = cur
        reference = gstr(c, ref_start, ref_end).decode()
        for rd in reads:
            if sum(1 for _, op in rd["cig"] if op == "M") == 2:
                ref = gstr(c, rd["start"], rd["start"] + _flen(rd["cig"])).decode()
                new = _left_align(rd["seq"], rd["cig"], ref)
                if new != rd["cig"]:
                    rd["cig"], rd["dirty"] = new, True
        cons, seen = [], set()
        for rd in reads:
            cs = _consensus(rd["seq"], rd["start"], rd["cig"])
            if cs is not None and cs not in seen:
                seen.add(cs)
                cons.append(cs)
        if len(cons) > MAX_CONSENSUS:
            cons = rng.sample(cons, MAX_CONSENSUS)
        for rd in reads:
            if rd["dirty"]:
                out[rd["row"]] = (rd["start"], rd["cig"], rd["mapq"])
        if not cons:
            continue
        orig = np.array([_orig(rd, g, c) for rd in reads], np.int64)
        q = np.full((len(reads), len(cons)), np.inf)
        o = np.full((len(reads), len(cons)), -1, np.int64)
        for ci, (cseq, i0, i1) in enumerate(cons):
            if not (ref_start <= i0 <= ref_end and ref_start <= i1 - 1 <= ref_end):
                raise ValueError("consensus and reference do not overlap")
            cstr = reference[:i0 - ref_start] + cseq + reference[i1 - 1 - ref_start:]
            carr = np.frombuffer(cstr.encode(), np.uint8)
            for ri, rd in enumerate(reads):
                n_off = len(cstr) - len(rd["seq"])
                if n_off <= 0:
                    continue
                win = np.lib.stride_tricks.sliding_window_view(carr, len(rd["seq"]))[:n_off]
                sq = np.frombuffer(rd["seq"].encode(), np.uint8)
                cost = np.where(win != sq[None, :], rd["quals"][None, :], 0).sum(axis=1)
                if sweep_bf16:
                    tq = int(rd["quals"].sum())
                    cost = tq - _bf16(tq - cost)
                k = int(np.argmin(cost))
                q[ri, ci], o[ri, ci] = float(cost[k]), k
        use = q < orig[:, None]
        qi = np.where(use, np.where(np.isfinite(q), q, 0), 0).astype(np.int64)
        totals = np.where(use, qi, orig[:, None]).sum(axis=0)
        best = int(q.shape[1] - 1 - np.argmin(totals[::-1]))
        lod = (int(orig.sum()) - int(totals[best])) / 10.0
        if not lod > LOD:
            continue
        cseq, i0, i1 = cons[best]
        for ri, rd in enumerate(reads):
            if not use[ri, best] or o[ri, best] < 0:
                continue
            off = int(o[ri, best])
            ns = ref_start + off
            n = len(rd["seq"])
            if i0 == i1 - 1:
                ide, end_len, pen = (len(cseq), "I"), n - len(cseq) - (i0 - ns), -len(cseq)
            else:
                ide, end_len, pen = (i1 - 1 - i0, "D"), n - (i0 - ns), len(cseq)
            head = i0 - ns
            if head > 0 and end_len > 0:
                cig, ne = [(head, "M"), ide, (end_len, "M")], ns + n + pen
            else:
                cig, ne = [(n, "M")], ns + n
            if off + (ne - ns) > len(reference):
                continue
            out[rd["row"]] = (ns, cig, rd["mapq"] + 10)
    return out


_ACGT = bytes.maketrans(bytes(range(6)), b"ACGTN*")


def _flen(cig: list) -> int:
    return sum(n for n, op in cig if op in "MDN=X")


def _ref_positions(cig: list, start: int, length: int) -> np.ndarray:
    rp = np.full(length, -1, np.int64)
    qi, ri = 0, start
    for n, op in cig:
        if op in "M=X":
            rp[qi:qi + n] = np.arange(ri, ri + n)
            qi += n
            ri += n
        elif op in "IS":
            qi += n
        elif op in "DN":
            ri += n
    return rp


def _orig(rd: dict, g: np.ndarray, c: int) -> int:
    """The read's mismatch quality before realignment."""
    if rd["pure"] and not rd["dirty"]:
        rp = rd["rp"]
        return int(rd["quals"][rd["codes"] != g[c, rp]].sum())
    ref = g[c, rd["start"]:rd["start"] + _flen(rd["cig"])].tobytes().translate(_ACGT).decode()
    return _mm_qual(rd["seq"], ref, rd["quals"])


# --------------------------------------------------------------------------
# BQSR
# --------------------------------------------------------------------------
def _cycles_dinucs(bases, lengths, flags, lmax):
    """Sequencer cycle and dinucleotide index of every residue (torch)."""
    import torch

    dev = bases.device
    rev = (flags & 0x10) != 0
    second = ((flags & 0x1) != 0) & ((flags & 0x80) != 0)
    L = lengths.to(torch.int64)
    one = torch.ones_like(L)
    init = torch.where(rev, torch.where(second, -L, L), torch.where(second, -one, one))
    inc = torch.where(rev, torch.where(second, one, -one), torch.where(second, -one, one))
    i = torch.arange(lmax, device=dev)[None, :]
    cyc = init[:, None] + inc[:, None] * i
    b = bases.to(torch.int64)
    comp = torch.as_tensor(_COMP, device=dev)
    prev_f = torch.nn.functional.pad(b[:, :-1], (1, 0), value=4)
    nxt = torch.nn.functional.pad(b[:, 1:], (0, 1), value=4)
    cur = torch.where(rev[:, None], comp[b], b)
    prev = torch.where(rev[:, None], comp[nxt], prev_f)
    first_m = torch.where(rev[:, None], i == L[:, None] - 1, i == 0)
    ok = (i < L[:, None]) & ~first_m & (cur < 4) & (prev < 4)
    return cyc, torch.where(ok, prev * 4 + cur, 16)


def solve(total: np.ndarray, mism: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Recalibrated quality per (rg, q, cycle, dinuc) cell: the global,
    per-quality, per-cycle and per-dinucleotide log-space deltas,
    bounded to [Q50 error, 1] and rounded half up."""
    err = (10.0 ** (-np.arange(256) / 10.0)).astype(dtype)
    total = np.asarray(total, dtype)
    mism = np.asarray(mism, dtype)
    one, two = dtype(1.0), dtype(2.0)

    def emp(t, m):
        return np.log((one + m) / (two + t))

    g_t, g_m = total.sum(axis=(1, 2, 3)), mism.sum(axis=(1, 2, 3))
    q_t, q_m = total.sum(axis=(2, 3)), mism.sum(axis=(2, 3))
    qs = np.arange(N_QUAL)
    g_exp = (err[qs][None, :] * q_t).sum(axis=1)
    c_t, c_m = total.sum(axis=3), mism.sum(axis=3)
    d_t, d_m = total.sum(axis=2), mism.sum(axis=2)
    lp = np.log(err[qs])
    gp = g_t > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        gd = np.where(gp, emp(g_t, g_m) - np.log(g_exp / np.maximum(g_t, one)), 0.0).astype(dtype)
        qp = gp[:, None] & (q_t > 0)
        off1 = lp[None, :] + gd[:, None]
        qd = np.where(qp, emp(q_t, q_m) - off1, 0.0).astype(dtype)
        off2 = off1 + qd
        cd = np.where(qp[:, :, None] & (c_t > 0), emp(c_t, c_m) - off2[:, :, None], 0.0).astype(dtype)
        dd = np.where(qp[:, :, None] & (d_t > 0), emp(d_t, d_m) - off2[:, :, None], 0.0).astype(dtype)
    logp = off2[:, :, None, None] + cd[:, :, :, None] + dd[:, :, None, :]
    bounded = np.minimum(dtype(0.0), np.maximum(np.log(err[MAX_QUAL]), logp))
    return np.floor(dtype(-10.0) * np.log10(np.exp(bounded)) + dtype(0.5)).astype(np.int32)


def recalibrate(r: Reads, dup: np.ndarray, start, cig_ops, cig_lens, n_ops, mapq,
                known_sites: bool, solve_dtype=np.float64, device: str = "cpu") -> tuple:
    """-> (the recalibrated qualities u8[n, L], 0 past each read's end;
    the number of residues observed).  The [n, L] work runs in plain
    torch on ``device``, the solve in NumPy."""
    import torch

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    n, lmax = r.quals.shape
    nc, clen = r.genome.shape
    flags = t(r.flags.astype(np.int64))
    mapped = (flags & 0x4) == 0
    mq = t(mapq.astype(np.int64))
    read_ok = mapped & ((flags & 0xB00) == 0) & ~t(dup) & (mq > 0) & (mq < 255)
    ops = t(cig_ops.astype(np.int64))
    lens = t(cig_lens.astype(np.int64))
    C = ops.shape[1]
    live = torch.arange(C, device=device)[None, :] < t(n_ops.astype(np.int64))[:, None]
    cq = torch.where(live & ((ops == OP_M) | (ops == OP_I) | (ops == OP_S)), lens, 0)
    cr = torch.where(live & ((ops == OP_M) | (ops == OP_D)), lens, 0)
    q_end = torch.cumsum(cq, 1)
    q0, r0 = q_end - cq, torch.cumsum(cr, 1) - cr
    j = torch.arange(lmax, device=device)[None, :]
    op_of = torch.zeros((n, lmax), dtype=torch.int64, device=device)
    for k in range(C):
        op_of += j >= q_end[:, k:k + 1]
    op_of.clamp_(max=C - 1)
    lengths = t(r.lengths.astype(np.int64))
    in_read = j < lengths[:, None]
    aligned = (in_read & (torch.gather(ops, 1, op_of) == OP_M) & torch.gather(live, 1, op_of)
               & mapped[:, None])
    ref_pos = (t(start.astype(np.int64))[:, None] + torch.gather(r0, 1, op_of)
               + (j - torch.gather(q0, 1, op_of)))
    del op_of
    c = t(np.clip(r.contig, 0, None).astype(np.int64))
    gidx = c[:, None] * clen + ref_pos.clamp(0, clen - 1)
    del ref_pos
    genome = t(r.genome.reshape(-1))
    bases = t(r.bases)
    q = t(r.quals).to(torch.int64)
    ok = aligned & (q > 0) & (bases < 4) & read_ok[:, None]
    if known_sites:
        snp = np.zeros(nc * clen, bool)
        for ci, ps in enumerate(r.snps):
            snp[ci * clen + ps] = True
        ok &= ~t(snp)[gidx]
    mm = ok & (bases != genome[gidx])
    del gidx
    cyc, din = _cycles_dinucs(bases, lengths, flags, lmax)
    n_rg = len(r.read_groups) + 1
    n_cyc = 2 * lmax + 1
    rg = t(r.rg.astype(np.int64))
    key = ((rg[:, None] * N_QUAL + q.clamp(0, N_QUAL - 1)) * n_cyc + (cyc + lmax)) * 17 + din
    size = n_rg * N_QUAL * n_cyc * 17
    shape = (n_rg, N_QUAL, n_cyc, 17)
    total = torch.bincount(key[ok], minlength=size).cpu().numpy().reshape(shape)
    mism = torch.bincount(key[mm], minlength=size).cpu().numpy().reshape(shape)
    table = t(solve(total, mism, solve_dtype).reshape(-1).astype(np.int64))
    new = torch.where(in_read & (q >= MIN_Q), table[key], torch.where(in_read, q, 0))
    return new.to(torch.uint8).cpu().numpy(), int(ok.sum())


def _cigar_strings(ops: np.ndarray, lens: np.ndarray, n_ops: np.ndarray) -> np.ndarray:
    out = np.full(len(ops), "", dtype=object)
    chars = np.array(list(OPC), dtype=object)
    for k in range(ops.shape[1]):
        live = k < n_ops
        out[live] = out[live] + lens[live, k].astype(str).astype(object) + chars[ops[live, k]]
    out[n_ops == 0] = "*"
    return out


# --------------------------------------------------------------------------
# The whole flagship
# --------------------------------------------------------------------------
def expected(r: Reads, known_sites: bool, device: str = "cpu", control: bool = False) -> dict:
    """What the flagship must publish for ``r``, per read (in ``r``'s
    order): the flag word with its duplicate bit, start, CIGAR, mapq,
    read group, bases, recalibrated qualities and the OQ stash.
    ``control`` computes it one precision step below what the
    configuration states: the realignment sweep's sums in bfloat16 and
    the BQSR solve in float32."""
    solve_dtype = np.float32 if control else np.float64
    dup = mark_duplicates(r)
    moved = realign(r, sweep_bf16=control)
    start = r.start.copy()
    mapq = r.mapq.copy()
    width = max(r.cig_ops.shape[1], 3)
    ops = np.zeros((r.n, width), np.uint8)
    lens = np.zeros((r.n, width), np.int32)
    ops[:, :r.cig_ops.shape[1]] = r.cig_ops
    lens[:, :r.cig_ops.shape[1]] = r.cig_lens
    n_ops = r.n_ops.copy()
    for row, (s, cig, mq) in moved.items():
        start[row], mapq[row], n_ops[row] = s, mq, len(cig)
        ops[row] = 0
        lens[row] = 0
        for k, (ln, op) in enumerate(cig):
            ops[row, k], lens[row, k] = OPC.index(op), ln
    quals, observed = recalibrate(r, dup, start, ops, lens, n_ops, mapq, known_sites,
                                  solve_dtype, device)
    cigars = _cigar_strings(ops, lens, n_ops)
    flags = (r.flags & ~0x400) | np.where(dup, 0x400, 0).astype(r.flags.dtype)
    rg = np.array([g for g, _ in r.read_groups], dtype=object)[r.rg]
    return {"key": read_keys(r), "flags": flags, "dup": dup, "start": start, "cigar": cigars,
            "mapq": mapq, "rg": rg, "bases": r.bases, "qual": quals, "oq": r.quals,
            "lengths": r.lengths, "n_moved": len(moved), "observed": observed}
