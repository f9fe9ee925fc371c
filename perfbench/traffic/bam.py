"""A small BAM writer: records assembled in bulk with numpy, BGZF blocks
deflated by zlib on a few threads (zlib releases the interpreter lock).

Records follow the SAM/BAM specification (v1.6, section 4.2): the
36-byte fixed part, the NUL-terminated name, the CIGAR as u32
``len << 4 | op``, 4-bit bases, qualities, then the ``RG:Z``, ``MD:Z``
and ``NM:C`` tags.  Blocks hold at most 0xFF00 input bytes, and the
stream ends with the standard empty EOF block.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from perfbench.traffic.wgs import Reads

_NIBBLE = np.array([1, 2, 4, 8, 15, 0], np.uint8)  # A C G T N pad
_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
_CORE = np.dtype([
    ("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"), ("l_name", "u1"),
    ("mapq", "u1"), ("bin", "<u2"), ("n_cigar", "<u2"), ("flag", "<u2"),
    ("l_seq", "<i4"), ("next_ref", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4"),
])
_CHUNK = 65_536  # records assembled at a time


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    end = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, off in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = off + (beg[hit] >> shift)
        done |= hit
    return out


def _flat(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Each row's first ``lens`` entries, concatenated."""
    return mat[np.arange(mat.shape[1])[None, :] < lens[:, None]]


def _scatter(out: np.ndarray, dst: np.ndarray, flat: np.ndarray, lens: np.ndarray) -> None:
    src = np.cumsum(lens) - lens
    out[np.repeat(dst - src, lens) + np.arange(int(lens.sum()))] = flat


def _records(r: Reads, lo: int, hi: int) -> bytes:
    sl = slice(lo, hi)
    n = hi - lo
    lengths = r.lengths[sl].astype(np.int64)
    n_ops = r.n_ops[sl].astype(np.int64)
    names = [f"r{p}\0" for p in r.names[sl].tolist()]
    name_len = np.fromiter(map(len, names), np.int64, n)
    rg_ids = [g for g, _ in r.read_groups]
    tags = [f"RGZ{rg_ids[g]}\0" if m is None else f"RGZ{rg_ids[g]}\0MDZ{m}\0NMC{chr(k)}"
            for g, m, k in zip(r.rg[sl].tolist(), r.md[lo:hi], r.nm[sl].tolist())]
    tag_len = np.fromiter(map(len, tags), np.int64, n)
    seq_len = (lengths + 1) // 2
    rec = 36 + name_len + 4 * n_ops + seq_len + lengths + tag_len
    off = np.cumsum(rec) - rec
    out = np.zeros(int(rec.sum()), np.uint8)

    core = np.zeros(n, _CORE)
    core["block_size"] = rec - 4
    core["ref_id"] = r.contig[sl]
    core["pos"] = r.start[sl]
    core["l_name"] = name_len
    core["mapq"] = r.mapq[sl]
    cons_ref = np.where(np.isin(r.cig_ops[sl], (0, 2)), r.cig_lens[sl], 0)
    cons_ref = np.where(np.arange(r.cig_ops.shape[1])[None, :] < n_ops[:, None], cons_ref, 0)
    beg = r.start[sl].astype(np.int64)
    end = beg + np.maximum(cons_ref.sum(axis=1), 1)
    core["bin"] = np.where(beg < 0, 4680, _reg2bin(np.maximum(beg, 0), end))
    core["n_cigar"] = n_ops
    core["flag"] = r.flags[sl]
    core["l_seq"] = lengths
    core["next_ref"] = r.mate_contig[sl]
    core["next_pos"] = r.mate_start[sl]
    core["tlen"] = r.tlen[sl]
    _scatter(out, off, core.view(np.uint8), np.full(n, 36, np.int64))
    pos = off + 36
    _scatter(out, pos, np.frombuffer("".join(names).encode("latin-1"), np.uint8), name_len)
    pos = pos + name_len
    cig = (r.cig_lens[sl].astype(np.uint32) << 4) | r.cig_ops[sl].astype(np.uint32)
    _scatter(out, pos, _flat(cig, n_ops).astype("<u4").view(np.uint8), 4 * n_ops)
    pos = pos + 4 * n_ops
    nib = _NIBBLE[r.bases[sl]]
    if nib.shape[1] % 2:
        nib = np.concatenate([nib, np.zeros((n, 1), np.uint8)], axis=1)
    packed = (nib[:, 0::2] << 4) | nib[:, 1::2]
    _scatter(out, pos, _flat(packed, seq_len), seq_len)
    pos = pos + seq_len
    _scatter(out, pos, _flat(r.quals[sl], lengths), lengths)
    pos = pos + lengths
    _scatter(out, pos, np.frombuffer("".join(tags).encode("latin-1"), np.uint8), tag_len)
    return out.tobytes()


def _block(data: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    head = struct.pack("<BBBBIBBHBBHH", 31, 139, 8, 4, 0, 0, 255, 6, 66, 67, 2,
                       len(cdata) + 25)
    return head + cdata + struct.pack("<II", zlib.crc32(data), len(data))


def write_bam(path: str, r: Reads, level: int = 6, threads: int = 8) -> int:
    """Write ``r`` as a coordinate-sorted BAM -> its size in bytes."""
    nc, clen = r.genome.shape
    text = "@HD\tVN:1.5\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{nm}\tLN:{clen}\n" for nm in r.contig_names) + "".join(
        f"@RG\tID:{i}\tSM:sample\tLB:{lb}\tPL:ILLUMINA\n" for i, lb in r.read_groups)
    tb = text.encode()
    head = [b"BAM\x01", struct.pack("<i", len(tb)), tb, struct.pack("<i", nc)]
    for nm in r.contig_names:
        nb = nm.encode() + b"\0"
        head += [struct.pack("<i", len(nb)), nb, struct.pack("<i", clen)]
    size = 0
    with open(path, "wb") as fh, ThreadPoolExecutor(threads) as pool:
        pending = b"".join(head)
        for lo in range(0, r.n, _CHUNK):
            pending += _records(r, lo, min(r.n, lo + _CHUNK))
            cut = len(pending) - len(pending) % 0xFF00
            blocks = [pending[i:i + 0xFF00] for i in range(0, cut, 0xFF00)]
            pending = pending[cut:]
            for b in pool.map(lambda d: _block(d, level), blocks):
                fh.write(b)
                size += len(b)
        if pending:
            b = _block(pending, level)
            fh.write(b)
            size += len(b)
        fh.write(_EOF)
    return size + len(_EOF)
