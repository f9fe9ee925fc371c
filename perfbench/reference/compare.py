"""The comparisons that decide ``correct``: what the timed path
published, read back, against what the plain reference works out.
Every number is a count of disagreements, and every limit is 0."""

from __future__ import annotations

import glob
import hashlib
import os

import numpy as np

_LUT = np.full(256, 4, np.int64)
for _i, _ch in enumerate(b"ACGT"):
    _LUT[_ch] = _i


TRANSFORM_CHECKS = ("rows_missing_or_extra", "dup_flags_differ", "other_flags_differ",
                    "alignments_differ", "read_groups_differ", "bases_differ",
                    "quals_differ", "oq_differ")
_BASES = np.frombuffer(b"ACGTNN", np.uint8)  # base codes 0..4; 5 is past a read's end


def read_transform_output(out_dir: str) -> dict:
    """A transform's Parquet parts -> columns in read-key order."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    cols = ["readName", "flags", "start", "cigar", "mapq", "recordGroupName", "sequence",
            "qual", "origQual"]
    files = sorted(glob.glob(os.path.join(out_dir, "*.parquet")))
    t = pa.concat_tables([pq.read_table(f, columns=cols) for f in files]).combine_chunks()
    name = pc.cast(pc.utf8_slice_codeunits(t["readName"], 1), pa.int64()).to_numpy()
    flags = t["flags"].to_numpy()
    key = name * 2 + ((flags & 0x80) != 0)
    order = np.argsort(key, kind="stable")
    idx = pa.array(order)
    out = {"key": key[order], "flags": flags[order],
           "start": pc.fill_null(t["start"], -1).to_numpy()[order],
           "mapq": t["mapq"].to_numpy(zero_copy_only=False)[order],
           "cigar": np.asarray(t["cigar"].to_pylist(), dtype=object)[order],
           "rg": np.asarray(t["recordGroupName"].to_pylist(), dtype=object)[order]}
    for col, field in (("sequence", "bases"), ("qual", "qual"), ("origQual", "origQual")):
        arr = pc.take(t[col], idx).combine_chunks()
        out[field] = _string_bytes(arr)
    return out


def _string_bytes(arr) -> tuple:
    """A string column -> (its bytes concatenated, the length of each)."""
    import pyarrow as pa

    arr = arr.cast(pa.large_string()) if arr.type != pa.large_string() else arr
    offs = np.frombuffer(arr.buffers()[1], np.int64)[arr.offset:arr.offset + len(arr) + 1]
    data = np.frombuffer(arr.buffers()[2], np.uint8)[offs[0]:offs[-1]]
    return data, np.diff(offs)


def _flat(mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    return mat[np.arange(mat.shape[1])[None, :] < lengths[:, None]]


def _residues_differ(got: tuple, want: np.ndarray, lengths: np.ndarray) -> int:
    """Residues of ``got`` (bytes, lengths) that differ from ``want``,
    the same residues as text; every residue where the lengths differ."""
    data, lens = got
    if len(lens) != len(lengths) or not np.array_equal(lens, lengths):
        return int(lengths.sum())
    return int((data != want).sum())


def _phred(mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    return _flat(mat, lengths).astype(np.uint8) + 33


def as_published(exp: dict) -> dict:
    """A reference's expected output in the shape
    :func:`read_transform_output` gives (to put a control in the
    program's place, and for the digest of the reference's answer)."""
    order = np.argsort(exp["key"], kind="stable")
    lens = exp["lengths"][order].astype(np.int64)
    return {"key": exp["key"][order], "flags": exp["flags"][order],
            "start": exp["start"][order], "mapq": exp["mapq"][order],
            "cigar": exp["cigar"][order], "rg": exp["rg"][order],
            "bases": (_BASES[_flat(exp["bases"][order], lens)], lens),
            "qual": (_phred(exp["qual"][order], lens), lens),
            "origQual": (_phred(exp["oq"][order], lens), lens)}


def compare_transform(ref: dict, got: dict) -> list:
    """-> [(name, disagreements, limit)], one per :data:`TRANSFORM_CHECKS`."""
    want = as_published(ref)
    missing = int(len(np.setxor1d(want["key"], got["key"])))
    if missing or len(want["key"]) != len(got["key"]):
        n = max(len(want["key"]), len(got["key"]))
        return [(TRANSFORM_CHECKS[0], max(missing, 1), 0)] + [(c, n, 0) for c in TRANSFORM_CHECKS[1:]]
    lens = want["bases"][1]
    flip = got["flags"].astype(np.int64) ^ want["flags"].astype(np.int64)
    aln = ((got["start"] != want["start"]) | (got["mapq"] != want["mapq"])
           | (got["cigar"] != want["cigar"]))
    values = (0, int(((flip & 0x400) != 0).sum()), int(((flip & ~0x400) != 0).sum()),
              int(aln.sum()), int((got["rg"] != want["rg"]).sum()),
              _residues_differ(got["bases"], want["bases"][0], lens),
              _residues_differ(got["qual"], want["qual"][0], lens),
              _residues_differ(got["origQual"], want["origQual"][0], lens))
    return [(c, v, 0) for c, v in zip(TRANSFORM_CHECKS, values)]


def digest(columns: dict) -> str:
    """One digest of a published (or :func:`as_published`) output, or of
    a k-mer table's arrays: equal digests mean every compared column is
    equal, so every count of disagreements is 0."""
    h = hashlib.sha256()
    for name in sorted(columns):
        v = columns[name]
        for a in (v if isinstance(v, tuple) else (v,)):
            a = np.asarray(a)
            if a.dtype == object:
                b = "\n".join(map(str, a.tolist())).encode()
            else:
                b = np.ascontiguousarray(a, np.uint8 if a.dtype == np.uint8 else np.int64).tobytes()
            h.update(name.encode() + len(b).to_bytes(8, "little"))
            h.update(b)
    return h.hexdigest()


def kmer_arrays(counts: dict, k: int) -> tuple:
    """The program's {k-mer: count} -> (packed keys, counts), key order."""
    if not counts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    raw = np.frombuffer("".join(counts.keys()).encode("ascii"), np.uint8).reshape(-1, k)
    keys = np.zeros(len(raw), np.int64)
    for j in range(k):
        keys = (keys << 3) | _LUT[raw[:, j]]
    vals = np.fromiter(counts.values(), np.int64, len(raw))
    order = np.argsort(keys, kind="stable")
    return keys[order], vals[order]


KMER_CHECKS = ("kmers_missing_or_extra", "kmer_counts_differ")


def compare_kmers(ref: tuple, got: tuple) -> list:
    rk, rc = ref
    gk, gc = got
    extra = int(len(np.setxor1d(rk, gk, assume_unique=True)))
    _, ri, gi = np.intersect1d(rk, gk, assume_unique=True, return_indices=True)
    return list(zip(KMER_CHECKS, (extra, int((rc[ri] != gc[gi]).sum())), (0, 0)))
