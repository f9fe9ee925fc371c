"""Schema constants for the columnar genomic data model (a copy of
``adam_tpu/formats/schema.py``, which the port may not import).

The reference stores one Avro record per read (``AlignmentRecord`` from
bdg-formats; field list mirrored from the reference's
``projections/AlignmentRecordField.scala:29-31``).
We keep the same logical fields but lay them out as struct-of-arrays
columnar batches (see :mod:`adam_tpu_torch.formats.batch`), with the string-ish
fields (bases, quals, CIGAR) encoded as small integers so they live on
device.

Encodings defined here:

* SAM flag bits (identical to the SAM spec the reference's boolean fields
  decompose into).
* 2-3 bit base codes (A,C,G,T,N + PAD) used everywhere on device.
* CIGAR op codes in htsjdk/SAM order (M,I,D,N,S,H,P,=,X).
"""

from __future__ import annotations

import numpy as np

# --------------------------------------------------------------------------
# SAM flag bits.  The reference explodes these into booleans on
# AlignmentRecord (readPaired, properPair, readMapped, ... — see
# converters/SAMRecordConverter.scala:64-101); we keep the packed u16 form
# as a single device column and provide mask helpers.
# --------------------------------------------------------------------------
FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST_OF_PAIR = 0x40
FLAG_SECOND_OF_PAIR = 0x80
FLAG_SECONDARY = 0x100
FLAG_FAILED_QC = 0x200
FLAG_DUPLICATE = 0x400
FLAG_SUPPLEMENTARY = 0x800

# --------------------------------------------------------------------------
# Base codes.  Dense 0..3 for ACGT makes 2-bit k-mer packing and one-hot
# matmuls trivial; 4 = N/any-ambiguity; 5 = padding beyond read length.
# --------------------------------------------------------------------------
BASE_A = 0
BASE_C = 1
BASE_G = 2
BASE_T = 3
BASE_N = 4
BASE_PAD = 5

_BASE_CHARS = "ACGTN"

# char -> code lookup over the whole byte range (unknown IUPAC codes -> N).
BASE_ENCODE_LUT = np.full(256, BASE_N, dtype=np.uint8)
for _i, _c in enumerate(_BASE_CHARS):
    BASE_ENCODE_LUT[ord(_c)] = _i
    BASE_ENCODE_LUT[ord(_c.lower())] = _i
BASE_ENCODE_LUT[ord("*")] = BASE_PAD

BASE_DECODE_LUT = np.frombuffer(b"ACGTN.", dtype=np.uint8).copy()

# Complement in code space (N -> N, PAD -> PAD).
BASE_COMPLEMENT = np.array(
    [BASE_T, BASE_G, BASE_C, BASE_A, BASE_N, BASE_PAD], dtype=np.uint8
)

QUAL_PAD = 255  # quality value used in padding lanes
SANGER_OFFSET = 33  # phred+33, util/PhredUtils.scala semantics

# Full-byte-range decode LUTs for the native fused decode+compact pass
# (native.lut_compact_rows): code -> ASCII base, qual -> clamped Sanger
# char ('~' = phred 93 cap, the SAM printable ceiling).
BASE_DECODE_LUT256 = BASE_DECODE_LUT[np.minimum(np.arange(256), BASE_PAD)]
QUAL_SANGER_LUT256 = (
    np.minimum(np.arange(256), 93) + SANGER_OFFSET
).astype(np.uint8)


def encode_bases(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> u8 code array."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return BASE_ENCODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode_bases(codes: np.ndarray, length: int | None = None) -> str:
    codes = np.asarray(codes, dtype=np.uint8)
    if length is not None:
        codes = codes[:length]
    return BASE_DECODE_LUT[np.minimum(codes, BASE_PAD)].tobytes().decode("ascii")


def decode_bases_bulk(codes: np.ndarray, lengths: np.ndarray) -> list[str]:
    """Decode many rows at once: one LUT pass over the [N, L] code matrix,
    one bytes->str decode, then per-row string slicing — ~20x cheaper than
    N ``decode_bases`` calls (each of which pays numpy-call overhead)."""
    codes = np.asarray(codes, dtype=np.uint8)
    if codes.ndim != 2:
        codes = codes.reshape(len(lengths), -1)
    L = codes.shape[1]
    s = BASE_DECODE_LUT[np.minimum(codes, BASE_PAD)].tobytes().decode("ascii")
    return [s[i * L : i * L + int(l)] for i, l in enumerate(lengths)]


def encode_quals(qual: str | bytes) -> np.ndarray:
    """Sanger phred+33 string -> u8 phred values."""
    if isinstance(qual, str):
        qual = qual.encode("ascii")
    return np.frombuffer(qual, dtype=np.uint8) - SANGER_OFFSET


def decode_quals(phred: np.ndarray, length: int | None = None) -> str:
    phred = np.asarray(phred)
    if length is not None:
        phred = phred[:length]
    return (phred.astype(np.uint8) + SANGER_OFFSET).tobytes().decode("ascii")


# --------------------------------------------------------------------------
# CIGAR op codes (SAM binary order, same as htsjdk CigarOperator ordinals
# the reference leans on via rich/RichAlignmentRecord.scala:41-57).
# --------------------------------------------------------------------------
CIGAR_M = 0
CIGAR_I = 1
CIGAR_D = 2
CIGAR_N = 3
CIGAR_S = 4
CIGAR_H = 5
CIGAR_P = 6
CIGAR_EQ = 7
CIGAR_X = 8
CIGAR_PAD = 15  # padding lanes in the [N, Cmax] cigar columns

CIGAR_CHARS = "MIDNSHP=X"
CIGAR_ENCODE = {c: i for i, c in enumerate(CIGAR_CHARS)}

# Op consumes query sequence / reference, as lookup tables over op code.
CIGAR_CONSUMES_QUERY = np.array(
    [1, 1, 0, 0, 1, 0, 0, 1, 1] + [0] * 7, dtype=np.int32
)
CIGAR_CONSUMES_REF = np.array(
    [1, 0, 1, 1, 0, 0, 0, 1, 1] + [0] * 7, dtype=np.int32
)


def encode_cigar(cigar: str, cmax: int) -> tuple[np.ndarray, np.ndarray, int]:
    """CIGAR string -> (ops u8[cmax], lens i32[cmax], n_ops).

    '*' (unavailable) -> zero ops.
    """
    ops = np.full(cmax, CIGAR_PAD, dtype=np.uint8)
    lens = np.zeros(cmax, dtype=np.int32)
    if not cigar or cigar == "*":
        return ops, lens, 0
    n = 0
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            if n >= cmax:
                raise ValueError(f"CIGAR {cigar!r} exceeds cmax={cmax}")
            ops[n] = CIGAR_ENCODE[ch]
            lens[n] = num
            num = 0
            n += 1
    return ops, lens, n


def decode_cigar(ops: np.ndarray, lens: np.ndarray, n: int) -> str:
    if n == 0:
        return "*"
    return "".join(f"{int(lens[i])}{CIGAR_CHARS[int(ops[i])]}" for i in range(n))


def cigar_str_stats(cigar: str) -> tuple[int, int]:
    """(query_length, reference_length) spanned by a CIGAR string."""
    qlen = rlen = num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            op = CIGAR_ENCODE[ch]
            qlen += num * int(CIGAR_CONSUMES_QUERY[op])
            rlen += num * int(CIGAR_CONSUMES_REF[op])
            num = 0
    return qlen, rlen
