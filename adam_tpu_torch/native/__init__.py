"""The port's ctypes loader for the native (C++) host codecs.

``adamtok.cpp`` and ``realign.cpp`` here are unchanged copies of the JAX
package's sources (the tokenizer's BQSR walk links against
``realign.cpp``'s MD parser, so the two build together).  They are
compiled with ``g++`` at first use into ``native/_build/`` (git-ignored),
keyed by a hash of the sources, the flags and the compiler.

Unlike ``adam_tpu/native``, nothing here degrades to a pure-Python codec:
a failed build raises, and so does a binding that cannot do its work
(where the JAX package's wrappers return None for the caller to fall
back).  A decoder returns None only for input that is not what it parses
(malformed SAM or BAM records, data that is not BGZF), and its caller
raises with the JAX package's message.  Only the functions this package
calls are bound.

Each codec call is timed under the JAX package's named timer and recorded
as a telemetry span of the same name (``utils/instrumentation.py``,
``utils/telemetry.py``), both no-ops unless recording is on.
"""

from __future__ import annotations

import ctypes as ct
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Sequence

import numpy as np

from adam_tpu_torch.utils import instrumentation as _instr
from adam_tpu_torch.utils import telemetry as _tele

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = [os.path.join(_DIR, "adamtok.cpp"), os.path.join(_DIR, "realign.cpp")]
_BUILD_DIR = os.path.join(_DIR, "_build")
_BASE_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
# -march=native first (the scan/fill/LUT loops vectorize); the plain
# flag set is the fallback for toolchains that refuse it
_FLAG_SETS = [_BASE_FLAGS + ["-march=native"], _BASE_FLAGS]

_LOCK = threading.Lock()
_LIB: ct.CDLL | None = None

_i64p = ct.POINTER(ct.c_int64)
_i32p = ct.POINTER(ct.c_int32)
_u8p = ct.POINTER(ct.c_uint8)


def _timed(timer_name: str):
    """Record a native call under the named-timer registry and as a
    telemetry span of the same name on the calling thread's track."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with _instr.TIMERS.time(timer_name), _tele.TRACE.span(timer_name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    return line
    except OSError:
        pass
    return ""


def _compiler() -> str:
    res = subprocess.run(["g++", "--version"], capture_output=True, timeout=30)
    return res.stdout.decode("utf-8", "replace").splitlines()[0]


def _build() -> str:
    """Compile the sources (if not already built) -> path of the .so."""
    h = hashlib.sha256()
    for path in _SOURCES:
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(_compiler().encode())
    errors = []
    os.makedirs(_BUILD_DIR, exist_ok=True)
    for flags in _FLAG_SETS:
        hf = h.copy()
        hf.update(" ".join(flags).encode())
        if "-march=native" in flags:
            hf.update(_cpu_flags().encode())
        so_path = os.path.join(_BUILD_DIR, f"adamtok_{hf.hexdigest()[:16]}.so")
        if os.path.exists(so_path):
            return so_path
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as td:
            tmp = os.path.join(td, "adamtok.so")
            cmd = ["g++", *flags, "-o", tmp, *_SOURCES, "-lz", "-pthread"]
            res = subprocess.run(cmd, capture_output=True, timeout=600)
            if res.returncode == 0:
                os.replace(tmp, so_path)
                return so_path
            errors.append(res.stderr.decode("utf-8", "replace")[-2000:])
    raise RuntimeError("building the native codecs failed:\n" + "\n".join(errors))


# the tokenizers' shared output columns (samtok_fill / bamtok_fill)
_OUT_COLS = [
    _i32p, _i32p, _i64p, _i64p, _i32p, _i32p, _i64p, _i32p,
    _i32p, _i32p, _u8p,                     # ...has_qual
    _u8p, _u8p, ct.c_int64,                 # bases, quals, lmax
    _u8p, _i32p, _i32p, ct.c_int64,         # cigar_*, cmax
    _u8p, _i64p,                            # name
    _u8p, _i64p,                            # attrs
    _u8p, _i64p, _u8p,                      # md
    _u8p, _i64p, _u8p,                      # oq
    _i64p, _i64p, _i64p,                    # byte counts out
]


def _bind(lib: ct.CDLL) -> None:
    lib.samtok_scan.restype = ct.c_void_p
    lib.samtok_scan.argtypes = [_u8p, ct.c_int64, ct.c_int64, ct.c_int]
    lib.samtok_dims.restype = None
    lib.samtok_dims.argtypes = [ct.c_void_p, _i64p, _i32p, _i32p, _i64p, _i64p]
    lib.samtok_fill.restype = ct.c_int
    lib.samtok_fill.argtypes = [
        ct.c_void_p, _u8p, _i64p, ct.c_int32, _u8p, _i64p, ct.c_int32,
    ] + _OUT_COLS
    lib.samtok_free.restype = None
    lib.samtok_free.argtypes = [ct.c_void_p]
    lib.bgzf_scan2.restype = ct.c_void_p
    lib.bgzf_scan2.argtypes = [_u8p, ct.c_int64, ct.c_int]
    lib.bgzf_consumed.restype = ct.c_int64
    lib.bgzf_consumed.argtypes = [ct.c_void_p]
    lib.bgzf_dims.restype = None
    lib.bgzf_dims.argtypes = [ct.c_void_p, _i64p, _i64p]
    lib.bgzf_fill.restype = ct.c_int
    lib.bgzf_fill.argtypes = [ct.c_void_p, _u8p, ct.c_int]
    lib.bgzf_free.restype = None
    lib.bgzf_free.argtypes = [ct.c_void_p]
    lib.bgzf_compress.restype = ct.c_int
    lib.bgzf_compress.argtypes = [
        _u8p, ct.c_int64, ct.c_int64, _u8p, ct.c_int64, _i64p, ct.c_int, ct.c_int,
    ]
    lib.bamtok_scan2.restype = ct.c_void_p
    lib.bamtok_scan2.argtypes = [_u8p, ct.c_int64, ct.c_int64, ct.c_int]
    lib.bamtok_consumed.restype = ct.c_int64
    lib.bamtok_consumed.argtypes = [ct.c_void_p]
    lib.bamtok_dims.restype = None
    lib.bamtok_dims.argtypes = [ct.c_void_p, _i64p, _i32p, _i32p, _i64p, _i64p]
    lib.bamtok_fill.restype = ct.c_int
    lib.bamtok_fill.argtypes = [ct.c_void_p, _u8p, _i64p, ct.c_int32] + _OUT_COLS + [
        ct.c_int]
    lib.bamtok_free.restype = None
    lib.bamtok_free.argtypes = [ct.c_void_p]
    lib.cigar_cols.restype = ct.c_int
    lib.cigar_cols.argtypes = [
        _u8p, _i64p, ct.c_int64, ct.c_int64, _u8p, _i32p, _i32p, ct.c_int,
    ]
    lib.bam_encode.restype = ct.c_int64
    lib.bam_encode.argtypes = [
        _i32p, _i32p, _i64p, _i32p, _i32p, _i64p, _i32p, _i32p,
        _u8p, _u8p,
        _u8p, _u8p, ct.c_int64,
        _u8p, _i32p, _i32p, ct.c_int64,
        _u8p, _i64p,
        _u8p, _i64p,
        _u8p, _i64p, _u8p,
        _u8p, _i64p, _u8p,
        _i32p, _u8p, _i64p, ct.c_int32, ct.c_int32,
        ct.c_int64, _u8p, ct.c_int64, ct.c_int,
    ]
    lib.sam_encode.restype = ct.c_int64
    lib.sam_encode.argtypes = [
        _i32p, _i32p, _i64p, _i32p, _i32p, _i64p, _i32p, _i32p,
        _u8p, _u8p,
        _u8p, _u8p, ct.c_int64,
        _u8p, _i32p, _i32p, ct.c_int64,
        _u8p, _i64p,
        _u8p, _i64p,
        _u8p, _i64p, _u8p,
        _u8p, _i64p, _u8p,
        _i32p, _u8p, _i64p, ct.c_int32,
        _u8p, _i64p, ct.c_int32,
        ct.c_int64, _u8p, ct.c_int64, ct.c_int,
    ]
    lib.fastq_encode.restype = ct.c_int64
    lib.fastq_encode.argtypes = [
        _i32p, _i32p, _u8p, _u8p, _u8p, ct.c_int64,
        _u8p, _i64p, ct.c_int, ct.c_int64, _u8p, ct.c_int64,
        ct.c_int,
    ]
    lib.ref_positions.restype = None
    lib.ref_positions.argtypes = [
        _u8p, _i32p, _i32p, _i64p, ct.c_int64, ct.c_int64, ct.c_int64,
        _i64p, ct.c_int,
    ]
    lib.cigar_strings.restype = ct.c_int64
    lib.cigar_strings.argtypes = [
        _u8p, _i32p, _i32p, ct.c_int64, ct.c_int64,
        _u8p, ct.c_int64, _i64p, ct.c_int,
    ]
    lib.span_gather.restype = None
    lib.span_gather.argtypes = [_u8p, _i64p, _i64p, ct.c_int64, _u8p]
    lib.span_gather_strided.restype = None
    lib.span_gather_strided.argtypes = [
        _u8p, _i64p, _i64p, ct.c_int64, ct.c_int64, _u8p,
    ]
    lib.lut_compact_rows.restype = None
    lib.lut_compact_rows.argtypes = [
        _u8p, _i32p, _i64p, ct.c_int64, ct.c_int64, _u8p, _u8p, ct.c_int,
    ]
    lib.line_index_strided.restype = ct.c_int64
    lib.line_index_strided.argtypes = [
        _u8p, ct.c_int64, ct.c_int64, ct.c_int64, _i64p, ct.c_int64,
    ]
    lib.realign_prep.restype = ct.c_void_p
    lib.realign_prep.argtypes = [
        _u8p, _u8p, ct.c_int64, ct.c_int64,            # bases/quals/N/L
        _i32p, _i64p,                                  # lengths/start
        _u8p, _i32p, _i32p, ct.c_int64,                # cigar cols + C
        _u8p, _i64p, _u8p,                             # md buf/off/valid
        _i64p, _i64p, ct.c_int64,                      # grows/goff/G
        ct.c_int,                                      # gen_consensus
    ]
    lib.realign_prep_dims.restype = None
    lib.realign_prep_dims.argtypes = [
        ct.c_void_p, _i64p, _i64p, _i64p, _i64p, _i64p, _i64p,
        _i64p, _i64p,
    ]
    lib.realign_prep_fill.restype = None
    lib.realign_prep_fill.argtypes = [
        ct.c_void_p,
        _i32p, _u8p, _i64p, _i64p, _i64p,              # targets
        _i32p, _i64p, _u8p, _i64p, _u8p, _i64p, _u8p,  # reads
        _u8p, _u8p, _i64p,
        _i32p, _u8p, _i64p, _i64p, _i64p,              # consensuses
    ]
    lib.realign_prep_free.restype = None
    lib.realign_prep_free.argtypes = [ct.c_void_p]
    lib.md_move_batch.restype = ct.c_int64
    lib.md_move_batch.argtypes = [
        _u8p, ct.c_int64, ct.c_int64, _i32p,
        _i64p, ct.c_int64,
        _u8p, _i64p,
        _i32p, _i64p,
        _i32p, _i32p, _u8p, _i32p, _i64p,
        _u8p, ct.c_int64, _i64p,
        _i64p, _i64p,
    ]


def lib() -> ct.CDLL:
    """The loaded library, built on first call (raises if the build or
    the load fails)."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                loaded = ct.CDLL(_build())
                _bind(loaded)
                _LIB = loaded
    return _LIB


def _nthreads() -> int:
    return max(1, min(16, os.cpu_count() or 1))


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(data, dtype=np.uint8)


_DUMMY = np.zeros(1, np.uint8)  # stand-in pointer for zero-size buffers


def _u8_ptr(a: np.ndarray):
    if len(a) == 0:
        a = _DUMMY
    return a.ctypes.data_as(_u8p)


def _str_dict(names: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
    from adam_tpu_torch.formats.strings import StringColumn

    c = StringColumn.from_list(list(names))
    return c.buf, c.offsets


@_timed(_instr.TOKENIZE_INPUT)
def tokenize_sam(data, body_off: int, contig_names: Sequence[str],
                 rg_names: Sequence[str]) -> dict | None:
    """Tokenize SAM body lines into columnar arrays; None on malformed
    records."""
    L_ = lib()
    buf = _as_u8(data)
    h = L_.samtok_scan(_u8_ptr(buf), len(buf), body_off, _nthreads())
    if not h:
        return None
    try:
        n = ct.c_int64()
        lmax = ct.c_int32()
        cmax = ct.c_int32()
        nameb = ct.c_int64()
        tagb = ct.c_int64()
        L_.samtok_dims(h, ct.byref(n), ct.byref(lmax), ct.byref(cmax),
                       ct.byref(nameb), ct.byref(tagb))
        n, L, C = n.value, max(1, lmax.value), max(1, cmax.value)
        nameb, tagb = nameb.value, tagb.value
        out = _alloc_columns(n, L, C, nameb, tagb)
        cbuf, coff = _str_dict(contig_names)
        gbuf, goff = _str_dict(rg_names)
        ab = ct.c_int64()
        mb = ct.c_int64()
        qb = ct.c_int64()
        rc = L_.samtok_fill(
            h,
            _u8_ptr(cbuf), coff.ctypes.data_as(_i64p), len(contig_names),
            _u8_ptr(gbuf), goff.ctypes.data_as(_i64p), len(rg_names),
            out["flags"].ctypes.data_as(_i32p),
            out["contig_idx"].ctypes.data_as(_i32p),
            out["start"].ctypes.data_as(_i64p),
            out["end"].ctypes.data_as(_i64p),
            out["mapq"].ctypes.data_as(_i32p),
            out["mate_contig_idx"].ctypes.data_as(_i32p),
            out["mate_start"].ctypes.data_as(_i64p),
            out["tlen"].ctypes.data_as(_i32p),
            out["rg_idx"].ctypes.data_as(_i32p),
            out["lengths"].ctypes.data_as(_i32p),
            _u8_ptr(out["has_qual"]),
            _u8_ptr(out["bases"].reshape(-1)), _u8_ptr(out["quals"].reshape(-1)),
            ct.c_int64(L),
            _u8_ptr(out["cigar_ops"].reshape(-1)),
            out["cigar_lens"].ctypes.data_as(_i32p),
            out["cigar_n"].ctypes.data_as(_i32p),
            ct.c_int64(C),
            _u8_ptr(out["name_buf"]), out["name_off"].ctypes.data_as(_i64p),
            _u8_ptr(out["attr_buf"]), out["attr_off"].ctypes.data_as(_i64p),
            _u8_ptr(out["md_buf"]), out["md_off"].ctypes.data_as(_i64p),
            _u8_ptr(out["md_present"]),
            _u8_ptr(out["oq_buf"]), out["oq_off"].ctypes.data_as(_i64p),
            _u8_ptr(out["oq_present"]),
            ct.byref(ab), ct.byref(mb), ct.byref(qb),
        )
        if rc != 0:
            return None
        out["attr_buf"] = out["attr_buf"][: ab.value]
        out["md_buf"] = out["md_buf"][: mb.value]
        out["oq_buf"] = out["oq_buf"][: qb.value]
        return out
    finally:
        L_.samtok_free(h)


def _alloc_columns(n: int, L: int, C: int, nameb: int, tagb: int) -> dict:
    return dict(
        n=n, lmax=L, cmax=C,
        flags=np.empty(n, np.int32),
        contig_idx=np.empty(n, np.int32),
        start=np.empty(n, np.int64),
        end=np.empty(n, np.int64),
        mapq=np.empty(n, np.int32),
        mate_contig_idx=np.empty(n, np.int32),
        mate_start=np.empty(n, np.int64),
        tlen=np.empty(n, np.int32),
        rg_idx=np.empty(n, np.int32),
        lengths=np.empty(n, np.int32),
        has_qual=np.empty(n, np.uint8),
        bases=np.empty((n, L), np.uint8),
        quals=np.empty((n, L), np.uint8),
        cigar_ops=np.empty((n, C), np.uint8),
        cigar_lens=np.empty((n, C), np.int32),
        cigar_n=np.empty(n, np.int32),
        name_buf=np.empty(max(1, nameb), np.uint8)[:nameb],
        name_off=np.empty(n + 1, np.int64),
        attr_buf=np.empty(max(1, tagb), np.uint8),
        attr_off=np.empty(n + 1, np.int64),
        md_buf=np.empty(max(1, tagb), np.uint8),
        md_off=np.empty(n + 1, np.int64),
        md_present=np.empty(n, np.uint8),
        oq_buf=np.empty(max(1, tagb), np.uint8),
        oq_off=np.empty(n + 1, np.int64),
        oq_present=np.empty(n, np.uint8),
    )


def _bgzf_inflate(buf: np.ndarray, partial: bool):
    """Scan + block-parallel inflate -> (bytes, input bytes consumed), or
    None when ``buf`` is not BGZF (or, without ``partial``, ends in a
    truncated block)."""
    L_ = lib()
    h = L_.bgzf_scan2(_u8_ptr(buf), len(buf), 1 if partial else 0)
    if not h:
        return None
    try:
        nb = ct.c_int64()
        ob = ct.c_int64()
        L_.bgzf_dims(h, ct.byref(nb), ct.byref(ob))
        out = np.empty(max(1, ob.value), np.uint8)
        if L_.bgzf_fill(h, _u8_ptr(out), _nthreads()) != 0:
            return None
        return out[: ob.value].tobytes(), int(L_.bgzf_consumed(h))
    finally:
        L_.bgzf_free(h)


@_timed(_instr.BGZF_CODEC)
def bgzf_decompress(data) -> bytes | None:
    """Block-parallel BGZF decode of a whole container; None if ``data``
    is not BGZF."""
    got = _bgzf_inflate(_as_u8(data), partial=False)
    return None if got is None else got[0]


@_timed(_instr.BGZF_CODEC)
def bgzf_decompress_partial(data) -> tuple[bytes, int] | None:
    """Streaming-window BGZF decode: decompress the *complete* blocks in
    ``data`` -> (decompressed bytes, input bytes consumed); a truncated
    final block is left for the caller's next window.  None if ``data``
    is not BGZF."""
    return _bgzf_inflate(_as_u8(data), partial=True)


@_timed(_instr.BGZF_CODEC)
def bgzf_compress(data, level: int = 6, block_size: int = 0xFF00) -> bytes:
    """Block-parallel BGZF encode, EOF block appended."""
    L_ = lib()
    buf = _as_u8(data)
    n = len(buf)
    block = min(max(1, block_size), 0xFF00)  # BSIZE is a u16 total-size field
    n_blocks = (n + block - 1) // block if n else 0
    cap = n + n_blocks * 64 + n // 512 + 1024
    out = np.empty(cap, np.uint8)
    out_len = ct.c_int64()
    rc = L_.bgzf_compress(
        _u8_ptr(buf), ct.c_int64(n), ct.c_int64(block), _u8_ptr(out),
        ct.c_int64(cap), ct.byref(out_len), ct.c_int(_nthreads()),
        ct.c_int(level),
    )
    if rc != 0:
        raise RuntimeError(f"bgzf_compress failed (code {rc})")
    return out[: out_len.value].tobytes()


@_timed(_instr.TOKENIZE_INPUT)
def tokenize_bam(raw, records_off: int, rg_names: Sequence[str],
                 partial: bool = False) -> dict | None:
    """Parse decompressed BAM records into columnar arrays; None on
    malformed records.

    With ``partial=True`` (streaming windows) a record truncated at the
    end of ``raw`` stops the scan instead of failing, and the result
    carries ``out["consumed"]``, the byte offset after the last complete
    record, so the caller can carry the tail into the next window."""
    L_ = lib()
    buf = _as_u8(raw)
    h = L_.bamtok_scan2(_u8_ptr(buf), len(buf), records_off, 1 if partial else 0)
    if not h:
        return None
    try:
        n = ct.c_int64()
        lmax = ct.c_int32()
        cmax = ct.c_int32()
        nameb = ct.c_int64()
        tagb = ct.c_int64()
        L_.bamtok_dims(h, ct.byref(n), ct.byref(lmax), ct.byref(cmax),
                       ct.byref(nameb), ct.byref(tagb))
        n, L, C = n.value, max(1, lmax.value), max(1, cmax.value)
        out = _alloc_columns(n, L, C, nameb.value, tagb.value)
        gbuf, goff = _str_dict(rg_names)
        ab = ct.c_int64()
        mb = ct.c_int64()
        qb = ct.c_int64()
        rc = L_.bamtok_fill(
            h,
            _u8_ptr(gbuf), goff.ctypes.data_as(_i64p), len(rg_names),
            out["flags"].ctypes.data_as(_i32p),
            out["contig_idx"].ctypes.data_as(_i32p),
            out["start"].ctypes.data_as(_i64p),
            out["end"].ctypes.data_as(_i64p),
            out["mapq"].ctypes.data_as(_i32p),
            out["mate_contig_idx"].ctypes.data_as(_i32p),
            out["mate_start"].ctypes.data_as(_i64p),
            out["tlen"].ctypes.data_as(_i32p),
            out["rg_idx"].ctypes.data_as(_i32p),
            out["lengths"].ctypes.data_as(_i32p),
            _u8_ptr(out["has_qual"]),
            _u8_ptr(out["bases"].reshape(-1)), _u8_ptr(out["quals"].reshape(-1)),
            ct.c_int64(L),
            _u8_ptr(out["cigar_ops"].reshape(-1)),
            out["cigar_lens"].ctypes.data_as(_i32p),
            out["cigar_n"].ctypes.data_as(_i32p),
            ct.c_int64(C),
            _u8_ptr(out["name_buf"]), out["name_off"].ctypes.data_as(_i64p),
            _u8_ptr(out["attr_buf"]), out["attr_off"].ctypes.data_as(_i64p),
            _u8_ptr(out["md_buf"]), out["md_off"].ctypes.data_as(_i64p),
            _u8_ptr(out["md_present"]),
            _u8_ptr(out["oq_buf"]), out["oq_off"].ctypes.data_as(_i64p),
            _u8_ptr(out["oq_present"]),
            ct.byref(ab), ct.byref(mb), ct.byref(qb),
            ct.c_int(_nthreads()),
        )
        if rc != 0:
            return None
        out["attr_buf"] = out["attr_buf"][: ab.value]
        out["md_buf"] = out["md_buf"][: mb.value]
        out["oq_buf"] = out["oq_buf"][: qb.value]
        out["consumed"] = int(L_.bamtok_consumed(h))
        return out
    finally:
        L_.bamtok_free(h)


def cigar_cols(buf: np.ndarray, offsets: np.ndarray, cmax: int):
    """CIGAR strings (flat u8 buffer + offsets) -> (ops u8[N, C],
    lens i32[N, C], n_ops i32[N]); raises if a row overflows ``cmax``
    or does not parse."""
    L_ = lib()
    buf = np.ascontiguousarray(buf, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    n = len(offsets) - 1
    C = max(1, int(cmax))
    ops = np.empty((n, C), np.uint8)
    lens = np.empty((n, C), np.int32)
    n_ops = np.empty(n, np.int32)
    rc = L_.cigar_cols(
        _u8_ptr(buf), offsets.ctypes.data_as(_i64p),
        ct.c_int64(n), ct.c_int64(C),
        _u8_ptr(ops.reshape(-1)), lens.ctypes.data_as(_i32p),
        n_ops.ctypes.data_as(_i32p), ct.c_int(_nthreads()),
    )
    if rc != 0:
        raise ValueError(f"cigar_cols: a CIGAR string does not parse into {C} ops")
    return ops, lens, n_ops


def _encode_prep(batch, side, rg_names: Sequence[str]):
    """Marshalling for the BAM encoder: the numpy batch, the sidecar's
    StringColumns, the RG dictionary and the leading ctypes arguments ->
    (n, args, base capacity, the arrays the arguments point into)."""
    from adam_tpu_torch.formats.strings import StringColumn

    b = batch.to_numpy()
    n = b.n_rows
    names = StringColumn.of(side.names)
    attrs = StringColumn.of(side.attrs)
    md = StringColumn.of(side.md)
    oq = StringColumn.of(side.orig_quals)
    if len(names) < n or len(attrs) < n or len(md) < n or len(oq) < n:
        raise ValueError(f"the sidecar has fewer rows than the batch's {n}")

    c64 = lambda x: np.ascontiguousarray(x, np.int64)  # noqa: E731
    c32 = lambda x: np.ascontiguousarray(x, np.int32)  # noqa: E731
    cu8 = lambda x: np.ascontiguousarray(x, np.uint8)  # noqa: E731

    gbuf, goff = _str_dict(rg_names)
    # every marshalled array stays alive for the duration of the call
    keep = dict(
        flags=c32(b.flags), contig_idx=c32(b.contig_idx), start=c64(b.start),
        mapq=c32(b.mapq), mate_contig_idx=c32(b.mate_contig_idx),
        mate_start=c64(b.mate_start), tlen=c32(b.tlen),
        lengths=c32(b.lengths), has_qual=cu8(b.has_qual), valid=cu8(b.valid),
        bases=cu8(b.bases).reshape(-1), quals=cu8(b.quals).reshape(-1),
        cigar_ops=cu8(b.cigar_ops).reshape(-1),
        cigar_lens=c32(b.cigar_lens), cigar_n=c32(b.cigar_n),
        md_valid=cu8(md.valid),
        oq_valid=cu8(np.asarray(oq.valid) & (oq.lengths() > 0)),
        rg_idx=c32(b.read_group_idx), gbuf=gbuf, goff=goff,
        strings=(names, attrs, md, oq),
    )
    args = [
        keep["flags"].ctypes.data_as(_i32p),
        keep["contig_idx"].ctypes.data_as(_i32p),
        keep["start"].ctypes.data_as(_i64p),
        keep["mapq"].ctypes.data_as(_i32p),
        keep["mate_contig_idx"].ctypes.data_as(_i32p),
        keep["mate_start"].ctypes.data_as(_i64p),
        keep["tlen"].ctypes.data_as(_i32p),
        keep["lengths"].ctypes.data_as(_i32p),
        _u8_ptr(keep["has_qual"]),
        _u8_ptr(keep["valid"]),
        _u8_ptr(keep["bases"]),
        _u8_ptr(keep["quals"]),
        ct.c_int64(b.lmax),
        _u8_ptr(keep["cigar_ops"]),
        keep["cigar_lens"].ctypes.data_as(_i32p),
        keep["cigar_n"].ctypes.data_as(_i32p),
        ct.c_int64(b.cmax),
        _u8_ptr(names.buf), names.offsets.ctypes.data_as(_i64p),
        _u8_ptr(attrs.buf), attrs.offsets.ctypes.data_as(_i64p),
        _u8_ptr(md.buf), md.offsets.ctypes.data_as(_i64p),
        _u8_ptr(keep["md_valid"]),
        _u8_ptr(oq.buf), oq.offsets.ctypes.data_as(_i64p),
        _u8_ptr(keep["oq_valid"]),
        keep["rg_idx"].ctypes.data_as(_i32p),
        _u8_ptr(gbuf), goff.ctypes.data_as(_i64p), ct.c_int32(len(rg_names)),
    ]
    # capacity: names + cigars + seq/qual + sidecar strings + RG tags
    lens = np.where(b.valid, b.lengths, 0).astype(np.int64)
    base_cap = (
        int(names.offsets[-1])
        + 12 * int(np.asarray(b.cigar_n, np.int64).sum())
        + int(lens.sum()) * 2
        + int(attrs.offsets[-1]) + int(md.offsets[-1]) + int(oq.offsets[-1])
        + (max((len(s) for s in rg_names), default=0) + 8) * n
    )
    return n, args, base_cap, keep


@_timed(_instr.SAM_ENCODE)
def bam_encode(batch, side, rg_names: Sequence[str], n_refs: int) -> bytes:
    """Encode a (ReadBatch, ReadSidecar) into the BAM record stream
    (everything after the reference list).  ``n_refs`` bounds the
    contig/mate refIDs: an index outside the reference list raises
    rather than writing a BAM that points outside it."""
    L_ = lib()
    n, args, base_cap, keep = _encode_prep(batch, side, rg_names)
    cap = int(n * 80 + base_cap)
    out = np.empty(cap, np.uint8)
    got = L_.bam_encode(
        *args, ct.c_int32(int(n_refs)), ct.c_int64(n), _u8_ptr(out),
        ct.c_int64(cap), ct.c_int(_nthreads()),
    )
    if got == -2:
        raise RuntimeError("bam_encode: output capacity exceeded")
    if got < 0:
        raise ValueError("bam_encode: a record's refID or read group lies "
                         f"outside the header's {n_refs} references and "
                         f"{len(rg_names)} read groups, or a tag does not encode")
    return out[:got].tobytes()


@_timed(_instr.SAM_ENCODE)
def sam_encode(batch, side, rg_names: Sequence[str],
               contig_names: Sequence[str]) -> bytes:
    """Format a (ReadBatch, ReadSidecar) as SAM text lines, without the
    header: 1-based positions (0 where unplaced), ``=`` for a mate on the
    read's own contig, and the MD, OQ and RG tags after the raw
    attributes.  A contig or read-group index outside the dictionaries
    raises."""
    L_ = lib()
    n, args, base_cap, keep = _encode_prep(batch, side, rg_names)
    cbuf, coff = _str_dict(contig_names)
    max_name = (max((len(s) for s in contig_names), default=1) + 2) * 2
    cap = int(n * (140 + max_name) + base_cap)
    out = np.empty(cap, np.uint8)
    got = L_.sam_encode(
        *args, _u8_ptr(cbuf), coff.ctypes.data_as(_i64p),
        ct.c_int32(len(contig_names)), ct.c_int64(n), _u8_ptr(out),
        ct.c_int64(cap), ct.c_int(_nthreads()),
    )
    if got == -2:
        raise RuntimeError("sam_encode: output capacity exceeded")
    if got < 0:
        raise ValueError("sam_encode: a record's contig or read group lies "
                         f"outside the header's {len(contig_names)} references "
                         f"and {len(rg_names)} read groups")
    return out[:got].tobytes()


@_timed(_instr.FASTQ_ENCODE)
def fastq_encode(batch, side, select, add_suffix: bool) -> bytes:
    """Format the ``select``-ed rows as FASTQ text: reverse-strand reads
    reverse-complemented back to sequencer orientation (quals reversed),
    ``/1`` ``/2`` on paired names when ``add_suffix``.  A sidecar with
    fewer names than rows raises (the JAX binding returns None there)."""
    from adam_tpu_torch.formats.strings import StringColumn

    L_ = lib()
    b = batch.to_numpy()
    n = b.n_rows
    names = StringColumn.of(side.names)
    if len(names) < n:
        raise ValueError(f"fastq_encode: {len(names)} names for {n} rows")
    lens = np.where(select, b.lengths, 0).astype(np.int64)
    cap = int(int(names.offsets[-1]) + 2 * int(lens.sum()) + 16 * n + 64)
    out = np.empty(cap, np.uint8)
    sel = np.ascontiguousarray(select, np.uint8)
    flags = np.ascontiguousarray(b.flags, np.int32)
    lengths = np.ascontiguousarray(b.lengths, np.int32)
    bases = np.ascontiguousarray(b.bases, np.uint8).reshape(-1)
    quals = np.ascontiguousarray(b.quals, np.uint8).reshape(-1)
    got = L_.fastq_encode(
        flags.ctypes.data_as(_i32p), lengths.ctypes.data_as(_i32p),
        _u8_ptr(sel), _u8_ptr(bases), _u8_ptr(quals), ct.c_int64(b.lmax),
        _u8_ptr(names.buf), names.offsets.ctypes.data_as(_i64p),
        ct.c_int(1 if add_suffix else 0),
        ct.c_int64(n), _u8_ptr(out), ct.c_int64(cap), ct.c_int(_nthreads()),
    )
    if got < 0:
        raise RuntimeError("fastq_encode: output capacity exceeded")
    return out[:got].tobytes()


def line_index_strided(data, begin: int, stride: int) -> np.ndarray:
    """Byte offsets of every ``stride``-th line start in ``data[begin:]``
    plus the final end offset -> i64 array."""
    L_ = lib()
    buf = _as_u8(data)
    n = len(buf)
    stride = max(1, int(stride))
    cap = (n - int(begin)) // stride + 3
    out = np.empty(cap, np.int64)
    got = L_.line_index_strided(
        _u8_ptr(buf), ct.c_int64(n), ct.c_int64(begin),
        ct.c_int64(stride), out.ctypes.data_as(_i64p), ct.c_int64(cap),
    )
    if got < 0:
        raise RuntimeError("line_index_strided: output capacity exceeded")
    return out[:got]


def ref_positions(cigar_ops, cigar_lens, cigar_n, start, lmax: int) -> np.ndarray:
    """Per-base reference positions -> i64[N, lmax] (-1 off-reference)."""
    L_ = lib()
    ops = np.ascontiguousarray(cigar_ops, np.uint8)
    lens = np.ascontiguousarray(cigar_lens, np.int32)
    n_ops = np.ascontiguousarray(cigar_n, np.int32)
    st = np.ascontiguousarray(start, np.int64)
    N, C = ops.shape
    out = np.empty((N, lmax), np.int64)
    L_.ref_positions(
        _u8_ptr(ops.reshape(-1)), lens.ctypes.data_as(_i32p),
        n_ops.ctypes.data_as(_i32p), st.ctypes.data_as(_i64p),
        ct.c_int64(N), ct.c_int64(C), ct.c_int64(lmax),
        out.ctypes.data_as(_i64p), ct.c_int(_nthreads()),
    )
    return out


def cigar_strings(cigar_ops, cigar_lens, cigar_n):
    """Columnar cigars -> (buf u8, offsets i64[N+1]) run-length strings
    ('*' when no ops)."""
    L_ = lib()
    ops = np.ascontiguousarray(cigar_ops, np.uint8)
    lens = np.ascontiguousarray(cigar_lens, np.int32)
    n_ops = np.ascontiguousarray(cigar_n, np.int32)
    n, C = ops.shape if ops.ndim == 2 else (len(n_ops), 0)
    if C == 0:
        off = np.arange(n + 1, dtype=np.int64)
        return np.full(n, ord("*"), np.uint8), off
    cap = int(12 * int(np.minimum(n_ops, C).clip(0).sum()) + n + 64)
    out = np.empty(cap, np.uint8)
    offsets = np.empty(n + 1, np.int64)
    got = L_.cigar_strings(
        _u8_ptr(ops.reshape(-1)), lens.ctypes.data_as(_i32p),
        n_ops.ctypes.data_as(_i32p), ct.c_int64(n), ct.c_int64(C),
        _u8_ptr(out), ct.c_int64(cap), offsets.ctypes.data_as(_i64p),
        ct.c_int(_nthreads()),
    )
    if got < 0:
        raise RuntimeError("cigar_strings: output capacity exceeded")
    return out[:got], offsets


def _spans_in_bounds(starts: np.ndarray, lens: np.ndarray, size: int) -> bool:
    """Corrupt-offset guard: negative lens from non-monotonic offsets
    would otherwise overflow the output buffers."""
    if not len(starts):
        return True
    return (
        int((starts + lens).max()) <= size
        and int(starts.min()) >= 0
        and int(lens.min()) >= 0
    )


def span_gather(src: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                total: int):
    """Packed gather of byte spans [starts[i], starts[i]+lens[i]) ->
    u8[total]; None when the spans fall outside ``src`` (the caller's
    numpy path then fails safe)."""
    L_ = lib()
    src = np.ascontiguousarray(src, np.uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    if not _spans_in_bounds(starts, lens, src.size):
        return None
    out = np.empty(int(total), np.uint8)
    L_.span_gather(
        _u8_ptr(src), starts.ctypes.data_as(_i64p),
        lens.ctypes.data_as(_i64p), ct.c_int64(len(starts)), _u8_ptr(out),
    )
    return out


def span_gather_strided(src: np.ndarray, starts: np.ndarray,
                        lens: np.ndarray, w: int):
    """Gather byte spans into a zero-padded [n, w] matrix; None when the
    spans fall outside ``src`` or exceed ``w``."""
    L_ = lib()
    src = np.ascontiguousarray(src, np.uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    n = len(starts)
    if not _spans_in_bounds(starts, lens, src.size) or (
        n and int(lens.max()) > w
    ):
        return None
    out = np.zeros((n, int(w)), np.uint8)
    L_.span_gather_strided(
        _u8_ptr(src), starts.ctypes.data_as(_i64p),
        lens.ctypes.data_as(_i64p), ct.c_int64(n), ct.c_int64(int(w)),
        _u8_ptr(out.reshape(-1)),
    )
    return out


def lut_compact_rows(mat: np.ndarray, lens: np.ndarray, lut: np.ndarray):
    """Padded byte matrix [N, W] -> (LUT-mapped compact string buffer,
    i64 arrow offsets), one fused native pass."""
    L_ = lib()
    mat = np.ascontiguousarray(mat, np.uint8)
    n, w = mat.shape
    lens32 = np.clip(np.asarray(lens), 0, w).astype(np.int32)
    lut = np.ascontiguousarray(lut, np.uint8)
    if lut.size < 256:
        raise ValueError("lut_compact_rows needs a 256-entry LUT")
    off = np.zeros(n + 1, np.int64)
    np.cumsum(lens32, out=off[1:])
    out = np.empty(max(1, int(off[-1])), np.uint8)
    L_.lut_compact_rows(
        _u8_ptr(mat.reshape(-1)), lens32.ctypes.data_as(_i32p),
        off.ctypes.data_as(_i64p), ct.c_int64(n), ct.c_int64(w),
        _u8_ptr(lut), _u8_ptr(out), _nthreads(),
    )
    return out[: int(off[-1])], off


def realign_prep(b, md_col_buf, md_col_off, md_valid, grows, goff,
                 gen_consensus: bool) -> dict:
    """Native phase-1 realignment prep (``realign.cpp``): per target the
    rebuilt reference, per to-clean read its left-normalized CIGAR/MD and
    original mismatch quality, per target the read-generated consensuses.

    ``b`` is a host ReadBatch of the candidate rows; the groups are the
    flat row list ``grows`` + offsets ``goff``.  Raises ValueError for
    malformed MD / missing deleted bases and IndexError for CIGAR
    overruns, as the Python path does."""
    L_ = lib()
    bases = np.ascontiguousarray(b.bases, np.uint8)
    quals = np.ascontiguousarray(b.quals, np.uint8)
    N, L = bases.shape
    lengths = np.ascontiguousarray(b.lengths, np.int32)
    start = np.ascontiguousarray(b.start, np.int64)
    ops = np.ascontiguousarray(b.cigar_ops, np.uint8)
    lens = np.ascontiguousarray(b.cigar_lens, np.int32)
    n_ops = np.ascontiguousarray(b.cigar_n, np.int32)
    C = ops.shape[1]
    md_buf = np.ascontiguousarray(md_col_buf, np.uint8)
    md_off = np.ascontiguousarray(md_col_off, np.int64)
    md_val = np.ascontiguousarray(md_valid, np.uint8)
    grows = np.ascontiguousarray(grows, np.int64)
    goff = np.ascontiguousarray(goff, np.int64)
    G = len(goff) - 1
    h = L_.realign_prep(
        _u8_ptr(bases), _u8_ptr(quals), ct.c_int64(N), ct.c_int64(L),
        lengths.ctypes.data_as(_i32p), start.ctypes.data_as(_i64p),
        _u8_ptr(ops.reshape(-1)), lens.ctypes.data_as(_i32p),
        n_ops.ctypes.data_as(_i32p), ct.c_int64(C),
        _u8_ptr(md_buf), md_off.ctypes.data_as(_i64p), _u8_ptr(md_val),
        grows.ctypes.data_as(_i64p), goff.ctypes.data_as(_i64p),
        ct.c_int64(G), ct.c_int(1 if gen_consensus else 0),
    )
    if not h:
        raise RuntimeError("realign_prep: the native prep returned no state")
    try:
        dims = [np.zeros(1, np.int64) for _ in range(8)]
        L_.realign_prep_dims(ct.c_void_p(h), *[d.ctypes.data_as(_i64p) for d in dims])
        (n_reads, cigar_bytes, md_bytes, n_cons, cons_bytes, ref_bytes,
         err, err_row) = (int(d[0]) for d in dims)
        if err:
            if err == 2:
                raise IndexError(f"realign prep: CIGAR overruns read at row {err_row}")
            raise ValueError(f"realign prep: malformed MD/alignment at row {err_row}")
        out = {
            "t_status": np.zeros(G, np.int32),
            "t_ref_buf": np.zeros(max(ref_bytes, 1), np.uint8),
            "t_ref_off": np.zeros(G + 1, np.int64),
            "t_ref_start": np.zeros(G, np.int64),
            "t_ref_end": np.zeros(G, np.int64),
            "r_group": np.zeros(n_reads, np.int32),
            "r_row": np.zeros(n_reads, np.int64),
            "r_cigar_buf": np.zeros(max(cigar_bytes, 1), np.uint8),
            "r_cigar_off": np.zeros(n_reads + 1, np.int64),
            "r_md_buf": np.zeros(max(md_bytes, 1), np.uint8),
            "r_md_off": np.zeros(n_reads + 1, np.int64),
            "r_md_set": np.zeros(n_reads, np.uint8),
            "r_dirty": np.zeros(n_reads, np.uint8),
            "r_pure": np.zeros(n_reads, np.uint8),
            "r_orig_qual": np.zeros(n_reads, np.int64),
            "c_group": np.zeros(n_cons, np.int32),
            "c_seq_buf": np.zeros(max(cons_bytes, 1), np.uint8),
            "c_seq_off": np.zeros(n_cons + 1, np.int64),
            "c_is": np.zeros(n_cons, np.int64),
            "c_ie": np.zeros(n_cons, np.int64),
        }
        L_.realign_prep_fill(
            ct.c_void_p(h),
            out["t_status"].ctypes.data_as(_i32p),
            _u8_ptr(out["t_ref_buf"]),
            out["t_ref_off"].ctypes.data_as(_i64p),
            out["t_ref_start"].ctypes.data_as(_i64p),
            out["t_ref_end"].ctypes.data_as(_i64p),
            out["r_group"].ctypes.data_as(_i32p),
            out["r_row"].ctypes.data_as(_i64p),
            _u8_ptr(out["r_cigar_buf"]),
            out["r_cigar_off"].ctypes.data_as(_i64p),
            _u8_ptr(out["r_md_buf"]),
            out["r_md_off"].ctypes.data_as(_i64p),
            _u8_ptr(out["r_md_set"]),
            _u8_ptr(out["r_dirty"]),
            _u8_ptr(out["r_pure"]),
            out["r_orig_qual"].ctypes.data_as(_i64p),
            out["c_group"].ctypes.data_as(_i32p),
            _u8_ptr(out["c_seq_buf"]),
            out["c_seq_off"].ctypes.data_as(_i64p),
            out["c_is"].ctypes.data_as(_i64p),
            out["c_ie"].ctypes.data_as(_i64p),
        )
        return out
    finally:
        L_.realign_prep_free(ct.c_void_p(h))


def md_move_batch(b, rows, ref_buf, ref_off, tloc, offs,
                  head_len, mid_len, mid_op, end_len, new_start):
    """Batched ``MdTag.move_alignment`` + canonical ``to_string`` for the
    realigned reads -> (md_buf u8, md_off i64[K+1])."""
    L_ = lib()
    bases = np.ascontiguousarray(b.bases, np.uint8)
    N, L = bases.shape
    lengths = np.ascontiguousarray(b.lengths, np.int32)
    rows = np.ascontiguousarray(rows, np.int64)
    K = len(rows)
    ref_buf = np.ascontiguousarray(ref_buf, np.uint8)
    ref_off = np.ascontiguousarray(ref_off, np.int64)
    tloc = np.ascontiguousarray(tloc, np.int32)
    offs = np.ascontiguousarray(offs, np.int64)
    head_len = np.ascontiguousarray(head_len, np.int32)
    mid_len = np.ascontiguousarray(mid_len, np.int32)
    mid_op = np.ascontiguousarray(mid_op, np.uint8)
    end_len = np.ascontiguousarray(end_len, np.int32)
    new_start = np.ascontiguousarray(new_start, np.int64)
    # MD length bound: digits+bases over the span plus deletion bases
    cap = int(K * (L + 64) + int(mid_len.sum()) + 64)
    err = np.zeros(1, np.int64)
    err_row = np.zeros(1, np.int64)
    for _ in range(2):
        out = np.zeros(max(cap, 1), np.uint8)
        out_off = np.zeros(K + 1, np.int64)
        got = L_.md_move_batch(
            _u8_ptr(bases), ct.c_int64(N), ct.c_int64(L),
            lengths.ctypes.data_as(_i32p),
            rows.ctypes.data_as(_i64p), ct.c_int64(K),
            _u8_ptr(ref_buf), ref_off.ctypes.data_as(_i64p),
            tloc.ctypes.data_as(_i32p), offs.ctypes.data_as(_i64p),
            head_len.ctypes.data_as(_i32p), mid_len.ctypes.data_as(_i32p),
            _u8_ptr(mid_op), end_len.ctypes.data_as(_i32p),
            new_start.ctypes.data_as(_i64p),
            _u8_ptr(out), ct.c_int64(cap), out_off.ctypes.data_as(_i64p),
            err.ctypes.data_as(_i64p), err_row.ctypes.data_as(_i64p),
        )
        if int(err[0]):
            if int(err[0]) == 2:
                raise IndexError(
                    f"md_move_batch: alignment overrun at row {int(err_row[0])}"
                )
            raise ValueError(f"md_move_batch: bad alignment at row {int(err_row[0])}")
        if got >= 0:
            return out[:got], out_off
        cap = -got
    raise RuntimeError("md_move_batch: output capacity exceeded twice")
