"""Column packing — the port's counterpart of ``adam_tpu/ops/colpack.py``
(kernel 2, ``csrc/pack_rows.cu``).

Pass C hands the writer two flat, encode-ready columns per window: each
row's in-read prefix of the SANGER-encoded recalibrated quals and of the
decoded bases, concatenated in row order (the Arrow data buffers).
:func:`pack_rows` does the compaction on the device so only
``sum(lengths)`` bytes per column come home.  On a CUDA tensor it
launches the hand-written kernel (or raises); on a CPU tensor it runs
:func:`pack_rows_plain`.  The per-byte encode of a column (``encode=``:
the SANGER encode of the quals, the base decode of the bases) runs inside
the kernel, through a 256-entry LUT; on the CPU it is :func:`sanger_body`
or :func:`base_decode_body` before the plain pack.  The mask (un)packing
stays plain torch, as it was XLA, not Pallas, in ``adam_tpu``.
"""

from __future__ import annotations

import numpy as np
import torch

from adam_tpu_torch.formats import schema
from adam_tpu_torch.ops import kernels


def pack_lengths(lengths, valid, has_qual=None) -> np.ndarray:
    """Per-row packed byte counts for a qual/base column: the read
    length for rows that carry the column, 0 for padding/invalid rows
    (and, when ``has_qual`` is given, for qual-less rows)."""
    lens = np.where(np.asarray(valid), np.asarray(lengths), 0)
    if has_qual is not None:
        lens = np.where(np.asarray(has_qual), lens, 0)
    return lens.astype(np.int64)


def pack_mask_bits(mask: np.ndarray) -> np.ndarray:
    """Bit-pack a host boolean [N, L] mask along its lane axis ->
    u8[N, ceil(L/8)] (``np.packbits`` big-endian layout): the per-pass
    observe masks ship to the device 8x smaller than booleans."""
    return np.packbits(np.asarray(mask, bool), axis=1)


def sanger_body(quals: torch.Tensor) -> torch.Tensor:
    """SANGER (phred+33) encode: min(q, 93) + 33, as u8."""
    return (
        torch.clamp(quals.to(torch.int32), max=93) + schema.SANGER_OFFSET
    ).to(torch.uint8)


def base_decode_body(bases: torch.Tensor) -> torch.Tensor:
    """Base codes -> ASCII (``schema.BASE_DECODE_LUT256``)."""
    lut = torch.from_numpy(schema.BASE_DECODE_LUT256).to(bases.device)
    return lut[bases.long()]


def pack_rows_plain(mat: torch.Tensor, lens: torch.Tensor, size: int) -> torch.Tensor:
    """Plain PyTorch version: scatter row prefixes ``mat[i, :lens[i]]``
    at the i64 exclusive-cumsum offsets into a zeroed ``[size]`` buffer,
    dropping positions at or past ``size`` (the XLA body's semantics)."""
    n, w = mat.shape
    lens = lens.to(torch.int64)
    offsets = torch.cumsum(lens, 0) - lens
    col = torch.arange(w, dtype=torch.int64, device=mat.device)[None, :]
    idx = offsets[:, None] + col
    keep = (col < lens[:, None]) & (idx < size)
    out = torch.zeros(size, dtype=mat.dtype, device=mat.device)
    out[idx[keep]] = mat[keep]
    return out


#: encode mode -> (plain PyTorch encode, the kernel's 256-entry LUT)
_ENCODES = {
    "none": (None, None),
    "sanger": (sanger_body, np.ascontiguousarray(schema.QUAL_SANGER_LUT256, np.uint8)),
    "base_decode": (base_decode_body,
                    np.ascontiguousarray(schema.BASE_DECODE_LUT256, np.uint8)),
}


def _tile_rows(w: int) -> int:
    """Rows of one tile of the pack kernel: about 16 KB of ``mat``, a
    multiple of 16 between 16 and 512 (``csrc/pack_rows.cu``)."""
    return min(512, max(16, (16384 // max(w, 1)) // 16 * 16))


def pack_rows(mat: torch.Tensor, lens: torch.Tensor, size: int,
              encode: str = "none") -> torch.Tensor:
    """Flat u8[size] buffer of the row prefixes ``encode(mat[i, :lens[i]])``
    at exclusive-cumsum offsets, zeros elsewhere; ``encode`` is "none",
    "sanger" (min(q, 93) + 33) or "base_decode"
    (``schema.BASE_DECODE_LUT256``).  The CUDA kernel for CUDA tensors,
    :func:`pack_rows_plain` of the encoded matrix for CPU tensors.
    ``lens`` must be non-negative."""
    if mat.dim() != 2 or mat.dtype != torch.uint8:
        raise ValueError("mat must be u8[n, w]")
    if lens.dtype != torch.int64 or tuple(lens.shape) != (mat.shape[0],):
        raise ValueError(f"lens must be i64[{mat.shape[0]}]")
    if lens.device != mat.device:
        raise ValueError("mat and lens on different devices")
    if size < 0:
        raise ValueError("size must be non-negative")
    if encode not in _ENCODES:
        raise ValueError(f"unknown encode {encode!r} (none, sanger, base_decode)")
    if mat.device.type == "cpu":
        fn = _ENCODES[encode][0]
        return pack_rows_plain(fn(mat) if fn else mat, lens, size)
    if mat.device.type != "cuda":
        raise ValueError(f"unsupported device {mat.device}")
    # the kernel's 16-byte copies need aligned starts
    mat = mat.contiguous()
    if mat.data_ptr() % 16:
        mat = mat.clone()
    lens = lens.contiguous()
    if lens.data_ptr() % 16:
        lens = lens.clone()
    n, w = mat.shape
    rows = _tile_rows(w)
    # the kernel writes every byte of out and scans lens into the tiles'
    # first output bytes in `base` itself
    out = torch.empty(size, dtype=torch.uint8, device=mat.device)
    base = torch.empty(-(-n // rows) + 1, dtype=torch.int64, device=mat.device)
    lut = _ENCODES[encode][1]  # host memory: the kernel takes it by value
    kernels.launch(
        "pack_rows", mat.data_ptr(), lens.data_ptr(), n, w, rows,
        lut.ctypes.data if lut is not None else None, base.data_ptr(),
        out.data_ptr(), size, device=mat.device, variant=encode,
    )
    return out
