"""The BQSR observe histogram: the port's counterpart of
``adam_tpu/ops/pallas_observe.py`` (kernel 1, ``csrc/observe_hist.cu``).

:func:`observe_hist` takes the precomputed i32 covariate keys ``[n, l]``,
the bit-packed residue-ok and mismatch masks ``u8[n, ceil(l/8)]``
(big-endian ``np.packbits`` layout) and ``read_ok`` ``bool[n]``, and
returns the ``(total, mism)`` i32 ``[size]`` histograms.  On a CUDA
tensor it launches the hand-written kernel (or raises); on a CPU tensor
it runs :func:`observe_hist_plain`, the plain PyTorch version with the
same arithmetic, which the CPU tests hold against the JAX package.
"""

from __future__ import annotations

import torch

from adam_tpu_torch.ops import kernels


def unpack_bits(packed: torch.Tensor, n_cols: int) -> torch.Tensor:
    """u8[n, ceil(n_cols/8)] big-endian bit-packed mask -> bool[n, n_cols]."""
    shifts = 7 - torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :n_cols].bool()


def observe_hist_plain(flat_key, res_bits, mm_bits, read_ok, size: int):
    """Plain PyTorch version: unpack the masks, then scatter-add ones
    into i32 bins (``index_add_``), as the XLA body does."""
    n, l = flat_key.shape
    include = unpack_bits(res_bits, l) & read_ok[:, None]
    mm = include & unpack_bits(mm_bits, l)
    keys = flat_key.reshape(-1).long()
    total = torch.zeros(size, dtype=torch.int32, device=flat_key.device)
    mism = torch.zeros(size, dtype=torch.int32, device=flat_key.device)
    total.index_add_(0, keys, include.reshape(-1).to(torch.int32))
    mism.index_add_(0, keys, mm.reshape(-1).to(torch.int32))
    return total, mism


def _check(flat_key, res_bits, mm_bits, read_ok, size):
    if flat_key.dim() != 2 or flat_key.dtype != torch.int32:
        raise ValueError("flat_key must be i32[n, l]")
    n, l = flat_key.shape
    lb = (l + 7) // 8
    for name, t in (("res_bits", res_bits), ("mm_bits", mm_bits)):
        if t.dtype != torch.uint8 or tuple(t.shape) != (n, lb):
            raise ValueError(f"{name} must be u8[{n}, {lb}]")
    if read_ok.dtype != torch.bool or tuple(read_ok.shape) != (n,):
        raise ValueError(f"read_ok must be bool[{n}]")
    devs = {t.device for t in (flat_key, res_bits, mm_bits, read_ok)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if size <= 0:
        raise ValueError("size must be positive")


def observe_hist(flat_key, res_bits, mm_bits, read_ok, size: int):
    """(total, mism) i32[size] observe histograms; the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    _check(flat_key, res_bits, mm_bits, read_ok, size)
    if flat_key.device.type == "cpu":
        return observe_hist_plain(flat_key, res_bits, mm_bits, read_ok, size)
    if flat_key.device.type != "cuda":
        raise ValueError(f"unsupported device {flat_key.device}")
    keys = flat_key.contiguous()
    res = res_bits.contiguous()
    mm = mm_bits.contiguous()
    rdok = read_ok.contiguous()
    n, l = keys.shape
    total = torch.zeros(size, dtype=torch.int32, device=keys.device)
    mism = torch.zeros(size, dtype=torch.int32, device=keys.device)
    kernels.launch(
        "observe_hist", keys.data_ptr(), res.data_ptr(), mm.data_ptr(),
        rdok.data_ptr(), n, l, res.shape[1], total.data_ptr(),
        mism.data_ptr(),
    )
    return total, mism
