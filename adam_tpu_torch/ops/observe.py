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


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool[n, n_cols] -> u8[n, ceil(n_cols/8)] big-endian bit-packed mask
    (``np.packbits``' layout, the inverse of :func:`unpack_bits`), on the
    mask's device."""
    n, n_cols = mask.shape
    pad = -n_cols % 8
    bits = torch.nn.functional.pad(mask.to(torch.int32), (0, pad)).reshape(n, -1, 8)
    weights = 1 << (7 - torch.arange(8, dtype=torch.int32, device=mask.device))
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def observe_hist_plain(flat_key, res_bits, mm_bits, read_ok, size: int,
                       slab_w: int | None = None):
    """Plain PyTorch version: unpack the masks, then scatter-add ones
    into i32 bins (``index_add_``), as the XLA body does.  ``slab_w`` is
    the kernel's partition of the bins and changes nothing here."""
    n, l = flat_key.shape
    include = unpack_bits(res_bits, l) & read_ok[:, None]
    mm = include & unpack_bits(mm_bits, l)
    keys = flat_key.reshape(-1).long()
    total = torch.zeros(size, dtype=torch.int32, device=flat_key.device)
    mism = torch.zeros(size, dtype=torch.int32, device=flat_key.device)
    total.index_add_(0, keys, include.reshape(-1).to(torch.int32))
    mism.index_add_(0, keys, mm.reshape(-1).to(torch.int32))
    return total, mism


#: slabs one pass of the kernel sorts by (csrc/observe_hist.cu kGroup)
_GROUP = 4096
#: the widest rows the kernel takes (its scatter stages a row in shared memory)
_MAX_LANES = 8192


def _check(flat_key, res_bits, mm_bits, read_ok, size, slab_w):
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
    if slab_w <= 0 or size % slab_w:
        raise ValueError(f"slab width {slab_w} does not divide size {size}")


def observe_hist(flat_key, res_bits, mm_bits, read_ok, size: int, slab_w: int):
    """(total, mism) i32[size] observe histograms; the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.  ``slab_w`` is the
    bin count of one (read group, quality) slab of the table,
    ``(2*l+1)*17`` for BQSR keys: the kernel counts one slab at a time in
    shared memory.  It must divide ``size``."""
    _check(flat_key, res_bits, mm_bits, read_ok, size, slab_w)
    if flat_key.device.type == "cpu":
        return observe_hist_plain(flat_key, res_bits, mm_bits, read_ok, size)
    if flat_key.device.type != "cuda":
        raise ValueError(f"unsupported device {flat_key.device}")
    keys = flat_key.contiguous()
    res = res_bits.contiguous()
    mm = mm_bits.contiguous()
    rdok = read_ok.contiguous()
    n, l = keys.shape
    if n * l >= 2**31 or size >= 2**31 or l > _MAX_LANES:
        raise ValueError(f"observe_hist kernel: {n} x {l} keys, {size} bins exceed "
                         f"its 2^31 keys / 2^31 bins / {_MAX_LANES}-lane limits")
    n_slabs = size // slab_w
    rec_bytes = 2 if slab_w <= 32768 else 4
    scratch_bytes = -(-n * l * rec_bytes // 16) * 16 + 4 * (3 * min(n_slabs, _GROUP) + 4)
    # total, mism and the kernel's per-slab counts: one buffer, zeroed by
    # the kernel's entry with one memset
    hist = torch.empty(2 * size + n_slabs, dtype=torch.int32, device=keys.device)
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=keys.device)
    kernels.launch(
        "observe_hist", keys.data_ptr(), res.data_ptr(), mm.data_ptr(),
        rdok.data_ptr(), n, l, res.shape[1], size, slab_w, hist.data_ptr(),
        scratch.data_ptr(), scratch_bytes, device=keys.device,
    )
    return hist[:size], hist[size:2 * size]
