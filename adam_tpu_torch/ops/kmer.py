"""k-mer and q-mer counting (the port of ``adam_tpu/ops/kmer.py``).

Every window of every read packs into one integer key, 3 bits per base
so N (code 4) is a base of its own, k <= 21 in an i64, then the keys are
counted by sort + run length on the device.  The JAX package gathers an
``[N, W, k]`` i64 tensor of the windows' bases (14 GB at 1,048,576 reads
x 80 windows x 21); here the same keys come from ``k`` shift-or steps
over ``[N, W]`` slices, and the q-mer weight (the product of the window's
base success probabilities) from ``k`` multiplies over ``[N, W]`` slices,
left to right: the order ``jnp.prod`` takes under ``jax.jit``, so the
f64 weights are bit-equal to the JAX package's (``torch.prod`` rounds
differently).  A window past the end of the reads (``k > L``) gathers
its bases clamped to the last lane, as the JAX gather does.

The entry points run on the card unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

import numpy as np
import torch

from adam_tpu_torch.device import resolve_device
from adam_tpu_torch.formats import schema
from adam_tpu_torch.formats.batch import ReadBatch
from adam_tpu_torch.ops.phred import PHRED_TO_SUCCESS

MAX_PACKED_K = 21  # 3 bits/base in a signed i64

_KMER_CHARS = np.frombuffer(b"ACGTN", np.uint8)


def _window_columns(mat: torch.Tensor, k: int):
    """The ``k`` column slices ``[N, W]`` whose j-th holds base j of every
    window (W = max(L - k + 1, 1)); past the last lane the index clamps."""
    L = mat.shape[1]
    W = max(L - k + 1, 1)
    for j in range(k):
        if j + W <= L:
            yield mat[:, j : j + W]
        else:  # k > L: one window, its missing bases clamped to lane L-1
            yield mat[:, min(j, L - 1)].unsqueeze(1)


def extract_kmers(bases, lengths, valid, k: int):
    """-> (packed i64[N, W], window_valid bool[N, W]) with W = L - k + 1.

    A window is valid when it lies inside the read and the row is valid.
    N bases take part (code 4), as the reference counts k-mer strings."""
    if k > MAX_PACKED_K:
        raise ValueError(f"k={k} exceeds packed maximum {MAX_PACKED_K}")
    n, L = bases.shape
    W = max(L - k + 1, 1)
    b64 = bases.to(torch.int64)
    packed = torch.zeros((n, W), dtype=torch.int64, device=bases.device)
    for col in _window_columns(b64, k):
        packed <<= 3
        packed |= col
    win_valid = (
        (torch.arange(W, device=bases.device)[None, :] + k <= lengths[:, None])
        & valid[:, None]
    )
    return packed, win_valid


def pack_kmer_string(s: str) -> int:
    v = 0
    for ch in s:
        v = (v << 3) | int(schema.BASE_ENCODE_LUT[ord(ch)])
    return v


def unpack_kmer(packed: int, k: int) -> str:
    chars = []
    for i in range(k):
        chars.append("ACGTN"[(packed >> (3 * (k - 1 - i))) & 0x7])
    return "".join(chars)


def _unpack_kmers(keys: np.ndarray, k: int) -> list[str]:
    """:func:`unpack_kmer` over an array of keys, vectorized."""
    keys = np.asarray(keys, np.int64)
    chars = np.empty((len(keys), k), np.uint8)
    for i in range(k):
        chars[:, i] = _KMER_CHARS[(keys >> (3 * (k - 1 - i))) & 0x7]
    return chars.view(f"S{k}").ravel().astype(f"U{k}").tolist()


def device_kmer_histogram(bases, lengths, valid, k: int):
    """Sort-based local count -> (sorted keys i64[M], run counts i32[M],
    is_head bool[M]), M = N * W.

    Invalid windows take the key -1 and sort first; ``is_head`` marks the
    first row of each run of equal keys (the -1 run excluded), so
    ``(keys[is_head], counts[is_head])`` is the histogram."""
    packed, win_valid = extract_kmers(bases, lengths, valid, k)
    flat = torch.where(win_valid, packed, torch.full_like(packed, -1)).reshape(-1)
    del packed, win_valid
    s = torch.sort(flat).values
    del flat
    is_new = torch.ones_like(s, dtype=torch.bool)
    if s.numel() > 1:
        is_new[1:] = s[1:] != s[:-1]
    is_head = is_new & (s >= 0)
    seg = torch.cumsum(is_new, 0) - 1
    counts = torch.bincount(seg, minlength=s.numel()).to(torch.int32)
    return s, counts[seg], is_head


def _device_columns(batch: ReadBatch, device, names) -> list[torch.Tensor]:
    """The batch's ``names`` columns as tensors on ``device``."""
    dev = resolve_device(device)
    out = []
    for f in names:
        x = getattr(batch, f)
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        out.append(x.to(dev))
    return out


def histogram_to_dict(bases, lengths, valid, k: int) -> dict[str, int]:
    """Run the device histogram over a padded batch's columns and decode
    the (k-mer string -> count) table, in sorted key order."""
    from adam_tpu_torch.utils.transfer import device_fetch

    s, run_counts, is_head = device_kmer_histogram(bases, lengths, valid, k)
    keys = device_fetch(s[is_head])
    counts = device_fetch(run_counts[is_head])
    return dict(zip(_unpack_kmers(keys, k), counts.tolist()))


def count_kmers(batch: ReadBatch, k: int, device: str = "cuda") -> dict[str, int]:
    """Exact k-mer counts over all reads (sequence strings, N included)."""
    if batch.n_rows == 0:
        return {}
    bases, lengths, valid = _device_columns(batch, device, ("bases", "lengths", "valid"))
    return histogram_to_dict(bases, lengths, valid, k)


def device_qmer_weights(bases, quals, lengths, valid, k: int):
    """-> (packed i64[N*W], weight f64[N*W]): the weight is the product of
    the window's base success probabilities (Quake's q-mer weight),
    multiplied left to right; invalid windows have key -1 and weight 0."""
    packed, win_valid = extract_kmers(bases, lengths, valid, k)
    table = torch.as_tensor(PHRED_TO_SUCCESS, dtype=torch.float64, device=quals.device)
    succ = table[quals.to(torch.int64).clamp(0, 255)]
    cols = _window_columns(succ, k)
    weights = next(cols).clone()
    for col in cols:
        weights *= col
    flat_keys = torch.where(win_valid, packed, torch.full_like(packed, -1)).reshape(-1)
    flat_w = torch.where(win_valid, weights, torch.zeros_like(weights)).reshape(-1)
    return flat_keys, flat_w


def count_qmers(batch: ReadBatch, k: int, device: str = "cuda") -> dict[str, float]:
    """q-mer weights summed per k-mer, in sorted key order.  The sum runs
    on the host in the JAX package's order: a stable argsort of the keys,
    then ``np.add.reduceat`` over each run."""
    if batch.n_rows == 0:
        return {}
    cols = _device_columns(batch, device, ("bases", "quals", "lengths", "valid"))
    from adam_tpu_torch.utils.transfer import device_fetch

    keys, weights = device_qmer_weights(*cols, k)
    keys, weights = device_fetch(keys), device_fetch(weights)
    order = np.argsort(keys, kind="stable")
    keys, weights = keys[order], weights[order]
    uniq, start_idx = np.unique(keys, return_index=True)
    sums = np.add.reduceat(weights, start_idx)
    keep = uniq >= 0
    return dict(zip(_unpack_kmers(uniq[keep], k), sums[keep].tolist()))
