"""Plain reference of ``count_kmers``: every window of ``k`` bases of
every read's sequence (as the BAM holds it, N included), counted
exactly.  Keys pack 3 bits a base (A C G T N = 0..4) in an int64, the
order the program's table is sorted in."""

from __future__ import annotations

import numpy as np

from perfbench.traffic.wgs import Reads


def n_kmers(r: Reads, k: int) -> int:
    return int(np.maximum(r.lengths.astype(np.int64) - k + 1, 0).sum())


def counts(r: Reads, k: int, device: str = "cpu") -> tuple:
    """-> (sorted unique keys i64, counts i64)."""
    import torch

    n, L = r.bases.shape
    W = max(L - k + 1, 0)
    out_k = []
    step = max(1, (1 << 24) // max(W, 1))
    for lo in range(0, n, step):
        b = torch.from_numpy(r.bases[lo:lo + step].astype(np.int64)).to(device)
        lens = torch.from_numpy(r.lengths[lo:lo + step].astype(np.int64)).to(device)
        key = torch.zeros((b.shape[0], W), dtype=torch.int64, device=device)
        for j in range(k):
            key = (key << 3) | b[:, j:j + W]
        ok = (torch.arange(W, device=device)[None, :] + k) <= lens[:, None]
        out_k.append(key[ok])
    keys = torch.cat(out_k) if out_k else torch.zeros(0, dtype=torch.int64)
    uk, uc = torch.unique(keys, sorted=True, return_counts=True)
    return uk.cpu().numpy(), uc.cpu().numpy().astype(np.int64)


def control_counts(r: Reads, k: int, device: str = "cpu") -> tuple:
    """The control in the program's place: a 32-bit hashed key table,
    decoded back through the exact keys that land in each slot (the
    first key of a slot stands for all of them)."""
    import torch

    exact_k, exact_c = counts(r, k, device=device)
    keys = torch.from_numpy(exact_k).to(device)
    mult = torch.tensor(0x9E3779B97F4A7C15 - (1 << 64), dtype=torch.int64, device=device)
    slot = ((keys * mult) >> 32) & 0xFFFFFFFF
    order = torch.argsort(slot, stable=True)
    s_sorted = slot[order]
    c_sorted = torch.from_numpy(exact_c).to(device)[order]
    head = torch.ones_like(s_sorted, dtype=torch.bool)
    head[1:] = s_sorted[1:] != s_sorted[:-1]
    seg = torch.cumsum(head.to(torch.int64), 0) - 1
    sums = torch.zeros(int(seg[-1]) + 1 if len(seg) else 0, dtype=torch.int64, device=device)
    sums.index_add_(0, seg, c_sorted)
    rep = keys[order][head]
    o2 = torch.argsort(rep)
    return rep[o2].cpu().numpy(), sums[o2].cpu().numpy()
