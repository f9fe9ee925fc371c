"""Per-kernel microbench (the counterpart of
``adam_tpu/utils/kernelbench.py``).

The end-to-end runs measure the pipeline; this module times each device
kernel of the BQSR passes in isolation, per backend and per grid bucket,
with the classic simple-timeit shape: one untimed warm-up call, then
``iters`` timed calls, each followed by ``torch.cuda.synchronize`` on the
card.

The result is a stable-schema JSON document (:data:`SCHEMA`, JAX's):

``{"schema": ..., "device": "cuda:0"|"cpu", "rows": [
    {"kernel", "backend", "mode", "g", "gl", "iters",
     "mean_s", "best_s"}, ...]}``

``device`` takes the place of JAX's ``jax_backend``.  The backends are
the port's names for JAX's: ``cuda`` (the hand kernels, JAX's
``pallas``) and ``plain`` (the plain PyTorch versions, JAX's ``xla``).
A ``cuda`` row calls the pass bodies, which launch kernels 1
(``csrc/observe_hist.cu``) and 2 (``csrc/pack_rows.cu``) through
``ops/kernels.launch``: per call ``observe`` launches kernel 1 once,
``pack`` kernel 2 once and ``apply`` kernel 2 twice.  JAX's ``fused_bc``
row has no counterpart: the port runs pass B and pass C apart, so its
cost is the ``observe`` row's plus the ``apply`` row's.  A ``plain`` row calls the twins directly
(``ops/observe.observe_hist_plain``, ``ops/colpack.pack_rows_plain``) and
launches nothing.  ``mode`` is the backend (``cuda`` or ``plain``): no
row runs in an interpret mode, so the port's ``utils/perfledger`` reads
every row as a real, lower-is-better time (JAX exempts its
``interpret`` rows).

On the CPU only ``plain`` rows run, and asking for ``cuda`` there
raises: there is no quiet plain row under a ``cuda`` name.  A row whose
kernel fails to build or launch becomes an ``"error"`` row, so that the
document survives (that IS the signal); ``python -m
adam_tpu_torch.utils.kernelbench`` then exits 1.

The ``cuda`` rows' launches count in ``ops/kernels.launches()`` like any
other: a caller that reads those counts for its own run resets them
before it (as ``chip_smoke.py`` does before every path it drives).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

SCHEMA = "adam_tpu.kernelbench/1"

#: Default grid buckets (rows, lanes), pow2-quantized like the streamed
#: windows' grids.
DEFAULT_GRIDS = ((256, 128),)

KERNELS = ("observe", "pack", "apply")
BACKENDS = ("cuda", "plain")


def _synth(g: int, gl: int, n_rg: int, seed: int = 7) -> dict:
    """Deterministic synthetic window at grid (g, gl) — realistic
    payload densities (copied from JAX's: the scatter/gather costs are
    shape-dominated, but all-zero masks would let the work shrink)."""
    from adam_tpu_torch.ops.colpack import pack_mask_bits

    rng = np.random.default_rng(seed)
    residue_ok = rng.random((g, gl)) < 0.95
    is_mm = rng.random((g, gl)) < 0.01
    return {
        "bases": rng.integers(0, 4, (g, gl), dtype=np.uint8),
        "quals": rng.integers(2, 40, (g, gl), dtype=np.uint8),
        "lengths": np.full((g,), gl, np.int32),
        "flags": np.zeros((g,), np.int32),
        "read_group_idx": rng.integers(
            0, max(n_rg - 1, 1), (g,), dtype=np.int32
        ),
        "res_bits": pack_mask_bits(residue_ok),
        "mm_bits": pack_mask_bits(is_mm),
        "read_ok": np.ones((g,), bool),
        "has_qual": np.ones((g,), bool),
        "valid": np.ones((g,), bool),
        "table": rng.integers(
            2, 40, (n_rg, 94, 2 * gl + 1, 17), dtype=np.uint8
        ),
    }


def _observe_plain(bases, quals, lengths, flags, read_group_idx,
                   res_bits, mm_bits, read_ok, n_rg: int, lmax: int):
    """``bqsr.observe_packed_body`` with the plain histogram."""
    from adam_tpu_torch.ops.observe import observe_hist_plain
    from adam_tpu_torch.pipelines.bqsr import N_DINUC, N_QUAL, covariate_keys

    n_cyc = 2 * lmax + 1
    keys = covariate_keys(bases, quals, lengths, flags, read_group_idx,
                          n_rg, lmax)
    total, mism = observe_hist_plain(keys, res_bits, mm_bits, read_ok,
                                     n_rg * N_QUAL * n_cyc * N_DINUC)
    shape = (n_rg, N_QUAL, n_cyc, N_DINUC)
    return (total.reshape(shape).to(torch.int64),
            mism.reshape(shape).to(torch.int64))


def _apply_plain(bases, quals, lengths, flags, read_group_idx,
                 has_qual, valid, phred_table, lmax: int, size: int):
    """``bqsr.apply_pack2_body`` with the plain packs."""
    from adam_tpu_torch.ops.colpack import (
        base_decode_body, pack_rows_plain, sanger_body,
    )
    from adam_tpu_torch.pipelines.bqsr import apply_table_body

    new_q = apply_table_body(bases, quals, lengths, flags, read_group_idx,
                             has_qual, valid, phred_table, lmax)
    lens = lengths.to(torch.int64)
    return (
        pack_rows_plain(sanger_body(new_q),
                        torch.where(valid & has_qual, lens, 0), size),
        pack_rows_plain(base_decode_body(bases),
                        torch.where(valid, lens, 0), size),
    )


def place(g: int, gl: int, n_rg: int, dev) -> dict:
    """:func:`_synth`'s window at grid (g, gl) as tensors on ``dev``."""
    return {k: torch.from_numpy(v).to(dev) for k, v in _synth(g, gl, n_rg).items()}


def _build(kernel: str, backend: str, g: int, gl: int, n_rg: int, dev,
           placed: dict | None = None):
    """-> zero-arg call thunk for one (kernel, backend, grid), its
    arguments placed on ``dev`` beforehand (``placed``: :func:`place`'s
    tensors, made here when not given), so the timed region is the launch
    and the work only."""
    from adam_tpu_torch.ops import colpack
    from adam_tpu_torch.pipelines import bqsr

    a = placed if placed is not None else place(g, gl, n_rg, dev)
    row5 = tuple(a[k] for k in (
        "bases", "quals", "lengths", "flags", "read_group_idx"
    ))
    cuda = backend == "cuda"
    size = g * gl
    if kernel == "observe":
        body = bqsr.observe_packed_body if cuda else _observe_plain
        args = row5 + (a["res_bits"], a["mm_bits"], a["read_ok"])
        return lambda: body(*args, n_rg, gl)
    if kernel == "pack":
        mat, lens = a["quals"], a["lengths"].to(torch.int64)
        if cuda:
            return lambda: colpack.pack_rows(mat, lens, size)
        return lambda: colpack.pack_rows_plain(mat, lens, size)
    if kernel == "apply":
        body = bqsr.apply_pack2_body if cuda else _apply_plain
        args = row5 + (a["has_qual"], a["valid"], a["table"])
        return lambda: body(*args, gl, size)
    raise ValueError(f"unknown kernel {kernel!r}")


def _timeit(thunk, iters: int, dev) -> tuple:
    """simple-timeit: one untimed warm-up call, then ``iters`` calls each
    synchronised on the card -> (mean_s, best_s)."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    thunk()
    sync()
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        thunk()
        sync()
        walls.append(time.perf_counter() - t0)
    return sum(walls) / len(walls), min(walls)


def run_kernelbench(
    grids=DEFAULT_GRIDS, iters: int = 5, n_rg: int = 3,
    kernels=KERNELS, backends=None, device: str = "cuda",
) -> dict:
    """Run the kernels across ``backends`` x ``grids`` on ``device``
    (default: the card) -> the :data:`SCHEMA` document.  ``backends``
    defaults to both on the card and to ``plain`` on the CPU, where
    ``cuda`` raises.  A kernel that fails to build or launch contributes
    an ``"error"`` row instead of ending the sweep."""
    from adam_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if backends is None:
        backends = BACKENDS if dev.type == "cuda" else ("plain",)
    bad = [b for b in backends if b not in BACKENDS]
    if bad:
        raise ValueError(f"unknown backend(s) {bad} (have {list(BACKENDS)})")
    if "cuda" in backends and dev.type != "cuda":
        raise ValueError(f"the cuda backend runs on the card, not on {dev}")
    rows = []
    placed: dict = {}  # (g, gl) -> the window on dev, made once per grid
    for bk in backends:
        for kernel in kernels:
            for g, gl in grids:
                row = {
                    "kernel": kernel, "backend": bk, "mode": bk,
                    "g": int(g), "gl": int(gl), "iters": int(iters),
                }
                try:
                    if (g, gl) not in placed:
                        placed[(g, gl)] = place(g, gl, n_rg, dev)
                    mean_s, best_s = _timeit(
                        _build(kernel, bk, g, gl, n_rg, dev, placed[(g, gl)]),
                        iters, dev,
                    )
                    row["mean_s"] = mean_s
                    row["best_s"] = best_s
                except Exception as e:  # keep the sweep alive
                    row["error"] = f"{type(e).__name__}: {e}"
                rows.append(row)
    return {"schema": SCHEMA, "device": str(dev), "rows": rows}


def _parse_grids(raw: str) -> tuple:
    grids = []
    for part in raw.split(","):
        g, _, gl = part.strip().lower().partition("x")
        try:
            grids.append((int(g), int(gl)))
        except ValueError:
            raise SystemExit(f"kernelbench: bad grid {part!r} (want GxGL)")
    return tuple(grids)


def _names(raw: str, have: tuple, what: str) -> tuple:
    got = tuple(x.strip() for x in raw.split(","))
    bad = [x for x in got if x not in have]
    if bad:
        raise SystemExit(f"kernelbench: unknown {what}(s) {bad} "
                         f"(have {list(have)})")
    return got


def main(argv=None) -> int:
    """``python -m adam_tpu_torch.utils.kernelbench [--grids GxGL,...]
    [--iters N] [--kernels a,b] [--backends cuda,plain] [--device
    cuda|cpu] [--out PATH]``: print (or write) the document; exit 1 when
    any row has an error."""
    ap = argparse.ArgumentParser(
        prog="python -m adam_tpu_torch.utils.kernelbench",
        description=f"per-kernel microbench ({SCHEMA})",
    )
    ap.add_argument("--grids", default=None,
                    help="comma-separated row-x-lane buckets, e.g. "
                    "256x128,262144x128")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--kernels", default=None,
                    help=f"comma-separated subset of {','.join(KERNELS)}")
    ap.add_argument("--backends", default=None,
                    help=f"comma-separated subset of {','.join(BACKENDS)}")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None,
                    help="write the JSON here instead of stdout")
    args = ap.parse_args(argv)
    kw = {"iters": args.iters, "device": args.device}
    if args.grids:
        kw["grids"] = _parse_grids(args.grids)
    if args.kernels:
        kw["kernels"] = _names(args.kernels, KERNELS, "kernel")
    if args.backends:
        kw["backends"] = _names(args.backends, BACKENDS, "backend")
    doc = run_kernelbench(**kw)
    text = json.dumps(doc, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    else:
        print(text)
    return 1 if any("error" in r for r in doc["rows"]) else 0


if __name__ == "__main__":
    sys.exit(main())
