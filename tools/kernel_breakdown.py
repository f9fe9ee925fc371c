"""Device time of each CUDA kernel inside one ``observe_hist`` and one
``pack_rows`` wrapper call, and the wrapper's host time, on one GPU (run:
``python3 tools/kernel_breakdown.py``).

Inputs are ``chip_smoke.py``'s phase-3 inputs (the main path's shapes:
g = 262,144 rows, gl = 128 lanes, n_rg = 3).  For each wrapper call
(``observe_hist``, ``pack_rows`` with encode "none" and "sanger") it
runs 3 warm-up calls, then 20 calls under ``torch.profiler`` and prints
the mean device time per call of every kernel and memset the profiler
saw, then the host time per call of 200 calls issued without a
synchronise in between (the time the Python wrapper and its launches
take).  Prints one JSON line; exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

ITERS = 20


def _per_call(fn, torch) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:90]
            by_name[name] = by_name.get(name, 0.0) + (e.time_range.end - e.time_range.start)
    out = {name: us / ITERS / 1e3 for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        fn()
    host = (time.perf_counter() - t0) / 200
    torch.cuda.synchronize()
    return {"device_ms_per_call": out, "device_ms_sum": sum(out.values()),
            "host_ms_per_call": host * 1e3}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from adam_tpu_torch.ops import colpack, observe
    from adam_tpu_torch.pipelines import bqsr

    dev = torch.device("cuda")
    t, g, gl = chip_smoke._kernel_inputs(dev)
    n_rg = 3
    slab_w = (2 * gl + 1) * bqsr.N_DINUC
    size = n_rg * bqsr.N_QUAL * slab_w
    keys = bqsr.covariate_keys(t["bases"], t["quals"], t["lengths"], t["flags"],
                               t["rg"], n_rg, gl)
    lens = t["lengths"].to(torch.int64)
    mat = colpack.sanger_body(t["quals"])
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": chip_smoke._smi()}
    out["observe_hist"] = _per_call(lambda: observe.observe_hist(
        keys, t["res_bits"], t["mm_bits"], t["read_ok"], size, slab_w), torch)
    out["pack_rows"] = _per_call(lambda: colpack.pack_rows(mat, lens, g * gl), torch)
    out["pack_rows_sanger"] = _per_call(lambda: colpack.pack_rows(
        t["quals"], lens, g * gl, encode="sanger"), torch)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
