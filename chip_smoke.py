"""Smoke test of the PyTorch/CUDA port on one GPU (run: ``python3 chip_smoke.py``).

Phases, each of which fails the script on any error:

1. the card: its name, and its name and power limit from nvidia-smi;
2. build: the CUDA kernels (one nvcc per source, started together) and
   the native host codecs;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (g = 262,144 rows, gl = 128 lanes, n_rg = 3),
   inputs from a numpy seed; bit equality required; times by CUDA events;
4. main path: a WGS-shaped SAM of 1,048,576 reads x 100 bp (4 contigs x
   800 kb, 2 read groups, PCR duplicates, soft clips) through
   ``python -m adam_tpu_torch transform -streaming -mark_duplicate_reads
   -recalibrate_base_qualities -window_reads 262144`` on the card, with
   the kernels' launch counts read around the run and the parts read back;
   then the same run once more under ``torch.profiler`` for the device's
   busy share of the wall;
5. card vs CPU: a 65,536-read input through the same transform on the
   card and on the CPU (plain versions); the parts must be byte-identical.

It imports nothing of JAX or of ``adam_tpu``.  Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero before
printing any result.  The line before the last is one JSON object with
the kernels' measurements; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

MAIN_READS = 1_048_576
WINDOW_READS = 262_144
PARITY_READS = 65_536
SEED = 7
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def _log(msg: str) -> None:
    print(msg, flush=True)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _kernel_inputs(dev):
    """Main-path-shaped inputs: WGS-like quals (declining profile with
    jitter), 88% full-length reads, both orientations, 3 read-group bins."""
    import numpy as np
    import torch

    from adam_tpu_torch.ops.colpack import pack_mask_bits

    g, gl, L = WINDOW_READS, 128, 100
    rng = np.random.default_rng(SEED)
    pos = np.arange(gl)
    prof = 38.0 - 12.0 * (np.minimum(pos, L - 1) / (L - 1)) ** 2
    quals = np.clip(prof[None, :] + rng.normal(0, 3, (g, gl)), 2, 40).astype(np.uint8)
    lengths = np.where(rng.random(g) < 0.88, L, rng.integers(60, L, g)).astype(np.int32)
    quals[np.arange(gl)[None, :] >= lengths[:, None]] = 255
    inp = dict(
        bases=rng.integers(0, 4, (g, gl)).astype(np.uint8),
        quals=quals,
        lengths=lengths,
        flags=(0x1 | rng.choice([0x40, 0x80], g) | rng.choice([0, 0x10], g)).astype(np.int32),
        rg=rng.integers(-1, 2, g).astype(np.int32),
    )
    in_read = np.arange(gl)[None, :] < lengths[:, None]
    res = in_read & (rng.random((g, gl)) < 0.97)
    mm = res & (rng.random((g, gl)) < 0.01)
    t = {k: torch.from_numpy(v).to(dev) for k, v in inp.items()}
    t["res_bits"] = torch.from_numpy(pack_mask_bits(res)).to(dev)
    t["mm_bits"] = torch.from_numpy(pack_mask_bits(mm)).to(dev)
    t["read_ok"] = torch.from_numpy(rng.random(g) < 0.9).to(dev)
    t["res"] = torch.from_numpy(res).to(dev)
    t["mm"] = torch.from_numpy(mm).to(dev)
    return t, g, gl


def check_kernels(dev) -> list:
    import torch

    from adam_tpu_torch.ops import colpack, observe
    from adam_tpu_torch.pipelines import bqsr

    t, g, gl = _kernel_inputs(dev)
    n_rg = 3
    size_h = n_rg * bqsr.N_QUAL * (2 * gl + 1) * bqsr.N_DINUC
    keys = bqsr.covariate_keys(t["bases"], t["quals"], t["lengths"], t["flags"],
                               t["rg"], n_rg, gl)
    out = []

    # ---- kernel 1: observe_hist -----------------------------------------
    args = (keys, t["res_bits"], t["mm_bits"], t["read_ok"], size_h)
    got = observe.observe_hist(*args)
    want = observe.observe_hist_plain(*args)
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    kflat = keys.reshape(-1)
    inc = (t["res"] & t["read_ok"][:, None]).reshape(-1)
    mmi = inc & t["mm"].reshape(-1)

    def library():
        return (torch.bincount(kflat[inc], minlength=size_h),
                torch.bincount(kflat[mmi], minlength=size_h))

    lib_t, lib_m = library()
    equal = equal and torch.equal(lib_t.int(), want[0]) and torch.equal(lib_m.int(), want[1])
    # the least the data needs: the keys of the residues that count (the
    # rest are skipped on their mask bits), both masks, read_ok, and one
    # write of the two i32 histograms
    counted = int(want[0].sum())
    n_bytes = counted * 4 + 2 * t["res_bits"].numel() + g + 2 * 4 * size_h
    out.append(dict(
        name="observe_hist", route="cuda",
        source="adam_tpu_torch/csrc/observe_hist.cu",
        replaces="adam_tpu/ops/pallas_observe.py:85",
        equal=equal, max_abs_err=err,
        ms=_time_ms(lambda: observe.observe_hist(*args)),
        plain_ms=_time_ms(lambda: observe.observe_hist_plain(*args)),
        library_ms=_time_ms(library),
        bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        residues_counted=counted,
    ))

    # ---- kernel 2: pack_rows --------------------------------------------
    mat = colpack.sanger_body(t["quals"])
    lens = t["lengths"].to(torch.int64)
    size_p = g * gl
    got = colpack.pack_rows(mat, lens, size_p)
    want = colpack.pack_rows_plain(mat, lens, size_p)
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max())
    mask = torch.arange(gl, device=dev)[None, :] < lens[:, None]
    lib = torch.masked_select(mat, mask)
    total = int(lens.sum())
    equal = torch.equal(got, want) and torch.equal(lib, want[:total]) \
        and not bool(want[total:].any())
    n_bytes = total + 8 * g + size_p
    out.append(dict(
        name="pack_rows", route="cuda",
        source="adam_tpu_torch/csrc/pack_rows.cu",
        replaces="adam_tpu/ops/colpack.py:111",
        equal=equal, max_abs_err=err,
        ms=_time_ms(lambda: colpack.pack_rows(mat, lens, size_p)),
        plain_ms=_time_ms(lambda: colpack.pack_rows_plain(mat, lens, size_p)),
        library_ms=_time_ms(lambda: torch.masked_select(mat, mask)),
        bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        bytes_packed=total,
    ))
    for k in out:
        k["kernel_ms"] = k["ms"]
        if not k["equal"]:
            raise AssertionError(f"kernel {k['name']} disagrees with its plain version: {k}")
    return out


def run_transform(sam: str, out_dir: str, device: str) -> dict:
    """The user's entry point, in this process: the CLI's main."""
    from adam_tpu_torch.cli.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([
            "transform", sam, out_dir, "-streaming", "-mark_duplicate_reads",
            "-recalibrate_base_qualities", "-window_reads", str(WINDOW_READS),
            "--device", device,
        ])
    if rc != 0:
        raise RuntimeError(f"transform exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def profile_transform(sam: str, out_dir: str) -> dict:
    """The main path once more under ``torch.profiler`` -> the device's
    busy share of the transform's own wall (``total_s``; the profiler's
    post-processing after the run is left out): the union of its kernel,
    copy and set intervals, and the names that took the most device time
    (cut to 100 characters).  None where the profiler saw no device
    activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stats = run_transform(sam, out_dir, "cuda")
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"busy_share": None, "note": "the profiler saw no device activity"}
    busy = 0.0
    end = spans[0][0]
    by_name: dict = {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name[:100]] = by_name.get(name[:100], 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "total_s": stats["total_s"], "reads_per_s": stats["reads_per_s"],
        "device_busy_s": busy / 1e6, "busy_share": busy / 1e6 / stats["total_s"],
        "device_top_ms": {name: us / 1e3 for name, us in top},
    }


def _part_hashes(d: str) -> dict:
    out = {}
    for f in sorted(os.listdir(d)):
        if f.startswith("part-"):
            with open(os.path.join(d, f), "rb") as fh:
                out[f] = hashlib.sha256(fh.read()).hexdigest()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.join(here, "tools"))
    from make_wgs_sam import make_wgs

    from adam_tpu_torch import native
    from adam_tpu_torch.device import resolve_device
    from adam_tpu_torch.ops import kernels

    # ---- 1. the card ----------------------------------------------------
    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = _smi()
    _log(f"device: {kind} (count {torch.cuda.device_count()})")
    _log(f"nvidia-smi: {smi}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.monotonic()
    secs = kernels.build()
    _log(f"kernels built in {time.monotonic() - t0:.2f} s (per source: "
         + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()) + ")")
    t0 = time.monotonic()
    native.lib()
    _log(f"native codecs built in {time.monotonic() - t0:.2f} s")

    # ---- 3. kernels vs plain versions -----------------------------------
    kern = check_kernels(dev)
    for k in kern:
        _log(f"kernel {k['name']}: equal={k['equal']} {k['ms']:.4f} ms "
             f"(plain {k['plain_ms']:.4f} ms, library {k['library_ms']:.4f} ms, "
             f"bound {k['bound_ms']:.4f} ms)")

    work = tempfile.mkdtemp(prefix="adam_tpu_torch_smoke_")
    try:
        # ---- 4. main path -------------------------------------------------
        sam = os.path.join(work, "wgs.sam")
        t0 = time.monotonic()
        make_wgs(sam, MAIN_READS, 100, seed=SEED)
        _log(f"generated {MAIN_READS} reads in {time.monotonic() - t0:.1f} s")
        out_dir = os.path.join(work, "wgs.adam")
        kernels.reset_launches()
        stats = run_transform(sam, out_dir, "cuda")
        launched = kernels.launches()
        _log("main path stats: " + json.dumps(stats, sort_keys=True))
        n_win = stats["n_windows"]
        if launched["observe_hist"] < n_win:
            raise AssertionError(f"observe_hist launched {launched['observe_hist']} "
                                 f"times for {n_win} windows")
        if launched["pack_rows"] != 2 * n_win:
            raise AssertionError(f"pack_rows launched {launched['pack_rows']} "
                                 f"times for {n_win} windows")
        import pyarrow.parquet as pq

        rows = dups = 0
        for f in sorted(os.listdir(out_dir)):
            if f.startswith("part-"):
                tbl = pq.read_table(os.path.join(out_dir, f), columns=["flags", "qual"])
                flags = tbl.column("flags").to_numpy()
                rows += len(flags)
                dups += int(((flags & 0x400) != 0).sum())
        if rows != MAIN_READS or stats["n_reads"] != MAIN_READS:
            raise AssertionError(f"wrote {rows} rows for {MAIN_READS} input reads")
        if dups == 0:
            raise AssertionError("no read was marked duplicate")
        _log(f"main path: {rows} rows, {dups} duplicates, "
             f"{stats['reads_per_s']:.0f} reads/s, launches {launched}")
        for k in kern:
            k["launches"] = launched[k["name"]]
        shutil.rmtree(out_dir)
        prof = profile_transform(sam, out_dir)
        _log("main path under the profiler: " + json.dumps(prof, sort_keys=True))
        shutil.rmtree(out_dir)
        os.unlink(sam)

        # ---- 5. card vs CPU -----------------------------------------------
        sam = os.path.join(work, "parity.sam")
        make_wgs(sam, PARITY_READS, 100, seed=SEED + 1)
        run_transform(sam, os.path.join(work, "cuda.adam"), "cuda")
        run_transform(sam, os.path.join(work, "cpu.adam"), "cpu")
        a = _part_hashes(os.path.join(work, "cuda.adam"))
        b = _part_hashes(os.path.join(work, "cpu.adam"))
        if not a or a != b:
            raise AssertionError(f"card and CPU parts differ: {a} vs {b}")
        _log(f"card vs CPU: {len(a)} parts byte-identical ({PARITY_READS} reads)")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"main_path": {
        "reads": MAIN_READS, "window_reads": WINDOW_READS, "stats": stats,
        "profile": prof,
    }}), flush=True)
    print(json.dumps({"kernels": kern}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
