"""One run of one benchmark cell of ``adam_tpu_torch`` on the card.

    python3 perfbench/run.py --workload CELL --seed N --seconds S --trace 0|1

One process does one run: it finds the cell's files by name, makes (or
finds in its cache) the seed's input, warms up with one whole job at the
cell's own shapes, then starts whole jobs back to back, closed loop, until
``--seconds`` have passed, and counts every job it started: the window
ends when the last of them has published its output.  After the window
it frees the program's state, checks what the last jobs published
against the plain reference under ``perfbench/reference/``, and prints
one JSON line as the last line of its standard output.

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` wraps
every job in ``torch.profiler`` and reports the per-layer metrics, each
read by its own reader under ``perfbench/metrics/``.

Without a card (or with fewer cards than the cell asks for) the run
exits with code 2 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FORBIDDEN = ("jax", "jaxlib", "flax", "adam_tpu")


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name (the part
    before the first dot, compared whole) is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, rehearse: dict | None = None) -> int:
    """Run one cell.  ``rehearse`` (tests only) runs it on the CPU at the
    sizes it gives, with the plain PyTorch versions of the kernels."""
    args = _args(argv)
    from perfbench.harness import core

    core.pin_build_caches()
    if not (core.ROOT / "adam_tpu_torch").is_dir():
        print("perfbench: adam_tpu_torch is not in this checkout", file=sys.stderr)
        return 3
    cell = core.cell(args.workload)
    chips = int(cell["entry"]["chips"])
    import torch

    if rehearse is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    else:
        device = "cpu"
    drv = core.driver(cell["spec"]["driver"])
    work_dir = Path(tempfile.mkdtemp(prefix="perfbench-"))
    try:
        return _run(args, cell, drv, device, work_dir, rehearse, torch)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)


def _run(args, cell, drv, device, work_dir, rehearse, torch) -> int:
    from perfbench.harness import core
    from perfbench.harness.trace import JobTrace

    state = drv.setup(cell, args.seed, device, work_dir, rehearse)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0

    tracer = JobTrace() if args.trace else None
    state.traced = bool(args.trace)
    jobs, failed = [], 0
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    while not jobs or time.perf_counter() - t0 < args.seconds:
        ctx = (tracer.job(lambda: drv.spans(state)) if tracer is not None
               else contextlib.nullcontext())
        try:
            with ctx:
                jobs.append(drv.run_job(state, len(jobs)))
        except Exception:  # a failed job is counted, and fails the run
            traceback.print_exc()
            failed += 1
            jobs.append(None)
    window_s = time.perf_counter() - t0
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0

    done = [j for j in jobs if j is not None]
    drv.release(state)
    t_check = time.perf_counter()
    checks = drv.check(state, done, args.seed) if done else []
    print(f"perfbench: setup {setup_s:.3f} s (of it {getattr(state, 'setup_parts', {})}), "
          f"{len(jobs)} jobs in {window_s:.3f} s, check {time.perf_counter() - t_check:.3f} s, "
          f"job outputs {getattr(state, 'bytes_written', 0)} bytes, "
          f"job walls {[round(j['wall_s'], 3) for j in done]}",
          file=sys.stderr)
    print(f"perfbench: window cpu {ru1.ru_utime - ru0.ru_utime:.3f} user "
          f"{ru1.ru_stime - ru0.ru_stime:.3f} sys s, "
          f"{ru1.ru_nivcsw - ru0.ru_nivcsw} involuntary and {ru1.ru_nvcsw - ru0.ru_nvcsw} "
          f"voluntary switches, {ru1.ru_minflt - ru0.ru_minflt} minor faults, "
          f"load {os.getloadavg()[0]:.2f} on {len(os.sched_getaffinity(0))} cpus",
          file=sys.stderr)
    correct = failed == 0 and bool(checks) and all(v <= lim for _, v, lim in checks)

    metrics: dict = {}
    run = {"jobs": done, "window_s": window_s, "cell": cell, "state": state,
           "trace": tracer.summary() if tracer is not None else None}
    if args.trace:
        for m in cell["per_layer"]:
            value = core.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            value = setup_s if m["name"] == "setup_s" else drv.rate(state, done, window_s, m["name"])
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": int(cell["entry"]["chips"]), "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(jobs), "failed": failed,
           "metrics": metrics, "device": dev}
    if tracer is not None:
        t = run["trace"]
        dev["busy_s"] = t["busy_s"]
        dev["window_s"] = t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    for name, v, lim in checks:
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
