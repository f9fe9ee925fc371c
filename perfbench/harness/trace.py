"""The device trace of a traced run: ``torch.profiler`` around each job.

The arithmetic of the busy time is the union of the device intervals
(kernels, copies and sets) over a job's own wall, as the repository's
chip smoke computes it from the program's ``--xprof-dir`` trace.  Idle
gaps are named by the innermost program span that covers them (the
driver hands over the program's spans on the monotonic clock; a marker
at the job's start ties that clock to the profiler's), else by the host
operation that overlaps them most, else by the device operation they
follow.  Device time is also summed by each kernel's base name (the
part before its argument list).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class JobTrace:
    """Accumulates each traced job's device time."""

    def __init__(self):
        self.busy_s = 0.0
        self.window_s = 0.0
        self.by_name: dict[str, float] = {}
        self.gaps: list[tuple[float, str]] = []
        self.n_device_events = 0

    @contextlib.contextmanager
    def job(self, spans=None):
        """Profile one job; ``spans()`` -> the program's [(name, t0_ns,
        t1_ns)] on ``time.monotonic_ns``, read once the job is done."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            mark_ns = time.monotonic_ns()
            with record_function(MARK):
                pass
            t0 = time.perf_counter()
            yield
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0  # the job's own wall, not the profiler's teardown
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.unlink(path)
        self._add(events, wall, mark_ns, spans() if spans is not None else [])

    def _add(self, events: list, wall: float, mark_ns: int = 0, spans=()) -> None:
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
        mark = next((float(e["ts"]) for e in xs if e.get("name") == MARK), None)
        prog = []
        if mark is not None:  # program spans onto the profiler's clock (us)
            prog = [(n, (a - mark_ns) / 1e3 + mark, (b - mark_ns) / 1e3 + mark) for n, a, b in spans]
        dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", "?"))
                     for e in xs if e.get("cat") in DEVICE_CATS)
        host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", "?"))
                for e in xs if e.get("cat") in ("cpu_op", "user_annotation")]
        self.n_device_events += len(dev)
        if mark is not None:  # the job's own wall on the profiler's clock
            t_lo, t_hi = mark, mark + wall * 1e6
        else:
            t_lo = min((h[0] for h in host), default=dev[0][0] if dev else 0.0)
            t_hi = max((h[1] for h in host), default=dev[-1][1] if dev else 0.0)
        busy, end, prev = 0.0, float("-inf"), "job start"
        gaps = []
        cur = t_lo
        for s0, s1, name in dev:
            base = kernel_base(name)
            self.by_name[base] = self.by_name.get(base, 0.0) + (s1 - s0) / 1e6
            if s0 > cur:
                gaps.append((cur, s0, prev))
            busy += max(0.0, s1 - max(s0, end))
            end = max(end, s1)
            cur = max(cur, s1)
            prev = name
        if t_hi > cur:
            gaps.append((cur, t_hi, prev))
        self.busy_s += busy / 1e6
        self.window_s += wall
        for g0, g1, after in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
            self.gaps.append(((g1 - g0) / 1e6, _label(g0, g1, prog, host, after)))

    def summary(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps, key=lambda g: -g[0])[:10]
        return {"busy_s": self.busy_s, "window_s": self.window_s,
                "device_s_by_name": dict(self.by_name),
                "n_device_events": self.n_device_events,
                "device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[label, s] for s, label in gaps]}


MARK = "perfbench.job"


def kernel_base(name: str) -> str:
    """``void ns::kern<T>(int*, ...)`` -> ``ns::kern``; an anonymous
    namespace is dropped."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("(", "<"):
        name = name.split(stop, 1)[0]
    return name.strip() or "?"


def _label(g0: float, g1: float, prog: list, host: list, after: str) -> str:
    mid = 0.5 * (g0 + g1)
    inner = [(b - a, n) for n, a, b in prog if a <= mid <= b]
    if inner:
        return f"program span {min(inner)[1]}"
    best, name = 0.0, None
    for h0, h1, hn in host:
        ov = min(g1, h1) - max(g0, h0)
        if ov > best:
            best, name = ov, hn
    if name is not None and best >= 0.5 * (g1 - g0):
        return f"host {name}"
    return f"host without a torch op or span, after {kernel_base(after)}"
