"""Named-timer registry and metrics report (copied from
``adam_tpu/utils/instrumentation.py``; the device trace is
``torch.profiler``).

The tracing shape of the reference (``instrumentation/Timers.scala:25-81``
+ bdg-utils ``Metrics``): one named timer per pipeline stage / hot loop,
used as ``with TIMERS.time("Sort Reads"): ...`` wherever the reference
writes ``SortReads.time { ... }``; the CLI's ``-print_metrics`` prints
the aggregated table at command end (``ADAMCommand.scala:56-89``).

Device additions: a command can run inside a ``torch.profiler`` trace
(:func:`device_trace`) whose Chrome-trace file shows the CUDA kernels
beside the host calls, and :func:`block` synchronizes device work so
wall times mean what they say.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field


@dataclass
class Timer:
    name: str
    total_ns: int = 0
    count: int = 0

    @property
    def total_s(self) -> float:
        return self.total_ns / 1e9


@dataclass
class TimerRegistry:
    timers: dict = field(default_factory=dict)
    recording: bool = False
    # Codec/write timers fire from the ingest thread and the writer pool
    # concurrently (pipelines/streamed.py); a lock keeps the
    # read-modify-write on Timer.total_ns from losing updates.
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def _timer_locked(self, name: str) -> Timer:
        # caller holds self._lock
        if name not in self.timers:
            self.timers[name] = Timer(name)
        return self.timers[name]

    def timer(self, name: str) -> Timer:
        with self._lock:
            return self._timer_locked(name)

    @contextlib.contextmanager
    def time(self, name: str):
        if not self.recording:
            yield
            return
        t0 = time.monotonic_ns()
        try:
            yield
        finally:
            dt = time.monotonic_ns() - t0
            with self._lock:
                t = self._timer_locked(name)
                t.total_ns += dt
                t.count += 1

    def add(self, name: str, ns: int) -> None:
        """Accumulate an externally-measured duration under ``name``
        (for stages whose wall is computed elsewhere, e.g. the streamed
        pipeline's stats dict)."""
        if not self.recording:
            return
        with self._lock:
            t = self._timer_locked(name)
            t.total_ns += ns
            t.count += 1

    def reset(self) -> None:
        """Clear timers; on the process-global ``TIMERS`` singleton also
        clear the structured metrics layer's counters/gauges
        (utils/telemetry.py) — one reset for the whole metrics surface,
        so a re-run never reports stale values from either.  Private
        registry instances reset only themselves: they must not wipe
        global telemetry another surface is still accumulating."""
        with self._lock:
            self.timers.clear()
        if self is globals().get("TIMERS"):
            from adam_tpu_torch.utils import telemetry  # late: it imports us

            telemetry.TRACE.reset_metrics()

    def snapshot(self) -> dict:
        """Consistent copy ``{name: (count, total_ns)}`` taken under the
        lock — safe to call concurrently with ``time()``/``add()`` from
        writer threads (the unlocked ``report()`` iteration raced with
        timer inserts)."""
        with self._lock:
            return {t.name: (t.count, t.total_ns) for t in self.timers.values()}

    def report(self) -> str:
        """Aggregated table, longest stages first (the Metrics printout)."""
        rows = sorted(
            self.snapshot().items(), key=lambda kv: -kv[1][1]
        )
        if not rows:
            return "Timings\n=======\n(no timers recorded)\n"
        w = max(len(name) for name, _ in rows)
        out = ["Timings", "======="]
        out.append(f"{'timer'.ljust(w)}  {'count':>7}  {'total s':>10}")
        for name, (count, total_ns) in rows:
            out.append(
                f"{name.ljust(w)}  {count:>7}  {total_ns / 1e9:>10.3f}"
            )
        return "\n".join(out) + "\n"


#: Process-wide registry — the ``object Timers`` analog.
TIMERS = TimerRegistry()

# Named stages mirroring instrumentation/Timers.scala:25-81 (subset that
# maps onto this framework's stages; names kept recognizable).
LOAD_ALIGNMENTS = "Load Alignments"
SORT_READS = "Sort Reads"
MARK_DUPLICATES = "Mark Duplicates"
BQSR = "Base Quality Recalibration"
REALIGN_INDELS = "Realign Indels"
TRIM_READS = "Trim Reads"
FLAGSTAT = "Flag Stat"
COUNT_KMERS = "Count Kmers"
SAVE_OUTPUT = "Save Output"

# Codec / IO-path timers — the per-output-format timing the reference
# gets from InstrumentedOutputFormat (rdd/ADAMRDDFunctions.scala:161-164)
# and the per-stage RDD instrumentation (rdd/ADAMContext.scala:158).
# These fire inside the native tokenizer dispatch and the Parquet part
# writers, so `-print_metrics` decomposes the ingest/encode/write share
# of a command's wall time.
TOKENIZE_INPUT = "Tokenize Input (native)"
BGZF_CODEC = "BGZF Codec (native)"
PARQUET_ENCODE = "Parquet Encode"
PARQUET_WRITE = "Write ADAM Record (part file)"
SAM_ENCODE = "Write SAM/BAM Record (encode)"
FASTQ_ENCODE = "Write FASTQ Record (encode)"
OBSERVE_WALK = "BQSR Observe Walk (native)"
APPLY_WALK = "BQSR Apply Walk (native)"


#: The ``record_function`` marker :func:`device_trace` records at its
#: start, and the trace's metadata key that holds the ``time.monotonic_ns()``
#: noted at that marker: together they put the program's spans (a
#: ``--trace-out`` export) on the profiler's clock.
DEVICE_TRACE_MARK = "adam_tpu_torch.device_trace.mark"
DEVICE_TRACE_MARK_NS = "adam_tpu_torch_mark_monotonic_ns"

# torch.profiler supports ONE active profile per process; a second
# concurrent start raises deep inside the profiler.  The flag makes
# device_trace reentrant-safe: nested/concurrent entries warn + no-op.
_DEVICE_TRACE_LOCK = threading.Lock()
_DEVICE_TRACE_ACTIVE = False


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace of a stage — the device face of the
    metrics system (the CLI exposes it as ``--xprof-dir DIR`` around the
    verb).  Profiles the CPU, and CUDA when a card is visible, and
    writes one Chrome-trace JSON file into ``log_dir``
    (``trace-<pid>.json``, loadable in Perfetto or chrome://tracing;
    no tensorboard package is needed).  A :data:`DEVICE_TRACE_MARK`
    marker at the start, with its ``time.monotonic_ns()`` under
    :data:`DEVICE_TRACE_MARK_NS` in the trace's metadata, ties the trace
    to the program's spans (``analyze --device-trace``).

    Reentrant-safe: when a trace is already active in this process the
    inner entry logs a warning and no-ops instead of crashing the
    profiler.  A profiler that cannot start raises.
    """
    global _DEVICE_TRACE_ACTIVE
    import logging
    import os

    log = logging.getLogger(__name__)
    with _DEVICE_TRACE_LOCK:
        if _DEVICE_TRACE_ACTIVE:
            already = True
        else:
            _DEVICE_TRACE_ACTIVE = True
            already = False
    if already:
        log.warning(
            "device_trace(%s): a profiler trace is already active in "
            "this process; nested trace request ignored", log_dir,
        )
        yield
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            mark_ns = time.monotonic_ns()
            with record_function(DEVICE_TRACE_MARK):
                pass
            prof.add_metadata_json(DEVICE_TRACE_MARK_NS, str(mark_ns))
            yield
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace-{os.getpid()}.json")
        )
    finally:
        with _DEVICE_TRACE_LOCK:
            _DEVICE_TRACE_ACTIVE = False


def block(x):
    """Synchronize the device of tensor ``x`` (a no-op for CPU tensors
    and non-tensors) so surrounding timers measure real work; returns
    ``x``."""
    import torch

    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)
    return x
