"""Structured tracing + metrics: spans, counters, gauges, histograms,
flight recorder, live heartbeat (copied from ``adam_tpu/utils/telemetry.py``;
the HBM sampler reads ``torch.cuda.memory_stats``).

The observability layer the reference gets from bdg-utils ``Metrics`` +
Spark's listener-decomposed stage/task timings
(``instrumentation/Timers.scala:25-81``, ``ADAMCommand.scala:56-89``),
built for the overlapped streamed pipeline: flat named timers
(:mod:`adam_tpu_torch.utils.instrumentation`, which this module subsumes)
cannot show queue depths, per-window latency, or where the
tokenize/dispatch/fetch/encode/write overlap breaks down.

Three primitives, one lock discipline (the ``TimerRegistry`` one —
single mutex, read-modify-write only under it):

* **spans** — ``with TRACE.span("bqsr.apply.dispatch", window=i):``
  records a timestamped interval with thread and parent attribution
  into (a) a per-name aggregate (count, total ns) and (b) a bounded
  in-memory **flight recorder** (ring buffer — long runs cannot OOM;
  evictions keep the newest events and are counted).
* **counters** — monotonically accumulated ints (reads ingested, bytes
  encoded/written, device windows dispatched/fetched).
* **gauges** — sampled values with last/min/max/n (writer-pool queue
  depth at submit/drain, device dispatch in-flight).
* **histograms** — ``Tracer.observe(name, value)`` accumulates into
  fixed log-spaced buckets (:data:`HIST_BUCKETS_PER_DECADE` per decade
  — shared global edges, so per-host/per-run merges are associative),
  and every span name additionally gets an **automatic duration
  histogram** (seconds) — scalar span totals answer "how much", the
  quantiles (p50/p90/p99 in ``snapshot()``/``report()``) answer "is
  the tail why the barrier stalls" (Dean & Barroso, The Tail at
  Scale: synchronized multi-device pipelines are governed by tail
  latency, not means).

Exports: :meth:`Tracer.to_json` (the ``--metrics-json`` snapshot, whose
``timers`` section is byte-identical to the ``-print_metrics`` table)
and :meth:`Tracer.to_chrome_trace` (the ``--trace-out`` view — complete
events on per-thread tracks, loadable in chrome://tracing / Perfetto,
so the streamed overlap is visually inspectable).

Disabled-by-default cost is one branch per call site: ``span()``
returns a shared no-op context manager and ``count()``/``gauge()``
return immediately when ``recording`` is off (micro-benchmark in
docs/OBSERVABILITY.md).  The streamed pipeline records its stage spans
into a private always-on :class:`Tracer` (a handful of events per
window) and derives its ``stats`` dict from them via
:func:`streamed_stats_view`, so the dict and the span data can never
disagree; the run tracer is absorbed into the global :data:`TRACE`
when recording is on.

Every span/counter/gauge name is declared here (the ``_span``/
``_metric`` registrations below): the JAX package's set plus the spans
of :data:`PORT_ONLY_SPANS`, which split the port's host time finer, and
the counters of :data:`PORT_ONLY_METRICS` — a **stable contract** held
by ``tests/test_torch_telemetry.py`` (exactly JAX's names plus those
lists, and every name the port's code records is registered).
:meth:`Tracer.to_chrome_trace` also writes the trace's epoch
(``epoch_ns``), so ``analyze --device-trace`` can put its spans on a
``--xprof-dir`` trace's clock.
"""

from __future__ import annotations

import json
import math
import os
import re
import sys
import threading
import time
from collections import deque

# One process-wide trace epoch so timestamps from every Tracer (the
# global TRACE, streamed run tracers, absorbed events) land on a single
# comparable time axis in the Chrome-trace export.
_EPOCH_NS = time.monotonic_ns()

# --------------------------------------------------------------------------
# Name registry — the stable contract (docs/OBSERVABILITY.md)
# --------------------------------------------------------------------------
_REGISTERED_SPANS: set = set()
_REGISTERED_METRICS: set = set()


def _span(name: str) -> str:
    _REGISTERED_SPANS.add(name)
    return name


def _metric(name: str) -> str:
    _REGISTERED_METRICS.add(name)
    return name


# ---- streamed-pipeline stage spans (pipelines/streamed.py; the stats
# dict keys derive from these via streamed_stats_view) ----
SPAN_PASS_A = _span("streamed.pass_a.ingest")
SPAN_TOKENIZE = _span("streamed.tokenize")
SPAN_MD_FETCH = _span("streamed.markdup.fetch")
SPAN_RESOLVE = _span("streamed.barrier.resolve")
SPAN_SPLIT = _span("streamed.pass_b.split")
SPAN_OBSERVE = _span("streamed.observe")
SPAN_TAIL = _span("streamed.tail")
SPAN_OBS_MERGE = _span("streamed.observe.merge_fetch")
SPAN_SOLVE = _span("streamed.barrier.solve")
SPAN_PASS_C = _span("streamed.pass_c")
SPAN_APPLY_DISPATCH = _span("streamed.apply.dispatch")
SPAN_APPLY_FETCH = _span("streamed.apply.fetch")
SPAN_WRITE_WAIT = _span("streamed.write_wait")
SPAN_TOTAL = _span("streamed.total")

# ---- per-call spans with backend attribution (pipelines/bqsr.py,
# pipelines/markdup.py) ----
SPAN_BQSR_OBSERVE = _span("bqsr.observe.window")
SPAN_BQSR_APPLY_DISPATCH = _span("bqsr.apply.dispatch")
SPAN_BQSR_APPLY_FETCH = _span("bqsr.apply.fetch")
SPAN_BQSR_APPLY_HOST = _span("bqsr.apply.host")
SPAN_MD_COLUMNS = _span("markdup.columns.dispatch")
# the megakernel tier: one fused B→C dispatch per window when the
# recalibration table is known up front (streamed.fused_bc 1/0).  JAX's
# names: the port runs pass B and pass C apart, so it records none of
# the three.  kernel.backend is the resolved kernel backend (0=xla
# 1=pallas in JAX, 0=plain 1=cuda in the port), once per run
SPAN_FUSED_BC = _span("bqsr.fused_bc")
G_FUSED_BC = _metric("streamed.fused_bc")
G_KERNEL_BACKEND = _metric("kernel.backend")
C_FUSED_DISPATCHED = _metric("device.windows.fused")

# ---- device pool (parallel/device_pool.py): multi-chip round-robin
# dispatch + per-device compile prewarm.  Dispatch/fetch spans carry a
# ``device=<k>`` attribution (the device id; the CUDA index in the port), which (a) aggregates
# into the snapshot's ``device_spans`` section (per-chip occupancy/
# skew) and (b) mirrors onto a per-chip ``device:<k>`` track in the
# Chrome-trace export.  The prewarm records one WALL umbrella span per
# run (concurrent per-compile spans sum past wall, so the derived
# ``prewarm_s`` comes from the umbrella) plus one compile span per
# (kernel shape, device). ----
SPAN_POOL_PREWARM = _span("device.pool.prewarm")
SPAN_POOL_PREWARM_C = _span("device.pool.prewarm.pass_c")
SPAN_POOL_PREWARM_COMPILE = _span("device.pool.prewarm.compile")
# ---- resilience (utils/faults.py, utils/retry.py, the streamed
# recovery paths): one ``device.pool.replay`` span per window whose
# device work was replayed on a survivor (or the host backend) after a
# failure, with ``device=<k>`` naming the chip that FAILED. ----
SPAN_POOL_REPLAY = _span("device.pool.replay")

# ---- multi-job transform service (adam_tpu/serve): one umbrella span
# per job run attempt on the global TRACE, ``job=<id>`` + ``tenant=``
# attributed — the SLO view of how long each tenant's job actually held
# a slot, resumed attempts included. ----
SPAN_SCHED_JOB = _span("sched.job.run")

# ---- job-scoped distributed traces (docs/OBSERVABILITY.md "Trace
# context").  One span per gateway admission, ``job=`` + ``trace=``
# attributed — the root of a job's trace (submit -> fused dispatch ->
# part write).  One span per FUSED coalescer dispatch
# (serve/batching.py) whose ``links`` arg names every contributing
# ticket's {job, window, trace} — the fan-in edge that lets a per-job
# trace export cross the fused-batch boundary. ----
SPAN_GW_SUBMIT = _span("gateway.job.submit")
SPAN_BATCH_FUSED = _span("sched.batch.fused")

# ---- barrier-2 per-fetch spans (pipelines/bqsr.merge_observations):
# one per device-resident observe histogram fetched at the merge
# barrier, ``device=<k>`` + ``window=<i>`` attributed — whether the n
# fetches serialize on the host thread (the ROADMAP "observe-fetch
# serialization" item) is directly readable off these spans' start
# timestamps in a trace. ----
SPAN_OBS_FETCH = _span("device.fetch.observe")

# ---- io/parquet.py part-writer spans ----
SPAN_PART_ENCODE = _span("parquet.part.encode")
SPAN_PART_WRITE = _span("parquet.part.write")

# ---- native tokenizer/codec spans share the timer-table names
# (native/__init__.py records each dispatch as BOTH a timer row and a
# span, so the flight recorder sees the codec work on its thread) ----
from adam_tpu_torch.utils import instrumentation as _ins  # noqa: E402

for _n in (
    _ins.TOKENIZE_INPUT, _ins.BGZF_CODEC, _ins.PARQUET_ENCODE,
    _ins.PARQUET_WRITE, _ins.SAM_ENCODE, _ins.FASTQ_ENCODE,
    _ins.OBSERVE_WALK, _ins.APPLY_WALK,
):
    _span(_n)

# ---- spans of this package only (PORT_ONLY_SPANS): where the host time
# of a streamed transform, of count_kmers and of the transform service goes
# below the stage spans.
# The streamed run's own (setup, pass-A wait, finish) go on its run
# tracer; the library's go on TRACE (one branch each when recording is
# off).  Every other name is the JAX package's.  The names added from the
# transform service's waits on are documented in adam_tpu_torch/OBSERVABILITY.md,
# the earlier ones in docs/OBSERVABILITY.md. ----
SPAN_KNOWN_SITES = _span("transform.known_sites.load")  # cli/actions._known_sites
SPAN_SETUP = _span("streamed.setup")          # run start -> pass A's first queue get
SPAN_PASS_A_WAIT = _span("streamed.pass_a.wait")  # pass A blocked on the ingest queue
SPAN_FINISH = _span("streamed.finish")        # after the write wait -> streamed.total's end
SPAN_OBSERVE_MD_WALK = _span("bqsr.observe.md_walk")    # MD walk + read mask
SPAN_OBSERVE_SNP_MASK = _span("bqsr.observe.snp_mask")  # native.mask_known_sites
SPAN_REALIGN_PREP = _span("realign.prep")      # targets, native prep, consensuses, tiles
SPAN_REALIGN_SWEEP = _span("realign.sweep")    # sweep dispatch; the fetch wait
SPAN_REALIGN_DECIDE = _span("realign.decide")  # scoring, rewrite decisions, write-back
SPAN_OQ_STASH = _span("bqsr.apply.oq_stash")
SPAN_PARQUET_READ = _span("parquet.read_table")    # io/parquet.load_alignments
SPAN_PARQUET_FROM_ARROW = _span("parquet.from_arrow")
SPAN_ARROW_CODES = _span("Arrow Codes (native)")  # native.arrow_codes, a timer row too
SPAN_KMERS_HISTOGRAM = _span("kmers.histogram")  # device sort + run lengths + fetch
SPAN_KMERS_DECODE = _span("kmers.decode")        # keys -> the dict of strings
# the transform service's waits, both on TRACE: a coalescer ticket from its
# submission to its group's dispatch (recorded by the dispatch thread), and
# a registered lane's WFQ turn from entry to grant (on the job's thread)
SPAN_BATCH_TICKET_WAIT = _span("sched.batch.ticket_wait")
SPAN_PACE_WAIT = _span("sched.pace.wait")
PORT_ONLY_SPANS = frozenset({
    SPAN_KNOWN_SITES, SPAN_SETUP, SPAN_PASS_A_WAIT, SPAN_FINISH,
    SPAN_OBSERVE_MD_WALK, SPAN_OBSERVE_SNP_MASK, SPAN_REALIGN_PREP,
    SPAN_REALIGN_SWEEP, SPAN_REALIGN_DECIDE, SPAN_OQ_STASH,
    SPAN_PARQUET_READ, SPAN_PARQUET_FROM_ARROW, SPAN_ARROW_CODES,
    SPAN_KMERS_HISTOGRAM, SPAN_KMERS_DECODE, SPAN_BATCH_TICKET_WAIT,
    SPAN_PACE_WAIT,
})
# the counters of this package only (PORT_ONLY_METRICS)
C_OBSERVE_SNP_MASKED = _metric("bqsr.observe.snp_masked")  # residues on a known site
PORT_ONLY_METRICS = frozenset({C_OBSERVE_SNP_MASKED})

# ---- counters ----
C_READS_INGESTED = _metric("reads.ingested")
C_WINDOWS_INGESTED = _metric("windows.ingested")
C_DEVICE_DISPATCHED = _metric("device.windows.dispatched")
C_DEVICE_FETCHED = _metric("device.windows.fetched")
C_BYTES_ENCODED = _metric("parquet.bytes.encoded")
C_BYTES_WRITTEN = _metric("parquet.bytes.written")
C_PARTS_WRITTEN = _metric("parquet.parts.written")
# part-encode byte accounting (io/parquet._count_encode_bytes):
# bytes_in = the decoded column payload entering a part encode (batch
# matrices + sidecar string buffers, the qual matrix replaced by the
# device-packed payload when pass C shipped one), bytes_out = the
# assembled arrow table handed to the writer.  Together they make the
# packed-column encode shrink directly visible in --metrics-json
# snapshots, and `adam-tpu analyze` prints the in->out->disk ratio in
# its write-tail decomposition.
C_ENCODE_BYTES_IN = _metric("parquet.encode.bytes_in")
C_ENCODE_BYTES_OUT = _metric("parquet.encode.bytes_out")
C_CANDIDATE_ROWS = _metric("realign.candidate_rows")
C_POOL_PREWARM_COMPILES = _metric("device.pool.prewarm.compiles")
# resilience counters: injected faults (utils/faults.point), retry
# attempts actually taken (utils/retry.retry_call — 0 on a clean run),
# and devices evicted from the pool after a spent retry budget
C_FAULT_INJECTED = _metric("fault.injected")
C_RETRY_ATTEMPTS = _metric("retry.attempts")
C_DEVICE_EVICTED = _metric("device.evicted")
# durable-resume counters (pipelines/checkpoint.RunJournal +
# pipelines/streamed.py --run-dir/--resume; docs/ROBUSTNESS.md "Durable
# window-granular resume"): output windows skipped because the journal
# records their part as durably published, persisted pass-B observe
# histograms reloaded instead of recomputed, and resumes REFUSED
# (fingerprint mismatch / torn journal → clean restart, never mixed
# output).  All zero on a fresh run.
C_RESUME_WINDOWS_SKIPPED = _metric("resume.windows_skipped")
C_RESUME_HISTOGRAMS_LOADED = _metric("resume.histograms_loaded")
C_RESUME_REFUSED = _metric("resume.refused")
# mesh execution mode (--partitioner mesh; parallel/partitioner.py):
# collective dispatches actually run on the batch mesh (observe/apply/
# markdup windows), and degradations — a mesh failure that dropped the
# run back to the pool path (windows folded into a suspect accumulator
# replay through the pool/host observe, bit-identically)
C_MESH_DISPATCHED = _metric("device.mesh.dispatched")
C_MESH_DEGRADED = _metric("device.mesh.degraded")
# multi-job transform service (adam_tpu/serve; docs/ROBUSTNESS.md
# "Fault-isolated multi-job scheduling"): admissions accepted, typed
# Busy rejections (capacity / draining — never an exception, never an
# unbounded queue), jobs quarantined after a spent job-retry budget,
# jobs interrupted at a window boundary by a graceful drain, and
# incomplete jobs resumed by the whole-process crash-recovery scan.
C_SCHED_ADMITTED = _metric("sched.jobs.admitted")
C_SCHED_REJECTED = _metric("sched.jobs.rejected")
C_SCHED_QUARANTINED = _metric("sched.jobs.quarantined")
C_SCHED_INTERRUPTED = _metric("sched.jobs.interrupted")
C_SCHED_RECOVERED = _metric("sched.jobs.recovered")
# HTTP gateway (adam_tpu/gateway; docs/SERVING.md): requests served
# (every method/route, errors included), typed back-pressure responses
# actually sent (429 capacity / 503 draining-or-transient — the wire
# twin of sched.jobs.rejected), and response payload bytes that left
# the process (part-fetch chunks + event-stream lines; headers
# excluded).  The per-request wall lands in the
# ``gateway.request.seconds`` histogram below.
C_GW_REQUESTS = _metric("gateway.requests")
C_GW_BUSY = _metric("gateway.busy")
C_GW_BYTES_OUT = _metric("gateway.bytes_out")
# cross-job window batching (adam_tpu/serve/batching.py; docs/SERVING.md
# "Continuous batching & quotas"): fused device dispatches actually
# issued by the coalescer, the per-job windows they carried (windows /
# dispatches is the dispatches-saved ratio `adam-tpu analyze` prints),
# real rows occupied vs grid rows dispatched (their running ratio is
# the heartbeat's `batch_fill`), and windows that FELL BACK to their
# job's solo dispatch path (a fused-dispatch failure isolates to the
# tickets it carried; each job re-dispatches alone, byte-identically).
C_BATCH_DISPATCHES = _metric("sched.batch.dispatches")
C_BATCH_WINDOWS = _metric("sched.batch.windows")
C_BATCH_ROWS_OCCUPIED = _metric("sched.batch.rows_occupied")
C_BATCH_ROWS_DISPATCHED = _metric("sched.batch.rows_dispatched")
C_BATCH_FALLBACKS = _metric("sched.batch.fallbacks")
# per-tenant quota enforcement (adam_tpu/serve/quota.py): submissions
# refused with the typed `Busy(kind="quota")` — the gateway's 429
# quota leg, distinct from the capacity leg
C_QUOTA_REJECTED = _metric("sched.quota.rejected")
# mid-run quota throttle (serve/quota.QuotaManager.throttle): grants
# deferred at the pacer seam because the tenant's rolling window was
# over budget — the smooth edge between "admitted" and the 429 leg
C_QUOTA_DEFERRED = _metric("sched.quota.deferred")

# ---- device health / hedged dispatch / SDC audit (utils/health.py,
# docs/ROBUSTNESS.md "Device health, hedging, and SDC audit").
# Scoreboard transitions: healthy->suspect demotions, entries into
# probation (placement-excluded; includes audit quarantines),
# re-admissions after a passing known-answer probe, and probes that
# FAILED (probation -> evicted).  Hedge counters: speculative
# re-dispatches launched when an in-flight window exceeded
# ADAM_TPU_HEDGE_FACTOR x the kernel's observed p99, the subset whose
# result was actually used (won), and the subset discarded because the
# primary finished first (wasted) — fired == won + wasted.  Audit
# counters: windows sampled for dual-compute (ADAM_TPU_AUDIT_RATE) and
# bit-compare mismatches caught (each one quarantines the producing
# device and replays the window from the host copy). ----
C_HEALTH_DEMOTED = _metric("device.health.demoted")
C_HEALTH_PROBATION = _metric("device.health.probation")
C_HEALTH_READMITTED = _metric("device.health.readmitted")
C_HEALTH_PROBE_FAILED = _metric("device.health.probe_failed")
C_HEDGE_FIRED = _metric("device.hedge.fired")
C_HEDGE_WON = _metric("device.hedge.won")
C_HEDGE_WASTED = _metric("device.hedge.wasted")
C_AUDIT_SAMPLED = _metric("device.audit.sampled")
C_AUDIT_MISMATCH = _metric("device.audit.mismatch")
# one span per SDC dual-compute comparison (pipelines/streamed.py
# _audit_result), ``device=`` + ``window=`` attributed — an incident
# bundle's embedded trace shows the audit interval itself next to the
# dispatch/fetch spans of the window it checked
SPAN_AUDIT_CHECK = _span("device.audit.check")

# ---- incident recorder (utils/incidents.py; docs/OBSERVABILITY.md
# "Incident bundles"): bundles actually written (trigger-cooldowns and
# the bounded-count prune mean this can lag the trigger counters), and
# ``/metrics`` scrapes served by the gateway — the heartbeat's
# ``metrics_scrapes`` field, so `adam-tpu top` can show whether a
# scraper is actually reaching the process. ----
C_INCIDENT_RECORDED = _metric("incident.recorded")
C_GW_SCRAPES = _metric("gateway.metrics.scrapes")

# ---- SLO engine + perf sentinel (utils/slo.py, utils/perfledger.py;
# docs/OBSERVABILITY.md "SLOs and error budgets" / "The perf ledger"):
# the judgment layer.  ``slo.worst_burn`` is the worst short-window
# error-budget burn rate across armed objectives (1.0 = spending
# exactly on objective), ``slo.budget_remaining`` the smallest
# remaining budget fraction; ``slo.breaches`` counts corroborated
# fast-burn crossings (each also fires the ``slo.burn`` incident
# trigger), and ``perf.regressions`` counts direction-aware perf keys
# the ledger sentinel flagged vs its rolling median baseline. ----
C_SLO_BREACHES = _metric("slo.breaches")
C_PERF_REGRESSIONS = _metric("perf.regressions")
G_SLO_WORST_BURN = _metric("slo.worst_burn")
G_SLO_BUDGET_REMAINING = _metric("slo.budget_remaining")

# ---- gauges ----
G_POOL_DEPTH = _metric("parquet.pool.queue_depth")
# the writer pool's LIVE admission bound (parts allowed in flight):
# starts at the construction inflight_parts and grows one part at a
# time while submits measurably gate (adaptive sizing, bounded by the
# scheduling affinity) — a run whose last value exceeds its first was
# writer-bound long enough for the pool to widen itself
G_POOL_BOUND = _metric("parquet.pool.inflight_bound")
G_DEVICE_INFLIGHT = _metric("device.dispatch.in_flight")
G_OBSERVE_HIDDEN = _metric("streamed.observe_overlap_hidden")
G_POOL_DEVICES = _metric("device.pool.devices")
# 1 when the barrier-1 duplicate-resolve lexsort ran as the device sort
# of the packed summary keys (parallel/dist.device_lexsort), 0 when it
# ran host-side — `adam-tpu analyze` labels the resolve stage with it
G_RESOLVE_DEVICE_SORT = _metric("streamed.resolve.device_sort")
# live job-slot occupancy of the multi-job scheduler (adam_tpu/serve)
G_SCHED_ACTIVE = _metric("sched.jobs.active")
# distinct jobs the coalescer's LAST fused dispatch carried (the
# heartbeat's `batched_jobs` field; 1 = batching on but traffic too
# sparse to coalesce)
G_BATCH_JOBS = _metric("sched.batch.jobs")

# ---- device ledger: tunnel byte accounting (utils/transfer.py +
# parallel/device_pool.py).  Counters carry the run totals; the
# per-direction throughput histograms (bytes/second, the shared fixed
# log-spaced buckets) answer whether the link itself — not the host —
# is the wall; the snapshot's ``transfers`` section attributes
# count/bytes/seconds per device AND per pipeline pass (a/observe/
# apply/sweep/prewarm via :func:`pass_scope`). ----
C_H2D_BYTES = _metric("device.h2d.bytes")
C_D2H_BYTES = _metric("device.d2h.bytes")
H_H2D_BPS = _metric("device.h2d.bps")
H_D2H_BPS = _metric("device.d2h.bps")

# ---- device-resident windows (parallel/device_pool.ResidentWindow,
# docs/PERF.md "Device-resident windows"): each window's bases/quals
# land on device once at ingest (the ``ingest`` pass bucket in the
# transfers section) and stay resident through markdup -> observe ->
# apply.  Counters: windows placed resident / total bytes placed /
# refcounted releases after pass C / handles dropped by an eviction or
# mesh degradation (their windows re-ship from the host ingest copy).
# The gauge tracks live resident bytes — back to 0 at run end, the
# no-HBM-growth invariant tests/test_resident.py asserts. ----
C_RESIDENT_WINDOWS = _metric("device.resident.windows")
C_RESIDENT_BYTES = _metric("device.resident.bytes")
C_RESIDENT_RELEASED = _metric("device.resident.released")
C_RESIDENT_EVICTED = _metric("device.resident.evicted")
G_RESIDENT_LIVE = _metric("device.resident.live_bytes")

# ---- compile ledger (utils/compile_ledger.py wraps every streamed jit
# dispatch site): per-dispatch executable-cache hit/miss accounting
# keyed by (kernel, grid shape, device).  A miss's duration is the
# dispatch WALL of the call that compiled (trace+compile dominate it);
# misses recorded outside a prewarm scope are cold compiles that landed
# INSIDE a timed window — the direct measurement of the PERF.md
# "prewarm coverage boundary".  Entries land in the snapshot's
# ``compiles`` section; the analyzer flags the in-window subset. ----
C_COMPILE_HITS = _metric("device.compile.cache_hits")
C_COMPILE_MISSES = _metric("device.compile.cache_misses")
C_COMPILE_IN_WINDOW = _metric("device.compile.in_window")
H_COMPILE_SECONDS = _metric("device.compile.seconds")

# ---- HBM footprint (device.memory_stats(), sampled per heartbeat
# tick; per-device last/peak live in the snapshot's ``hbm`` section —
# this gauge is the cross-device total for the printed table) ----
G_HBM_IN_USE = _metric("device.hbm.bytes_in_use")

# ---- histograms (explicit observe() sites; every span name also gets
# an automatic duration histogram under its own name, in seconds) ----
H_FETCH_SECONDS = _metric("device.fetch.seconds")
H_POOL_SUBMIT_WAIT = _metric("parquet.pool.submit_wait")
# end-to-end gateway request wall (accept -> last byte written),
# streaming requests included — the service-side latency SLO view
H_GW_REQUEST_SECONDS = _metric("gateway.request.seconds")
# per-fused-dispatch grid fill (rows occupied / rows dispatched, in
# (0, 1]): the coalescer's fill/latency tradeoff rendered as a
# distribution — `adam-tpu analyze` prints its quantiles in the
# Batching section
H_BATCH_FILL = _metric("sched.batch.fill")

#: Device-only metrics: the paired-CPU bench baseline zeroes these
#: instead of omitting them so round-over-round diffs are key-stable.
DEVICE_ONLY_COUNTERS = frozenset({
    C_DEVICE_DISPATCHED, C_DEVICE_FETCHED, C_POOL_PREWARM_COMPILES,
    C_H2D_BYTES, C_D2H_BYTES,
    C_COMPILE_HITS, C_COMPILE_MISSES, C_COMPILE_IN_WINDOW,
    C_MESH_DISPATCHED, C_MESH_DEGRADED,
})
DEVICE_ONLY_GAUGES = frozenset({G_DEVICE_INFLIGHT, G_POOL_DEVICES})
DEVICE_ONLY_HISTOGRAMS = frozenset(
    {H_FETCH_SECONDS, H_H2D_BPS, H_D2H_BPS, H_COMPILE_SECONDS}
)


def registered_spans() -> frozenset:
    return frozenset(_REGISTERED_SPANS)


def registered_metrics() -> frozenset:
    return frozenset(_REGISTERED_METRICS)


def registered_names() -> frozenset:
    """Every declared span/counter/gauge name — the contract the
    name test holds every ``SPAN_*``/``C_*``/``G_*``/``H_*`` use to."""
    return frozenset(_REGISTERED_SPANS | _REGISTERED_METRICS)


# --------------------------------------------------------------------------
# Histograms: fixed log-spaced buckets, shared by every histogram
# --------------------------------------------------------------------------
#: Bucket resolution: 4 buckets per decade — bucket ``i`` spans
#: ``[10^(i/4), 10^((i+1)/4))``.  The edges are GLOBAL and fixed (never
#: derived from the data), so merging two histograms is a plain
#: bucket-count sum: associative and commutative across runs, hosts and
#: absorb() calls.
HIST_BUCKETS_PER_DECADE = 4

#: Values at or below this clamp into the lowest bucket (durations are
#: nonnegative; sub-picosecond observations carry no signal).
_HIST_MIN_VALUE = 1e-12


def format_bytes(v) -> str:
    """Human-readable byte count (shared by the analyzer report and
    the ``adam-tpu top`` dashboard); ``"-"`` for non-numbers."""
    if not isinstance(v, (int, float)):
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(v) < 1024.0 or unit == "TiB":
            return f"{v:.1f}{unit}" if unit != "B" else f"{int(v)}B"
        v /= 1024.0


def hist_bucket_index(value: float) -> int:
    """The fixed log-spaced bucket a value falls in."""
    v = max(float(value), _HIST_MIN_VALUE)
    return math.floor(math.log10(v) * HIST_BUCKETS_PER_DECADE)


def hist_bucket_bounds(index: int) -> tuple:
    """``[lo, hi)`` edges of bucket ``index``."""
    return (
        10.0 ** (index / HIST_BUCKETS_PER_DECADE),
        10.0 ** ((index + 1) / HIST_BUCKETS_PER_DECADE),
    )


def _new_hist() -> dict:
    return {"count": 0, "sum": 0.0, "min": None, "max": None, "buckets": {}}


def _hist_observe(h: dict, value: float) -> None:
    """Accumulate one observation (caller holds the tracer lock)."""
    v = float(value)
    h["count"] += 1
    h["sum"] += v
    if h["min"] is None or v < h["min"]:
        h["min"] = v
    if h["max"] is None or v > h["max"]:
        h["max"] = v
    idx = hist_bucket_index(v)
    b = h["buckets"]
    b[idx] = b.get(idx, 0) + 1


def _hist_quantile(h: dict, q: float) -> float | None:
    """Quantile estimate from the bucket counts: walk to the bucket
    holding rank ``q * count`` and return its geometric midpoint,
    clamped to the observed [min, max] so single-sample histograms
    report the sample, not a bucket edge."""
    if not h["count"]:
        return None
    target = q * h["count"]
    acc = 0
    # JSON round-trips turn bucket keys into strings; accept both
    items = sorted((int(k), v) for k, v in h["buckets"].items())
    for idx, n in items:
        acc += n
        if acc >= target:
            mid = 10.0 ** ((idx + 0.5) / HIST_BUCKETS_PER_DECADE)
            lo = h["min"] if h["min"] is not None else mid
            hi = h["max"] if h["max"] is not None else mid
            return min(max(mid, lo), hi)
    return h["max"]


def hist_summary(h: dict) -> dict:
    """Snapshot form of one histogram: scalars + p50/p90/p99 + the
    (string-keyed, JSON-safe) sparse bucket counts that make merges
    across snapshots possible."""
    return {
        "count": h["count"],
        "sum": h["sum"],
        "min": h["min"],
        "max": h["max"],
        "p50": _hist_quantile(h, 0.50),
        "p90": _hist_quantile(h, 0.90),
        "p99": _hist_quantile(h, 0.99),
        "buckets": {str(k): v for k, v in h["buckets"].items()},
    }


def merge_histograms(a: dict, b: dict) -> dict:
    """Merge two histograms in snapshot form (fixed global edges make
    this a plain bucket sum — associative, so per-host merge order
    cannot change the result)."""
    out = _new_hist()
    for h in (a, b):
        if not h or not h.get("count"):
            continue
        out["count"] += h["count"]
        out["sum"] += h["sum"]
        for bound, pick in (("min", min), ("max", max)):
            v = h.get(bound)
            if v is not None:
                out[bound] = v if out[bound] is None else pick(out[bound], v)
        for k, n in h.get("buckets", {}).items():
            k = int(k)
            out["buckets"][k] = out["buckets"].get(k, 0) + n
    return hist_summary(out)


# --------------------------------------------------------------------------
# Transfer pass attribution
# --------------------------------------------------------------------------
# Thread-local pipeline-pass scope: the streamed pipeline enters
# pass_scope("a"/"observe"/"apply"/"sweep") around each pass's dispatch/
# fetch sites, so the transfer ledger can attribute tunnel bytes per
# pass without threading a label through the bqsr/markdup/transfer
# APIs (the same shape as device_pool's replay_scope).
_PASS_TLS = threading.local()

#: The bucket transfers land in when no pass scope is active (library
#: calls, the monolithic pipeline, tests).
PASS_OTHER = "other"


class pass_scope:
    """Marks the current thread as inside one streamed pipeline pass
    for transfer attribution (reentrant; inner scopes shadow outer)."""

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        stack = getattr(_PASS_TLS, "stack", None)
        if stack is None:
            stack = _PASS_TLS.stack = []
        stack.append(self._name)
        return self

    def __exit__(self, *exc):
        _PASS_TLS.stack.pop()
        return False


def current_pass() -> str | None:
    """The innermost active :class:`pass_scope` name, or None."""
    stack = getattr(_PASS_TLS, "stack", None)
    return stack[-1] if stack else None


# --------------------------------------------------------------------------
# Trace context — job-scoped distributed traces
# --------------------------------------------------------------------------
# A trace context is one hex trace_id minted at job submission (the
# gateway, the scheduler, or transform_streamed itself for solo runs),
# persisted in JOB.json so recovery replays keep the SAME id, and
# attached to every span recorded while it is in scope.  Two carriers,
# by design (the Dapper model, adapted to the in-process pool):
#
# * :class:`trace_scope` — thread-local, for code running ON a thread
#   that belongs to one job (the pass_scope shape; helper threads must
#   re-enter it explicitly, exactly like hedged_call re-enters the
#   caller's pass_scope).
# * :meth:`Tracer.set_trace` — a per-tracer default.  A streamed run
#   tracer is ALREADY job-scoped (one Tracer per transform_streamed
#   call), so stamping its default onto every event it records covers
#   worker threads without any TLS plumbing.
#
# The explicit ``trace=`` span attr wins over both — the coalescer's
# fused dispatch serves MANY traces at once and links them via its
# ``links`` arg instead of claiming any single one.
_TRACE_TLS = threading.local()


def mint_trace_id() -> str:
    """A fresh 16-hex-char trace id (crypto-random: ids minted by
    concurrent gateway submissions must never collide)."""
    import binascii

    return binascii.hexlify(os.urandom(8)).decode("ascii")


class trace_scope:
    """Marks the current thread as working for one trace (reentrant;
    inner scopes shadow outer).  ``trace_scope(None)`` is a no-op frame
    so callers can re-enter a captured-maybe-None context untested —
    the hedged_call helper-thread pattern."""

    def __init__(self, trace_id: str | None):
        self._trace = trace_id

    def __enter__(self):
        stack = getattr(_TRACE_TLS, "stack", None)
        if stack is None:
            stack = _TRACE_TLS.stack = []
        stack.append(self._trace)
        return self

    def __exit__(self, *exc):
        _TRACE_TLS.stack.pop()
        return False


def current_trace() -> str | None:
    """The innermost active :class:`trace_scope` id, or None."""
    stack = getattr(_TRACE_TLS, "stack", None)
    for tid in reversed(stack or ()):
        if tid is not None:
            return tid
    return None


# Active-trace registry: the heartbeat's ``active_traces`` field.  A
# trace activates when its job's run starts and deactivates in the
# run's finally — refcounted, because a recovery replay can briefly
# overlap the original registration.
_ACTIVE_TRACES_LOCK = threading.Lock()
_ACTIVE_TRACES: dict = {}  # trace_id -> activation count


def activate_trace(trace_id: str | None) -> None:
    if not trace_id:
        return
    with _ACTIVE_TRACES_LOCK:
        _ACTIVE_TRACES[trace_id] = _ACTIVE_TRACES.get(trace_id, 0) + 1


def deactivate_trace(trace_id: str | None) -> None:
    if not trace_id:
        return
    with _ACTIVE_TRACES_LOCK:
        n = _ACTIVE_TRACES.get(trace_id, 0) - 1
        if n <= 0:
            _ACTIVE_TRACES.pop(trace_id, None)
        else:
            _ACTIVE_TRACES[trace_id] = n


def active_traces() -> tuple:
    """The currently-active trace ids (sorted, for stable output)."""
    with _ACTIVE_TRACES_LOCK:
        return tuple(sorted(_ACTIVE_TRACES))


def event_in_trace(ev: dict, trace_id: str) -> bool:
    """True when a flight-recorder event belongs to ``trace_id`` —
    either stamped directly (``ev["trace"]``) or linked through a
    fused-dispatch fan-in edge (``args.links[*].trace``).  The one
    membership predicate the /trace export, the incident recorder and
    the tests all share."""
    if ev.get("trace") == trace_id:
        return True
    links = (ev.get("args") or {}).get("links")
    if not links:
        return False
    try:
        return any(l.get("trace") == trace_id for l in links)
    except (AttributeError, TypeError):
        return False


# --------------------------------------------------------------------------
# Prometheus name mangling — shared by gateway/metrics.py and the
# telemetry-names staticcheck rule
# --------------------------------------------------------------------------
#: Prefix every exposed series carries (`reads.ingested` ->
#: `adam_tpu_reads_ingested`).
PROMETHEUS_PREFIX = "adam_tpu_"

#: The exposition-format metric-name grammar (no leading digit).
_PROM_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")


def prometheus_name(name: str) -> str:
    """Mangle a registered metric name into its Prometheus series name
    (``.`` -> ``_``, prefixed).  Total function — validation is the
    lint's job (:mod:`adam_tpu.staticcheck.rules.telemetry_names`
    asserts every registered name mangles to a VALID, collision-free
    series name, so the gateway's render path never has to)."""
    return PROMETHEUS_PREFIX + name.replace(".", "_")


def prometheus_name_valid(mangled: str) -> bool:
    """Whether a mangled series name satisfies the Prometheus
    exposition grammar ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    return bool(_PROM_NAME_OK.match(mangled))


#: Ring bound on retained compile-ledger entries: every entry is one
#: real XLA compile (seconds each), so a run can't plausibly exceed
#: this — it exists so a pathological shape explosion degrades to
#: truncation (counted) instead of unbounded growth.
_MAX_COMPILE_ENTRIES = 512


# --------------------------------------------------------------------------
# Span context managers
# --------------------------------------------------------------------------
class _NullSpan:
    """Shared no-op span: the disabled fast path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tr", "name", "attrs", "_t0", "_parent")

    def __init__(self, tr: "Tracer", name: str, attrs: dict):
        self._tr = tr
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        tls = self._tr._tls
        self._parent = getattr(tls, "span", None)
        tls.span = self
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        dur = time.monotonic_ns() - self._t0
        self._tr._tls.span = self._parent
        self._tr._record(
            self.name, self._t0, dur, self.attrs,
            self._parent.name if self._parent is not None else None,
        )
        return False


class Tracer:
    """Span/counter/gauge recorder with a bounded flight recorder.

    Thread-safe under one mutex (the ``TimerRegistry`` lock
    discipline); per-name aggregates live OUTSIDE the ring, so span
    totals stay exact even after the ring evicts old events.
    """

    def __init__(self, recording: bool = False, capacity: int | None = None):
        if capacity is None:
            raw = os.environ.get("ADAM_TPU_TRACE_EVENTS", "")
            try:
                capacity = int(raw)
            except ValueError:
                # the module-level TRACE constructs at import time from
                # every entry point: a malformed tuning var must degrade
                # to the default, not brick the CLI with a ValueError
                if raw:
                    import logging

                    logging.getLogger(__name__).warning(
                        "ADAM_TPU_TRACE_EVENTS=%r is not an int; using "
                        "default 65536", raw,
                    )
                capacity = 65536
        self.recording = recording
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max(1, capacity))
        self._spans: dict = {}     # name -> [count, total_ns]
        self._dev_spans: dict = {} # name -> {device key -> [count, total_ns]}
        self._counters: dict = {}  # name -> int
        self._gauges: dict = {}    # name -> {last, min, max, n}
        self._hists: dict = {}     # name -> _new_hist() dict
        # device ledger: host<->device transfer accounting per
        # direction/device/pass, compile-cache entries, HBM samples
        self._xfer: dict = {}      # dir -> dev -> pass -> [n, bytes, s]
        self._compiles: list = []  # {kernel, shape, device, seconds, ...}
        self._compiles_dropped = 0
        self._hbm: dict = {}       # dev -> {last, peak, n}
        # per-tenant quota ledger (serve/quota.py feeds it): tenant ->
        # {charges, bytes, compute_s, budget_bytes, budget_compute_s}
        self._quota: dict = {}
        # device-health ledger (utils/health.py feeds it): device key ->
        # {state, score, reason, transitions} — the snapshot's `health`
        # section, rendered by `adam-tpu analyze` as "Device health"
        self._health: dict = {}
        # job-scoped trace context: the per-tracer default trace id
        # (set_trace) and the per-trace aggregate ledger the snapshot's
        # `traces` section reports: trace_id -> [events, total span ns]
        self._trace = None
        self._traces: dict = {}
        self._tls = threading.local()
        self._n_recorded = 0

    # ---- trace context ----------------------------------------------------
    def set_trace(self, trace_id: str | None) -> None:
        """Set this tracer's default trace id: every event recorded
        with no explicit ``trace=`` attr and no active
        :class:`trace_scope` is stamped with it.  The streamed run
        tracer is job-scoped, so its default covers every worker
        thread recording into it — no TLS plumbing required."""
        self._trace = trace_id

    @property
    def trace(self) -> str | None:
        """This tracer's default trace id (None when unset)."""
        return self._trace

    # ---- recording --------------------------------------------------------
    def span(self, name: str, **attrs):
        """Span context manager; a shared no-op when not recording."""
        if not self.recording:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def add_span(self, name: str, start_ns: int, dur_ns: int,
                 thread: str | None = None, **attrs) -> None:
        """Record an externally-measured interval (monotonic_ns clock)."""
        if not self.recording:
            return
        self._record(name, start_ns, dur_ns, attrs, None, thread)

    def _record(self, name, t0, dur, attrs, parent, thread=None):
        ev = {
            "name": name,
            "ts_ns": t0,
            "dur_ns": dur,
            "thread": thread or threading.current_thread().name,
        }
        if parent:
            ev["parent"] = parent
        if attrs:
            ev["args"] = dict(attrs)
        # trace attribution: explicit span attr > thread's trace_scope >
        # the tracer's own default (a streamed run tracer is job-scoped,
        # so its default covers worker threads with no TLS plumbing)
        trace = (attrs or {}).get("trace") or current_trace() or self._trace
        if trace:
            ev["trace"] = trace
        dev = (attrs or {}).get("device")
        if (
            dev is not None and (attrs or {}).get("replay")
            and name != SPAN_POOL_REPLAY
        ):
            # replayed work aggregates under ``<k>:replay``, NOT under
            # the survivor's own key: after an eviction the survivor's
            # organic occupancy and the windows it re-ran for the dead
            # chip must stay separable (the evicted device's
            # pre-eviction spans keep its original key untouched).  The
            # replay UMBRELLA is exempt: on a cascading eviction (a
            # device dies mid-replay) the nested umbrella is recorded
            # inside the outer replay_scope, but it must stay under the
            # failed chip's plain key or the analyzer would count the
            # recovery wall as busy time and miss the eviction.
            dev = f"{dev}:replay"
        with self._lock:
            self._events.append(ev)
            self._n_recorded += 1
            agg = self._spans.get(name)
            if agg is None:
                self._spans[name] = [1, dur]
            else:
                agg[0] += 1
                agg[1] += dur
            # automatic per-span-name duration histogram (seconds):
            # the scalar total says how much, the quantiles say whether
            # the tail is what the barriers wait on
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _new_hist()
            _hist_observe(h, dur / 1e9)
            if trace:
                # per-trace aggregate: survives ring eviction, merges
                # additively (absorb / merge_snapshots) — "how much
                # recorded work does trace T have" stays answerable
                # even after the events themselves age out
                tagg = self._traces.get(trace)
                if tagg is None:
                    self._traces[trace] = [1, dur]
                else:
                    tagg[0] += 1
                    tagg[1] += dur
            if dev is not None:
                # per-device aggregate: the snapshot's device_spans
                # section (chip occupancy + skew; time-sliced chips are
                # NOT symmetric, so per-device walls must be separable)
                per = self._dev_spans.setdefault(name, {})
                dagg = per.get(dev)
                if dagg is None:
                    per[dev] = [1, dur]
                else:
                    dagg[0] += 1
                    dagg[1] += dur

    def count(self, name: str, n: int = 1) -> None:
        if not self.recording:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def observe(self, name: str, value) -> None:
        """Record one value into a fixed-bucket histogram (the counter
        lock discipline: one branch when disabled, read-modify-write
        only under the mutex when recording)."""
        if not self.recording:
            return
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _new_hist()
            _hist_observe(h, value)

    def record_transfer(self, direction: str, nbytes: int, seconds: float,
                        device=None, pass_name: str | None = None) -> None:
        """Account one host<->device transfer (``direction`` is ``h2d``
        or ``d2h``): the run-total byte counter, the per-direction
        throughput histogram (bytes/second — only when the transfer
        took measurable wall, so instant memcpys don't pollute the link
        quantiles), and the per-(device, pass) attribution the
        snapshot's ``transfers`` section reports.  ``pass_name``
        defaults to the thread's active :class:`pass_scope`."""
        if not self.recording:
            return
        nbytes = int(nbytes)
        counter = C_H2D_BYTES if direction == "h2d" else C_D2H_BYTES
        hname = H_H2D_BPS if direction == "h2d" else H_D2H_BPS
        if pass_name is None:
            pass_name = current_pass() or PASS_OTHER
        dev = "default" if device is None else str(device)
        with self._lock:
            self._counters[counter] = self._counters.get(counter, 0) + nbytes
            if seconds > 1e-9 and nbytes:
                h = self._hists.get(hname)
                if h is None:
                    h = self._hists[hname] = _new_hist()
                _hist_observe(h, nbytes / seconds)
            per = self._xfer.setdefault(direction, {}).setdefault(dev, {})
            agg = per.get(pass_name)
            if agg is None:
                per[pass_name] = [1, nbytes, float(seconds)]
            else:
                agg[0] += 1
                agg[1] += nbytes
                agg[2] += float(seconds)

    def record_compile(self, kernel: str, shape, device, seconds: float,
                       in_window: bool) -> None:
        """Record one executable-cache MISS (a real trace+compile) in
        the compile ledger: the miss counter, the compile-duration
        histogram, and a (kernel, shape, device) entry — flagged
        ``in_window`` when it happened at a live dispatch site rather
        than under a prewarm scope (the cold compile then landed inside
        a timed window, the exact event the prewarm exists to prevent)."""
        if not self.recording:
            return
        entry = {
            "kernel": str(kernel),
            "shape": list(shape) if shape is not None else None,
            "device": "default" if device is None else str(device),
            "seconds": round(float(seconds), 6),
            "in_window": bool(in_window),
        }
        with self._lock:
            self._counters[C_COMPILE_MISSES] = (
                self._counters.get(C_COMPILE_MISSES, 0) + 1
            )
            if in_window:
                self._counters[C_COMPILE_IN_WINDOW] = (
                    self._counters.get(C_COMPILE_IN_WINDOW, 0) + 1
                )
            h = self._hists.get(H_COMPILE_SECONDS)
            if h is None:
                h = self._hists[H_COMPILE_SECONDS] = _new_hist()
            _hist_observe(h, seconds)
            if len(self._compiles) < _MAX_COMPILE_ENTRIES:
                self._compiles.append(entry)
            else:
                self._compiles_dropped += 1

    def record_hbm(self, device_key: str, bytes_in_use: int,
                   peak_bytes=None) -> None:
        """One HBM footprint sample for one device (the heartbeat tick
        feeds this from ``device.memory_stats()``).  ``peak`` keeps the
        max ever seen — the backend-reported peak when available, else
        the max sampled ``bytes_in_use``."""
        if not self.recording:
            return
        bytes_in_use = int(bytes_in_use)
        hi = int(peak_bytes) if peak_bytes is not None else bytes_in_use
        hi = max(hi, bytes_in_use)
        with self._lock:
            g = self._hbm.get(str(device_key))
            if g is None:
                self._hbm[str(device_key)] = {
                    "last": bytes_in_use, "peak": hi, "n": 1,
                }
            else:
                g["last"] = bytes_in_use
                if hi > g["peak"]:
                    g["peak"] = hi
                g["n"] += 1

    def record_quota(self, tenant: str, nbytes: int = 0,
                     compute_s: float = 0.0, budget_bytes=None,
                     budget_compute_s=None) -> None:
        """Account one quota charge against a tenant (serve/quota.py
        feeds this from the device ledger's h2d/d2h grant sizes and the
        per-pass compute attribution).  The snapshot's ``quota`` section
        carries the running per-tenant consumption — and the budgets,
        when the QuotaManager knows them — so ``adam-tpu analyze`` can
        render per-tenant consumption next to the batching fill."""
        if not self.recording:
            return
        with self._lock:
            q = self._quota.get(str(tenant))
            if q is None:
                q = self._quota[str(tenant)] = {
                    "charges": 0, "bytes": 0, "compute_s": 0.0,
                    "budget_bytes": None, "budget_compute_s": None,
                }
            q["charges"] += 1
            q["bytes"] += int(nbytes)
            q["compute_s"] += float(compute_s)
            if budget_bytes is not None:
                q["budget_bytes"] = int(budget_bytes)
            if budget_compute_s is not None:
                q["budget_compute_s"] = float(budget_compute_s)

    def record_health(self, device_key: str, state: str, score: float,
                      reason: str = "", transition: bool = True) -> None:
        """One device-health scoreboard update (utils/health.py feeds
        transitions and the run-end publish).  The ledger keeps the
        LAST state/score per device plus a transition count, so the
        snapshot's ``health`` section reads as "where every chip ended
        up and how often it moved".  ``transition=False`` records a
        state WITHOUT counting movement — the run-end ``publish`` of
        the board's current states, which must not inflate the count
        of transitions the run actually witnessed (a serve process
        publishes once per job)."""
        if not self.recording:
            return
        with self._lock:
            h = self._health.get(str(device_key))
            if h is None:
                # every device starts healthy, so a first LIVE record
                # that is not healthy is itself a transition; a publish
                # of a pre-existing state is not
                h = self._health[str(device_key)] = {
                    "state": state, "score": 0.0, "reason": "",
                    "transitions": (
                        1 if transition and state != "healthy" else 0
                    ),
                }
            else:
                if transition and h["state"] != state:
                    h["transitions"] += 1
                h["state"] = state
            h["score"] = round(float(score), 3)
            if reason:
                h["reason"] = str(reason)

    def gauge(self, name: str, value) -> None:
        if not self.recording:
            return
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                self._gauges[name] = {
                    "last": value, "min": value, "max": value, "n": 1,
                }
            else:
                g["last"] = value
                if value < g["min"]:
                    g["min"] = value
                if value > g["max"]:
                    g["max"] = value
                g["n"] += 1

    # ---- reading ----------------------------------------------------------
    def counters_and_gauges(self) -> tuple:
        """(counters, gauges) copies only — the heartbeat's per-beat
        accessor.  ``snapshot()`` computes histogram quantiles and
        copies every span/device aggregate; at subsecond beat intervals
        that is wasted O(names) work done under the recording mutex."""
        with self._lock:
            return (
                dict(self._counters),
                {k: dict(v) for k, v in self._gauges.items()},
            )

    def span_seconds(self) -> dict:
        """Per-name total span seconds (concurrency-safe copy)."""
        with self._lock:
            return {k: v[1] / 1e9 for k, v in self._spans.items()}

    def events(self) -> list:
        """Copy of the flight-recorder ring (oldest surviving first)."""
        with self._lock:
            return [dict(e) for e in self._events]

    def events_for_trace(self, trace_id: str) -> list:
        """The flight recorder filtered to one trace: events stamped
        with the id plus fused-dispatch events whose ``links`` name it
        (:func:`event_in_trace`) — the query the ``/jobs/<id>/trace``
        gateway surface and the incident recorder are built on."""
        with self._lock:
            return [
                dict(e) for e in self._events
                if event_in_trace(e, trace_id)
            ]

    def snapshot(self) -> dict:
        """Aggregate view (spans/counters/gauges), safe to call
        concurrently with recording.  Does NOT include the event ring —
        that is the Chrome-trace export's job."""
        with self._lock:
            return {
                "spans": {
                    k: {"count": v[0], "total_s": v[1] / 1e9}
                    for k, v in self._spans.items()
                },
                "device_spans": {
                    name: {
                        str(d): {"count": v[0], "total_s": v[1] / 1e9}
                        for d, v in per.items()
                    }
                    for name, per in self._dev_spans.items()
                },
                "counters": dict(self._counters),
                "gauges": {k: dict(v) for k, v in self._gauges.items()},
                "histograms": {
                    k: hist_summary(v) for k, v in self._hists.items()
                },
                "transfers": {
                    direction: {
                        dev: {
                            p: {
                                "count": v[0],
                                "bytes": v[1],
                                "seconds": round(v[2], 6),
                            }
                            for p, v in per.items()
                        }
                        for dev, per in by_dev.items()
                    }
                    for direction, by_dev in self._xfer.items()
                },
                "compiles": {
                    "entries": [dict(e) for e in self._compiles],
                    "dropped": self._compiles_dropped,
                },
                "hbm": {k: dict(v) for k, v in self._hbm.items()},
                "quota": {k: dict(v) for k, v in self._quota.items()},
                "health": {k: dict(v) for k, v in self._health.items()},
                "traces": {
                    k: {"events": v[0], "total_s": v[1] / 1e9}
                    for k, v in self._traces.items()
                },
                "events_recorded": self._n_recorded,
                "events_retained": len(self._events),
                "events_evicted": self._n_recorded - len(self._events),
            }

    # ---- lifecycle --------------------------------------------------------
    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._spans.clear()
            self._dev_spans.clear()
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._xfer.clear()
            self._compiles.clear()
            self._compiles_dropped = 0
            self._hbm.clear()
            self._quota.clear()
            self._health.clear()
            self._traces.clear()
            self._n_recorded = 0

    def reset_metrics(self) -> None:
        """Clear counters + gauges + histograms (and the device-ledger
        sections derived with them) only (TimerRegistry.reset delegates
        here so one reset clears the whole metrics surface)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._xfer.clear()
            self._compiles.clear()
            self._compiles_dropped = 0
            self._hbm.clear()
            self._quota.clear()
            self._health.clear()

    def absorb(self, other: "Tracer") -> None:
        """Merge another tracer's events + aggregates into this one
        (the streamed run tracer folds into the global TRACE)."""
        with other._lock:
            events = [dict(e) for e in other._events]
            spans = {k: list(v) for k, v in other._spans.items()}
            dev_spans = {
                k: {d: list(v) for d, v in per.items()}
                for k, per in other._dev_spans.items()
            }
            counters = dict(other._counters)
            gauges = {k: dict(v) for k, v in other._gauges.items()}
            hists = {
                k: {**v, "buckets": dict(v["buckets"])}
                for k, v in other._hists.items()
            }
            xfer = {
                d: {dev: {p: list(v) for p, v in per.items()}
                    for dev, per in by_dev.items()}
                for d, by_dev in other._xfer.items()
            }
            compiles = [dict(e) for e in other._compiles]
            compiles_dropped = other._compiles_dropped
            hbm = {k: dict(v) for k, v in other._hbm.items()}
            quota = {k: dict(v) for k, v in other._quota.items()}
            health = {k: dict(v) for k, v in other._health.items()}
            traces = {k: list(v) for k, v in other._traces.items()}
            n_rec = other._n_recorded
        with self._lock:
            self._events.extend(events)
            self._n_recorded += n_rec
            for k, (c, ns) in spans.items():
                agg = self._spans.get(k)
                if agg is None:
                    self._spans[k] = [c, ns]
                else:
                    agg[0] += c
                    agg[1] += ns
            for k, per in dev_spans.items():
                mine = self._dev_spans.setdefault(k, {})
                for d, (c, ns) in per.items():
                    dagg = mine.get(d)
                    if dagg is None:
                        mine[d] = [c, ns]
                    else:
                        dagg[0] += c
                        dagg[1] += ns
            for k, v in counters.items():
                self._counters[k] = self._counters.get(k, 0) + v
            for k, h in hists.items():
                mine = self._hists.get(k)
                if mine is None:
                    self._hists[k] = h
                else:
                    mine["count"] += h["count"]
                    mine["sum"] += h["sum"]
                    for bound, pick in (("min", min), ("max", max)):
                        v = h[bound]
                        if v is not None:
                            mine[bound] = (
                                v if mine[bound] is None
                                else pick(mine[bound], v)
                            )
                    for idx, n in h["buckets"].items():
                        mine["buckets"][idx] = (
                            mine["buckets"].get(idx, 0) + n
                        )
            for k, g in gauges.items():
                mine = self._gauges.get(k)
                if mine is None:
                    self._gauges[k] = dict(g)
                else:
                    mine["last"] = g["last"]
                    mine["min"] = min(mine["min"], g["min"])
                    mine["max"] = max(mine["max"], g["max"])
                    mine["n"] += g["n"]
            for d, by_dev in xfer.items():
                mdir = self._xfer.setdefault(d, {})
                for dev, per in by_dev.items():
                    mdev = mdir.setdefault(dev, {})
                    for p, (c, nb, s) in per.items():
                        agg = mdev.get(p)
                        if agg is None:
                            mdev[p] = [c, nb, s]
                        else:
                            agg[0] += c
                            agg[1] += nb
                            agg[2] += s
            room = _MAX_COMPILE_ENTRIES - len(self._compiles)
            self._compiles.extend(compiles[:room])
            self._compiles_dropped += (
                compiles_dropped + max(0, len(compiles) - room)
            )
            for k, g in hbm.items():
                mine = self._hbm.get(k)
                if mine is None:
                    self._hbm[k] = dict(g)
                else:
                    mine["last"] = g["last"]
                    mine["peak"] = max(mine["peak"], g["peak"])
                    mine["n"] += g["n"]
            for k, q in quota.items():
                mine = self._quota.get(k)
                if mine is None:
                    self._quota[k] = dict(q)
                else:
                    mine["charges"] += q["charges"]
                    mine["bytes"] += q["bytes"]
                    mine["compute_s"] += q["compute_s"]
                    for bk in ("budget_bytes", "budget_compute_s"):
                        if q.get(bk) is not None:
                            mine[bk] = q[bk]
            for k, hrow in health.items():
                mine = self._health.get(k)
                if mine is None:
                    self._health[k] = dict(hrow)
                else:
                    # the absorbed tracer's view is the newer one (run
                    # tracers fold into TRACE at run end): its last
                    # state wins, transition counts SUM and nothing
                    # else — every real transition was counted exactly
                    # once by whichever tracer witnessed it live, and
                    # run-end publishes carry transition=False, so a
                    # state difference here is a stale last-known
                    # state, not an uncounted movement
                    mine["transitions"] += hrow["transitions"]
                    mine["state"] = hrow["state"]
                    mine["score"] = hrow["score"]
                    if hrow.get("reason"):
                        mine["reason"] = hrow["reason"]
            for k, (c, ns) in traces.items():
                tagg = self._traces.get(k)
                if tagg is None:
                    self._traces[k] = [c, ns]
                else:
                    tagg[0] += c
                    tagg[1] += ns

    # ---- exports ----------------------------------------------------------
    def to_json(self, timers=None, include_events: bool = False) -> dict:
        """The ``--metrics-json`` document.  ``timers`` defaults to the
        process-wide :data:`~adam_tpu_torch.utils.instrumentation.TIMERS`;
        its section carries the same (count, total_s) rows as the
        printed ``-print_metrics`` table, so the two cannot drift.
        ``include_events=True`` appends the flight-recorder ring (the
        dump-on-error view)."""
        if timers is None:
            timers = _ins.TIMERS
        doc = self.snapshot()
        doc["timers"] = {
            name: {"count": c, "total_s": ns / 1e9}
            for name, (c, ns) in sorted(timers.snapshot().items())
        }
        doc["meta"] = {
            "pid": os.getpid(),
            "epoch_ns": _EPOCH_NS,
            "schema": "adam_tpu.telemetry/1",
        }
        if include_events:
            doc["events"] = self.events()
        return doc

    def to_chrome_trace(self, trace_id: str | None = None) -> dict:
        """Flight recorder -> Chrome trace-event JSON (Perfetto /
        chrome://tracing).  Each recording thread gets its own track, so
        the streamed tokenize/dispatch/fetch/encode/write overlap is
        visually inspectable.  Events carrying a ``device=<k>``
        attribution (the multi-chip pool's dispatch/fetch/prewarm spans)
        are additionally mirrored onto a ``device:<k>`` track — one
        track per chip, so per-device queue occupancy and skew are
        visible next to the host threads.

        ``trace_id`` filters the export to one job's trace (stamped
        events plus fused dispatches linking it — the
        ``GET /jobs/<id>/trace`` gateway view): same shape, fewer
        events, so anything that loads the full export loads the
        per-job one."""
        evs = (
            self.events() if trace_id is None
            else self.events_for_trace(trace_id)
        )
        pid = os.getpid()
        tids: dict = {}
        out = []

        def _tid(track: str) -> int:
            if track not in tids:
                tids[track] = len(tids) + 1
                out.append({
                    "ph": "M", "pid": pid, "tid": tids[track],
                    "name": "thread_name", "args": {"name": track},
                })
            return tids[track]

        for e in evs:
            _tid(e["thread"])
        for e in evs:
            ev = {
                "ph": "X",
                "pid": pid,
                "tid": tids[e["thread"]],
                "name": e["name"],
                "cat": "adam_tpu",
                "ts": (e["ts_ns"] - _EPOCH_NS) / 1e3,  # microseconds
                "dur": e["dur_ns"] / 1e3,
            }
            args = dict(e.get("args") or {})
            if "parent" in e:
                args["parent"] = e["parent"]
            if "trace" in e:
                args["trace"] = e["trace"]
            if args:
                ev["args"] = args
            out.append(ev)
            dev = (e.get("args") or {}).get("device")
            if dev is not None:
                mirror = dict(ev)
                mirror["tid"] = _tid(f"device:{dev}")
                # explicit mirror marker: the analyzer must count each
                # interval once, and two genuinely-concurrent same-name
                # spans can coincide to the microsecond — only this
                # marker distinguishes a mirror from a twin
                mirror["cat"] = CHROME_MIRROR_CAT
                out.append(mirror)
        # carry the histogram section alongside the events (viewers
        # ignore unknown top-level keys): explicit observe() metrics
        # (device.fetch.seconds, parquet.pool.submit_wait) are not
        # spans, so a trace alone could never reproduce their
        # quantiles — and the span-duration histograms here aggregate
        # PAST the ring's retention, unlike the events.  Ring occupancy
        # rides along too: a consumer attributing wall time from the
        # events (utils/analyzer.py) must know when the oldest events
        # were evicted, or truncation reads as fabricated idle time.
        with self._lock:
            hists = {k: hist_summary(v) for k, v in self._hists.items()}
            xfer = {
                d: {
                    dev: {
                        p: {"count": v[0], "bytes": v[1],
                            "seconds": round(v[2], 6)}
                        for p, v in per.items()
                    }
                    for dev, per in by_dev.items()
                }
                for d, by_dev in self._xfer.items()
            }
            compiles = {
                "entries": [dict(e) for e in self._compiles],
                "dropped": self._compiles_dropped,
            }
            hbm = {k: dict(v) for k, v in self._hbm.items()}
            quota = {k: dict(v) for k, v in self._quota.items()}
            health = {k: dict(v) for k, v in self._health.items()}
            trace_aggs = {
                k: {"events": v[0], "total_s": v[1] / 1e9}
                for k, v in self._traces.items()
                if trace_id is None or k == trace_id
            }
            counters = dict(self._counters)
            gauges = {k: dict(v) for k, v in self._gauges.items()}
            n_rec = self._n_recorded
            n_ret = len(self._events)
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "histograms": hists,
            # the device ledger rides along (viewers ignore unknown
            # top-level keys): transfers/compiles/HBM are aggregates,
            # not spans, so a trace alone could never reproduce them —
            # and the analyzer must render the same report sections
            # from either artifact kind.  Counters too: the tunnel byte
            # totals and compile hit/miss counts live there.
            "transfers": xfer,
            "compiles": compiles,
            "hbm": hbm,
            "quota": quota,
            "health": health,
            "counters": counters,
            # gauges ride along too: the analyzer labels the resolve
            # stage (device vs host sort) and the execution mode off
            # them, from either artifact kind
            "gauges": gauges,
            # per-trace aggregates (filtered when the export is):
            # a per-job export states how much recorded work its trace
            # has IN TOTAL, so a consumer can tell a complete export
            # from one whose events aged out of the ring
            "traces": trace_aggs,
            "events_recorded": n_rec,
            "events_evicted": n_rec - n_ret,
            # the monotonic_ns origin of every ``ts``: ties the spans to a
            # --xprof-dir trace (utils/analyzer.device_trace_report)
            "epoch_ns": _EPOCH_NS,
        }

    def dump_json(self, path: str, timers=None,
                  include_events: bool = False) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(timers, include_events=include_events),
                      fh, indent=1, default=str)

    def dump_chrome_trace(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_chrome_trace(), fh, default=str)

    def report(self) -> str:
        """Counters/gauges table printed below the timer table by
        ``-print_metrics``."""
        snap = self.snapshot()
        out = []
        if snap["counters"]:
            w = max(len(k) for k in snap["counters"])
            out += ["Counters", "========"]
            out.append(f"{'counter'.ljust(w)}  {'value':>14}")
            for k in sorted(snap["counters"]):
                out.append(f"{k.ljust(w)}  {snap['counters'][k]:>14}")
            out.append("")
        if snap["gauges"]:
            w = max(len(k) for k in snap["gauges"])
            out += ["Gauges", "======"]
            out.append(
                f"{'gauge'.ljust(w)}  {'last':>8}  {'min':>8}  {'max':>8}"
                f"  {'samples':>8}"
            )
            for k in sorted(snap["gauges"]):
                g = snap["gauges"][k]
                out.append(
                    f"{k.ljust(w)}  {g['last']:>8}  {g['min']:>8}"
                    f"  {g['max']:>8}  {g['n']:>8}"
                )
            out.append("")
        if snap.get("histograms"):
            w = max(len(k) for k in snap["histograms"])
            out += ["Histograms (seconds)", "===================="]
            out.append(
                f"{'histogram'.ljust(w)}  {'count':>8}  {'p50':>10}"
                f"  {'p90':>10}  {'p99':>10}  {'max':>10}"
            )

            def _f(v):
                return f"{v:.6f}" if v is not None else "-"

            for k in sorted(snap["histograms"]):
                h = snap["histograms"][k]
                out.append(
                    f"{k.ljust(w)}  {h['count']:>8}  {_f(h['p50']):>10}"
                    f"  {_f(h['p90']):>10}  {_f(h['p99']):>10}"
                    f"  {_f(h['max']):>10}"
                )
            out.append("")
        if not out:
            return "Counters/Gauges\n===============\n(none recorded)\n"
        return "\n".join(out)


#: Chrome-trace ``cat`` of the synthetic per-chip mirror copies
#: ``to_chrome_trace`` emits next to each device-attributed span's
#: host-thread event (utils/analyzer.py skips these when attributing).
CHROME_MIRROR_CAT = "adam_tpu.device-mirror"

#: Process-wide tracer — the ``object Timers`` analog for the
#: structured layer.  Off by default; the CLI flips it on for
#: ``-print_metrics`` / ``--metrics-json`` / ``--trace-out``.
TRACE = Tracer()


# --------------------------------------------------------------------------
# Derived views
# --------------------------------------------------------------------------
def streamed_stats_view(snap: dict) -> dict:
    """Rebuild the streamed pipeline's timing ``stats`` keys from span
    data (a :meth:`Tracer.snapshot`).  ``transform_streamed`` itself
    calls this on its run tracer — the stats dict IS this view, so the
    printed stats and the span data cannot disagree, and a test can
    recompute the view from an exported snapshot.
    """
    spans = snap.get("spans", {})

    def s(name):
        e = spans.get(name)
        return e["total_s"] if e else None

    out = {}
    for key, name in (
        ("prewarm_s", SPAN_POOL_PREWARM),
        ("ingest_pass_s", SPAN_PASS_A),  # prewarm subtracted below
        ("md_cols_fetch_s", SPAN_MD_FETCH),
        ("resolve_s", SPAN_RESOLVE),
        ("split_s", SPAN_SPLIT),
        ("observe_s", SPAN_OBSERVE),
        ("obs_merge_fetch_s", SPAN_OBS_MERGE),
        ("solve_s", SPAN_SOLVE),
        ("apply_device_dispatch_s", SPAN_APPLY_DISPATCH),
        ("apply_device_fetch_s", SPAN_APPLY_FETCH),
        ("write_wait_s", SPAN_WRITE_WAIT),
        ("total_s", SPAN_TOTAL),
    ):
        v = s(name)
        if v is not None:
            out[key] = v
    if "prewarm_s" in out and "ingest_pass_s" in out:
        # the prewarm umbrella is nested inside pass A (it fires on the
        # first ingested window): subtract it so the stage rows stay
        # disjoint and sum to the pipeline wall
        out["ingest_pass_s"] = max(
            0.0, out["ingest_pass_s"] - out["prewarm_s"]
        )
    # the pass-C re-warm (the solved table's real width) is nested
    # inside pass C: fold its wall into prewarm_s for the headline, and
    # remember it for the apply_split subtraction below — real compile
    # time must never masquerade as host encode/submit time
    prewarm_c = s(SPAN_POOL_PREWARM_C)
    if prewarm_c is not None:
        out["prewarm_s"] = out.get("prewarm_s", 0.0) + prewarm_c
    tail = s(SPAN_TAIL)
    if tail is not None:
        obs = s(SPAN_OBSERVE) or 0.0
        hidden = bool(
            snap.get("gauges", {}).get(G_OBSERVE_HIDDEN, {}).get("last", 0)
        )
        had_candidates = (
            snap.get("counters", {}).get(C_CANDIDATE_ROWS, 0) > 0
        )
        if had_candidates:
            # subtract the observe wall only when it genuinely ran
            # under the realign sweeps' device drain (streamed.py's
            # observe_overlap_hidden semantics)
            out["realign_s"] = tail - obs if hidden else tail
        else:
            out["realign_s"] = max(0.0, tail - obs)
    pass_c = s(SPAN_PASS_C)
    if pass_c is not None:
        # host share of pass C: the device dispatch/fetch walls (and
        # any pass-C re-warm compiles) are their own disjoint rows
        out["apply_split_s"] = max(
            0.0,
            pass_c
            - (s(SPAN_APPLY_DISPATCH) or 0.0)
            - (s(SPAN_APPLY_FETCH) or 0.0)
            - (prewarm_c or 0.0),
        )
    return out


#: The streamed run's top-level stage spans: one after another on the
#: run's own thread (the others nest inside them), so their totals add up
#: without overlap.
STREAMED_STAGE_SPANS = (
    SPAN_SETUP, SPAN_PASS_A, SPAN_RESOLVE, SPAN_SPLIT, SPAN_TAIL,
    SPAN_OBS_MERGE, SPAN_SOLVE, SPAN_PASS_C, SPAN_WRITE_WAIT, SPAN_FINISH,
)


def streamed_unattributed_s(snap: dict) -> float:
    """Seconds of ``streamed.total`` under none of
    :data:`STREAMED_STAGE_SPANS` (the stats line's ``unattributed_s``),
    from a streamed run's :meth:`Tracer.snapshot`: its span totals
    outlive the ring's eviction."""
    spans = snap["spans"]
    covered = sum(spans[n]["total_s"] for n in STREAMED_STAGE_SPANS if n in spans)
    return max(0.0, spans[SPAN_TOTAL]["total_s"] - covered)


def key_stable_snapshot(tr: Tracer | None = None) -> dict:
    """Snapshot with device-only counters/gauges ensured present (as
    zeros) — the bench's paired-CPU-baseline path uses this so
    round-over-round artifact diffs are key-stable."""
    snap = (tr or TRACE).snapshot()
    for name in sorted(DEVICE_ONLY_COUNTERS):
        snap["counters"].setdefault(name, 0)
    for name in sorted(DEVICE_ONLY_GAUGES):
        snap["gauges"].setdefault(
            name, {"last": 0, "min": 0, "max": 0, "n": 0}
        )
    snap.setdefault("device_spans", {})
    snap.setdefault("histograms", {})
    for name in sorted(DEVICE_ONLY_HISTOGRAMS):
        snap["histograms"].setdefault(name, hist_summary(_new_hist()))
    # device-ledger sections: empty-but-present on the CPU leg
    xfer = snap.setdefault("transfers", {})
    for direction in ("h2d", "d2h"):
        xfer.setdefault(direction, {})
    snap.setdefault("compiles", {"entries": [], "dropped": 0})
    snap.setdefault("hbm", {})
    snap.setdefault("quota", {})
    return snap


def merge_snapshots(snaps: list) -> dict:
    """Combine per-host snapshots (parallel/dist.gather_host_telemetry)
    into one report with per-host skew: for every span name, the
    min/max total wall across hosts — the Spark-listener per-executor
    skew view.  Histograms merge across hosts too (fixed global bucket
    edges make the merge a plain bucket sum, so host order is
    irrelevant) into combined p50/p90/p99 under ``histograms``.  The
    per-trace aggregates merge the same way (plain event/second sums
    per trace_id — a job whose windows executed on several hosts reads
    as one combined row), associatively, so gathering host snapshots
    in any grouping yields the same ``traces`` section.  The health
    and quota sections merge the same missing-side-tolerant way (a
    host that never tracked a device or admitted a tenant simply
    contributes nothing): health keeps per-device the WORST state
    across hosts (max transitions, min score — pessimism is the right
    default for a fleet view), quota sums per-tenant spend and keeps
    the first host's budgets (budgets are configuration, identical
    across hosts by construction).  Both keys are always present in
    the merged doc (empty dicts when no host carried the section), so
    consumers stay key-stable."""
    skew = {}
    hists: dict = {}
    traces: dict = {}
    health: dict = {}
    quota: dict = {}
    _HEALTH_RANK = {"healthy": 0, "suspect": 1, "probation": 2,
                    "evicted": 3}
    for snap in snaps:
        for name, e in snap.get("spans", {}).items():
            sk = skew.setdefault(
                name, {"min_s": e["total_s"], "max_s": e["total_s"]}
            )
            sk["min_s"] = min(sk["min_s"], e["total_s"])
            sk["max_s"] = max(sk["max_s"], e["total_s"])
        for name, h in snap.get("histograms", {}).items():
            hists[name] = merge_histograms(hists.get(name, {}), h)
        for tid, t in snap.get("traces", {}).items():
            agg = traces.setdefault(tid, {"events": 0, "total_s": 0.0})
            agg["events"] += t.get("events", 0)
            agg["total_s"] += t.get("total_s", 0.0)
        for dev, row in (snap.get("health") or {}).items():
            if not isinstance(row, dict):
                continue
            cur = health.get(dev)
            if cur is None:
                health[dev] = dict(row)
                continue
            if (_HEALTH_RANK.get(row.get("state"), 0)
                    > _HEALTH_RANK.get(cur.get("state"), 0)):
                cur["state"] = row.get("state")
                if row.get("reason"):
                    cur["reason"] = row["reason"]
            if isinstance(row.get("score"), (int, float)):
                cur["score"] = min(cur.get("score", row["score"]),
                                   row["score"])
            cur["transitions"] = (cur.get("transitions", 0)
                                  + row.get("transitions", 0))
        for tenant, row in (snap.get("quota") or {}).items():
            if not isinstance(row, dict):
                continue
            cur = quota.get(tenant)
            if cur is None:
                quota[tenant] = dict(row)
                continue
            for k in ("charges", "bytes", "compute_s"):
                cur[k] = (cur.get(k) or 0) + (row.get(k) or 0)
            for bk in ("budget_bytes", "budget_compute_s"):
                if cur.get(bk) is None and row.get(bk) is not None:
                    cur[bk] = row[bk]
    return {
        "n_hosts": len(snaps),
        "hosts": snaps,
        "span_skew": skew,
        "histograms": hists,
        "traces": traces,
        "health": health,
        "quota": quota,
    }


# --------------------------------------------------------------------------
# Live progress heartbeat
# --------------------------------------------------------------------------
#: NDJSON schema tag every heartbeat line carries.  /2 added the
#: device-ledger fields (tunnel bytes + HBM); /3 appended the
#: ``partitioner`` execution-mode field; /4 appended the cross-job
#: batching fields (``batch_fill`` + ``batched_jobs``); /5 appended
#: ``device_health`` (the per-device scoreboard states,
#: utils/health.py); /6 appended the trace/incident activity fields
#: (``active_traces``, ``metrics_scrapes``, ``last_incident``,
#: ``last_incident_age_s`` — utils/incidents.py); /7 appended the
#: judgment fields (``slo_worst_burn``, ``perf_regressions`` —
#: utils/slo.py + utils/perfledger.py) — each older version's fields
#: are a strict prefix of the next, so a consumer keying on field
#: NAMES keeps working; ``adam-tpu top`` accepts all seven.
HEARTBEAT_SCHEMA = "adam_tpu.heartbeat/7"

#: THE heartbeat line field set — a stable contract (documented in
#: docs/OBSERVABILITY.md, lint-enforced by scripts/check-telemetry-names):
#: every line carries exactly these keys, in this order, so a consumer
#: tailing the stream never needs per-line schema discovery.
HEARTBEAT_FIELDS = (
    "schema",
    "seq",
    "elapsed_s",
    "windows_ingested",
    "windows_total",
    "windows_resumed",
    "parts_written",
    "reads_ingested",
    "reads_per_s",
    "bytes_written",
    "h2d_bytes",
    "d2h_bytes",
    "hbm_bytes_in_use",
    "hbm_peak_bytes",
    "inflight",
    "inflight_per_device",
    "retries",
    "faults",
    "devices_evicted",
    "eta_s",
    "done",
    "ok",
    # /3: the streamed execution mode ("pool" | "mesh"; a mesh run that
    # degraded mid-flight flips to "pool" on its next beat) — appended
    # so the /2 fields stay a strict prefix
    "partitioner",
    # /4: cross-job window batching (serve/batching.py) — the running
    # grid fill rate (rows occupied / rows dispatched across every
    # fused dispatch so far; null when batching is off or nothing
    # coalesced yet) and the distinct-job count of the LAST fused
    # dispatch.
    "batch_fill",
    "batched_jobs",
    # /5: the device-health scoreboard's per-device states
    # ({device key: healthy|suspect|probation|evicted} from
    # utils/health.BOARD; null while no device has ever been tracked).
    "device_health",
    # /6: trace/incident activity (utils/incidents.py) — the count of
    # currently-active job traces, the count of gateway /metrics
    # scrapes served so far (a scraper-is-actually-reaching-us
    # signal for `adam-tpu top`), and the id + age of the newest
    # incident bundle recorded by THIS process (both null until one
    # fires).  Appended LAST so the /5 fields stay a strict prefix.
    "active_traces",
    "metrics_scrapes",
    "last_incident",
    "last_incident_age_s",
    # /7: the judgment layer (utils/slo.py + utils/perfledger.py) —
    # the worst short-window error-budget burn rate across armed SLO
    # objectives (null while no SLO engine is armed) and the running
    # count of perf keys the ledger sentinel flagged as regressed.
    # Appended LAST so the /6 fields stay a strict prefix.
    "slo_worst_burn",
    "perf_regressions",
)

def _health_states_for_heartbeat():
    """The /5 ``device_health`` field: the process-wide slot-health
    board's states, or None while it tracks nothing (a lazy import:
    ``utils/health.py`` imports this module)."""
    from adam_tpu_torch.utils import health as health_mod

    return health_mod.BOARD.states() or None


def _slo_for_heartbeat():
    """The /7 ``slo_worst_burn`` field: the armed SLO engine's worst
    short-window burn rate, or None while no engine is armed (a lazy
    import: ``utils/slo.py`` imports this module)."""
    try:
        from adam_tpu_torch.utils import slo as slo_mod

        burn = slo_mod.worst_burn()
        return round(burn, 3) if burn is not None else None
    except Exception:
        return None


def _incident_for_heartbeat():
    """The /6 ``last_incident`` + ``last_incident_age_s`` fields: the
    newest bundle this process recorded, as ``(id, age_s)``, both None
    until one fires (a lazy import: ``utils/incidents.py`` imports this
    module)."""
    try:
        from adam_tpu_torch.utils import incidents as incidents_mod

        last = incidents_mod.last_incident()
        if not last:
            return None, None
        age = time.monotonic() - last["ts_monotonic"]
        return last["id"], round(max(0.0, age), 1)
    except Exception:
        return None, None


_DEFAULT_HEARTBEAT_INTERVAL_S = 2.0

#: Default size cap on a file heartbeat sink before rotation (bytes).
_DEFAULT_PROGRESS_MAX_BYTES = 64 * 1024 * 1024


def progress_max_bytes() -> int:
    """Heartbeat sink rotation cap (``ADAM_TPU_PROGRESS_MAX_BYTES``,
    default 64 MiB, ``0`` disables): when the NDJSON file passes the
    cap it rotates to ``<path>.1`` and a fresh file continues — a
    multi-hour service-style run cannot grow the sink unboundedly.
    Malformed values degrade to the default (tuning-var contract)."""
    raw = os.environ.get("ADAM_TPU_PROGRESS_MAX_BYTES", "").strip()
    if not raw:
        return _DEFAULT_PROGRESS_MAX_BYTES
    try:
        v = int(raw)
    except ValueError:
        import logging

        logging.getLogger(__name__).warning(
            "ADAM_TPU_PROGRESS_MAX_BYTES=%r is not an int; using default "
            "%d", raw, _DEFAULT_PROGRESS_MAX_BYTES,
        )
        return _DEFAULT_PROGRESS_MAX_BYTES
    return max(0, v)


def sample_hbm(devices=None) -> dict:
    """Per-device memory footprint via ``torch.cuda.memory_stats(i)`` —
    ``{str(i): {"bytes_in_use": int, "peak_bytes_in_use": int}}``, keyed
    by the CUDA index as the ``device=<k>`` span attribution is.

    ``bytes_in_use`` is the caching allocator's live bytes
    (``allocated_bytes.all.current``) and ``peak_bytes_in_use`` its peak
    (``allocated_bytes.all.peak``): the JAX meaning, live tensors.  The
    bytes the allocator holds in reserve (``reserved_bytes``) are not
    reported.  ``devices`` is a list of CUDA indices or ``torch.device``
    objects (default: every visible card); CPU devices are skipped, and
    a process without a card yields ``{}``, so the heartbeat and the
    analyzer render their explicit "unsupported" marker instead of
    fabricating zeros."""
    import torch

    if not torch.cuda.is_available():
        return {}
    if devices is None:
        devices = range(torch.cuda.device_count())
    out = {}
    for d in devices:
        if isinstance(d, torch.device):
            if d.type != "cuda":
                continue
            d = d.index if d.index is not None else torch.cuda.current_device()
        ms = torch.cuda.memory_stats(d)
        # an allocator not used yet on this card reports no keys: 0 bytes
        cur = int(ms.get("allocated_bytes.all.current", 0))
        out[str(d)] = {
            "bytes_in_use": cur,
            "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", cur)),
        }
    return out


def progress_sink_from_env() -> str | None:
    """Resolve ``ADAM_TPU_PROGRESS`` into a heartbeat sink: ``None``
    (unset/``0`` — the default, zero-overhead path), ``"stderr"``
    (``1``/``stderr``/``-``), or a file path to append NDJSON lines to."""
    raw = os.environ.get("ADAM_TPU_PROGRESS", "").strip()
    if not raw or raw == "0":
        return None
    if raw in ("1", "stderr", "-"):
        return "stderr"
    return raw


def progress_interval_s() -> float:
    """Heartbeat sample period (``ADAM_TPU_PROGRESS_INTERVAL_S``,
    default 2 s; malformed or nonpositive values degrade to the default
    with a warning — a tuning-var typo must not kill a pipeline)."""
    raw = os.environ.get("ADAM_TPU_PROGRESS_INTERVAL_S", "").strip()
    if not raw:
        return _DEFAULT_HEARTBEAT_INTERVAL_S
    try:
        v = float(raw)
    except ValueError:
        v = -1.0
    if v <= 0:
        import logging

        logging.getLogger(__name__).warning(
            "ADAM_TPU_PROGRESS_INTERVAL_S=%r is not a positive number; "
            "using default %.1fs", raw, _DEFAULT_HEARTBEAT_INTERVAL_S,
        )
        return _DEFAULT_HEARTBEAT_INTERVAL_S
    return v


class Heartbeat:
    """Daemon-thread progress heartbeat: one NDJSON line per sample.

    Samples the given tracers (the streamed run tracer plus the global
    :data:`TRACE` — counters are summed across them, gauges read from
    the first tracer that carries each) every ``interval_s`` seconds
    and writes one :data:`HEARTBEAT_FIELDS`-shaped JSON line to the
    sink (``"stderr"`` or a file path).  Emits immediately on
    :meth:`start` (short runs still get a line) and a final
    ``done=true`` line on :meth:`stop` (idempotent, exception-safe).

    Off is the default everywhere: when no sink is configured the
    streamed pipeline constructs no Heartbeat at all — the disabled
    cost is one ``if`` per run, the same ~zero-overhead contract the
    spans keep.  A heartbeat failure (closed sink, provider bug) is
    swallowed: progress reporting must never kill the run it reports.
    """

    def __init__(self, tracers, sink: str = "stderr",
                 interval_s: float | None = None):
        self._tracers = list(tracers)
        self._sink = sink
        self._interval = (
            progress_interval_s() if interval_s is None else interval_s
        )
        self._fh = None
        self._owns_fh = False
        self._t0 = None
        self._seq = 0
        self._total = None
        self._parts_total = None
        self._provider = None
        # HBM sampling: the device set to poll memory_stats() on each
        # beat (None = every visible card); a backend that
        # yields no stats flips _hbm_supported off after the first beat
        # so an unsupported backend costs one probe, not one per tick
        self._devices = None
        self._hbm_supported = True
        self._max_bytes = progress_max_bytes()
        self._stop_ev = threading.Event()
        self._state_lock = threading.Lock()
        self._emit_lock = threading.Lock()
        self._closed = False
        self._ok = True
        self._started = False
        self._stopped = False
        self._thread = None

    # ---- producer-side knobs ------------------------------------------
    def set_total(self, n: int) -> None:
        """The ingested-window count (known at pass A's end).  Set
        once and never overwritten — ``windows_ingested / windows_total``
        must stay <= 1 for a progress consumer."""
        self._total = int(n)

    def set_parts_total(self, n: int) -> None:
        """The exact output-part count (known at pass C — residual
        windows drop, the realigned part joins): the ETA extrapolates
        ``parts_written`` against this, falling back to the window
        count until it is known."""
        self._parts_total = int(n)

    def set_provider(self, fn) -> None:
        """Register a callable returning extra field values (only keys
        in :data:`HEARTBEAT_FIELDS` are honored; the streamed pipeline
        supplies per-device in-flight depth this way)."""
        self._provider = fn

    def set_devices(self, devices) -> None:
        """The device set whose HBM footprint each beat samples
        (default: every visible card).  The streamed pipeline
        passes its pool's devices so the per-device keys match the
        ``device=<k>`` span attribution."""
        self._devices = list(devices)

    def _sample_hbm(self) -> dict:
        """One HBM poll (graceful {} when unsupported), recorded into
        the first tracer's ``hbm`` ledger so the run snapshot carries
        the per-window peaks a tailing consumer saw live."""
        if not self._hbm_supported:
            return {}
        try:
            stats = sample_hbm(self._devices)
        except Exception:
            stats = {}
        if not stats:
            self._hbm_supported = False
            return {}
        if self._tracers:
            tr = self._tracers[0]
            total = 0
            for key, s in stats.items():
                tr.record_hbm(key, s["bytes_in_use"],
                              s["peak_bytes_in_use"])
                total += s["bytes_in_use"]
            tr.gauge(G_HBM_IN_USE, total)
        return stats

    # ---- lifecycle -----------------------------------------------------
    def start(self) -> None:
        with self._state_lock:
            if self._started:
                return
            self._started = True
        self._t0 = time.monotonic()
        if self._sink != "stderr":
            try:
                # append, as documented: back-to-back runs pointed at
                # one log keep their history (runs delimit themselves —
                # seq restarts at 0 and the last line carries done=true).
                # Line-buffered: each line is one write()+implicit flush,
                # so a tailing consumer (`adam-tpu top`) never reads a
                # torn last line from the stdio buffer boundary.
                self._fh = open(self._sink, "a", buffering=1)
                self._owns_fh = True
            except OSError:
                import logging

                logging.getLogger(__name__).warning(
                    "cannot open progress sink %s; falling back to "
                    "stderr", self._sink, exc_info=True,
                )
                self._fh = None
        self._emit(done=False)
        self._thread = threading.Thread(
            target=self._loop, name="adam-tpu-heartbeat", daemon=True
        )
        self._thread.start()

    def stop(self, ok: bool = True) -> None:
        """Final ``done=true`` line + teardown.  ``ok=False`` marks the
        run as crashed on that line — without it a consumer tailing the
        stream would read an exception-path exit as a completed run."""
        if not ok:
            self._ok = False
        with self._state_lock:
            if not self._started or self._stopped:
                return
            self._stopped = True
        self._stop_ev.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._emit(done=True)
        if self._owns_fh and self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    def _loop(self) -> None:
        while not self._stop_ev.wait(self._interval):
            self._emit(done=False)

    def _maybe_rotate(self) -> None:
        """Size-capped rotation of a file sink (caller holds the emit
        lock, so no line can be torn across the rotation): past the
        ``ADAM_TPU_PROGRESS_MAX_BYTES`` cap the current file moves to
        ``<path>.1`` (replacing any previous rotation) and a fresh file
        continues — bounded disk for service-style multi-hour runs,
        and a tailing consumer sees a normal truncate-to-zero.

        Called BEFORE each write, never after: the newest line — in
        particular the final ``done=true`` line — must always be in
        the live file, or a tailer (``adam-tpu top``) could watch a
        fresh empty file forever while the line that ends its loop
        sits in the rotation."""
        if (
            not self._max_bytes or not self._owns_fh
            or self._fh is None
        ):
            return
        try:
            if self._fh.tell() < self._max_bytes:
                return
            self._fh.close()
            os.replace(self._sink, self._sink + ".1")
            self._fh = open(self._sink, "a", buffering=1)
        except OSError:
            # rotation is hygiene, not correctness: on failure keep
            # appending to whatever handle still works
            try:
                if self._fh is None or self._fh.closed:
                    self._fh = open(self._sink, "a", buffering=1)
            except OSError:
                self._fh = None

    # ---- sampling ------------------------------------------------------
    def sample(self, done: bool = False) -> dict:
        """One heartbeat line as a dict (exactly HEARTBEAT_FIELDS)."""
        counters: dict = {}
        gauges: dict = {}
        for tr in self._tracers:
            trc, trg = tr.counters_and_gauges()
            for k, v in trc.items():
                counters[k] = counters.get(k, 0) + v
            for k, v in trg.items():
                gauges.setdefault(k, v)
        elapsed = time.monotonic() - (self._t0 or time.monotonic())
        reads = counters.get(C_READS_INGESTED, 0)
        parts = counters.get(C_PARTS_WRITTEN, 0)
        total = self._total
        parts_total = (
            self._parts_total if self._parts_total is not None else total
        )
        eta = None
        if parts_total and parts:
            eta = round(elapsed * max(0, parts_total - parts) / parts, 1)
        hbm = self._sample_hbm()
        line = {
            "schema": HEARTBEAT_SCHEMA,
            "seq": self._seq,
            "elapsed_s": round(elapsed, 3),
            "windows_ingested": counters.get(C_WINDOWS_INGESTED, 0),
            "windows_total": total,
            # resumed-vs-fresh visibility: parts_written / eta_s already
            # count only THIS process's work (the skipped windows never
            # reach the writer pool), so this is the one field a
            # consumer needs to tell a resumed completion from a fresh
            # one
            "windows_resumed": counters.get(C_RESUME_WINDOWS_SKIPPED, 0),
            "parts_written": parts,
            "reads_ingested": reads,
            "reads_per_s": (
                round(reads / elapsed, 1) if elapsed > 0 else 0.0
            ),
            "bytes_written": counters.get(C_BYTES_WRITTEN, 0),
            # tunnel byte accounting (the transfer ledger's run totals)
            "h2d_bytes": counters.get(C_H2D_BYTES, 0),
            "d2h_bytes": counters.get(C_D2H_BYTES, 0),
            # HBM footprint per device ({} + null on backends without
            # memory_stats — an explicit "unsupported" marker, never
            # fabricated zeros)
            "hbm_bytes_in_use": {
                k: v["bytes_in_use"] for k, v in hbm.items()
            },
            "hbm_peak_bytes": (
                max(v["peak_bytes_in_use"] for v in hbm.values())
                if hbm else None
            ),
            "inflight": gauges.get(G_DEVICE_INFLIGHT, {}).get("last", 0),
            "inflight_per_device": {},
            "retries": counters.get(C_RETRY_ATTEMPTS, 0),
            "faults": counters.get(C_FAULT_INJECTED, 0),
            "devices_evicted": counters.get(C_DEVICE_EVICTED, 0),
            "eta_s": eta,
            "done": done,
            "ok": self._ok,
            # overridden by the streamed provider with the live mode
            # ("pool" | "mesh"); None = the producer predates /3 fields
            "partitioner": None,
            # cross-job batching (/4): derived from the coalescer's
            # counters whenever the sampled tracers carry them (the
            # service-wide heartbeat samples the global TRACE, which
            # the coalescer records on); null otherwise
            "batch_fill": (
                round(
                    counters[C_BATCH_ROWS_OCCUPIED]
                    / counters[C_BATCH_ROWS_DISPATCHED], 4,
                )
                if counters.get(C_BATCH_ROWS_DISPATCHED) else None
            ),
            "batched_jobs": gauges.get(G_BATCH_JOBS, {}).get("last"),
            "device_health": _health_states_for_heartbeat(),
        }
        # trace/incident activity (/6): live registry + the newest
        # bundle recorded by this process (both process-wide, like the
        # health scoreboard)
        inc_id, inc_age = _incident_for_heartbeat()
        line["active_traces"] = len(active_traces())
        line["metrics_scrapes"] = counters.get(C_GW_SCRAPES, 0)
        line["last_incident"] = inc_id
        line["last_incident_age_s"] = inc_age
        # judgment layer (/7): worst burn across armed SLO objectives
        # (process-wide, like the incident recorder) + flagged perf
        # regressions
        line["slo_worst_burn"] = _slo_for_heartbeat()
        line["perf_regressions"] = counters.get(C_PERF_REGRESSIONS, 0)
        if self._provider is not None:
            try:
                for k, v in (self._provider() or {}).items():
                    if k in HEARTBEAT_FIELDS:
                        line[k] = v
            except Exception:  # provider bugs must not kill the beat
                pass
        return line

    def _emit(self, done: bool) -> None:
        # one writer at a time: without the lock, a daemon thread
        # stalled inside fh.write past stop()'s join timeout could race
        # the final done=true line — duplicate seq values, a periodic
        # line AFTER the final one, or a write to the closed handle.
        # Bounded acquire so a wedged sink makes stop() drop its final
        # line instead of hanging the pipeline on exit.
        if not self._emit_lock.acquire(timeout=5.0):
            return
        try:
            if self._closed:
                return
            if done:
                self._closed = True
            self._maybe_rotate()
            line = self.sample(done)
            self._seq += 1
            fh = self._fh if self._fh is not None else sys.stderr
            fh.write(json.dumps(line, default=str) + "\n")
            fh.flush()
        except Exception:
            # a torn sink (closed stderr under pytest, full disk) must
            # never take the pipeline down with it
            pass
        finally:
            self._emit_lock.release()
