"""Fault-isolated multi-job scheduler for the streamed transform — the
port's counterpart of ``adam_tpu/serve/scheduler.py``.

The jobs run on ``device`` (default ``cuda``, which raises without a
card; ``cpu`` runs the plain versions).  With one card there is no
shared pool, as in JAX: each job keeps the single-device path on the
card.  A pool of the caller's (``device_pool=``, e.g. two slots of one
card, ``parallel/device_pool.DevicePool``) is shared by the jobs through
one ``PoolLease`` each.

The ROADMAP's "always-on transform service" jump: one process, one
shared :class:`~adam_tpu_torch.parallel.device_pool.DevicePool`, N concurrent
streamed jobs — each an ordinary ``transform_streamed`` run wearing
three service-grade harnesses (docs/ROBUSTNESS.md "Fault-isolated
multi-job scheduling"):

* **Admission control** — ``max_jobs`` bounded slots; a full or
  draining scheduler returns a typed :class:`~adam_tpu_torch.serve.job.Busy`
  instead of queueing unboundedly.  Admitted jobs interleave their
  windows on the shared pool under per-tenant weighted fair queuing
  (serve/fairness.py).
* **Fault isolation / quarantine** — a job whose run keeps failing is
  resumed from its own :class:`~adam_tpu_torch.pipelines.checkpoint.RunJournal`
  up to ``job_retries`` times (``ADAM_TPU_SCHED_JOB_RETRIES``), then
  **quarantined**: its lease returns to the pool, its journal stays
  resumable for an operator, and the surviving jobs never notice —
  device eviction triggered by one job replays only that job's
  in-flight windows (the pool's recovery paths are already per-job).
* **Graceful drain** — :meth:`request_drain` stops admissions and
  cancels every lane; each job stops at its next window boundary with
  in-flight parts published and journaled
  (:class:`~adam_tpu_torch.pipelines.streamed.RunCancelled` semantics), so a
  SIGTERM'd service exits 0 with every journal durable.
* **Whole-process crash recovery** — :meth:`recover` scans the run-root
  for durably written ``JOB.json`` records and resumes every
  non-terminal job from its journal, bit-identically, under the journal's
  fingerprint/refusal rules (a changed input refuses and restarts
  clean; a quarantined job stays quarantined — auto-resuming poison
  would crash-loop the pool).

Every job runs in its own thread with its own run tracer and its own
``adam_tpu.heartbeat/7`` stream at ``<run-root>/<job>/heartbeat.ndjson``
(``adam-tpu top <run-root>`` aggregates them).  The ``sched.*`` fault
points (``sched.admit`` / ``sched.dispatch`` / ``sched.drain`` /
``sched.job_crash``, job id in the ``device`` selector slot) extend the
fault matrix to the scheduler itself.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional, Union

from adam_tpu_torch.parallel import device_pool as dp_mod
from adam_tpu_torch.pipelines import streamed as streamed_mod
from adam_tpu_torch.pipelines.checkpoint import RunJournal
from adam_tpu_torch.serve.fairness import WeightedInterleaver
from adam_tpu_torch.serve.job import (
    DONE,
    INTERRUPTED,
    PENDING,
    QUARANTINED,
    RESUMABLE_STATES,
    RUNNING,
    Admitted,
    Busy,
    JobRecord,
    JobSpec,
)
from adam_tpu_torch.utils import faults
from adam_tpu_torch.utils import incidents
from adam_tpu_torch.utils import slo as slo_mod
from adam_tpu_torch.utils import retry as retry_mod
from adam_tpu_torch.utils import telemetry as tele
from adam_tpu_torch.utils.durability import atomic_write_json
from adam_tpu_torch.utils.retry import _env_int

log = logging.getLogger(__name__)

JOB_FILE = "JOB.json"
JOB_SCHEMA = "adam_tpu.serve_job/1"
RUN_DIR_NAME = "run"
HEARTBEAT_NAME = "heartbeat.ndjson"


def default_job_retries() -> int:
    """Quarantine policy bound: how many RESUMES a failing job gets
    before quarantine (``ADAM_TPU_SCHED_JOB_RETRIES``, default 1 — two
    attempts total; the typo-degrades-to-default tuning-var rule)."""
    return _env_int("ADAM_TPU_SCHED_JOB_RETRIES", 1)


class JobScheduler:
    """In-process async scheduler: N streamed jobs on one device pool.

    ``run_root`` is the service's durable state root — one
    subdirectory per job (``JOB.json`` + ``run/`` journal +
    ``heartbeat.ndjson``).  ``devices``/``partitioner`` configure the
    shared pool exactly like the CLI flags configure a solo run; jobs
    may pin their own ``partitioner`` in the spec.
    """

    def __init__(self, run_root: str, *, max_jobs: int = 2,
                 devices: Optional[int] = None,
                 partitioner: Optional[str] = None,
                 job_retries: Optional[int] = None,
                 batching: Optional[bool] = None,
                 batch_wait_ms: Optional[float] = None,
                 quota=None,
                 slo=None,
                 device_pool=None,
                 device="cuda"):
        from adam_tpu_torch.device import resolve_device
        from adam_tpu_torch.serve.batching import batching_enabled
        from adam_tpu_torch.serve.quota import QuotaManager, quota_from_env
        from adam_tpu_torch.utils import perfledger

        self.device = resolve_device(device)
        self._device_pool = device_pool
        self.run_root = os.path.abspath(run_root)
        os.makedirs(self.run_root, exist_ok=True)
        # arm the incident recorder on the service's durable root:
        # anomaly triggers anywhere in this process (health transition,
        # hedge, SDC mismatch, retry exhaustion, quota 429 burst) drop
        # bundles under <run-root>/incidents/ (utils/incidents.py)
        incidents.install(self.run_root)
        self.max_jobs = max(1, max_jobs)
        self.devices = devices
        self.partitioner = partitioner
        self.job_retries = (
            job_retries if job_retries is not None
            else default_job_retries()
        )
        # cross-job window batching (serve/batching.py; `--batch` /
        # ADAM_TPU_BATCH, default off): the coalescer itself is built
        # lazily with the shared pool on the first job start
        self.batching = (
            batching_enabled() if batching is None else bool(batching)
        )
        self._batch_wait_ms = batch_wait_ms
        self._coalescer = None
        # per-tenant quota enforcement (serve/quota.py; `--quota` /
        # ADAM_TPU_QUOTA, default none): accepts a ready QuotaManager,
        # a grammar string, or None (then the environment decides)
        if quota is None:
            self._quota = quota_from_env()
        elif isinstance(quota, str):
            self._quota = QuotaManager(quota) if quota.strip() else None
        else:
            self._quota = quota
        # declarative SLOs (utils/slo.py; `--slo` / ADAM_TPU_SLO,
        # default none): accepts a ready SLOEngine, a grammar string,
        # or None (then the environment decides).  The engine arms
        # module-wide with its budget file under the service root, so
        # restarts resume the error budget; the perf ledger arms on
        # the same root so every completed job books its perf keys
        # there (utils/perfledger.py).
        if slo is None:
            slo = slo_mod.slo_from_env()
        self._slo = slo_mod.install(slo, self.run_root) \
            if slo is not None else None
        perfledger.install(self.run_root)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # serializes JOB.json rewrites: a submit/recover thread and the
        # job's own state transitions may persist the same record
        # concurrently, and atomic_write_json's staging name is fixed
        # per target path
        self._persist_lock = threading.Lock()
        self._jobs: dict[str, JobRecord] = {}
        self._threads: dict[str, threading.Thread] = {}
        self._interleaver = WeightedInterleaver()
        self._draining = False
        self._closed = False
        self._pool = None
        self._pool_built = False
        # service-wide heartbeat (<run-root>/heartbeat.ndjson): samples
        # the global TRACE — tunnel bytes, retry/fault counters, HBM —
        # the pool-totals row `adam-tpu top <run-root>` renders next to
        # the per-job (job-scoped) streams
        self._service_hb = None
        # the service is an observability-on system: per-job heartbeats
        # sample the global TRACE for pool-wide counters, and concurrent
        # jobs must never flip/reset it per-run (the solo pipeline's
        # heartbeat restore semantics assume one run per process)
        self._restore_recording = tele.TRACE.recording
        tele.TRACE.recording = True
        # drain-aware retry backoff: every retry sleep in this process
        # waits on this event, so a SIGTERM drain never stalls up to
        # ADAM_TPU_RETRY_MAX_BACKOFF_S per in-flight retry — the
        # sleeping retry wakes and runs its remaining attempts with a
        # small bounded pause (failure semantics untouched: a mid-drain
        # transient still absorbs), and the job stops at its window
        # boundary under the normal drain contract
        self._drain_ev = threading.Event()
        retry_mod.set_cancel_event(self._drain_ev)

    # ---- paths ---------------------------------------------------------
    def job_dir(self, job_id: str) -> str:
        return os.path.join(self.run_root, job_id)

    def job_run_dir(self, job_id: str) -> str:
        return os.path.join(self.job_dir(job_id), RUN_DIR_NAME)

    def heartbeat_path(self, job_id: str) -> str:
        return os.path.join(self.job_dir(job_id), HEARTBEAT_NAME)

    # ---- durable job records -------------------------------------------
    def _persist(self, rec: JobRecord) -> None:
        """Durably rewrite the job's ``JOB.json`` (fsync'd atomic
        publish — the crash-recovery scan trusts these bytes)."""
        with self._lock:
            doc = {
                "schema": JOB_SCHEMA,
                "spec": rec.spec.to_doc(),
                "state": rec.state,
                "attempts": rec.attempts,
                "error": rec.error,
            }
        with self._persist_lock:
            atomic_write_json(
                os.path.join(self.job_dir(rec.spec.job_id), JOB_FILE),
                doc,
            )

    @staticmethod
    def _read_job_doc(path: str) -> Optional[dict]:
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError) as e:
            log.warning("job record %s is unreadable (%s); skipping",
                        path, e)
            return None
        if not isinstance(doc, dict) or doc.get("schema") != JOB_SCHEMA:
            log.warning("job record %s has schema %r (want %r); skipping",
                        path, doc.get("schema") if isinstance(doc, dict)
                        else type(doc).__name__, JOB_SCHEMA)
            return None
        return doc

    # ---- admission -----------------------------------------------------
    def _active_count_locked(self) -> int:
        return sum(
            1 for r in self._jobs.values()
            if r.state in (PENDING, RUNNING)
        )

    def _unsettled_count_locked(self) -> int:
        """Jobs whose runner thread has not fully unwound (durable
        terminal persist included) — what :meth:`wait` blocks on."""
        return sum(1 for r in self._jobs.values() if not r.settled)

    def submit(self, spec: JobSpec,
               recovered: bool = False) -> Union[Admitted, Busy]:
        """Admit one job, or refuse with a typed :class:`Busy`.

        Never blocks and never queues: a ``Busy`` caller owns the
        retry policy (the CLI front-end polls as slots free).
        ``recovered`` marks a crash-recovery resubmission — it bypasses
        the capacity bound (the slots were already granted by the
        process that died) and resumes from the journal."""
        faults.point("sched.admit", device=spec.job_id)
        spec.validate()
        with self._lock:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if self._draining:
                tele.TRACE.count(tele.C_SCHED_REJECTED)
                return Busy(
                    "scheduler is draining; not accepting jobs",
                    kind="draining",
                )
            prior = self._jobs.get(spec.job_id)
            if prior is not None and (
                prior.state in (PENDING, RUNNING) or not prior.settled
            ):
                # `not settled` closes a narrow race: a terminal record
                # whose runner thread has not finished unwinding could
                # otherwise have its OLD thread's finally deregister
                # the resubmission's fresh fairness lane
                tele.TRACE.count(tele.C_SCHED_REJECTED)
                return Busy(
                    f"job {spec.job_id!r} is already {prior.state}",
                    kind="duplicate",
                )
            # per-tenant quota gate (serve/quota.py): an over-budget
            # tenant's FRESH submissions are refused with the typed
            # quota leg + a budget-derived Retry-After before they can
            # take a slot — other tenants are untouched.  Deliberately
            # AFTER the duplicate check (an idempotent re-PUT of a live
            # job must keep answering duplicate, never 429) and skipped
            # for resubmissions of a known job (prior is not None:
            # resuming an interrupted/quarantined journal) and for
            # crash recovery — that spend already happened, and
            # refusing the resume would strand a journal.
            if (
                self._quota is not None and not recovered
                and prior is None
            ):
                exceeded = self._quota.check(spec.tenant)
                if exceeded is not None:
                    from adam_tpu_torch.serve.quota import rate_retry_hint

                    hint = exceeded.retry_after_s
                    if exceeded.resource == "bytes":
                        # bytes-per-grant refinement: the fairness
                        # ring's sized grants estimate how fast the
                        # service actually burns bytes — the larger
                        # (more honest) of the two hints wins
                        rh = rate_retry_hint(
                            exceeded.used - exceeded.budget,
                            self._interleaver.grant_records(64),
                        )
                        if rh is not None:
                            hint = max(hint, rh)
                    tele.TRACE.count(tele.C_SCHED_REJECTED)
                    tele.TRACE.count(tele.C_QUOTA_REJECTED)
                    # burst detection: N quota 429s inside the rolling
                    # window fire one "quota.burst" incident bundle
                    # (cooldown-limited, so at most one bundle write
                    # ever lands under this admission lock)
                    incidents.note_quota_rejected(spec.tenant)
                    return Busy(
                        exceeded.reason, kind="quota",
                        retry_after_s=hint,
                    )
            if not recovered and self._active_count_locked() >= self.max_jobs:
                tele.TRACE.count(tele.C_SCHED_REJECTED)
                return Busy(
                    f"at capacity ({self.max_jobs} job slot(s) in use); "
                    "retry when a slot frees",
                    kind="capacity",
                )
            if spec.trace_id is None:
                # direct (non-gateway) submission: mint the job's trace
                # here so every admitted job carries one; a recovered
                # spec keeps the id JOB.json round-tripped (one job =
                # one trace across SIGKILL/recovery attempts)
                spec.trace_id = tele.mint_trace_id()
            rec = JobRecord(spec, state=PENDING, recovered=recovered)
            if prior is not None:
                # re-admission of a terminal job resumes its journal
                rec.recovered = recovered or prior.state in (
                    INTERRUPTED, QUARANTINED,
                )
                rec.attempts = 0
            self._jobs[spec.job_id] = rec
        os.makedirs(self.job_dir(spec.job_id), exist_ok=True)
        self._persist(rec)
        self._interleaver.register(
            spec.job_id, tenant=spec.tenant, weight=spec.weight
        )
        self._ensure_service_heartbeat()
        t = threading.Thread(
            target=self._run_job, args=(rec,),
            name=f"adam-tpu-job:{spec.job_id}", daemon=True,
        )
        with self._lock:
            self._threads[spec.job_id] = t
        t.start()
        tele.TRACE.count(
            tele.C_SCHED_RECOVERED if recovered else tele.C_SCHED_ADMITTED
        )
        self._gauge_active()
        return Admitted(spec.job_id)

    def _gauge_active(self) -> None:
        with self._lock:
            n = self._active_count_locked()
        tele.TRACE.gauge(tele.G_SCHED_ACTIVE, n)

    def _ensure_service_heartbeat(self) -> None:
        with self._lock:
            if self._service_hb is not None:
                return
            hb = tele.Heartbeat(
                [tele.TRACE],
                os.path.join(self.run_root, HEARTBEAT_NAME),
            )
            self._service_hb = hb
        hb.start()

    # ---- the shared pool -----------------------------------------------
    def _get_pool(self):
        """The shared pool: the caller's ``device_pool``, else one built
        once over the attached cards (None with one card: the jobs then
        keep the single-device path)."""
        with self._lock:
            if self._pool_built:
                return self._pool
            self._pool_built = True
        pool = None
        try:
            pool = (self._device_pool if self._device_pool is not None
                    else dp_mod.make_pool(self.devices, self.device))
        except Exception as e:
            log.warning("shared device pool unavailable (%s); jobs run "
                        "on the single-device path", e)
        with self._lock:
            self._pool = pool
        return pool

    def _ensure_coalescer(self):
        """Build the shared cross-job coalescer once (with the shared
        pool, the WFQ interleaver and the quota manager attached).
        None once the scheduler is closed — a job thread racing
        ``close()`` must never rebuild a fresh coalescer whose
        dispatcher thread nothing would ever stop."""
        from adam_tpu_torch.serve.batching import WindowCoalescer

        with self._lock:
            if self._closed:
                return None
            if self._coalescer is not None:
                return self._coalescer
        pool = self._get_pool()
        with self._lock:
            if self._closed:
                return None
            if self._coalescer is None:
                self._coalescer = WindowCoalescer(
                    pool=pool, wait_ms=self._batch_wait_ms,
                    interleaver=self._interleaver, quota=self._quota,
                    device=self.device,
                )
            return self._coalescer

    def _job_coalesces(self, spec: JobSpec) -> bool:
        """True when this job's dispatches can reach the coalescer: a
        non-mesh effective execution mode, resolved as the pipeline
        resolves it (spec override, scheduler default, then the
        ``ADAM_TPU_*`` environment), so an env-pinned mesh job never sits
        in the eligible set as a silent member."""
        try:
            from adam_tpu_torch.parallel.partitioner import (
                resolve_execution_mode,
            )

            return resolve_execution_mode(
                spec.partitioner if spec.partitioner
                else self.partitioner
            ) != "mesh"
        except Exception:
            # a malformed backend/partitioner env surfaces from the
            # job's own run with proper attribution; here it just
            # means "don't register"
            return False

    def _job_pacer(self, spec: JobSpec):
        """The job's pacer: the mid-run quota throttle, then the WFQ
        turn, then the quota byte charge — every grant's window payload
        size lands on the tenant's rolling-window budget (the
        device-ledger-shaped byte leg; the coalescer charges the
        compute leg per fused dispatch).  The throttle DEFERS an
        over-budget tenant's grant (bounded sleeps until enough spend
        ages out of the rolling window, ``sched.quota.deferred``)
        instead of letting a long admitted job stream past its budget
        until the next admission-time 429; a drain or per-job cancel
        interrupts the deferral immediately and the turn that follows
        raises ``RunCancelled`` as usual."""
        from adam_tpu_torch.serve.quota import throttle_enabled

        inner = self._interleaver.pacer(spec.job_id)
        quota = self._quota
        if quota is None:
            return inner
        tenant = spec.tenant
        job_id = spec.job_id
        throttling = throttle_enabled()

        def _stop_deferral() -> bool:
            return (
                self.draining or self._interleaver.cancelled(job_id)
            )

        def pace(phase: str, index: int, size: int = 0) -> None:
            if throttling:
                quota.throttle(tenant, should_stop=_stop_deferral)
            inner(phase, index, size)
            if size:
                quota.charge(tenant, nbytes=size)

        return pace

    # ---- the job runner -------------------------------------------------
    def _set_state(self, rec: JobRecord, state: str,
                   error: Optional[str] = None) -> None:
        with self._lock:
            rec.state = state
            if error is not None:
                rec.error = error
            self._cond.notify_all()
        self._persist(rec)

    def _run_job(self, rec: JobRecord) -> None:
        spec = rec.spec
        resume = rec.recovered
        lease = None
        coal = None
        coal_client = None
        try:
            self._set_state(rec, RUNNING)
            pool = self._get_pool()
            if pool is not None:
                lease = pool.lease(job=spec.job_id)
            if self.batching and self._job_coalesces(spec):
                # cross-job batching: register this job with the shared
                # coalescer and hand its bound client to the pipeline.
                # Jobs that can never submit tickets (mesh execution
                # mode — the mesh already fuses the device set per
                # window — or a non-device backend) are skipped
                # outright: a registered-but-silent member would force
                # every other job's group to wait out the full batching
                # delay instead of flushing early.
                coal = self._ensure_coalescer()
                if coal is not None:
                    coal_client = coal.client(
                        spec.job_id, spec.tenant, trace=spec.trace_id,
                    )
            known_snps = known_indels = None
            t0 = time.monotonic()
            while True:
                try:
                    faults.point("sched.job_crash", device=spec.job_id)
                    if (spec.known_snps or spec.known_indels) and \
                            known_snps is None and known_indels is None:
                        known_snps, known_indels = _load_known_sites(spec)
                    with tele.TRACE.span(
                        tele.SPAN_SCHED_JOB, job=spec.job_id,
                        tenant=spec.tenant, trace=spec.trace_id,
                    ):
                        stats = streamed_mod.transform_streamed(
                            spec.input, spec.output,
                            mark_duplicates=spec.mark_duplicates,
                            recalibrate=spec.recalibrate,
                            realign=spec.realign,
                            known_snps=known_snps,
                            known_indels=known_indels,
                            window_reads=spec.window_reads,
                            compression=spec.compression,
                            devices=self.devices,
                            partitioner=(
                                spec.partitioner if spec.partitioner
                                else self.partitioner
                            ),
                            progress=self.heartbeat_path(spec.job_id),
                            run_dir=self.job_run_dir(spec.job_id),
                            resume=resume,
                            pacer=self._job_pacer(spec),
                            device_pool=lease,
                            coalescer=coal_client,
                            trace=spec.trace_id,
                            device=str(self.device),
                        )
                    with self._lock:
                        rec.stats = stats
                    self._set_state(rec, DONE, error="")
                    # SLO observation: one completed job against the
                    # armed objectives (no-op when --slo is off).
                    # Interrupted jobs are excluded — a drain is an
                    # operator action, not a service failure.
                    slo_mod.observe_job(
                        spec.tenant, time.monotonic() - t0, ok=True,
                        trace_id=spec.trace_id,
                    )
                    log.info("job %s done (%s reads, %s windows)",
                             spec.job_id, stats.get("n_reads"),
                             stats.get("windows_fresh"))
                    return
                except streamed_mod.RunCancelled:
                    # graceful drain: in-flight parts published, the
                    # journal is durable and resumable — NOT a failure
                    tele.TRACE.count(tele.C_SCHED_INTERRUPTED)
                    self._set_state(rec, INTERRUPTED)
                    log.info(
                        "job %s interrupted at a window boundary "
                        "(drain); its journal resumes it", spec.job_id,
                    )
                    return
                except Exception as e:
                    with self._lock:
                        rec.attempts += 1
                        attempts = rec.attempts
                        rec.error = f"{type(e).__name__}: {e}"
                    resume = True
                    if attempts > self.job_retries:
                        # QUARANTINE: the job stops consuming slots and
                        # devices; journal + JOB.json stay on disk for
                        # an operator resubmission.  Survivor jobs keep
                        # streaming — nothing here touches them.
                        tele.TRACE.count(tele.C_SCHED_QUARANTINED)
                        self._set_state(rec, QUARANTINED)
                        # a quarantined job is an availability bad
                        # event against the armed objectives
                        slo_mod.observe_job(
                            spec.tenant, time.monotonic() - t0,
                            ok=False, trace_id=spec.trace_id,
                        )
                        log.error(
                            "job %s QUARANTINED after %d failed "
                            "attempt(s) (last: %s); its journal stays "
                            "resumable, survivors are unaffected",
                            spec.job_id, attempts, rec.error,
                        )
                        return
                    self._persist(rec)
                    log.warning(
                        "job %s attempt %d failed (%s); resuming from "
                        "its journal (%d retr%s left)",
                        spec.job_id, attempts, rec.error,
                        self.job_retries - attempts + 1,
                        "y" if self.job_retries - attempts + 1 == 1
                        else "ies",
                    )
        finally:
            if lease is not None:
                lease.release()
            if coal is not None:
                # drop out of the coalesce-eligible set FIRST: groups
                # waiting for this job's windows flush immediately
                coal.deregister(spec.job_id)
            self._interleaver.deregister(spec.job_id)
            self._gauge_active()
            with self._lock:
                # LAST: the terminal state is already durably persisted
                # above, so a waiter unblocked by this flag can trust
                # what a crash-recovery scan would read
                rec.settled = True
                self._cond.notify_all()

    # ---- drain / wait / lifecycle --------------------------------------
    def request_drain(self) -> None:
        """Stop admissions and cancel every lane; jobs stop at their
        next window boundary with parts published and journals durable
        (idempotent, non-blocking — pair with :meth:`wait`)."""
        with self._lock:
            already = self._draining
            self._draining = True
        if already:
            return
        faults.point("sched.drain")
        log.info("drain requested: admissions closed, %d job(s) will "
                 "stop at their next window boundary",
                 len(self.active_jobs()))
        # wake every backoff-sleeping retry NOW: a drain must not wait
        # out exponential backoffs (utils/retry.set_cancel_event)
        self._drain_ev.set()
        self._interleaver.cancel()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain to completion: :meth:`request_drain` + wait
        for every job to reach a terminal state.  True when fully
        drained within ``timeout``."""
        self.request_drain()
        return self.wait(timeout)

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def active_jobs(self) -> list:
        with self._lock:
            return [
                r.spec.job_id for r in self._jobs.values()
                if r.state in (PENDING, RUNNING)
            ]

    def cancel(self, job_id: str) -> bool:
        """Cancel one running/pending job at its next window boundary
        (the single-job twin of :meth:`request_drain`): its pacer turn
        raises ``RunCancelled``, in-flight parts publish, the journal
        stays durable and resumable, and the job lands ``interrupted``
        — a re-submission resumes it.  False when the job is unknown
        or already terminal (nothing to cancel)."""
        with self._lock:
            rec = self._jobs.get(job_id)
            active = rec is not None and rec.state in (PENDING, RUNNING)
        if not active:
            return False
        self._interleaver.cancel(job_id)
        return True

    def grant_times(self, last: Optional[int] = None) -> list:
        """The fairness interleaver's recent grant timestamps (the
        gateway's Retry-After signal; serve/fairness.py)."""
        return self._interleaver.grant_times(last)

    def grant_records(self, last: Optional[int] = None) -> list:
        """Recent ``(time, size)`` grant records — the bytes-per-grant
        view the quota leg's Retry-After derives from."""
        return self._interleaver.grant_records(last)

    @property
    def quota(self):
        """The per-tenant QuotaManager (None when quotas are off)."""
        return self._quota

    def has_capacity(self) -> bool:
        """True when a submission would not be refused for capacity or
        draining — the polite client's pre-check, so a capacity poll
        loop doesn't inflate ``sched.jobs.rejected`` (and the
        ``sched.admit`` fault point's arrival count) with one refusal
        per poll tick."""
        with self._lock:
            return (
                not self._draining and not self._closed
                and self._active_count_locked() < self.max_jobs
            )

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until no job is pending/running (True) or ``timeout``
        elapses (False)."""
        deadline = (
            time.monotonic() + timeout if timeout is not None else None
        )
        with self._lock:
            while self._unsettled_count_locked():
                remaining = (
                    deadline - time.monotonic()
                    if deadline is not None else 0.2
                )
                if deadline is not None and remaining <= 0:
                    return False
                self._cond.wait(min(0.2, max(remaining, 0.01)))
            return True

    def close(self) -> None:
        """Release process-wide hooks (restores the TRACE recording
        flag the constructor flipped, stops the service heartbeat).
        Jobs must be terminal."""
        with self._lock:
            self._closed = True
            hb = self._service_hb
            self._service_hb = None
            coal = self._coalescer
            self._coalescer = None
        if coal is not None:
            coal.stop()
        if hb is not None:
            hb.stop()
        # release the process-wide retry-cancel registration, but only
        # if it is still ours (a newer scheduler may have re-registered)
        retry_mod.clear_cancel_event(self._drain_ev)
        tele.TRACE.recording = self._restore_recording
        # disarm the incident recorder, but only if it is still armed
        # on OUR run-root (a newer scheduler may have re-armed it)
        if incidents.incidents_dir() == os.path.join(
                self.run_root, incidents.INCIDENTS_DIRNAME):
            incidents.uninstall()
        # same for the SLO engine and the perf ledger (both armed on
        # our run-root by the constructor)
        from adam_tpu_torch.utils import perfledger

        if self._slo is not None and slo_mod.engine() is self._slo:
            slo_mod.uninstall()
        if perfledger.ledger_root() == self.run_root:
            perfledger.uninstall()

    # ---- whole-process crash recovery ----------------------------------
    def recover(self) -> list:
        """Scan the run-root and resume every incomplete job.

        Each subdirectory with a readable ``JOB.json`` in a resumable
        state (pending/running/interrupted — i.e. the previous process
        died or drained mid-job) is resubmitted with ``resume`` against
        its own journal; the journal's fingerprint rules guarantee the
        continuation is bit-identical or refused-and-restarted.  Done
        and quarantined jobs are re-registered for status visibility
        but not re-run.  Returns the resumed job ids."""
        resumed = []
        try:
            entries = sorted(os.listdir(self.run_root))
        except OSError as e:
            log.warning("cannot scan run root %s: %s", self.run_root, e)
            return resumed
        for name in entries:
            job_path = os.path.join(self.run_root, name, JOB_FILE)
            if not os.path.isfile(job_path):
                continue
            doc = self._read_job_doc(job_path)
            if doc is None:
                continue
            try:
                spec = JobSpec.from_doc(doc.get("spec") or {})
            except (TypeError, ValueError) as e:
                log.warning("job record %s has a malformed spec (%s); "
                            "skipping", job_path, e)
                continue
            state = doc.get("state")
            with self._lock:
                known = spec.job_id in self._jobs
            if known:
                continue
            if state not in RESUMABLE_STATES:
                # terminal: visible in status(), never re-run here
                rec = JobRecord(
                    spec, state=state if state else QUARANTINED,
                    attempts=int(doc.get("attempts") or 0),
                    error=doc.get("error"), settled=True,
                )
                with self._lock:
                    self._jobs[spec.job_id] = rec
                continue
            peek = RunJournal.peek(self.job_run_dir(spec.job_id))
            log.info(
                "recovering job %s (was %s%s)", spec.job_id, state,
                f", {peek['completed']} window(s) durable" if peek
                else ", no journal yet",
            )
            got = self.submit(spec, recovered=True)
            if isinstance(got, Admitted):
                resumed.append(spec.job_id)
            else:
                log.warning("recovery of job %s refused: %s",
                            spec.job_id, got.reason)
        return resumed

    # ---- status ---------------------------------------------------------
    def status(self) -> dict:
        """Point-in-time service view: per-job state + journal
        progress, pool lease occupancy, drain flag."""
        with self._lock:
            jobs = {
                jid: {
                    "state": r.state,
                    "tenant": r.spec.tenant,
                    "weight": r.spec.weight,
                    "attempts": r.attempts,
                    "error": r.error,
                    # the full spec rides along: the gateway's
                    # idempotent-PUT comparison and its part-fetch
                    # routes (spec["output"] is the part directory)
                    # both read it from here
                    "spec": r.spec.to_doc(),
                }
                for jid, r in self._jobs.items()
            }
            draining = self._draining
            pool = self._pool
        for jid, view in jobs.items():
            peek = RunJournal.peek(self.job_run_dir(jid))
            view["windows_durable"] = peek["completed"] if peek else 0
            view["n_windows"] = peek["n_windows"] if peek else None
        return {
            "run_root": self.run_root,
            "max_jobs": self.max_jobs,
            "draining": draining,
            "batching": self.batching,
            "quota": (
                self._quota.status() if self._quota is not None else None
            ),
            "slo": (
                self._slo.evaluate() if self._slo is not None else None
            ),
            "active_leases": (
                [lz.job for lz in pool.active_leases()]
                if pool is not None else []
            ),
            "jobs": jobs,
        }


def _load_known_sites(spec: JobSpec) -> tuple:
    """Load the spec's known-SNP/indel VCFs against the input's
    sequence dictionary (the actions.py plumbing, job-scoped)."""
    from adam_tpu_torch.api.datasets import GenotypeDataset
    from adam_tpu_torch.io import context

    contig_names = context.load_header(spec.input).seq_dict.names
    known = indels = None
    if spec.known_snps:
        known = GenotypeDataset.load(
            spec.known_snps, contig_names=contig_names
        ).snp_table()
    if spec.known_indels:
        indels = GenotypeDataset.load(
            spec.known_indels, contig_names=contig_names
        ).indel_table()
    return known, indels
