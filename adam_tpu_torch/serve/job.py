"""Job model for the multi-job transform service (``adam_tpu/serve``).

One :class:`JobSpec` describes one streamed transform the scheduler can
run, quarantine, drain and resume; it is deliberately a JSON-roundtrip
value object (``to_doc``/``from_doc``) because whole-process crash
recovery re-reads the spec from the job directory's durably written
``JOB.json`` — everything the pipeline needs to reproduce the run
bit-identically must survive the process (the RunJournal fingerprint
then re-validates that nothing changed underneath).

Admission returns **typed results**, never queues unboundedly:
:class:`Admitted` carries the slotted job's id, :class:`Busy` carries a
human-readable reason (at capacity / draining / duplicate) plus the
machine-readable ``kind`` — the front-end decides whether to back off
and retry, exactly like a load-shedding RPC server.

The port's copy of ``adam_tpu/serve/job.py`` (stdlib and numpy code, no JAX): the
wire formats, schemas and file layouts are JAX's, byte for byte.
"""

from __future__ import annotations

import re
from dataclasses import asdict, dataclass, field
from typing import Optional

#: Job lifecycle states (persisted verbatim in ``JOB.json``).
PENDING = "pending"
RUNNING = "running"
DONE = "done"
QUARANTINED = "quarantined"
INTERRUPTED = "interrupted"

#: States a crash-recovery scan resumes (``quarantined`` is sticky:
#: auto-resuming a poison job on every service restart would turn one
#: bad input into a crash loop for the whole pool — the operator
#: resubmits explicitly once the cause is fixed).
RESUMABLE_STATES = frozenset({PENDING, RUNNING, INTERRUPTED})

#: Terminal states (the job holds no slot, no lane and no lease).
TERMINAL_STATES = frozenset({DONE, QUARANTINED, INTERRUPTED})

_JOB_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


@dataclass
class JobSpec:
    """One streamed-transform job (the flag subset the streamed
    pipeline supports; known-sites inputs are PATHS so the spec stays a
    JSON value — the job thread loads the tables, and the journal
    fingerprint covers their content)."""

    job_id: str
    input: str
    output: str
    tenant: str = "default"
    #: the tenant's fair share — window grants interleave proportionally
    #: to it across concurrently running tenants (serve/fairness.py)
    weight: float = 1.0
    mark_duplicates: bool = True
    recalibrate: bool = True
    realign: bool = True
    known_snps: Optional[str] = None
    known_indels: Optional[str] = None
    window_reads: int = 262_144
    compression: str = "zstd"
    partitioner: Optional[str] = None
    #: job-scoped trace context (docs/OBSERVABILITY.md "Trace
    #: context"): minted at gateway submission (or by the scheduler
    #: for direct submits), echoed to the client, and — because the
    #: spec round-trips through JOB.json — stable across SIGKILL/
    #: recovery replay, so a job's trace stays ONE trace however many
    #: attempts it took
    trace_id: Optional[str] = None

    def validate(self) -> None:
        if not _JOB_ID_RE.match(self.job_id or ""):
            raise ValueError(
                f"job_id {self.job_id!r} must match {_JOB_ID_RE.pattern} "
                "(it names the job's run directory)"
            )
        if not self.input or not self.output:
            raise ValueError(
                f"job {self.job_id!r} needs both input and output paths"
            )
        if self.weight <= 0:
            raise ValueError(
                f"job {self.job_id!r} weight must be > 0 "
                f"(got {self.weight})"
            )
        if self.window_reads < 1:
            raise ValueError(
                f"job {self.job_id!r} window_reads must be >= 1 "
                f"(got {self.window_reads})"
            )

    def to_doc(self) -> dict:
        return asdict(self)

    @classmethod
    def from_doc(cls, doc: dict) -> "JobSpec":
        known = {f for f in cls.__dataclass_fields__}
        spec = cls(**{k: v for k, v in doc.items() if k in known})
        spec.validate()
        return spec


@dataclass(frozen=True)
class Admitted:
    """Typed admission success: the job holds a slot and is running."""

    job_id: str


@dataclass(frozen=True)
class Busy:
    """Typed admission rejection — the bounded-slots contract: a full
    or draining scheduler REFUSES instead of queueing unboundedly.
    ``kind`` is one of ``capacity`` / ``draining`` / ``duplicate`` /
    ``quota`` (the tenant spent its rolling-window byte/compute
    budget, serve/quota.py — the gateway's 429 quota leg).
    ``retry_after_s``, when set, is a budget-derived hint that
    OVERRIDES the gateway's grant-cadence Retry-After: quota frees on
    the rolling window's schedule, not at job-slot turnover speed."""

    reason: str
    kind: str = "capacity"
    retry_after_s: Optional[int] = None


@dataclass
class JobRecord:
    """Scheduler-side live state for one admitted job (the persisted
    subset mirrors into ``JOB.json`` after every transition)."""

    spec: JobSpec
    state: str = PENDING
    attempts: int = 0
    error: Optional[str] = None
    #: True when this record was rebuilt by the crash-recovery scan —
    #: its first run attempt resumes from the journal instead of
    #: starting fresh
    recovered: bool = False
    #: True once the job's runner thread has fully unwound (terminal
    #: state durably persisted, lease released, lane deregistered) —
    #: ``JobScheduler.wait`` blocks on THIS, not on the state alone, so
    #: a drain that returns guarantees every JOB.json is fsync'd
    settled: bool = False
    stats: Optional[dict] = field(default=None, repr=False)
