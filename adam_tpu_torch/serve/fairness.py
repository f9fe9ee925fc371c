"""Per-tenant weighted window interleaving (``adam_tpu/serve``).

The streamed pipeline calls its ``pacer`` hook once per window at the
pass-A and pass-C boundaries; when N jobs share one device pool, those
calls all land here and the interleaver decides whose window goes next.
The discipline is classic **virtual-time weighted fair queuing** over
*tenants* (not jobs): each tenant owns a virtual clock that advances by
``1 / weight`` per granted window, and the waiting tenant with the
smallest clock wins — so a tenant with weight 2 streams two windows for
every one a weight-1 tenant streams, whenever both are actually
waiting, and two jobs of one tenant share that tenant's allocation
instead of doubling it.

Work-conserving by construction: a tenant that is busy computing (not
blocked in :meth:`turn`) never stalls anyone, and its clock catches up
to the global virtual time when it returns, so an idle spell earns no
burst of back-to-back grants.  A solo job is granted immediately every
time — pacing a one-job pool costs one lock acquisition per window.

The interleaver is also the graceful-drain trigger: :meth:`cancel`
makes every blocked (and future) :meth:`turn` raise
:class:`~adam_tpu_torch.pipelines.streamed.RunCancelled`, which the streamed
pipeline honors at the window boundary — in-flight parts publish, the
journal stays resumable (docs/ROBUSTNESS.md).

Each turn of a registered lane, from entry to grant, is one
``sched.pace.wait`` span on ``TRACE`` (recording on only).

The port's copy of ``adam_tpu/serve/fairness.py``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from adam_tpu_torch.pipelines.streamed import RunCancelled
from adam_tpu_torch.utils import faults
from adam_tpu_torch.utils import telemetry as tele

#: Recheck period for blocked turns: grants notify the condition, so
#: this only bounds recovery from a theoretical missed wakeup.
_WAIT_S = 0.1


class _Tenant:
    __slots__ = ("weight", "vt")

    def __init__(self, weight: float, vt: float):
        self.weight = weight
        self.vt = vt


class _Lane:
    __slots__ = ("job", "tenant", "cancelled", "waiting_seq")

    def __init__(self, job: str, tenant: str):
        self.job = job
        self.tenant = tenant
        self.cancelled = False
        self.waiting_seq: Optional[int] = None


class WeightedInterleaver:
    """Thread-safe tenant-weighted window interleaver (module doc)."""

    #: Grant-history ring depth (the fairness audit window; a
    #: service-lifetime list would grow one entry per window forever).
    HISTORY = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._tenants: dict[str, _Tenant] = {}
        self._lanes: dict[str, _Lane] = {}
        self._grants: deque = deque(maxlen=self.HISTORY)
        self._vtime = 0.0
        self._arrivals = 0
        self._cancel_all = False

    # ---- lane lifecycle (scheduler-side) -------------------------------
    def register(self, job: str, tenant: str = "default",
                 weight: float = 1.0) -> None:
        """Add a job lane under its tenant's clock.  The tenant's clock
        catches up to the global virtual time, so joining late earns no
        retroactive share."""
        with self._lock:
            t = self._tenants.get(tenant)
            if t is None:
                self._tenants[tenant] = _Tenant(
                    max(weight, 1e-9), self._vtime
                )
            else:
                t.weight = max(weight, 1e-9)
                t.vt = max(t.vt, self._vtime)
            self._lanes[job] = _Lane(job, tenant)
            self._cond.notify_all()

    def deregister(self, job: str) -> None:
        """Drop a job lane (idempotent); the tenant's clock survives so
        a follow-up job of the same tenant keeps its fair position."""
        with self._lock:
            lane = self._lanes.pop(job, None)
            if lane is not None and not any(
                ln.tenant == lane.tenant for ln in self._lanes.values()
            ):
                # last lane of the tenant: drop the clock — a future
                # re-register catches up to the global time anyway
                self._tenants.pop(lane.tenant, None)
            self._cond.notify_all()

    def cancel(self, job: Optional[str] = None) -> None:
        """Make ``turn`` raise ``RunCancelled`` for one job (or, with
        ``None``, for every job — the graceful-drain trigger).  Blocked
        turns wake immediately."""
        with self._lock:
            if job is None:
                self._cancel_all = True
            else:
                lane = self._lanes.get(job)
                if lane is not None:
                    lane.cancelled = True
            self._cond.notify_all()

    def cancelled(self, job: str) -> bool:
        """Whether ``turn`` would raise for this job right now (drain
        or per-job cancel) — the quota throttle's stop probe, so a
        deferral never outlives the drain that should interrupt it."""
        with self._lock:
            if self._cancel_all:
                return True
            lane = self._lanes.get(job)
            return lane is not None and lane.cancelled

    def grant_history(self) -> list:
        """Recent grants as job ids, oldest first (bounded ring)."""
        with self._lock:
            return [job for job, _, _ in self._grants]

    def grant_times(self, last: Optional[int] = None) -> list:
        """Monotonic timestamps of recent grants, oldest first (the
        newest ``last`` when given).  The gateway derives its
        ``Retry-After`` hint from the inter-grant cadence here: when
        windows are flowing at one grant every t seconds, "come back
        after a batch of windows has drained" is the honest estimate
        of when a slot could free (docs/SERVING.md back-pressure)."""
        with self._lock:
            times = [t for _, t, _ in self._grants]
        return times if last is None else times[-last:]

    def grant_records(self, last: Optional[int] = None) -> list:
        """Recent grants as ``(monotonic time, size)`` pairs, oldest
        first.  ``size`` is the granted window's byte payload (the
        streamed pipeline passes it through the pacer seam; 0 when the
        caller predates sizes) — the quota leg's Retry-After derives
        from bytes-per-grant here instead of grant cadence alone
        (serve/quota.rate_retry_hint)."""
        with self._lock:
            recs = [(t, s) for _, t, s in self._grants]
        return recs if last is None else recs[-last:]

    def tenant_clock(self, tenant: str) -> Optional[float]:
        """The tenant's WFQ virtual clock (None when unknown) — the
        cross-job coalescer orders the row blocks of a fused dispatch
        by it, so the most underserved tenant's windows lead the grid
        exactly as they would have led the solo grant order."""
        with self._lock:
            t = self._tenants.get(tenant)
            return t.vt if t is not None else None

    # ---- the pacing hot path -------------------------------------------
    def pacer(self, job: str):
        """The per-job ``pacer(phase, index, size)`` hook the scheduler
        hands to ``transform_streamed`` — one fault point + one turn
        per window boundary.  ``size`` is the window's byte payload
        (0 from callers that predate sizes); it lands in the grant
        ring so the quota leg can reason in bytes-per-grant."""

        def pace(phase: str, index: int, size: int = 0,
                 _job=job) -> None:
            faults.point("sched.dispatch", device=_job)
            self.turn(_job, size=size)

        return pace

    def _next_waiter_locked(self) -> Optional[_Lane]:
        """The lane to grant next: smallest (clock, tenant-name) among
        tenants with a waiter; FIFO within the tenant.  Caller holds
        the lock."""
        best_lane = None
        best_key = None
        for lane in self._lanes.values():
            if lane.waiting_seq is None:
                continue
            t = self._tenants[lane.tenant]
            key = (t.vt, lane.tenant, lane.waiting_seq)
            if best_key is None or key < best_key:
                best_key = key
                best_lane = lane
        return best_lane

    def turn(self, job: str, size: int = 0) -> None:
        """Block until this job's tenant is granted the next window.

        Unregistered jobs free-run (a pacer outliving its lane must not
        deadlock teardown).  Raises ``RunCancelled`` once the job — or
        the whole pool — is cancelled.  ``size`` (bytes this grant
        covers) is recorded in the grant ring beside the timestamp."""
        t0_ns = time.monotonic_ns()
        with self._lock:
            lane = self._lanes.get(job)
            if lane is None:
                return
            t = self._tenants[lane.tenant]
            # idle catch-up: a tenant that computed for a while resumes
            # at the current virtual time, never with a grant burst
            t.vt = max(t.vt, self._vtime)
            self._arrivals += 1
            lane.waiting_seq = self._arrivals
            try:
                while True:
                    if self._cancel_all or lane.cancelled:
                        raise RunCancelled(
                            f"job {job} cancelled by the scheduler "
                            "(drain or quarantine)"
                        )
                    if self._next_waiter_locked() is lane:
                        self._vtime = t.vt
                        t.vt += 1.0 / t.weight
                        self._grants.append(
                            (job, time.monotonic(), int(size))
                        )
                        self._cond.notify_all()
                        break
                    self._cond.wait(_WAIT_S)
            finally:
                lane.waiting_seq = None
        tele.TRACE.add_span(tele.SPAN_PACE_WAIT, t0_ns,
                            time.monotonic_ns() - t0_ns, job=job,
                            tenant=lane.tenant)
