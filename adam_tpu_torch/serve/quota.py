"""Per-tenant quota enforcement for the multi-job transform service
(docs/SERVING.md "Continuous batching & quotas").

The device ledger (``utils/telemetry.py``) already attributes every h2d/d2h byte and every
compile second; this module turns that accounting into an *admission*
contract: each tenant owns a rolling-window budget of device-link
bytes and compute seconds, consumption is charged from the fairness
interleaver's grant sizes (serve/fairness.py records bytes-per-grant)
and the cross-job coalescer's per-dispatch attribution
(serve/batching.py), and a submission from an over-budget tenant is
refused with a typed ``Busy(kind="quota")`` carrying a
**budget-derived** Retry-After — the gateway's 429 quota leg, distinct
from the capacity leg (which signals "slots full", not "you spent your
share").

Grammar (``--quota`` / ``ADAM_TPU_QUOTA``)::

    tenantA:bytes=512M,compute=10s;tenantB:bytes=2G;*:bytes=1G

``bytes`` is the rolling-window device-byte budget (h2d + d2h charged
to the tenant; suffixes K/M/G/T are binary), ``compute`` the
device-compute-seconds budget (optional ``s`` suffix).  ``*`` names
the default budget for tenants without their own clause; tenants with
neither clause are unlimited.  The window is
``ADAM_TPU_QUOTA_WINDOW_S`` (default 60 s): charges age out of the
budget exactly ``window_s`` after they were incurred, so a refused
tenant is admissible again once enough of its recent spend expires —
which is precisely what its Retry-After advertises.  Malformed clauses
warn and are ignored (the tuning-var contract every ``ADAM_TPU_*``
knob keeps): a quota typo must never take down admission for everyone.

Enforcement has two rungs.  **Admission** refuses fresh submissions
from an over-budget tenant (the 429 leg above).  **Mid-run
throttling** (:meth:`QuotaManager.throttle`, on by default with
``ADAM_TPU_QUOTA_THROTTLE``; ``ADAM_TPU_QUOTA_MAX_DEFER_S`` bounds a
single deferral) smooths the edge for long jobs: when a tenant goes
over budget mid-run, its next window grants DEFER at the pacer seam —
short bounded sleeps until enough spend ages out of the rolling
window — instead of streaming at full rate until the next admission
check.  Deferred grants count ``sched.quota.deferred``; a drain (or
job cancel) interrupts a deferral immediately, and a job is never
killed mid-flight for quota (killing a paid-for run wastes the spend
that triggered the kill).  Other tenants' throughput is untouched —
the WFQ interleaver still owns intra-run fairness.

The port's copy of ``adam_tpu/serve/quota.py``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

from adam_tpu_torch.utils import telemetry as tele

log = logging.getLogger(__name__)

#: Default rolling budget window (seconds) — ``ADAM_TPU_QUOTA_WINDOW_S``.
DEFAULT_WINDOW_S = 60.0

#: Retry-After bounds for the quota leg (seconds).  Wider than the
#: capacity leg's [1, 30]: a spent byte budget frees on the quota
#: window's schedule, not at job-slot turnover speed.
QUOTA_RETRY_MIN_S = 1
QUOTA_RETRY_MAX_S = 3600

#: Mid-run throttle poll step (seconds): short enough that a drain or
#: an expiring charge is honored promptly, long enough not to spin.
THROTTLE_POLL_S = 0.05


def throttle_enabled() -> bool:
    """``ADAM_TPU_QUOTA_THROTTLE`` (default on): whether over-budget
    tenants get pacer-level grant deferral mid-run."""
    from adam_tpu_torch.utils.retry import env_toggle

    return env_toggle("ADAM_TPU_QUOTA_THROTTLE", True)


def max_defer_s() -> float:
    """``ADAM_TPU_QUOTA_MAX_DEFER_S``: the bound on ONE grant's
    deferral; 0/unset means "derive from the rolling window" (the
    window plus a poll's slack — by then every charge that was in the
    window when the deferral began has aged out, so a longer wait can
    never be needed)."""
    from adam_tpu_torch.utils.retry import env_float

    v = env_float("ADAM_TPU_QUOTA_MAX_DEFER_S", 0.0)
    return v if v > 0 else 0.0

_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_size(text: str) -> int:
    """``512M`` -> bytes (binary suffixes K/M/G/T, bare ints pass)."""
    t = text.strip().lower()
    mult = 1
    if t and t[-1] in _SUFFIX:
        mult = _SUFFIX[t[-1]]
        t = t[:-1]
    return int(float(t) * mult)


def quota_window_s() -> float:
    """The rolling budget window (``ADAM_TPU_QUOTA_WINDOW_S``; a
    malformed or nonpositive value warns and keeps the default —
    ``utils/retry.env_float``, the shared tuning-var parser)."""
    from adam_tpu_torch.utils.retry import env_float

    v = env_float("ADAM_TPU_QUOTA_WINDOW_S", DEFAULT_WINDOW_S)
    if v <= 0:
        log.warning(
            "ADAM_TPU_QUOTA_WINDOW_S=%s is not positive; using default "
            "%.0fs", v, DEFAULT_WINDOW_S,
        )
        return DEFAULT_WINDOW_S
    return v


@dataclass(frozen=True)
class Budget:
    """One tenant's rolling-window budget (None = unlimited)."""

    bytes: Optional[int] = None
    compute_s: Optional[float] = None

    @property
    def limited(self) -> bool:
        return self.bytes is not None or self.compute_s is not None


@dataclass(frozen=True)
class QuotaExceeded:
    """Typed refusal: which budget the tenant exhausted, by how much,
    and when the rolling window frees enough spend to admit again."""

    tenant: str
    resource: str  # "bytes" | "compute_s"
    used: float
    budget: float
    retry_after_s: int

    @property
    def reason(self) -> str:
        if self.resource == "bytes":
            return (
                f"tenant {self.tenant!r} is over its device-byte quota "
                f"({int(self.used)} of {int(self.budget)} bytes in the "
                "rolling window); retry after the window frees budget"
            )
        return (
            f"tenant {self.tenant!r} is over its compute quota "
            f"({self.used:.3f} of {self.budget:.3f} s in the rolling "
            "window); retry after the window frees budget"
        )


def parse_quota_spec(spec: str) -> dict:
    """Grammar (module docstring) -> ``{tenant: Budget}``.  Malformed
    clauses warn and are skipped — never raise (tuning-var contract)."""
    budgets: dict = {}
    for clause in (spec or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        tenant, sep, body = clause.partition(":")
        tenant = tenant.strip()
        if not sep or not tenant or not body.strip():
            log.warning(
                "quota clause %r is not tenant:key=value[,...]; ignoring",
                clause,
            )
            continue
        nbytes = compute = None
        ok = True
        for item in body.split(","):
            key, s2, val = item.partition("=")
            key = key.strip().lower()
            val = val.strip().lower()
            try:
                if not s2:
                    raise ValueError("missing '='")
                if key == "bytes":
                    nbytes = parse_size(val)
                elif key in ("compute", "compute_s"):
                    compute = float(val[:-1] if val.endswith("s") else val)
                else:
                    raise ValueError(f"unknown key {key!r}")
            except ValueError as e:
                log.warning(
                    "quota clause %r: bad item %r (%s); ignoring the "
                    "whole clause", clause, item, e,
                )
                ok = False
                break
        if ok:
            budgets[tenant] = Budget(bytes=nbytes, compute_s=compute)
    return budgets


def rate_retry_hint(deficit_bytes: float, grant_records: list,
                    now: Optional[float] = None) -> Optional[int]:
    """Bytes-per-grant Retry-After estimate: given the fairness ring's
    recent ``(monotonic time, size)`` grant records, the tenant's byte
    deficit divided by the observed service byte rate is roughly how
    long the rolling window needs to drain that much spend.  ``None``
    when the ring carries no sized grants yet (cold service)."""
    recs = [(t, s) for t, s in (grant_records or []) if s > 0]
    if deficit_bytes <= 0 or len(recs) < 2:
        return None
    t0 = recs[0][0]
    t1 = recs[-1][0] if now is None else max(now, recs[-1][0])
    span = t1 - t0
    if span <= 0:
        return None
    rate = sum(s for _, s in recs) / span  # bytes/second
    if rate <= 0:
        return None
    return int(min(QUOTA_RETRY_MAX_S,
                   max(QUOTA_RETRY_MIN_S, round(deficit_bytes / rate))))


class QuotaManager:
    """Rolling-window per-tenant byte/compute accounting + the typed
    admission check (module docstring).  Thread-safe: jobs charge from
    their own threads, the coalescer from its dispatcher thread, and
    admission reads from the scheduler's."""

    def __init__(self, spec: str = "", window_s: Optional[float] = None,
                 clock=time.monotonic, tracer=None):
        self.budgets = parse_quota_spec(spec)
        self.window_s = (
            float(window_s) if window_s is not None else quota_window_s()
        )
        self._clock = clock
        self._tracer = tracer if tracer is not None else tele.TRACE
        self._lock = threading.Lock()
        # tenant -> deque[(t, bytes, compute_s)], oldest first
        self._charges: dict = {}

    def budget_for(self, tenant: str) -> Budget:
        b = self.budgets.get(tenant)
        if b is None:
            b = self.budgets.get("*")
        return b if b is not None else Budget()

    @property
    def enforcing(self) -> bool:
        return any(b.limited for b in self.budgets.values())

    # ---- charging -------------------------------------------------------
    def charge(self, tenant: str, nbytes: int = 0,
               compute_s: float = 0.0) -> None:
        """Account one charge against a tenant's rolling window (and
        mirror it into the telemetry quota ledger, so `adam-tpu
        analyze` renders per-tenant consumption)."""
        if nbytes <= 0 and compute_s <= 0:
            return
        now = self._clock()
        with self._lock:
            dq = self._charges.get(tenant)
            if dq is None:
                dq = self._charges[tenant] = deque()
            dq.append((now, int(nbytes), float(compute_s)))
            self._prune_locked(tenant, now)
        b = self.budget_for(tenant)
        self._tracer.record_quota(
            tenant, nbytes=nbytes, compute_s=compute_s,
            budget_bytes=b.bytes, budget_compute_s=b.compute_s,
        )

    def _prune_locked(self, tenant: str, now: float) -> None:
        dq = self._charges.get(tenant)
        if not dq:
            return
        horizon = now - self.window_s
        while dq and dq[0][0] < horizon:
            dq.popleft()

    def consumed(self, tenant: str) -> tuple:
        """(bytes, compute_s) spent inside the current window."""
        now = self._clock()
        with self._lock:
            self._prune_locked(tenant, now)
            dq = self._charges.get(tenant) or ()
            return (
                sum(c[1] for c in dq),
                sum(c[2] for c in dq),
            )

    # ---- the admission check -------------------------------------------
    def check(self, tenant: str) -> Optional[QuotaExceeded]:
        """None when the tenant may be admitted; a typed
        :class:`QuotaExceeded` (with a budget-derived Retry-After)
        when its rolling-window spend exceeds a budget."""
        b = self.budget_for(tenant)
        if not b.limited:
            return None
        now = self._clock()
        with self._lock:
            self._prune_locked(tenant, now)
            dq = list(self._charges.get(tenant) or ())
        used_b = sum(c[1] for c in dq)
        used_c = sum(c[2] for c in dq)
        if b.bytes is not None and used_b > b.bytes:
            return QuotaExceeded(
                tenant, "bytes", used_b, b.bytes,
                self._expiry_hint(dq, now, used_b - b.bytes, idx=1),
            )
        if b.compute_s is not None and used_c > b.compute_s:
            return QuotaExceeded(
                tenant, "compute_s", used_c, b.compute_s,
                self._expiry_hint(dq, now, used_c - b.compute_s, idx=2),
            )
        return None

    def _expiry_hint(self, dq: list, now: float, deficit: float,
                     idx: int) -> int:
        """Seconds until enough of the oldest charges age out of the
        window to cover ``deficit`` — the honest Retry-After: the
        rolling window IS the refill schedule."""
        freed = 0.0
        for charge in dq:
            freed += charge[idx]
            if freed >= deficit:
                eta = charge[0] + self.window_s - now
                return int(min(QUOTA_RETRY_MAX_S,
                               max(QUOTA_RETRY_MIN_S, round(eta))))
        return int(min(QUOTA_RETRY_MAX_S,
                       max(QUOTA_RETRY_MIN_S, round(self.window_s))))

    # ---- the mid-run throttle ------------------------------------------
    def throttle(self, tenant: str, should_stop=None,
                 max_wait_s: Optional[float] = None,
                 sleep=None, tracer=None) -> float:
        """Defer one grant while ``tenant`` is over budget (the pacer
        seam calls this before taking the WFQ turn).  Returns the
        seconds actually deferred (0.0 on the in-budget fast path —
        one ``check`` call).

        The wait polls in :data:`THROTTLE_POLL_S` steps so (a) charges
        aging out of the rolling window free the grant promptly and
        (b) ``should_stop()`` — the scheduler's drain/cancel probe —
        interrupts a deferral immediately (the caller's own pacer turn
        then raises ``RunCancelled``).  Bounded by ``max_wait_s``
        (default :func:`max_defer_s`): a stuck budget degrades to a
        bounded delay, never a wedged job.  Counts
        ``sched.quota.deferred`` once per deferral episode."""
        if self.check(tenant) is None:
            return 0.0
        if should_stop is not None and should_stop():
            # draining/cancelled: the caller's own pacer turn raises
            # next — a deferral that would end before it began is not
            # an episode (no count, no warning)
            return 0.0
        tr = tracer if tracer is not None else self._tracer
        tr.count(tele.C_QUOTA_DEFERRED)
        if max_wait_s is not None:
            bound = max_wait_s
        else:
            bound = max_defer_s() or (self.window_s + 1.0)
        do_sleep = sleep if sleep is not None else time.sleep
        t0 = self._clock()
        exceeded = self.check(tenant)
        log.warning(
            "tenant %r over budget mid-run (%s); deferring grants up "
            "to %.1fs", tenant,
            exceeded.reason if exceeded else "rechecking", bound,
        )
        while True:
            if should_stop is not None and should_stop():
                break
            if self.check(tenant) is None:
                break
            if self._clock() - t0 >= bound:
                break
            do_sleep(THROTTLE_POLL_S)
        return max(0.0, self._clock() - t0)

    # ---- status ---------------------------------------------------------
    def status(self) -> dict:
        """Point-in-time per-tenant view (scheduler/gateway status)."""
        with self._lock:
            tenants = sorted(
                set(self._charges) | set(self.budgets) - {"*"}
            )
        out = {}
        for t in tenants:
            used_b, used_c = self.consumed(t)
            b = self.budget_for(t)
            out[t] = {
                "bytes_used": used_b,
                "compute_s_used": round(used_c, 6),
                "budget_bytes": b.bytes,
                "budget_compute_s": b.compute_s,
            }
        return {"window_s": self.window_s, "tenants": out}


def quota_from_env() -> Optional[QuotaManager]:
    """Build a manager from ``ADAM_TPU_QUOTA`` (None when unset/empty
    — the zero-overhead default)."""
    spec = os.environ.get("ADAM_TPU_QUOTA", "").strip()
    if not spec:
        return None
    return QuotaManager(spec)
