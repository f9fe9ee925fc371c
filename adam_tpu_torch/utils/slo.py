"""Service-level objectives over the existing telemetry plane
(docs/OBSERVABILITY.md "SLOs and error budgets").

The telemetry below *records*; this module *judges*.  A declarative
spec names per-tenant (or service-wide, ``*``) objectives over signals
the stack already measures — the ``sched.job.run`` span wall, the
non-quarantined job fraction, counter throughput — and an evaluator
turns the stream of completed jobs into compliance, error-budget
remaining, and the SRE-workbook **multi-window burn rate**: how many
times faster than "exactly on objective" the budget is being spent,
over a short and a long rolling window simultaneously, so a one-job
blip (short window only) and a slow leak (long window only) both fail
to page while a genuine fast burn (both) fires the ``slo.burn``
trigger through the incident recorder.

Grammar (``--slo`` / ``ADAM_TPU_SLO``)::

    tenantA:p99(sched.job.run)<30s;tenantB:avail>=0.999;*:avail>=0.99

Clauses split on ``;``, each ``tenant:objective[,objective...]``.
Objective forms:

``pNN(span)<BOUND``
    latency: at least NN% of the tenant's completed jobs finish the
    named span under BOUND (suffixes ``ms``/``s``/``m``; bare numbers
    are seconds).  Today the only per-job span the scheduler feeds is
    ``sched.job.run``; other names parse but observe nothing.
``avail>=FRAC``
    availability: the non-quarantined fraction of completed jobs is at
    least FRAC.
``tput(counter)>=RATE``
    throughput floor: the named counter advances at >= RATE per second
    (suffix ``/s`` optional), sampled at evaluation time.

Malformed clauses warn and are skipped — the tuning-var contract every
``ADAM_TPU_*`` knob keeps: an SLO typo must never take down serving.

Windows: the short window is ``ADAM_TPU_SLO_WINDOW_S`` (default 300 s,
the 5-minute analogue) and the long window is 12x that (the 1-hour
analogue), so scaling the knob scales both.  A fast burn fires when
the short-window burn rate is >= ``ADAM_TPU_SLO_FAST_BURN`` (default
14.4, the workbook's 2%-of-budget-in-an-hour figure) AND the
long-window burn corroborates at >= fast/2.4 (the 6x analogue).

Budget state (cumulative good/bad events per objective) persists
durably in ``<run-root>/SLO_BUDGET.json`` via
``durability.atomic_write_json``, so a scheduler restart resumes the
budget instead of silently refilling it.  The file also records each
objective's target, which makes it self-contained for
``adam-tpu analyze`` (the "SLO" section renders from the budget file
sitting next to any artifact).

Like the incident recorder this is a module-level arm/disarm seam:
``install(spec, run_root)`` / ``uninstall()``; producers call the
module functions (``observe_job``, ``note_perf_regression``) which
no-op when disarmed, so the hot path never imports policy.

The port's copy of ``adam_tpu/utils/slo.py``; the files it writes are JAX's.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from adam_tpu_torch.utils import telemetry as tele

log = logging.getLogger(__name__)

#: Schema tag on the ``/slo`` status document and analyzer section.
SLO_SCHEMA = "adam_tpu.slo/1"

#: Schema tag on the durable budget file.
BUDGET_SCHEMA = "adam_tpu.slo_budget/1"

#: Durable budget file name under the run root.
BUDGET_FILENAME = "SLO_BUDGET.json"

#: Default short rolling window (seconds) — ``ADAM_TPU_SLO_WINDOW_S``.
#: The long window is always ``LONG_WINDOW_FACTOR`` times the short
#: one (5 m -> 1 h analogue).
DEFAULT_WINDOW_S = 300.0
LONG_WINDOW_FACTOR = 12.0

#: Default fast-burn threshold on the short window
#: (``ADAM_TPU_SLO_FAST_BURN``); the long window corroborates at
#: ``fast / FAST_LONG_RATIO``.
DEFAULT_FAST_BURN = 14.4
FAST_LONG_RATIO = 2.4

_DURATION_SUFFIX = {"ms": 1e-3, "s": 1.0, "m": 60.0}

_LATENCY_RE = re.compile(
    r"^p(?P<q>\d{1,2}(?:\.\d+)?)\((?P<name>[a-z0-9_.]+)\)"
    r"\s*<\s*(?P<bound>[0-9.]+)(?P<suffix>ms|s|m)?$")
_AVAIL_RE = re.compile(r"^avail\s*>=\s*(?P<frac>0?\.\d+|1(?:\.0+)?)$")
_TPUT_RE = re.compile(
    r"^tput\((?P<name>[a-z0-9_.]+)\)\s*>=\s*(?P<rate>[0-9.]+)(?:/s)?$")


def slo_window_s() -> float:
    """The short rolling window (``ADAM_TPU_SLO_WINDOW_S``; malformed
    or nonpositive warns and keeps the default)."""
    from adam_tpu_torch.utils.retry import env_float

    v = env_float("ADAM_TPU_SLO_WINDOW_S", DEFAULT_WINDOW_S)
    if v <= 0:
        log.warning("ADAM_TPU_SLO_WINDOW_S=%s is not positive; using "
                    "default %.0fs", v, DEFAULT_WINDOW_S)
        return DEFAULT_WINDOW_S
    return v


def fast_burn_threshold() -> float:
    """``ADAM_TPU_SLO_FAST_BURN`` (default 14.4): the short-window
    burn rate at which ``slo.burn`` fires (long window corroborates
    at a 2.4x lower bar)."""
    from adam_tpu_torch.utils.retry import env_float

    v = env_float("ADAM_TPU_SLO_FAST_BURN", DEFAULT_FAST_BURN)
    if v <= 0:
        log.warning("ADAM_TPU_SLO_FAST_BURN=%s is not positive; using "
                    "default %.1f", v, DEFAULT_FAST_BURN)
        return DEFAULT_FAST_BURN
    return v


@dataclass(frozen=True)
class Objective:
    """One parsed clause: a tenant scope plus a target over a signal.

    ``allowed`` is the error budget as a bad-event fraction: a p99
    latency objective allows 1% of jobs over the bound, ``avail>=
    0.999`` allows 0.1% quarantined.  Throughput floors are pass/fail
    at sample time, so their ``allowed`` is a nominal 1% too (a floor
    persistently unmet burns at 100x — loudly, as it should).
    """

    tenant: str  # "*" = service-wide
    kind: str  # "latency" | "avail" | "tput"
    name: Optional[str]  # span / counter name, None for avail
    target: float  # quantile frac (latency), avail frac, rate floor
    bound_s: Optional[float] = None  # latency bound, seconds

    @property
    def allowed(self) -> float:
        """Allowed bad-event fraction (the error budget)."""
        if self.kind == "latency":
            return max(1.0 - self.target, 1e-6)
        if self.kind == "avail":
            return max(1.0 - self.target, 1e-6)
        return 0.01

    @property
    def key(self) -> str:
        """Stable identity used in the budget file and status doc."""
        if self.kind == "latency":
            q = f"{self.target * 100:g}"
            return f"{self.tenant}:p{q}({self.name})<{self.bound_s:g}s"
        if self.kind == "avail":
            return f"{self.tenant}:avail>={self.target:g}"
        return f"{self.tenant}:tput({self.name})>={self.target:g}"

    def matches(self, tenant: Optional[str]) -> bool:
        return self.tenant == "*" or tenant == self.tenant


def parse_duration_s(text: str, suffix: Optional[str]) -> float:
    return float(text) * _DURATION_SUFFIX.get(suffix or "s", 1.0)


def parse_slo_spec(spec: str) -> list:
    """Grammar (module docstring) -> ``[Objective, ...]``.  Malformed
    clauses warn and are skipped — never raise (tuning-var contract)."""
    objectives: list = []
    for clause in (spec or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        tenant, sep, body = clause.partition(":")
        tenant = tenant.strip()
        if not sep or not tenant or not body.strip():
            log.warning("slo clause %r is not tenant:objective[,...]; "
                        "ignoring", clause)
            continue
        for item in body.split(","):
            item = item.strip().lower()
            if not item:
                continue
            m = _LATENCY_RE.match(item)
            if m:
                q = float(m.group("q")) / 100.0
                bound = parse_duration_s(m.group("bound"), m.group("suffix"))
                if 0.0 < q < 1.0 and bound > 0:
                    objectives.append(Objective(
                        tenant=tenant, kind="latency", name=m.group("name"),
                        target=q, bound_s=bound))
                    continue
            m = _AVAIL_RE.match(item)
            if m:
                frac = float(m.group("frac"))
                if 0.0 < frac <= 1.0:
                    objectives.append(Objective(
                        tenant=tenant, kind="avail", name=None, target=frac))
                    continue
            m = _TPUT_RE.match(item)
            if m:
                rate = float(m.group("rate"))
                if rate > 0:
                    objectives.append(Objective(
                        tenant=tenant, kind="tput", name=m.group("name"),
                        target=rate))
                    continue
            log.warning("slo clause %r: bad objective %r; ignoring it",
                        clause, item)
    return objectives


@dataclass
class _ObjState:
    """Mutable per-objective state: the rolling event window plus the
    durable cumulative budget counters."""

    objective: Objective
    events: deque = field(default_factory=deque)  # (t_mono, good: bool)
    good_total: int = 0  # cumulative, persisted
    bad_total: int = 0  # cumulative, persisted
    last_sample: Optional[tuple] = None  # tput: (t_mono, counter value)


class SLOEngine:
    """Evaluates parsed objectives over the job-completion stream.

    Thread-safe: jobs complete on scheduler worker threads, the
    gateway's ``/slo`` handler and the heartbeat sampler read from
    their own.  ``observe_job`` is the single write seam; it updates
    the rolling windows, persists the budget file, publishes the
    ``slo.worst_burn`` / ``slo.budget_remaining`` gauges, and fires
    ``slo.burn`` on a corroborated fast burn.
    """

    def __init__(self, objectives: list, run_root: Optional[str] = None,
                 *, window_s: Optional[float] = None,
                 fast_burn: Optional[float] = None) -> None:
        self._lock = threading.Lock()
        self._run_root = os.path.abspath(run_root) if run_root else None
        self._window_s = float(window_s) if window_s else slo_window_s()
        self._long_window_s = self._window_s * LONG_WINDOW_FACTOR
        self._fast_burn = (float(fast_burn) if fast_burn
                           else fast_burn_threshold())
        self._states = [_ObjState(objective=o) for o in objectives]
        self._load_budget()

    # ---- durable budget ----

    @property
    def budget_path(self) -> Optional[str]:
        if not self._run_root:
            return None
        return os.path.join(self._run_root, BUDGET_FILENAME)

    def _load_budget(self) -> None:
        path = self.budget_path
        if not path or not os.path.exists(path):
            return
        import json

        try:
            with open(path, encoding="utf-8") as fh:
                doc = json.load(fh)
            saved = doc.get("objectives", {})
        except (OSError, ValueError) as e:
            log.warning("could not load SLO budget %s (%s); starting "
                        "fresh", path, e)
            return
        for st in self._states:
            row = saved.get(st.objective.key)
            if isinstance(row, dict):
                st.good_total = int(row.get("good", 0))
                st.bad_total = int(row.get("bad", 0))

    def _persist_budget_locked(self) -> None:
        path = self.budget_path
        if not path:
            return
        from adam_tpu_torch.utils.durability import atomic_write_json

        doc = {
            "schema": BUDGET_SCHEMA,
            "window_s": self._window_s,
            "objectives": {
                st.objective.key: {
                    "tenant": st.objective.tenant,
                    "kind": st.objective.kind,
                    "target": st.objective.target,
                    "allowed": st.objective.allowed,
                    "good": st.good_total,
                    "bad": st.bad_total,
                }
                for st in self._states
            },
        }
        try:
            atomic_write_json(path, doc)
        except OSError as e:  # budget durability is best-effort
            log.warning("could not persist SLO budget %s: %s", path, e)

    # ---- observation ----

    def observe_job(self, tenant: Optional[str], duration_s: float,
                    ok: bool = True, *, span: str = "sched.job.run",
                    trace_id: Optional[str] = None,
                    tracer=None) -> None:
        """Book one completed job: ``ok=False`` means quarantined.
        Latency objectives over ``span`` judge ``duration_s`` against
        their bound; availability objectives judge ``ok``."""
        now = time.monotonic()
        with self._lock:
            for st in self._states:
                o = st.objective
                if not o.matches(tenant):
                    continue
                if o.kind == "latency":
                    if o.name != span:
                        continue
                    good = ok and duration_s < o.bound_s
                elif o.kind == "avail":
                    good = ok
                else:
                    continue  # tput is sampled, not event-driven
                st.events.append((now, good))
                if good:
                    st.good_total += 1
                else:
                    st.bad_total += 1
            self._evict_locked(now)
            self._persist_budget_locked()
        self._evaluate_and_alert(trace_id=trace_id, tracer=tracer)

    def note_bad_event(self, n: int = 1, *, reason: str = "") -> None:
        """Charge ``n`` bad events against every objective — the perf
        sentinel's burn charge: a confirmed perf regression spends
        error budget even when no individual job missed its bound."""
        now = time.monotonic()
        with self._lock:
            for st in self._states:
                if st.objective.kind == "tput":
                    continue
                for _ in range(max(0, int(n))):
                    st.events.append((now, False))
                    st.bad_total += 1
            self._evict_locked(now)
            self._persist_budget_locked()
        self._evaluate_and_alert(reason_prefix=reason)

    def _evict_locked(self, now: float) -> None:
        horizon = now - self._long_window_s
        for st in self._states:
            ev = st.events
            while ev and ev[0][0] < horizon:
                ev.popleft()

    # ---- evaluation ----

    @staticmethod
    def _window_frac(events: deque, since: float) -> tuple:
        """(bad fraction, event count) among events newer than
        ``since``; an empty window is compliant (0.0, 0)."""
        bad = n = 0
        for t, good in reversed(events):
            if t < since:
                break
            n += 1
            if not good:
                bad += 1
        return ((bad / n) if n else 0.0, n)

    def _eval_tput_locked(self, st: _ObjState, now: float) -> tuple:
        """Sample the counter and return (bad_frac, rate) — pass/fail
        at this instant; the first sample establishes the baseline."""
        snap = tele.TRACE.snapshot()
        value = snap.get("counters", {}).get(st.objective.name, 0)
        prev = st.last_sample
        st.last_sample = (now, value)
        if prev is None or now - prev[0] <= 0:
            return 0.0, None
        rate = (value - prev[1]) / (now - prev[0])
        good = rate >= st.objective.target
        st.events.append((now, good))
        if good:
            st.good_total += 1
        else:
            st.bad_total += 1
        return (0.0 if good else 1.0), rate

    def evaluate(self) -> dict:
        """Compliance, burn rates, and budget remaining per objective,
        plus the service-wide worst burn — the ``/slo`` document."""
        now = time.monotonic()
        rows = []
        with self._lock:
            self._evict_locked(now)
            for st in self._states:
                o = st.objective
                rate = None
                if o.kind == "tput":
                    _, rate = self._eval_tput_locked(st, now)
                bad_short, n_short = self._window_frac(
                    st.events, now - self._window_s)
                bad_long, n_long = self._window_frac(
                    st.events, now - self._long_window_s)
                burn_short = bad_short / o.allowed
                burn_long = bad_long / o.allowed
                total = st.good_total + st.bad_total
                bad_frac_total = (st.bad_total / total) if total else 0.0
                remaining = max(0.0, 1.0 - bad_frac_total / o.allowed)
                row = {
                    "key": o.key,
                    "tenant": o.tenant,
                    "kind": o.kind,
                    "name": o.name,
                    "target": o.target,
                    "allowed": o.allowed,
                    "compliance": 1.0 - bad_long,
                    "burn_short": burn_short,
                    "burn_long": burn_long,
                    "events_short": n_short,
                    "events_long": n_long,
                    "good_total": st.good_total,
                    "bad_total": st.bad_total,
                    "budget_remaining": remaining,
                    "fast_burn": (burn_short >= self._fast_burn
                                  and burn_long >= self._fast_burn
                                  / FAST_LONG_RATIO),
                }
                if o.kind == "latency":
                    row["bound_s"] = o.bound_s
                if rate is not None:
                    row["rate"] = rate
                rows.append(row)
        worst = max((r["burn_short"] for r in rows), default=0.0)
        remaining = min((r["budget_remaining"] for r in rows), default=1.0)
        return {
            "schema": SLO_SCHEMA,
            "window_s": self._window_s,
            "long_window_s": self._long_window_s,
            "fast_burn_threshold": self._fast_burn,
            "objectives": rows,
            "worst_burn": worst,
            "budget_remaining": remaining,
        }

    def _evaluate_and_alert(self, *, trace_id=None, tracer=None,
                            reason_prefix: str = "") -> None:
        status = self.evaluate()
        tele.TRACE.gauge(tele.G_SLO_WORST_BURN, status["worst_burn"])
        tele.TRACE.gauge(tele.G_SLO_BUDGET_REMAINING,
                         status["budget_remaining"])
        burning = [r for r in status["objectives"] if r["fast_burn"]]
        if not burning:
            return
        tele.TRACE.count(tele.C_SLO_BREACHES, len(burning))
        from adam_tpu_torch.utils import incidents

        worst = max(burning, key=lambda r: r["burn_short"])
        reason = (
            f"{reason_prefix + ': ' if reason_prefix else ''}"
            f"objective {worst['key']} burning error budget at "
            f"{worst['burn_short']:.1f}x over the {self._window_s:.0f}s "
            f"window ({worst['burn_long']:.1f}x long); "
            f"{worst['budget_remaining'] * 100:.1f}% of budget remains"
        )
        incidents.maybe_record("slo.burn", trace_id=trace_id,
                               tracer=tracer, reason=reason)

    def worst_burn(self) -> float:
        """Short-window worst burn across objectives (heartbeat cell);
        reads the gauges' source of truth by re-evaluating."""
        return self.evaluate()["worst_burn"]


# ---- module-level arm/disarm (the incident-recorder pattern) ----

_ENGINE: Optional[SLOEngine] = None
_LOCK = threading.Lock()


def install(spec, run_root: Optional[str] = None, *,
            window_s: Optional[float] = None) -> Optional[SLOEngine]:
    """Arm the SLO engine.  ``spec`` is a grammar string, a parsed
    objective list, or an :class:`SLOEngine`.  A spec that parses to
    zero objectives leaves the engine disarmed (and warns — a typo'd
    spec must degrade, not raise)."""
    global _ENGINE
    if isinstance(spec, SLOEngine):
        engine = spec
    else:
        objectives = (parse_slo_spec(spec) if isinstance(spec, str)
                      else list(spec or []))
        if not objectives:
            if spec:
                log.warning("SLO spec %r parsed to no objectives; SLO "
                            "engine stays disarmed", spec)
            return None
        engine = SLOEngine(objectives, run_root, window_s=window_s)
    with _LOCK:
        _ENGINE = engine
    return engine


def uninstall() -> None:
    global _ENGINE
    with _LOCK:
        _ENGINE = None


def installed() -> bool:
    return _ENGINE is not None


def engine() -> Optional[SLOEngine]:
    return _ENGINE


def slo_from_env() -> Optional[str]:
    """``ADAM_TPU_SLO``: the spec string, or None when unset/empty."""
    spec = os.environ.get("ADAM_TPU_SLO", "").strip()
    return spec or None


def observe_job(tenant: Optional[str], duration_s: float, ok: bool = True,
                **kw) -> None:
    """Module seam for producers: books a completed job against the
    armed engine; no-op when disarmed."""
    eng = _ENGINE
    if eng is not None:
        eng.observe_job(tenant, duration_s, ok, **kw)


def note_perf_regression(n: int = 1, *, reason: str = "") -> None:
    """The perf sentinel's SLO burn charge (no-op when disarmed)."""
    eng = _ENGINE
    if eng is not None:
        eng.note_bad_event(n, reason=reason or "perf regression")


def status() -> Optional[dict]:
    """The ``/slo`` document, or None when no engine is armed."""
    eng = _ENGINE
    return eng.evaluate() if eng is not None else None


def worst_burn() -> Optional[float]:
    """Heartbeat cell: worst short-window burn, None when disarmed."""
    eng = _ENGINE
    return eng.worst_burn() if eng is not None else None


def _reset_for_tests() -> None:
    uninstall()
