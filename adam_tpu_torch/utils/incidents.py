"""Anomaly-triggered incident bundles — the flight recorder's escape
hatch for tail events.

The flight recorder is a bounded ring: on a long run, the evidence
around the one event an operator actually cares about — the hedge that
fired, the SDC mismatch that quarantined a chip — is silently evicted
minutes later (the Tail-at-Scale framing in utils/telemetry.py: the
interesting events are exactly the rare ones the ring loses).  This
module snapshots that evidence AT the anomaly, into a timestamped JSON
bundle under the run dir, where it survives the ring, the process, and
the operator's lunch break.

Triggers (each call site names its trigger; the set is closed and
documented in docs/OBSERVABILITY.md):

* ``health.transition`` — the device-health scoreboard moved a chip
  (utils/health.py demotion/probation/eviction/readmission).
* ``hedge.fired`` — a speculative re-dispatch launched because an
  in-flight window exceeded its latency threshold
  (parallel/device_pool.hedged_call).
* ``audit.mismatch`` — the SDC dual-compute audit caught a bit
  mismatch (pipelines/streamed._audit_result).
* ``retry.exhausted`` — a retry budget was genuinely spent on
  retryable failures (utils/retry.retry_call).
* ``quota.burst`` — a burst of per-tenant quota 429s
  (:func:`note_quota_rejected` fed from serve/scheduler.py).

A bundle carries the triggering trace (Chrome-trace JSON filtered to
the job's trace_id, fused fan-in links included), the flight-recorder
ring tail, a full metrics snapshot, and the health board — everything
the post-hoc "what happened to job J's window 12" question needs.

Lifecycle: :func:`install` arms the recorder on a run dir (the
scheduler's run root, or a solo run's ``--run-dir``); uninstalled, every
trigger is one predicate and a return — the disabled-by-default
overhead contract the spans keep.  Recording is best-effort and
swallowed: an incident bundle must never take down the run it
documents.

Knobs (tolerantly parsed, the ``ADAM_TPU_*`` house rule):

* ``ADAM_TPU_INCIDENTS`` — master toggle (default on once installed).
* ``ADAM_TPU_INCIDENT_MAX`` — bundle-count bound per incidents dir
  (default 16; oldest pruned).
* ``ADAM_TPU_INCIDENT_COOLDOWN_S`` — per-trigger cooldown (default
  30 s; a flapping chip yields one bundle per cooldown, not thousands).
* ``ADAM_TPU_INCIDENT_EVENTS`` — ring-tail cap per bundle (default
  4096 newest events).
* ``ADAM_TPU_INCIDENT_QUOTA_BURST`` / ``ADAM_TPU_INCIDENT_QUOTA_WINDOW_S``
  — the quota-429 burst threshold (default 3 rejections in 10 s).

The port's copy of ``adam_tpu/utils/incidents.py``; the files it writes are JAX's.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque

from adam_tpu_torch.utils import telemetry as tele
from adam_tpu_torch.utils.retry import env_float, env_toggle, _env_int

log = logging.getLogger(__name__)

#: Schema tag every bundle carries.
INCIDENT_SCHEMA = "adam_tpu.incident/1"

#: The closed trigger vocabulary (docs/OBSERVABILITY.md).
TRIGGERS = (
    "health.transition",
    "hedge.fired",
    "audit.mismatch",
    "retry.exhausted",
    "quota.burst",
    "slo.burn",
    "perf.regression",
)

#: Subdirectory of the installed run dir bundles land in.
INCIDENTS_DIRNAME = "incidents"

_DEFAULT_MAX_BUNDLES = 16
_DEFAULT_COOLDOWN_S = 30.0
_DEFAULT_EVENT_CAP = 4096
_DEFAULT_QUOTA_BURST = 3
_DEFAULT_QUOTA_WINDOW_S = 10.0

_LOCK = threading.Lock()
_DIR: str | None = None         # armed incidents dir (None = disarmed)
_SEQ = 0                        # per-process bundle ordinal
_LAST_BY_TRIGGER: dict = {}     # trigger -> monotonic ts of last bundle
_LAST_INCIDENT: dict | None = None
_QUOTA_REJECTS: deque = deque() # (monotonic ts, tenant) burst window


# ---------------------------------------------------------------------------
# Lifecycle
# ---------------------------------------------------------------------------
def install(run_dir: str) -> None:
    """Arm the recorder: bundles land under ``<run_dir>/incidents/``.
    Idempotent; a second install re-points the recorder (one recorder
    per process — the scheduler's run root wins over per-job dirs
    because it installs first and jobs never re-install)."""
    global _DIR
    with _LOCK:
        _DIR = os.path.join(str(run_dir), INCIDENTS_DIRNAME)


def uninstall() -> None:
    """Disarm (tests; a drained scheduler leaves itself armed — late
    triggers during teardown still deserve evidence)."""
    global _DIR
    with _LOCK:
        _DIR = None


def installed() -> bool:
    with _LOCK:
        return _DIR is not None


def incidents_dir() -> str | None:
    """The armed incidents dir (None when disarmed)."""
    with _LOCK:
        return _DIR


def last_incident() -> dict | None:
    """Summary of the newest bundle THIS process recorded (the
    heartbeat's ``last_incident`` / ``last_incident_age_s`` fields), or
    None: ``{id, trigger, ts, ts_monotonic, path}``."""
    with _LOCK:
        return dict(_LAST_INCIDENT) if _LAST_INCIDENT else None


def _reset_for_tests() -> None:
    global _DIR, _SEQ, _LAST_INCIDENT
    with _LOCK:
        _DIR = None
        _SEQ = 0
        _LAST_BY_TRIGGER.clear()
        _LAST_INCIDENT = None
        _QUOTA_REJECTS.clear()


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------
def maybe_record(trigger: str, *, device=None, window=None,
                 trace_id: str | None = None, tracer=None,
                 reason: str = "") -> str | None:
    """Record one incident bundle if the recorder is armed, enabled,
    and the trigger is off cooldown; returns the bundle path (None
    when skipped).  Best-effort: any failure is logged and swallowed —
    evidence collection must never kill the run it documents.

    ``tracer`` defaults to the global :data:`~adam_tpu_torch.utils.telemetry.TRACE`;
    call sites inside a streamed run pass their run tracer so the
    bundle's ring/trace carry the job's own spans.  ``trace_id``
    defaults to the tracer's job trace (or the thread's trace scope),
    and selects the embedded Chrome-trace view."""
    try:
        return _record(trigger, device=device, window=window,
                       trace_id=trace_id, tracer=tracer, reason=reason)
    except Exception:
        log.warning("incident bundle for %s failed", trigger,
                    exc_info=True)
        return None


def _record(trigger, *, device, window, trace_id, tracer, reason):
    global _SEQ, _LAST_INCIDENT
    now = time.monotonic()
    with _LOCK:
        dirpath = _DIR
        if dirpath is None:
            return None
        if not env_toggle("ADAM_TPU_INCIDENTS", True):
            return None
        cooldown = max(
            0.0, env_float("ADAM_TPU_INCIDENT_COOLDOWN_S",
                           _DEFAULT_COOLDOWN_S)
        )
        last = _LAST_BY_TRIGGER.get(trigger)
        if last is not None and (now - last) < cooldown:
            return None
        _LAST_BY_TRIGGER[trigger] = now
        _SEQ += 1
        seq = _SEQ
    tr = tracer if tracer is not None else tele.TRACE
    if trace_id is None:
        trace_id = tele.current_trace() or tr.trace
    bundle_id = "inc-%d-%04d-%s" % (
        int(time.time()), seq, trigger.replace(".", "-")
    )
    event_cap = _env_int("ADAM_TPU_INCIDENT_EVENTS", _DEFAULT_EVENT_CAP)
    ring = tr.events()
    bundle = {
        "schema": INCIDENT_SCHEMA,
        "id": bundle_id,
        "trigger": trigger,
        "reason": str(reason) if reason else "",
        "ts": time.time(),
        "device": None if device is None else str(device),
        "window": window,
        "trace_id": trace_id,
        # newest ring tail (the evidence the eviction would lose)
        "events": ring[-event_cap:],
        "events_dropped": max(0, len(ring) - event_cap),
        "metrics": tr.snapshot(),
        "health": _health_status(),
        # the triggering trace, as the same Chrome-trace shape the
        # gateway /trace surface serves — dispatch/fetch/audit spans of
        # the implicated window included, fan-in links intact
        "trace": (
            tr.to_chrome_trace(trace_id) if trace_id is not None else None
        ),
    }
    path = os.path.join(dirpath, bundle_id + ".json")
    from adam_tpu_torch.utils.durability import atomic_write_json

    os.makedirs(dirpath, exist_ok=True)
    atomic_write_json(path, bundle)
    _prune(dirpath)
    tele.TRACE.count(tele.C_INCIDENT_RECORDED)
    with _LOCK:
        _LAST_INCIDENT = {
            "id": bundle_id, "trigger": trigger, "ts": bundle["ts"],
            "ts_monotonic": now, "path": path,
        }
    log.warning("incident %s recorded (%s): %s", bundle_id, trigger,
                path)
    return path


def _health_status():
    """Health-board snapshot for the bundle (lazy import; None when the
    board is empty or unimportable).  Called with NO locks held — the
    board snapshot takes the board's own lock, and a trigger fired from
    inside a board transition must already have released it
    (utils/health.py defers its incident hook past unlock)."""
    try:
        from adam_tpu_torch.utils import health as health_mod

        return health_mod.BOARD.status() or None
    except Exception:
        return None


def _prune(dirpath: str) -> None:
    """Bounded bundle count: delete oldest beyond the cap (bundle ids
    sort chronologically — epoch seconds then per-process seq)."""
    cap = _env_int("ADAM_TPU_INCIDENT_MAX", _DEFAULT_MAX_BUNDLES)
    try:
        names = sorted(
            n for n in os.listdir(dirpath)
            if n.startswith("inc-") and n.endswith(".json")
        )
    except OSError:
        return
    for n in names[:-cap] if len(names) > cap else ():
        try:
            os.unlink(os.path.join(dirpath, n))
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Quota-burst detector
# ---------------------------------------------------------------------------
def note_quota_rejected(tenant: str) -> None:
    """Feed one quota 429 into the burst detector (serve/scheduler.py
    calls this at its ``Busy(kind="quota")`` site).  A burst —
    ``ADAM_TPU_INCIDENT_QUOTA_BURST`` rejections inside
    ``ADAM_TPU_INCIDENT_QUOTA_WINDOW_S`` — records one ``quota.burst``
    bundle (the per-trigger cooldown still applies, so a sustained
    storm yields one bundle per cooldown)."""
    if not installed():
        return
    now = time.monotonic()
    window_s = max(
        0.1, env_float("ADAM_TPU_INCIDENT_QUOTA_WINDOW_S",
                       _DEFAULT_QUOTA_WINDOW_S)
    )
    burst = _env_int("ADAM_TPU_INCIDENT_QUOTA_BURST",
                     _DEFAULT_QUOTA_BURST)
    with _LOCK:
        _QUOTA_REJECTS.append((now, str(tenant)))
        while _QUOTA_REJECTS and now - _QUOTA_REJECTS[0][0] > window_s:
            _QUOTA_REJECTS.popleft()
        n = len(_QUOTA_REJECTS)
        tenants = sorted({t for _, t in _QUOTA_REJECTS})
        fire = n >= burst
        if fire:
            _QUOTA_REJECTS.clear()
    if fire:
        maybe_record(
            "quota.burst",
            reason="%d quota rejections in %.0fs (tenants: %s)"
                   % (n, window_s, ", ".join(tenants)),
        )


# ---------------------------------------------------------------------------
# Listing — `adam-tpu incidents` and the gateway GET /incidents
# ---------------------------------------------------------------------------
def summarize_bundle(doc: dict, path: str | None = None) -> dict:
    """One bundle's list-view row (the CLI table and the gateway
    ``/incidents`` payload share it)."""
    return {
        "id": doc.get("id"),
        "trigger": doc.get("trigger"),
        "reason": doc.get("reason") or "",
        "ts": doc.get("ts"),
        "device": doc.get("device"),
        "window": doc.get("window"),
        "trace_id": doc.get("trace_id"),
        "path": path,
    }


def list_bundles(run_dir: str) -> list:
    """Bundle summaries under ``<run_dir>/incidents/`` (or ``run_dir``
    itself when it already IS an incidents dir), oldest first.
    Malformed files are skipped with a warning — a torn bundle must not
    hide its siblings."""
    import json

    dirpath = str(run_dir)
    if os.path.basename(os.path.normpath(dirpath)) != INCIDENTS_DIRNAME:
        cand = os.path.join(dirpath, INCIDENTS_DIRNAME)
        if os.path.isdir(cand):
            dirpath = cand
    try:
        names = sorted(
            n for n in os.listdir(dirpath)
            if n.startswith("inc-") and n.endswith(".json")
        )
    except OSError:
        return []
    out = []
    for n in names:
        path = os.path.join(dirpath, n)
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            log.warning("skipping malformed incident bundle %s", path)
            continue
        if doc.get("schema") != INCIDENT_SCHEMA:
            log.warning("skipping %s: unknown schema %r", path,
                        doc.get("schema"))
            continue
        out.append(summarize_bundle(doc, path))
    return out
