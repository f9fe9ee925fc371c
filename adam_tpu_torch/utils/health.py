"""Per-slot health scoreboard: healthy -> suspect -> probation -> evicted,
the hedge and SDC-audit knobs, and the re-admission probe — the port's
counterpart of ``adam_tpu/utils/health.py``.

The retry, eviction and replay layers handle a slot that fails loudly.
This module is for one that misbehaves quietly:

* a **straggler**: hedged dispatch (``ADAM_TPU_HEDGE_FACTOR``, wired in
  ``pipelines/streamed.py``) re-runs an overdue window on another slot,
  and the board demotes the slot whose latency stays degraded;
* a **silent data corruptor**: the SDC audit (``ADAM_TPU_AUDIT_RATE``)
  recomputes a deterministic sample of windows with the plain PyTorch
  version on the CPU and compares the bytes; a mismatch quarantines the
  slot here and the window replays on another slot of the card.  The CPU
  result is only the comparison's reference: it is never published.

The board keeps a decaying penalty score per slot (JAX's weights: retry
0.5, timeout 1.5, latency breach 1.0; an audit mismatch goes straight to
probation), with JAX's thresholds and knobs (``ADAM_TPU_HEALTH_SUSPECT``,
``_PROBATION``, ``_DECAY_S``, ``_COOLDOWN_S``, ``_LATENCY_FACTOR``).  A
slot in probation is left out of placement until its cooldown passes and
:func:`probe_known_answer` returns the exact integer product; a failed
probe evicts it.  Availability beats health: the filter never empties the
placeable set.

One process-wide board (:data:`BOARD`) spans runs, keyed by slot
(:func:`device_key`), not by ``torch.device``: two slots on one card are
two entries.  Every transition (to suspect, probation or evicted) is
logged, recorded in the tracer's health ledger, and fires a
``health.transition`` incident bundle (``utils/incidents.py``) once the
board's lock is released, as in JAX.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from typing import Optional

from adam_tpu_torch.utils import telemetry as tele
from adam_tpu_torch.utils.retry import _env_int, _env_seed, env_float

log = logging.getLogger(__name__)

HEALTHY = "healthy"
SUSPECT = "suspect"
PROBATION = "probation"
EVICTED = "evicted"

W_RETRY = 0.5
W_TIMEOUT = 1.5
W_LATENCY = 1.0

_DEF_SUSPECT = 3.0
_DEF_PROBATION = 6.0
_DEF_DECAY_S = 30.0
_DEF_COOLDOWN_S = 30.0
_DEF_LATENCY_FACTOR = 4.0
MIN_LATENCY_SAMPLES = 8
_DEF_HEDGE_MIN_S = 0.05
_EWMA_ALPHA = 0.25


def min_latency_samples() -> int:
    return _env_int("ADAM_TPU_HEDGE_MIN_SAMPLES", MIN_LATENCY_SAMPLES)


def device_key(device) -> str:
    """The board's key for a slot: its own ``key`` (``"cuda:0#1"``: slot 1
    on ``cuda:0``); strings pass through (``"mesh"``, test fixtures); None
    is ``"default"``, the single-device path; a bare ``torch.device`` keys
    as its string."""
    if device is None:
        return "default"
    if isinstance(device, str):
        return device
    key = getattr(device, "key", None)
    return key if key is not None else str(device)


def hedge_factor() -> float:
    """``ADAM_TPU_HEDGE_FACTOR`` (default 0, hedging off): hedge a window
    whose dispatch+fetch wall passes this multiple of the kernel's p99."""
    v = env_float("ADAM_TPU_HEDGE_FACTOR", 0.0)
    return v if v > 0 else 0.0


def audit_rate() -> float:
    """``ADAM_TPU_AUDIT_RATE`` (default 0, audit off), clamped to [0, 1]."""
    v = env_float("ADAM_TPU_AUDIT_RATE", 0.0)
    return min(max(v, 0.0), 1.0)


def audit_due(window: int, rate: Optional[float] = None,
              seed: Optional[int] = None) -> bool:
    """Whether window ``window`` is audited: a pure function of (seed,
    window), never of placement or time, so a resume audits the windows
    the killed run would have (JAX's function, value for value)."""
    r = audit_rate() if rate is None else rate
    if r <= 0:
        return False
    if r >= 1:
        return True
    if seed is None:
        seed = _env_seed("ADAM_TPU_AUDIT_SEED", 0)
    digest = hashlib.sha256(f"{seed}:{int(window)}".encode()).digest()
    unit = int.from_bytes(digest[:8], "big") / float(1 << 64)
    return unit < r


class _Device:
    __slots__ = ("score", "state", "t_score", "since", "probes", "signals",
                 "reason", "ewma")

    def __init__(self, now: float):
        self.score = 0.0
        self.state = HEALTHY
        self.t_score = now
        self.since = now
        self.probes = 0
        self.signals = {"retry": 0, "timeout": 0, "latency": 0, "mismatch": 0}
        self.reason = ""
        self.ewma: dict = {}


class HealthBoard:
    """The per-slot health scoreboard (module docstring)."""

    def __init__(self, clock=time.monotonic,
                 suspect_score: Optional[float] = None,
                 probation_score: Optional[float] = None,
                 decay_halflife_s: Optional[float] = None,
                 cooldown_s: Optional[float] = None,
                 latency_factor: Optional[float] = None):
        self._clock = clock
        self.suspect_score = (suspect_score if suspect_score is not None
                              else env_float("ADAM_TPU_HEALTH_SUSPECT", _DEF_SUSPECT))
        self.probation_score = (probation_score if probation_score is not None
                                else env_float("ADAM_TPU_HEALTH_PROBATION",
                                               _DEF_PROBATION))
        self.decay_halflife_s = max(1e-3, (
            decay_halflife_s if decay_halflife_s is not None
            else env_float("ADAM_TPU_HEALTH_DECAY_S", _DEF_DECAY_S)))
        self.cooldown_s = (cooldown_s if cooldown_s is not None
                           else env_float("ADAM_TPU_HEALTH_COOLDOWN_S", _DEF_COOLDOWN_S))
        self.latency_factor = (
            latency_factor if latency_factor is not None
            else env_float("ADAM_TPU_HEALTH_LATENCY_FACTOR", _DEF_LATENCY_FACTOR))
        self._lock = threading.Lock()
        self._dev: dict[str, _Device] = {}
        self._lat: dict[str, dict] = {}
        self.next_probe_due = float("inf")
        # transitions staged under the lock, recorded after its release
        # (the bundle writer snapshots this board, which takes the lock)
        self._pending_incidents: list = []

    def _slot_locked(self, key: str) -> _Device:
        d = self._dev.get(key)
        if d is None:
            d = self._dev[key] = _Device(self._clock())
        return d

    def _decay_locked(self, d: _Device, now: float) -> None:
        dt = max(0.0, now - d.t_score)
        if dt > 0 and d.score > 0:
            d.score *= 0.5 ** (dt / self.decay_halflife_s)
            if d.score < 1e-6:
                d.score = 0.0
        d.t_score = now
        if d.state == SUSPECT and d.score < 0.5 * self.suspect_score:
            d.state = HEALTHY
            d.since = now

    def _penalize_locked(self, key: str, weight: float, signal: str,
                         reason: str, tracer) -> None:
        now = self._clock()
        d = self._slot_locked(key)
        self._decay_locked(d, now)
        d.score += weight
        d.signals[signal] = d.signals.get(signal, 0) + 1
        if d.state in (PROBATION, EVICTED):
            return
        if d.score >= self.probation_score:
            self._enter_probation_locked(key, d, now, reason, tracer)
        elif d.score >= self.suspect_score and d.state == HEALTHY:
            d.state = SUSPECT
            d.since = now
            d.reason = reason
            tracer.count(tele.C_HEALTH_DEMOTED)
            tracer.record_health(key, SUSPECT, d.score, reason)
            self._pending_incidents.append((key, SUSPECT, reason, tracer))
            log.warning("slot %s health: healthy -> suspect (score %.1f, %s)",
                        key, d.score, reason)

    def _enter_probation_locked(self, key: str, d: _Device, now: float,
                                reason: str, tracer) -> None:
        d.state = PROBATION
        d.since = now
        d.reason = reason
        self.next_probe_due = min(self.next_probe_due, now + self.cooldown_s)
        tracer.count(tele.C_HEALTH_PROBATION)
        tracer.record_health(key, PROBATION, d.score, reason)
        self._pending_incidents.append((key, PROBATION, reason, tracer))
        log.error("slot %s health: PROBATION (score %.1f, %s) — left out of "
                  "placement; re-admission probe after %.0fs cooldown",
                  key, d.score, reason, self.cooldown_s)

    def _flush_incidents(self) -> None:
        """Record the staged ``health.transition`` bundles; every public
        feed calls it after releasing the lock."""
        with self._lock:
            if not self._pending_incidents:
                return
            pending = self._pending_incidents
            self._pending_incidents = []
        from adam_tpu_torch.utils import incidents

        for key, state, reason, tracer in pending:
            incidents.maybe_record(
                "health.transition", device=key, tracer=tracer,
                reason=f"device {key} -> {state}: {reason}",
            )

    def note_retry(self, device, site: str = "", tracer=None) -> None:
        """A transient, retried failure attributed to ``device``."""
        with self._lock:
            self._penalize_locked(device_key(device), W_RETRY, "retry",
                                  f"retried failure at {site or 'device call'}",
                                  tracer if tracer is not None else tele.TRACE)
        self._flush_incidents()

    def note_timeout(self, device, site: str = "", tracer=None) -> None:
        """A fetch-deadline watchdog trip attributed to ``device``."""
        with self._lock:
            self._penalize_locked(device_key(device), W_TIMEOUT, "timeout",
                                  f"deadline exceeded at {site or 'device.fetch'}",
                                  tracer if tracer is not None else tele.TRACE)
        self._flush_incidents()

    def observe_latency(self, kernel: str, device, seconds: float,
                        tracer=None) -> None:
        """One window's dispatch+fetch wall on ``device``: feeds the pooled
        per-kernel histogram (the hedge threshold's p99) and the per-(kernel,
        slot) EWMA; a wall, or an EWMA, above ``latency_factor`` x the pooled
        p99 (or the best peer's EWMA) penalizes the slot as a straggler."""
        s = float(seconds)
        key = device_key(device)
        with self._lock:
            h = self._lat.get(kernel)
            if h is None:
                h = self._lat[kernel] = tele._new_hist()
            d = self._slot_locked(key)
            prev = d.ewma.get(kernel)
            ew = s if prev is None else _EWMA_ALPHA * s + (1 - _EWMA_ALPHA) * prev
            d.ewma[kernel] = ew
            breach = None
            pool_sample = True
            if h["count"] >= min_latency_samples():
                p99 = tele._hist_quantile(h, 0.99) or 0.0
                bound = self.latency_factor * p99
                if bound > 0 and s > bound:
                    breach = "pooled p99"
                    pool_sample = False
                elif bound > 0 and ew > bound and (prev is None or prev <= bound):
                    breach = "pooled p99"
                if breach is None:
                    peer = min((o.ewma[kernel] for ok, o in self._dev.items()
                                if ok != key and kernel in o.ewma), default=0.0)
                    rel = self.latency_factor * peer
                    if rel > 0 and s > rel and ew > rel:
                        breach = "best peer EWMA"
                        pool_sample = False
            if pool_sample:
                tele._hist_observe(h, s)
            if breach:
                self._penalize_locked(
                    key, W_LATENCY, "latency",
                    f"{kernel} wall {s * 1e3:.1f}ms above "
                    f"{self.latency_factor:g}x {breach}",
                    tracer if tracer is not None else tele.TRACE)
        self._flush_incidents()

    def note_hedge_lost(self, device, kernel: str = "", tracer=None) -> None:
        """``device`` lost a hedge race: weighted like a latency breach."""
        with self._lock:
            self._penalize_locked(device_key(device), W_LATENCY, "latency",
                                  f"lost hedge race on {kernel or 'dispatch'}",
                                  tracer if tracer is not None else tele.TRACE)
        self._flush_incidents()

    def quarantine(self, device, reason: str = "", tracer=None) -> None:
        """Straight to probation: the SDC audit's verdict."""
        key = device_key(device)
        with self._lock:
            now = self._clock()
            d = self._slot_locked(key)
            d.signals["mismatch"] = d.signals.get("mismatch", 0) + 1
            if d.state in (PROBATION, EVICTED):
                return
            d.score = max(d.score, self.probation_score)
            d.t_score = now
            self._enter_probation_locked(key, d, now, reason or "quarantined",
                                         tracer if tracer is not None else tele.TRACE)
        self._flush_incidents()

    def mark_evicted(self, device, tracer=None) -> None:
        """The pool evicted this slot: terminal, never placeable again."""
        key = device_key(device)
        with self._lock:
            d = self._slot_locked(key)
            if d.state == EVICTED:
                return
            d.state = EVICTED
            d.since = self._clock()
            tr = tracer if tracer is not None else tele.TRACE
            tr.record_health(key, EVICTED, d.score, d.reason)
            self._pending_incidents.append(
                (key, EVICTED, d.reason or "evicted by the pool", tr))
        self._flush_incidents()

    def state(self, device) -> str:
        with self._lock:
            d = self._dev.get(device_key(device))
            if d is None:
                return HEALTHY
            self._decay_locked(d, self._clock())
            return d.state

    def blocked(self, device) -> bool:
        """True when ``device`` must be left out of placement (probation or
        evicted)."""
        with self._lock:
            d = self._dev.get(device_key(device))
            return d is not None and d.state not in (HEALTHY, SUSPECT)

    def hedge_threshold(self, kernel: str) -> Optional[float]:
        """Seconds after which an in-flight ``kernel`` window is hedged:
        ``ADAM_TPU_HEDGE_FACTOR`` x the pooled p99, floored at
        ``ADAM_TPU_HEDGE_MIN_S``; None while hedging is off or too few walls
        are pooled."""
        factor = hedge_factor()
        if factor <= 0:
            return None
        with self._lock:
            h = self._lat.get(kernel)
            if h is None or h["count"] < min_latency_samples():
                return None
            p99 = tele._hist_quantile(h, 0.99)
        if not p99:
            return None
        return max(factor * p99, env_float("ADAM_TPU_HEDGE_MIN_S", _DEF_HEDGE_MIN_S))

    def probe_maybe_due(self) -> bool:
        """Lock-free gate: False when no probation slot can be probe-due."""
        return self._clock() >= self.next_probe_due

    def due_probes(self, candidates=None) -> list:
        """Probation keys whose cooldown has passed (restricted to
        ``candidates``); each returned key's cooldown restarts at once."""
        now = self._clock()
        if now < self.next_probe_due:
            return []
        cand = None if candidates is None else {device_key(c) for c in candidates}
        due = []
        with self._lock:
            nxt = float("inf")
            for key, d in self._dev.items():
                if d.state != PROBATION:
                    continue
                if (cand is None or key in cand) and now - d.since >= self.cooldown_s:
                    due.append(key)
                    d.since = now
                    d.probes += 1
                nxt = min(nxt, d.since + self.cooldown_s)
            self.next_probe_due = nxt
        return due

    def readmit(self, device, tracer=None) -> None:
        """A probation slot passed its probe: back into placement."""
        key = device_key(device)
        tr = tracer if tracer is not None else tele.TRACE
        with self._lock:
            d = self._dev.get(key)
            if d is None or d.state != PROBATION:
                return
            d.state = HEALTHY
            d.score = 0.0
            d.since = self._clock()
            d.t_score = d.since
            d.reason = ""
            tr.count(tele.C_HEALTH_READMITTED)
            tr.record_health(key, HEALTHY, 0.0, "probe passed")
        log.warning("slot %s health: re-admission probe passed", key)

    def probe_failed(self, device, tracer=None) -> None:
        """The probe returned wrong bits or raised: the slot is evicted."""
        key = device_key(device)
        tr = tracer if tracer is not None else tele.TRACE
        with self._lock:
            d = self._slot_locked(key)
            d.state = EVICTED
            d.since = self._clock()
            tr.count(tele.C_HEALTH_PROBE_FAILED)
            tr.record_health(key, EVICTED, d.score, "re-admission probe failed")
            self._pending_incidents.append(
                (key, EVICTED, "re-admission probe failed", tr))
        self._flush_incidents()
        log.error("slot %s health: re-admission probe FAILED — evicting", key)

    def states(self) -> dict:
        """``{slot key: state}`` for every tracked slot (the heartbeat's
        ``device_health``)."""
        with self._lock:
            now = self._clock()
            out = {}
            for key, d in self._dev.items():
                self._decay_locked(d, now)
                out[key] = d.state
            return out

    def status(self) -> dict:
        """Full per-slot view."""
        with self._lock:
            now = self._clock()
            out = {}
            for key, d in sorted(self._dev.items()):
                self._decay_locked(d, now)
                out[key] = {"state": d.state, "score": round(d.score, 3),
                            "signals": dict(d.signals), "probes": d.probes,
                            "reason": d.reason}
            return out

    def publish(self, tracer) -> None:
        """Record every tracked slot's state in ``tracer``'s health ledger
        (not counted as transitions)."""
        for key, row in self.status().items():
            tracer.record_health(key, row["state"], row["score"], row["reason"],
                                 transition=False)

    def reset(self) -> None:
        """Test hook: forget every slot and latency pool."""
        with self._lock:
            self._dev.clear()
            self._lat.clear()
            self._pending_incidents.clear()
            self.next_probe_due = float("inf")


BOARD = HealthBoard()


def reset_board() -> None:
    """Test hook: clear the process-wide board."""
    BOARD.reset()


_PROBE_ARGS = None


def probe_known_answer(slot) -> bool:
    """The re-admission probe: a small integer matrix product computed on
    ``slot``'s device (i64 products and sums, exact on every device) and
    fetched through ``utils/transfer.device_fetch``, which must equal the
    host numpy product bit for bit.  False on any failure: a probe never
    escalates."""
    global _PROBE_ARGS
    try:
        import numpy as np
        import torch

        from adam_tpu_torch.utils.transfer import device_fetch

        if _PROBE_ARGS is None:
            rng = np.random.default_rng(0xADA)
            _PROBE_ARGS = (rng.integers(0, 127, size=(64, 64), dtype=np.int32),
                           rng.integers(0, 127, size=(64, 64), dtype=np.int32))
        a, b = _PROBE_ARGS
        expect = a.astype(np.int64) @ b.astype(np.int64)
        dev = getattr(slot, "device", slot)
        with _scope(slot):
            da = torch.from_numpy(a).to(dev).to(torch.int64)
            db = torch.from_numpy(b).to(dev).to(torch.int64)
            got = (da[:, :, None] * db[None, :, :]).sum(dim=1)
        return bool(np.array_equal(device_fetch(got, slot), expect))
    except Exception as e:
        log.warning("known-answer probe failed to run: %s", e)
        return False


def _scope(slot):
    import contextlib

    scope = getattr(slot, "scope", None)
    return scope() if scope is not None else contextlib.nullcontext()
