"""Deterministic fault injection (the port's copy of
``adam_tpu/utils/faults.py``): named fault points in the pipeline that a
*fault spec* arms, so tests can drive the real code through failures and
host deaths reproducibly.  Disabled, each point costs one module-global
branch.

A spec comes from ``ADAM_TPU_FAULTS`` (read at import) or the CLI's
``--fault-spec``.  The grammar is the JAX package's::

    spec    := clause (';' clause)*
    clause  := site '=' action (',' option)*
    action  := 'transient' | 'permanent' | 'delay:<seconds>' | 'kill'
             | 'corrupt'
    option  := 'every=N'    match every Nth arrival at the site
             | 'after=N'    skip the first N arrivals
             | 'times=N'    stop matching after N injections
             | 'device=K'   only arrivals attributed to K
             | 'pass=NAME'  only arrivals under this pass scope
                            (a / resolve / observe / sweep / apply)
             | 'p=F'        match with probability F (seeded RNG)
             | 'seed=N'     RNG seed for p= (default 0)

Arrival counters are per clause, so ``every=3`` means "the 3rd, 6th, 9th
... time any call reaches this site".  ``transient`` raises
:class:`TransientFault`, ``permanent`` :class:`PermanentFault`,
``delay:S`` sleeps S seconds at the site, and ``kill`` SIGKILLs the
process itself (a host death: no cleanup, no atexit).  The ``pass=``
selector reads the thread's ``utils/telemetry.pass_scope``, and each
injection counts ``fault.injected`` on the global tracer, as in JAX.

The port parses every site and action the JAX package knows, with the
same messages, and arms every site (:data:`ARMED_POINTS`):

* ``proc.kill`` with the phase in the ``device`` slot: ``ingest`` (per
  tokenized window, on the ingest thread), ``pass_a`` (per pass-A
  window), ``pass_b`` (per observed window), ``fused_bc`` (per fused B->C
  dispatch), ``barrier2`` (at the merge's entry and after the table is
  journaled), ``pass_c`` (per fresh part submit), ``write`` (after each
  part's durable publish) and ``batch`` (per fused cross-job dispatch);
* ``parquet.encode`` (the writer pool's encoder) and ``parquet.write``
  (before a part's staging write);
* ``device.dispatch`` (before each window's device work, attributed to
  the pool slot's id: ``device=1`` is slot 1), ``device.fetch`` (each
  ``utils/transfer.device_fetch``; its ``corrupt`` action flips one bit
  of the fetched array through :func:`corrupt_array`, which the SDC audit
  catches) and ``pool.prewarm`` (each prewarm launch of a slot);
* the service's sites (``serve/``, ``gateway/``), the job id in the
  ``device`` slot where there is one: ``sched.admit`` (each submission),
  ``sched.dispatch`` (each pacer turn), ``sched.job_crash`` (each run
  attempt of a job), ``sched.drain`` (a drain request), ``sched.batch``
  (each fused dispatch, the pass kind in ``device``), ``gateway.accept``
  (each request), ``gateway.stream`` (each event-stream line) and
  ``gateway.fetch`` (each part-fetch chunk).
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time

from adam_tpu_torch.utils import telemetry as tele

log = logging.getLogger(__name__)

#: Every site the JAX package names (a spec naming another is refused at
#: parse time, with JAX's message).
KNOWN_POINTS = frozenset({
    "device.dispatch",
    "device.fetch",
    "parquet.write",
    "parquet.encode",
    "pool.prewarm",
    "proc.kill",
    "sched.admit",
    "sched.batch",
    "sched.dispatch",
    "sched.drain",
    "sched.job_crash",
    "gateway.accept",
    "gateway.stream",
    "gateway.fetch",
})

#: The sites the port arms: every one JAX names.
ARMED_POINTS = KNOWN_POINTS

#: Sites whose call path can flip result bits (JAX's; the parse refuses a
#: ``corrupt`` clause anywhere else, as JAX does).
CORRUPT_POINTS = frozenset({"device.fetch"})

class FaultError(Exception):
    """Base class of injected faults (never raised itself)."""


class TransientFault(FaultError):
    """Injected retryable failure."""


class PermanentFault(FaultError):
    """Injected non-retryable failure."""


class _Clause:
    __slots__ = (
        "site", "action", "delay_s", "every", "after", "times",
        "device", "pass_name", "p", "seed", "_rng", "_arrivals",
        "_fired",
    )

    def __init__(self, site: str, action: str, delay_s: float,
                 every: int | None, after: int, times: int | None,
                 device: str | None, p: float | None, seed: int,
                 pass_name: str | None = None):
        self.site = site
        self.action = action
        self.delay_s = delay_s
        self.every = every
        self.after = after
        self.times = times
        self.device = device
        self.pass_name = pass_name
        self.p = p
        self.seed = seed
        self._rng = random.Random(seed)
        self._arrivals = 0
        self._fired = 0

    def arrive(self, device, pass_name=None) -> bool:
        """Advance this clause's arrival counter and evaluate its
        predicate (under the module lock).  Every clause on a site sees
        every arrival; firing and the ``times=`` count are the caller's."""
        if self.device is not None and str(device) != self.device:
            return False
        if self.pass_name is not None and pass_name != self.pass_name:
            return False
        self._arrivals += 1
        if self.times is not None and self._fired >= self.times:
            return False
        if self._arrivals <= self.after:
            return False
        if self.every is not None:
            return self._arrivals % self.every == 0
        if self.p is not None:
            return self._rng.random() < self.p
        return True


def _parse_clause(text: str) -> _Clause:
    head, _, opts = text.partition(",")
    site, sep, action = head.partition("=")
    site = site.strip()
    action = action.strip()
    if not sep or not site or not action:
        raise ValueError(
            f"fault clause {text!r}: expected 'site=action[,option...]'"
        )
    if site not in KNOWN_POINTS:
        raise ValueError(
            f"fault clause {text!r}: unknown fault point {site!r} "
            f"(known: {sorted(KNOWN_POINTS)})"
        )
    delay_s = 0.0
    if action.startswith("delay:"):
        try:
            delay_s = float(action[len("delay:"):])
        except ValueError:
            raise ValueError(
                f"fault clause {text!r}: delay wants a float seconds value"
            ) from None
        action = "delay"
    if action not in ("transient", "permanent", "delay", "kill",
                      "corrupt"):
        raise ValueError(
            f"fault clause {text!r}: unknown action {action!r} "
            "(expected transient | permanent | delay:<seconds> | kill "
            "| corrupt)"
        )
    if action == "corrupt" and site not in CORRUPT_POINTS:
        raise ValueError(
            f"fault clause {text!r}: 'corrupt' only fires at the "
            f"corruption-capable sites {sorted(CORRUPT_POINTS)} — a "
            "clause here would arm an injection that can never flip "
            "anything"
        )
    every = times = None
    after = 0
    device = None
    pass_name = None
    p = None
    seed = 0
    for opt in filter(None, (o.strip() for o in opts.split(","))):
        key, sep, val = opt.partition("=")
        if not sep:
            raise ValueError(f"fault clause {text!r}: bad option {opt!r}")
        try:
            if key == "every":
                every = int(val)
                if every < 1:
                    raise ValueError
            elif key == "after":
                after = int(val)
            elif key == "times":
                times = int(val)
            elif key == "device":
                device = val
            elif key == "pass":
                pass_name = val
            elif key == "p":
                p = float(val)
            elif key == "seed":
                seed = int(val)
            else:
                raise ValueError(
                    f"fault clause {text!r}: unknown option {key!r}"
                )
        except ValueError as e:
            if e.args and "fault clause" in str(e):
                raise
            raise ValueError(
                f"fault clause {text!r}: bad value for {key!r}: {val!r}"
            ) from None
    return _Clause(site, action, delay_s, every, after, times, device, p,
                   seed, pass_name)


def parse_spec(spec: str) -> list:
    """Parse a fault-spec string into clauses (validation errors raise
    ``ValueError`` with the offending clause)."""
    return [
        _parse_clause(c)
        for c in filter(None, (c.strip() for c in spec.split(";")))
    ]


# Module state: ENABLED is the one branch the disabled fast path pays.
ENABLED = False
_CLAUSES: list = []
_LOCK = threading.Lock()


def install(spec: str | None) -> None:
    """Arm (or, with None/empty, disarm) a fault spec process-wide.
    Raises ``ValueError`` for a malformed spec.  Arming or disarming
    also resets the slot-health scoreboard (``utils/health.py``), as in
    JAX: the signals an injected spec manufactures must not leak into
    later runs in the process."""
    global ENABLED, _CLAUSES
    clauses = parse_spec(spec) if spec else []
    with _LOCK:
        was = ENABLED
        _CLAUSES = clauses
        ENABLED = bool(clauses)
    if was or clauses:
        from adam_tpu_torch.utils import health as health_mod

        health_mod.reset_board()
    if clauses:
        log.warning(
            "fault injection ARMED: %d clause(s) from %r (this is a "
            "testing facility; unset ADAM_TPU_FAULTS / --fault-spec for "
            "production runs)", len(clauses), spec,
        )


def clear() -> None:
    """Disarm all fault clauses (test teardown hook)."""
    install(None)


def point(site: str, device=None, pass_name=None) -> None:
    """A named fault point.  Disabled cost: one module-global branch.

    ``device`` is what the arrival is attributed to (the phase name at
    ``proc.kill``), matched against a clause's ``device=K``;
    ``pass_name`` overrides the thread's pass scope for ``pass=``.
    ``corrupt`` clauses never fire here: they live on the data channel
    (:func:`corrupt_array`), whose arrivals count apart."""
    if not ENABLED:
        return
    if pass_name is None:
        # the thread's telemetry pass scope, as in the JAX package
        pass_name = tele.current_pass()
    fire = None
    with _LOCK:
        # every same-site clause counts the arrival; the first whose
        # predicate matches fires
        for clause in _CLAUSES:
            if clause.site != site or clause.action == "corrupt":
                continue
            if clause.arrive(device, pass_name) and fire is None:
                fire = clause
        if fire is not None:
            fire._fired += 1
    if fire is None:
        return
    tele.TRACE.count(tele.C_FAULT_INJECTED)
    if fire.action == "delay":
        log.warning("fault injected at %s (device=%s): delay %.3fs",
                    site, device, fire.delay_s)
        time.sleep(fire.delay_s)
        return
    if fire.action == "kill":
        import signal

        log.warning("fault injected at %s (device=%s): SIGKILL self",
                    site, device)
        os.kill(os.getpid(), signal.SIGKILL)
        return  # pragma: no cover - unreachable after SIGKILL
    log.warning("fault injected at %s (device=%s): %s", site, device,
                fire.action)
    if fire.action == "permanent":
        raise PermanentFault(f"injected permanent fault at {site}"
                             f" (device={device})")
    raise TransientFault(f"injected transient fault at {site}"
                         f" (device={device})")


def corrupt_array(site: str, arr, device=None, pass_name=None):
    """The data channel of the fault grammar: ``arr`` (a just-fetched
    numpy result) through the ``corrupt`` clauses armed at ``site`` —
    a copy with one bit flipped when a clause fires, the very same object
    otherwise.  The flipped bit is a pure function of the clause's seed
    and its injection count (JAX's draw), so a run reproduces its
    corruption from the spec.  Disabled cost: one module-global branch."""
    if not ENABLED:
        return arr
    if pass_name is None:
        pass_name = tele.current_pass()
    fire = None
    with _LOCK:
        for clause in _CLAUSES:
            if clause.site != site or clause.action != "corrupt":
                continue
            if clause.arrive(device, pass_name) and fire is None:
                fire = clause
        if fire is not None:
            fire._fired += 1
            draw = fire._rng.random()
    if fire is None:
        return arr
    import numpy as np

    a = np.asarray(arr)
    if a.size == 0 or a.dtype == object:
        return arr
    out = np.array(a, copy=True)
    flat = out.reshape(-1).view(np.uint8).reshape(-1)
    pos = int(draw * flat.size * 8) % (flat.size * 8)
    flat[pos // 8] ^= np.uint8(1 << (pos % 8))
    tele.TRACE.count(tele.C_FAULT_INJECTED)
    log.warning("fault injected at %s (device=%s, pass=%s): corrupt — flipped "
                "bit %d of a %d-byte result", site, device, pass_name, pos,
                flat.size)
    return out


# Arm from the environment at import: child processes (the SIGKILL
# tests, chip_smoke.py's kill legs) are armed through ADAM_TPU_FAULTS.
if os.environ.get("ADAM_TPU_FAULTS", "").strip():
    install(os.environ["ADAM_TPU_FAULTS"])
