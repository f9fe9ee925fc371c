"""The per-window device pool: round-robin dispatch over pool *slots* —
the port's counterpart of ``adam_tpu/parallel/device_pool.py``.

**Slots.**  A JAX pool entry is a device, and each JAX device has its own
stream.  The port's entry is a :class:`Slot`: an index, a
``torch.device`` and its own ``torch.cuda.Stream`` (none on the CPU).  So
``DevicePool(make_slots(["cuda:0", "cuda:0"]))`` is a two-slot pool on
one card, and ``DevicePool(make_slots(["cpu", "cpu"]))`` one in the CPU
tests.  Slots are distinct objects, and the prewarm cache, the eviction
set and the health board key by slot (``utils/health.device_key``), never
by ``torch.device``.  A slot's work runs inside :meth:`Slot.scope`: its
device made current and its stream current there, so every copy, torch
op and hand kernel (``ops/kernels.launch``) of the window queues on the
slot's stream, and fetches wait on that stream alone
(``utils/transfer.device_fetch``).  A tensor handed across slots goes
through :func:`move_to`, which orders the streams and records the use.

The pieces, as in JAX:

* :class:`DevicePool` / :class:`PoolLease` / :func:`make_pool`: window
  ``i`` runs on the ``i % n``-th placeable slot; placement is a pure
  function of the index, so eviction replay and resume compose.
  :func:`resolve_device_count` caps ``--devices N`` at
  ``torch.cuda.device_count()`` with a warning (one card runs one device,
  as JAX on a one-chip box); a two-slot pool on one card is built only
  through the library seam (``transform_streamed(device_pool=)``).
* **Eviction and replay**: :meth:`DevicePool.evict` drops a slot whose
  retry budget is spent; its windows replay on the survivors under
  :class:`replay_scope`.  When every slot is gone, :class:`AllDevicesEvicted`
  **raises**: JAX falls back to its host backend there, the port has no
  CPU fallback on the card path (a deliberate difference).
* **Prewarm**: :meth:`DevicePool.prewarm` runs each kernel set entry
  (``*_prewarm_entry``) once per slot, concurrently, before the first
  window's work, so the first launches (the lazy build, the module load,
  CUDA's lazy loading) land outside the timed windows; a process-wide
  cache dedupes (entry, slot).  Prewarm launches count apart from the
  main path's (``ops/kernels.prewarm_launches``).
* :func:`hedged_call`, :func:`probe_device_tflops`, :func:`sweep_weights`
  and :class:`SweepSchedule` (the realign sweep fan-out).
* :class:`ResidentWindow`: a window's five per-residue tensors, placed on
  its slot once at ingest and read by passes A, B and C.

The pool merges nothing itself: per-slot histograms and columns come back
through the same per-window parts as on one device and the barriers sum
them in window order, so a pool run's bytes equal the one-device run's.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from adam_tpu_torch.formats import schema
from adam_tpu_torch.formats.batch import (
    grid_cigar_cols, grid_cols, grid_rows, pad_rows_np,
)
from adam_tpu_torch.utils import faults
from adam_tpu_torch.utils import health as health_mod
from adam_tpu_torch.utils import retry as retry_mod
from adam_tpu_torch.utils import telemetry as tele

log = logging.getLogger(__name__)


class AllDevicesEvicted(RuntimeError):
    """Every slot of the pool has been evicted.  The port raises here (JAX
    falls back to its host backend): no path carries on on the CPU when
    the card fails."""


# --------------------------------------------------------------------------
# Slots
# --------------------------------------------------------------------------
class Slot:
    """One pool entry: ``index`` (its span ``device=`` id), ``device`` and
    its own ``stream`` (None: the device's current stream, which the
    single-device path and the CPU use).  ``attributed`` is False for the
    single-device path's implicit slot, which carries no ``device=``
    attribution and keys as ``"default"``, as JAX's default device does."""

    __slots__ = ("index", "device", "stream", "attributed")

    def __init__(self, index: int, device, stream=None, attributed: bool = True):
        self.index = int(index)
        self.device = torch.device(device)
        self.stream = stream
        self.attributed = attributed

    @property
    def id(self) -> int:
        return self.index

    @property
    def platform(self) -> str:
        return self.device.type

    @property
    def key(self) -> str:
        return f"{self.device}#{self.index}" if self.attributed else "default"

    def scope(self):
        """Make this slot's device and stream current, and attribute the
        thread's kernel launches to it."""
        from adam_tpu_torch.ops import kernels

        stack = contextlib.ExitStack()
        if self.device.type == "cuda":
            stack.enter_context(torch.cuda.device(self.device))
            if self.stream is not None:
                stack.enter_context(torch.cuda.stream(self.stream))
        stack.enter_context(kernels.slot_scope(self.index))
        return stack

    def synchronize(self) -> None:
        """Wait for every operation queued on this slot's stream."""
        if self.device.type == "cuda":
            (self.stream or torch.cuda.current_stream(self.device)).synchronize()

    def __repr__(self) -> str:
        return f"Slot({self.index}, {self.device})"


def make_slots(devices: Sequence) -> list:
    """One :class:`Slot` per entry of ``devices`` (a device may repeat:
    ``["cuda:0", "cuda:0"]`` is two slots on one card), each with its own
    stream on the card."""
    from adam_tpu_torch.device import resolve_device

    slots = []
    for i, d in enumerate(devices):
        dev = resolve_device(d)
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        slots.append(Slot(i, dev, stream))
    return slots


def solo_slot(device) -> Slot:
    """The single-device path's implicit slot: no own stream, no
    attribution."""
    return Slot(0, device, None, attributed=False)


def as_slot(s) -> Slot:
    """A :class:`Slot` as given, or the solo slot of a device."""
    return s if isinstance(s, Slot) else solo_slot(s)


def move_to(x: torch.Tensor, src: Slot, dst: Slot) -> torch.Tensor:
    """``x`` (produced on ``src``'s stream) made usable on ``dst``'s: the
    destination stream waits for the source's work, the copy (if the
    devices differ) runs on the destination stream, and a tensor shared
    across streams records its use so its memory is not reused early."""
    if x.device.type != "cuda":
        return x.to(dst.device)
    src_stream = src.stream or torch.cuda.current_stream(src.device)
    with dst.scope():
        dst_stream = torch.cuda.current_stream(dst.device)
        if src_stream != dst_stream:
            dst_stream.wait_stream(src_stream)
        out = x.to(dst.device)
        if out.data_ptr() == x.data_ptr() and src_stream != dst_stream:
            x.record_stream(dst_stream)
    return out


# --------------------------------------------------------------------------
# Attribution, replay scope, placement
# --------------------------------------------------------------------------
_REPLAY_TLS = threading.local()


class replay_scope:
    """Marks the current thread as replaying an evicted slot's window
    (reentrant; see :func:`span_attrs`)."""

    def __enter__(self):
        _REPLAY_TLS.depth = getattr(_REPLAY_TLS, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _REPLAY_TLS.depth -= 1
        return False


def in_replay() -> bool:
    """True while the current thread is inside a :class:`replay_scope`."""
    return getattr(_REPLAY_TLS, "depth", 0) > 0


def _attr_id(slot):
    """The span ``device=`` value of a slot: its index."""
    return getattr(slot, "id", slot)


def span_attrs(slot=None) -> dict:
    """Span attrs for a dispatch/fetch site: ``{}`` without a pool slot
    (the single-device path), ``{"device": <slot id>}`` otherwise, plus
    ``replay=1`` inside a :class:`replay_scope`."""
    if slot is None or not getattr(slot, "attributed", True):
        return {}
    attrs = {"device": _attr_id(slot)}
    if in_replay():
        attrs["replay"] = 1
    return attrs


def putter(slot=None):
    """The host->device placement every dispatch site shares: the numpy
    array copied to the slot's device on its stream, and booked in the h2d
    ledger (bytes from the host array, attributed to the slot and the
    active pass scope) when recording is on."""
    slot = slot if slot is not None else solo_slot("cpu")
    dev = slot.device
    dev_id = _attr_id(slot) if slot.attributed else None

    def put(x):
        t0 = time.monotonic()
        with slot.scope():
            out = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        if tele.TRACE.recording:
            tele.TRACE.record_transfer("h2d", getattr(x, "nbytes", 0),
                                       time.monotonic() - t0, device=dev_id)
        return out

    return put


# --------------------------------------------------------------------------
# Device-resident windows
# --------------------------------------------------------------------------
class ResidentWindow:
    """One window's ingest-resident payload on its slot: ``bases``/``quals``
    u8[g, gl] and ``lengths``/``flags``/``read_group_idx`` i32[g],
    grid-padded, placed once and read by pass A (markdup keys), pass B
    (observe) and pass C (apply + pack); the later passes ship only their
    per-pass inputs.  The duplicate flags resolved at barrier 1 change only
    the host batch: the kernels read ``flags`` for the orientation bits,
    which duplicate marking never touches.

    Refcounted: the streamed run holds one reference per window and
    releases it after the window's pass-C fetch, so device memory frees
    window by window; :meth:`retain` pins the window for a consumer
    across a concurrent boundary, and :meth:`release` frees only when the
    count reaches zero.  :meth:`drop` is the fault path (eviction, a mesh
    degrade): it frees whatever the count, after which the window
    re-ships from its host copy."""

    FIELDS = ("bases", "quals", "lengths", "flags", "read_group_idx")

    def __init__(self, window: int, slot, tensors: dict, g: int, gl: int,
                 nbytes: int):
        self.window = window
        self.slot = slot  # a Slot, or "mesh" (then tensors are per shard)
        self.g = g
        self.gl = gl
        self.nbytes = nbytes
        self._t = tensors
        self._refs = 1
        self._lock = threading.Lock()

    @property
    def device(self) -> torch.device:
        return self.slot.device

    @property
    def alive(self) -> bool:
        with self._lock:
            return self._t is not None

    def get(self, name: str):
        with self._lock:
            if self._t is None:
                raise RuntimeError(f"resident window {self.window} already released")
            return self._t[name]

    def args(self) -> tuple:
        """The five resident tensors, in kernel-argument order."""
        return tuple(self.get(f) for f in self.FIELDS)

    def retain(self) -> None:
        """Add a reference (a no-op once freed)."""
        with self._lock:
            if self._t is not None:
                self._refs += 1

    def release(self) -> bool:
        """Drop one reference; True when this call freed the tensors."""
        with self._lock:
            if self._t is None:
                return False
            self._refs -= 1
            if self._refs > 0:
                return False
            self._t = None
            return True

    def drop(self) -> bool:
        """Free the tensors whatever the count; True when they were still
        held."""
        with self._lock:
            held = self._t is not None
            self._t = None
            self._refs = 0
            return held

    @staticmethod
    def host_arrays(b, g: int, gl: int) -> dict:
        """Batch ``b``'s five columns padded to the ``[g, gl]`` grid."""
        return {
            # adam-tpu: noqa[residency] reason=the host side of the ingest placement: make_resident_window and mesh_resident_window place these under pass_scope('ingest'); the other callers are fallbacks (the SDC audit's CPU reference, the coalescer's re-ship of a released window in serve/batching._resident_cols)
            "bases": pad_rows_np(b.bases, g, schema.BASE_PAD, cols=gl),
            # adam-tpu: noqa[residency] reason=as for bases above: the ingest placement's host-side pad
            "quals": pad_rows_np(b.quals, g, schema.QUAL_PAD, cols=gl),
            "lengths": pad_rows_np(b.lengths, g, 0),
            "flags": pad_rows_np(b.flags, g, schema.FLAG_UNMAPPED),
            "read_group_idx": pad_rows_np(b.read_group_idx, g, -1),
        }

    @staticmethod
    def place(b, slot, window: int = 0) -> "ResidentWindow":
        """Pad host batch ``b`` to its grid and place it on ``slot`` (a
        :class:`Slot`, or a device for the single-device path)."""
        slot = as_slot(slot)
        g = grid_rows(b.n_rows)
        gl = grid_cols(b.lmax)
        host = ResidentWindow.host_arrays(b, g, gl)
        put = putter(slot)
        return ResidentWindow(window, slot, {k: put(a) for k, a in host.items()},
                              g, gl, sum(int(a.nbytes) for a in host.values()))


def make_resident_window(b, window: int, device="cuda") -> ResidentWindow:
    """Place one window's resident payload on ``device`` (a device or a
    pool slot; default: the card) -> its :class:`ResidentWindow`.  ``b``
    is the window batch's host view; the arrays pad to the row and lane
    grid that a per-pass dispatch would have shipped."""
    from adam_tpu_torch.device import resolve_device

    return ResidentWindow.place(
        b, device if isinstance(device, Slot) else resolve_device(device), window=window)


# --------------------------------------------------------------------------
# The pool
# --------------------------------------------------------------------------
#: Process-wide prewarm cache: (entry key, slot key, route) triples already
#: launched.
_PREWARMED: set = set()
_PREWARM_LOCK = threading.Lock()


def reset_prewarm_cache() -> None:
    """Test hook: forget which (kernel, shape, slot) triples are warm."""
    with _PREWARM_LOCK:
        _PREWARMED.clear()


def attached_count(device="cuda") -> int:
    """The devices a pool may span: ``torch.cuda.device_count()`` for the
    card, 1 for the CPU (a CPU pool of several slots is built only through
    the library seam)."""
    if torch.device(device).type != "cuda":
        return 1
    try:
        return torch.cuda.device_count()
    except Exception:
        return 1


def resolve_device_count(requested: Optional[int] = None, device="cuda") -> int:
    """How many devices the streamed run fans out over: ``requested`` (the
    ``--devices`` flag), then ``ADAM_TPU_DEVICES``, then every attached
    device, capped at :func:`attached_count` with a warning and floored at
    1.  Only an explicit ``requested < 1`` raises; a malformed env value
    warns and uses every attached device."""
    if requested is not None and requested < 1:
        raise ValueError(f"--devices must be >= 1 (got {requested})")
    if requested is None:
        raw = os.environ.get("ADAM_TPU_DEVICES", "").strip()
        if raw:
            try:
                requested = int(raw)
            except ValueError:
                requested = None
            if requested is not None and requested < 1:
                requested = None
            if requested is None:
                log.warning("ADAM_TPU_DEVICES=%r is not a positive int; using "
                            "all attached devices", raw)
    attached = max(1, attached_count(device))
    if requested is None:
        return attached
    if requested > attached:
        log.warning("--devices %d requested but only %d attached; using %d",
                    requested, attached, attached)
    return max(1, min(requested, attached))


class DevicePool:
    """Round-robin window -> slot placement over an explicit slot set.

    ``pool.device(i)`` is window ``i``'s slot (``i % n`` over the
    placeable slots); ``pool.put(arr, i)`` places a host array on it.
    Placement is a pure function of the index, so eviction replay (the
    next survivor) and a resume compose freely with it."""

    def __init__(self, slots: Sequence):
        slots = list(slots)
        if not slots:
            raise ValueError("DevicePool needs at least one slot")
        if len({id(s) for s in slots}) != len(slots):
            raise ValueError("DevicePool slots must be distinct objects")
        self.devices = [s if isinstance(s, Slot) else Slot(i, s)
                        for i, s in enumerate(slots)]
        self._dead: set = set()
        self._leases: set = set()
        self._evict_lock = threading.Lock()
        self.health = health_mod.BOARD

    # ---- leases (the service's per-job handles) ----------------------
    def lease(self, job: Optional[str] = None) -> "PoolLease":
        lease = PoolLease(self, job=job)
        with self._evict_lock:
            self._leases.add(lease)
        return lease

    def _drop_lease(self, lease: "PoolLease") -> None:
        with self._evict_lock:
            self._leases.discard(lease)

    def active_leases(self) -> list:
        with self._evict_lock:
            return list(self._leases)

    @property
    def n(self) -> int:
        """The configured fan-out (evictions do not shrink it)."""
        return len(self.devices)

    # ---- eviction and health ------------------------------------------
    def survivors(self) -> list:
        """Slots not evicted (the prewarm set: probation slots stay warm)."""
        with self._evict_lock:
            return [s for s in self.devices if s.key not in self._dead]

    def alive_devices(self) -> list:
        """The placeable slots: survivors minus health-blocked ones, unless
        that would empty the set (availability beats health)."""
        alive = self.survivors()
        if len(alive) <= 1:
            return alive
        ok = [s for s in alive if not self.health.blocked(s)]
        return ok if ok else alive

    def evict(self, slot, reason: str = "", tracer=None) -> bool:
        """Take a failed slot out of placement; True when this call evicted
        it.  Counts ``device.evicted`` on ``tracer`` (or the global TRACE)."""
        if slot is None:
            return False
        with self._evict_lock:
            if slot.key in self._dead:
                return False
            self._dead.add(slot.key)
            left = len(self.devices) - len(self._dead)
        log.error("evicting slot %s after its retry budget%s; %d of %d pool "
                  "slot(s) remain", slot.key, f" ({reason})" if reason else "",
                  left, len(self.devices))
        (tracer if tracer is not None else tele.TRACE).count(tele.C_DEVICE_EVICTED)
        self.health.mark_evicted(slot, tracer=tracer)
        return True

    def _maybe_probe(self, tracer=None) -> None:
        """Run the due re-admission probes of this pool's probation slots."""
        if not self.health.probe_maybe_due():
            return
        survivors = self.survivors()
        due = set(self.health.due_probes(survivors))
        for s in survivors:
            if s.key not in due:
                continue
            if health_mod.probe_known_answer(s):
                self.health.readmit(s, tracer=tracer)
            else:
                self.health.probe_failed(s, tracer=tracer)
                self.evict(s, reason="re-admission probe failed", tracer=tracer)

    def device(self, window: int) -> Slot:
        """Window ``window``'s slot; raises :class:`AllDevicesEvicted` when
        none is left."""
        self._maybe_probe()
        alive = self.alive_devices()
        if not alive:
            raise AllDevicesEvicted(f"all {len(self.devices)} pool slots evicted")
        return alive[window % len(alive)]

    def device_index(self, window: int) -> int:
        """Index of window's slot in the original order (stable under
        eviction)."""
        return self.devices.index(self.device(window))

    def device_id(self, window: int):
        return _attr_id(self.device(window))

    def put(self, arr, window: int) -> torch.Tensor:
        """Place a host array on window's slot (booked in the h2d ledger)."""
        return putter(self.device(window))(arr)

    # ---- prewarm ---------------------------------------------------------
    def prewarm(self, entries: Sequence[tuple], tracer=None) -> int:
        """Run each ``(key, fn)`` entry once per surviving slot,
        concurrently (one thread per slot): ``fn(slot)`` launches the
        kernel set on dummy tensors at the entry's grid shape and waits
        for it.  Each (key, slot) runs once per process.  A failed entry
        is retried in place (``pool.prewarm`` fault site), then warned
        about and forgotten, so the shape simply runs cold at its first
        dispatch.  Returns the number of (entry, slot) prewarms run."""
        from adam_tpu_torch.utils import compile_ledger

        tr = tracer if tracer is not None else tele.TRACE
        todo: list = []
        claimed: set = set()
        with _PREWARM_LOCK:
            for key, fn in entries:
                for s in self.survivors():
                    cache_key = (key, s.key, compile_ledger.route_of(s))
                    if cache_key not in _PREWARMED and cache_key not in claimed:
                        claimed.add(cache_key)
                        todo.append((key, fn, s, cache_key))
                    else:
                        compile_ledger.claim(key, s)
            _PREWARMED.update(claimed)
        if not todo:
            return 0

        caller_trace = tele.current_trace()

        def one(item):
            key, fn, s, cache_key = item

            def warm_once():
                faults.point("pool.prewarm", device=_attr_id(s))
                with s.scope():
                    fn(s)
                s.synchronize()

            try:
                with tele.trace_scope(caller_trace), tr.span(
                    tele.SPAN_POOL_PREWARM_COMPILE, device=_attr_id(s),
                    kernel=str(key[0]),
                ), compile_ledger.prewarm_scope(), tele.pass_scope("prewarm"), \
                        compile_ledger.track(key, s):
                    retry_mod.retry_call(warm_once, site="device.pool.prewarm")
            except Exception:
                with _PREWARM_LOCK:
                    _PREWARMED.discard(cache_key)
                log.warning("prewarm of %s on slot %s failed; the shape runs "
                            "cold at its first dispatch instead", key, s.key,
                            exc_info=True)
                return 0
            tr.count(tele.C_POOL_PREWARM_COMPILES)
            return 1

        with ThreadPoolExecutor(max_workers=self.n) as ex:
            return sum(ex.map(one, todo))


class PoolLease:
    """One job's handle onto a shared :class:`DevicePool`: the pool's
    interface plus the job label on eviction log lines and an idempotent
    :meth:`release`.  Eviction stays shared: a slot that spent one job's
    retry budget is dead for every job."""

    def __init__(self, pool: DevicePool, job: Optional[str] = None):
        self._pool = pool
        self.job = job
        self._released = threading.Event()

    @property
    def devices(self) -> list:
        return self._pool.devices

    @property
    def n(self) -> int:
        return self._pool.n

    @property
    def health(self):
        return self._pool.health

    def survivors(self) -> list:
        return self._pool.survivors()

    def alive_devices(self) -> list:
        return self._pool.alive_devices()

    def device(self, window: int):
        return self._pool.device(window)

    def device_index(self, window: int) -> int:
        return self._pool.device_index(window)

    def device_id(self, window: int):
        return self._pool.device_id(window)

    def put(self, arr, window: int):
        return self._pool.put(arr, window)

    def prewarm(self, entries: Sequence[tuple], tracer=None) -> int:
        return self._pool.prewarm(entries, tracer=tracer)

    def evict(self, slot, reason: str = "", tracer=None) -> bool:
        if self.job and slot is not None:
            reason = f"job {self.job}: {reason}" if reason else f"job {self.job}"
        return self._pool.evict(slot, reason=reason, tracer=tracer)

    @property
    def released(self) -> bool:
        return self._released.is_set()

    def release(self) -> None:
        """Return this lease to the pool (idempotent)."""
        if not self._released.is_set():
            self._released.set()
            self._pool._drop_lease(self)


def make_pool(requested: Optional[int] = None, device="cuda") -> Optional[DevicePool]:
    """A pool over the first :func:`resolve_device_count` devices of
    ``device``'s type, or None for one device (the caller keeps its
    single-device path)."""
    n = resolve_device_count(requested, device)
    if n <= 1:
        return None
    return DevicePool(make_slots([torch.device("cuda", k) for k in range(n)]))


# --------------------------------------------------------------------------
# Hedged dispatch
# --------------------------------------------------------------------------
def hedged_call(primary_fn, hedge_fn, threshold_s: float, tracer=None):
    """Run ``primary_fn()`` on a helper thread; if it is still running after
    ``threshold_s``, run ``hedge_fn()`` (the same window on another slot,
    from its host copy) on the calling thread.  The first result wins; the
    bytes are the same either way.  Returns ``(result, winner, fired)``
    with ``winner`` ``"primary"`` or ``"hedge"``.  Counters:
    ``device.hedge.fired``, ``.won``, ``.wasted`` (fired = won + wasted).
    A hedge that raises falls back to waiting out the primary."""
    tr = tracer if tracer is not None else tele.TRACE
    box: list = []
    done = threading.Event()
    caller_pass = tele.current_pass()
    caller_trace = tele.current_trace()

    def run_primary():
        try:
            with tele.trace_scope(caller_trace):
                if caller_pass is not None:
                    with tele.pass_scope(caller_pass):
                        box.append((True, primary_fn()))
                else:
                    box.append((True, primary_fn()))
        except BaseException as e:  # relayed below
            box.append((False, e))
        done.set()

    t = threading.Thread(target=run_primary, daemon=True, name="hedge-primary")
    t.start()
    if done.wait(threshold_s):
        ok, val = box[0]
        if ok:
            return val, "primary", False
        raise val
    tr.count(tele.C_HEDGE_FIRED)
    from adam_tpu_torch.utils import incidents

    incidents.maybe_record(
        "hedge.fired", trace_id=caller_trace or tr.trace, tracer=tr,
        reason="in-flight window exceeded its %.3fs hedge threshold" % threshold_s,
    )
    try:
        hedged = hedge_fn()
    except Exception as e:
        log.warning("hedged re-dispatch failed (%s); waiting out the primary", e)
        tr.count(tele.C_HEDGE_WASTED)
        done.wait()
        ok, val = box[0]
        if ok:
            return val, "primary", True
        raise val
    if done.is_set() and box and box[0][0]:
        tr.count(tele.C_HEDGE_WASTED)
        return box[0][1], "primary", True
    tr.count(tele.C_HEDGE_WON)
    return hedged, "hedge", True


# --------------------------------------------------------------------------
# The streamed kernel set as prewarm entries
# --------------------------------------------------------------------------
def _zeros(shape, dtype, slot, fill=0):
    return torch.full(shape, fill, dtype=dtype, device=slot.device)


def resident_dummy(slot, g: int, gl: int) -> tuple:
    """Dummy resident tensors at grid (g, gl), in kernel-argument order."""
    return (_zeros((g, gl), torch.uint8, slot, schema.BASE_PAD),
            _zeros((g, gl), torch.uint8, slot, schema.QUAL_PAD),
            _zeros((g,), torch.int32, slot), _zeros((g,), torch.int32, slot,
                                                    schema.FLAG_UNMAPPED),
            _zeros((g,), torch.int32, slot, -1))


def markdup_prewarm_entry(b, g: Optional[int] = None) -> tuple:
    """Prewarm entry of pass A's markdup reductions at batch ``b``'s grid
    (``g`` overrides the row grid: the mesh passes its shard's rows)."""
    g = grid_rows(b.n_rows) if g is None else g
    gl = grid_cols(b.lmax)
    gc = grid_cigar_cols(b.cigar_ops.shape[1] if b.cigar_ops.ndim == 2 else 1)

    def warm(slot, g=g, gl=gl, gc=gc):
        from adam_tpu_torch.pipelines.markdup import markdup_columns_local

        bases, quals, lengths, flags, _rg = resident_dummy(slot, g, gl)
        markdup_columns_local(
            _zeros((g,), torch.int64, slot, -1), _zeros((g,), torch.int64, slot, -1),
            flags, _zeros((g, gc), torch.uint8, slot, schema.CIGAR_PAD),
            _zeros((g, gc), torch.int32, slot), _zeros((g,), torch.int32, slot),
            quals, lengths)

    return (("markdup.columns", g, gc, gl), warm)


def observe_prewarm_entry(b, n_rg: int, g: Optional[int] = None) -> tuple:
    """Prewarm entry of pass B's observe (covariate keys + kernel 1) at
    batch ``b``'s grid."""
    g = grid_rows(b.n_rows) if g is None else g
    gl = grid_cols(b.lmax)

    def warm(slot, g=g, gl=gl):
        from adam_tpu_torch.pipelines.bqsr import observe_packed_body

        npk = -(-gl // 8)
        observe_packed_body(*resident_dummy(slot, g, gl),
                            _zeros((g, npk), torch.uint8, slot),
                            _zeros((g, npk), torch.uint8, slot),
                            _zeros((g,), torch.bool, slot), n_rg, gl)

    return (("bqsr.observe_packed", g, gl, n_rg), warm)


def apply_prewarm_entry(b, n_rg: int, n_cyc: int, g: Optional[int] = None) -> tuple:
    """Prewarm entry of pass C's apply + both packs (kernel 2, twice) keyed
    by the solved table's real cycle width."""
    g = grid_rows(b.n_rows) if g is None else g
    gl = grid_cols(b.lmax)

    def warm(slot, g=g, gl=gl):
        from adam_tpu_torch.pipelines.bqsr import N_DINUC, N_QUAL, apply_pack2_body

        apply_pack2_body(*resident_dummy(slot, g, gl),
                         _zeros((g,), torch.bool, slot), _zeros((g,), torch.bool, slot),
                         _zeros((n_rg, N_QUAL, n_cyc, N_DINUC), torch.uint8, slot),
                         gl, g * gl)

    return (("bqsr.apply_pack2", g, gl, n_rg, n_cyc), warm)


def streamed_prewarm_entries(b, n_rg: int, *, mark_duplicates: bool = True,
                             recalibrate: bool = True) -> list:
    """The kernel set the streamed run dispatches at batch ``b``'s grid:
    pass A's markdup reductions, pass B's observe and pass C's apply + pack
    at the width window ``b`` would solve (``2*gl + 1``; pass C warms again
    at the solved table's real width)."""
    gl = grid_cols(b.lmax)
    entries = []
    if mark_duplicates:
        entries.append(markdup_prewarm_entry(b))
    if recalibrate:
        entries.append(observe_prewarm_entry(b, n_rg))
        entries.append(apply_prewarm_entry(b, n_rg, 2 * gl + 1))
    return entries


# --------------------------------------------------------------------------
# The realign sweep fan-out
# --------------------------------------------------------------------------
_PROBE_TFLOPS: dict = {}
_PROBE_LOCK = threading.Lock()


def probe_device_tflops(slot) -> float:
    """One small timed f32 matmul on ``slot`` -> TFLOP/s (best of 3, cached
    per slot key): only the relative speed of the slots matters."""
    slot = as_slot(slot)
    with _PROBE_LOCK:
        got = _PROBE_TFLOPS.get(slot.key)
    if got is not None:
        return got
    try:
        n = 1024
        with slot.scope():
            a = torch.ones((n, n), dtype=torch.float32, device=slot.device)
            a @ a
            slot.synchronize()
            best = float("inf")
            for _ in range(3):
                t0 = time.monotonic()
                a @ a
                slot.synchronize()
                best = min(best, max(time.monotonic() - t0, 1e-9))
        tf = 2 * n ** 3 / best / 1e12
    except Exception:
        return 0.0  # not cached: the next schedule probes again
    with _PROBE_LOCK:
        _PROBE_TFLOPS[slot.key] = tf
    return tf


def sweep_weights(slots) -> list:
    """Relative throughput weight per slot for the sweep scheduler:
    ``ADAM_TPU_SWEEP_TFLOPS`` (comma floats, entry k weights slot id k,
    ids past the list take the mean; a malformed value gives equal
    weights), then a one-time matmul probe on card slots, then equal
    weights (CPU slots are symmetric)."""
    n = len(slots)
    raw = os.environ.get("ADAM_TPU_SWEEP_TFLOPS", "").strip()
    if raw:
        try:
            vals = [float(v) for v in raw.split(",") if v.strip()]
            if vals and all(v > 0 for v in vals):
                mean = sum(vals) / len(vals)
                out = []
                for i, s in enumerate(slots):
                    sid = getattr(s, "id", i)
                    out.append(vals[sid] if isinstance(sid, int) and 0 <= sid < len(vals)
                               else mean)
                return out
        except ValueError:
            pass
        log.warning("ADAM_TPU_SWEEP_TFLOPS=%r is not a comma list of positive "
                    "floats; using equal weights", raw)
        return [1.0] * n
    if any(getattr(s, "platform", "cpu") != "cpu" for s in slots):
        probed = [probe_device_tflops(s) for s in slots]
        if all(v > 0 for v in probed):
            return probed
    return [1.0] * n


class SweepSchedule:
    """Deterministic deficit round-robin over a slot set: chunk ``k`` goes
    to the slot with the largest credit (weight share x chunks seen -
    chunks assigned).  Equal weights are plain round-robin.  Placement
    never changes a sweep's values."""

    def __init__(self, devices, weights=None):
        self.devices = list(devices)
        w = list(weights) if weights is not None else sweep_weights(self.devices)
        total = sum(w) or 1.0
        self._share = [v / total for v in w]
        self._credit = [0.0] * len(self.devices)

    def next_device(self):
        for i, s in enumerate(self._share):
            self._credit[i] += s
        i = max(range(len(self._credit)), key=lambda k: self._credit[k])
        self._credit[i] -= 1.0
        return self.devices[i]
