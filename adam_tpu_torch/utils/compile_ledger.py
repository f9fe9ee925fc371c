"""Compile ledger: first-launch accounting at every dispatch site — the
port's counterpart of ``adam_tpu/utils/compile_ledger.py``.

On the TPU a "compile" is an XLA trace and compile of a jit, keyed per
device.  In the port a **compile is the first launch of a (kernel, shape
class, slot)** in the process: that launch pays the lazy ``nvcc`` build or
the shared library's module load (``ops/kernels.library``), CUDA's lazy
module loading on that context, and the caching allocator's first blocks
for that shape class; every later launch of the triple pays none of it.
The key is the prewarm entry's ``(kernel, *grid dims)`` tuple, the slot's
key (``utils/health.device_key``) and the kernel route (``"cuda"`` on the
card, ``"plain"`` on the CPU), so the ledger's notion of warm agrees with
the device pool's prewarm by construction.

* A first dispatch is a **cache miss**: ``device.compile.cache_misses``
  counts it, ``device.compile.seconds`` records its wall and an entry
  lands in the snapshot's ``compiles`` section.  A miss outside a prewarm
  scope also counts ``device.compile.in_window``: a first launch that fell
  inside a timed window instead of the prewarm.
* Every later dispatch is a **cache hit** (``device.compile.cache_hits``).

A dispatch that raises gives its claim back, so the retry measures again.
"""

from __future__ import annotations

import threading
import time

from adam_tpu_torch.utils import telemetry as tele

_SEEN: set = set()
_LOCK = threading.Lock()
_PREWARM_TLS = threading.local()


def reset() -> None:
    """Test hook: forget every launched triple."""
    with _LOCK:
        _SEEN.clear()


class prewarm_scope:
    """Marks the current thread as launching under a prewarm (reentrant):
    a miss inside it is expected, outside it it is in-window."""

    def __enter__(self):
        _PREWARM_TLS.depth = getattr(_PREWARM_TLS, "depth", 0) + 1
        return self

    def __exit__(self, *exc):
        _PREWARM_TLS.depth -= 1
        return False


def in_prewarm() -> bool:
    return getattr(_PREWARM_TLS, "depth", 0) > 0


def device_cache_key(slot) -> str:
    """The slot half of the key: ``"default"`` for the single-device path
    (no pool, no prewarm: its first launch is in-window, and the ledger
    says so), a string as given (the mesh's ``"mesh:<n>"``), else the
    slot's key."""
    if slot is None:
        return "default"
    if isinstance(slot, str):
        return slot
    from adam_tpu_torch.utils.health import device_key

    return device_key(slot)


def route_of(slot) -> str:
    """The kernel route half of the key: ``"cuda"`` for a slot on the
    card, ``"plain"`` on the CPU (the plain PyTorch versions)."""
    dev = getattr(slot, "device", slot)
    return "cuda" if getattr(dev, "type", None) == "cuda" else "plain"


def _key(key: tuple, slot, route) -> tuple:
    return (key, device_cache_key(slot), route if route is not None else route_of(slot))


def claim(key: tuple, slot=None, route=None) -> None:
    """Mark a triple warm without recording anything (the prewarm's
    already-warm path: a faulted dispatch may have handed its claim back
    while the triple stayed warm)."""
    with _LOCK:
        _SEEN.add(_key(key, slot, route))


class track:
    """Context manager for one dispatch: records a hit or a miss against
    the process-wide seen-set (claimed on entry, discarded if the body
    raises).  ``route`` overrides the slot's own (the mesh passes its
    members' route with its ``"mesh:<n>"`` key)."""

    __slots__ = ("_key", "_slot", "_route", "_cache_key", "_t0", "_miss")

    def __init__(self, key: tuple, slot=None, route=None):
        self._key = key
        self._slot = slot
        self._route = route
        self._miss = False

    def __enter__(self):
        self._cache_key = _key(self._key, self._slot, self._route)
        with _LOCK:
            self._miss = self._cache_key not in _SEEN
            _SEEN.add(self._cache_key)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            with _LOCK:
                _SEEN.discard(self._cache_key)
            return False
        if not self._miss:
            tele.TRACE.count(tele.C_COMPILE_HITS)
            return False
        tele.TRACE.record_compile(
            str(self._key[0]), tuple(self._key[1:]), self._cache_key[1],
            time.monotonic() - self._t0, in_window=not in_prewarm(),
        )
        return False
