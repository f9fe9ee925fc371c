"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface (``<name>_launch``), loaded
with ctypes.  The build runs at first use, from the sources in the
checkout, into ``csrc/_build/`` (git-ignored), keyed by a hash of the
source and the flags; :func:`build` starts one ``nvcc`` per missing
library, all at once.  Nothing here is imported or built on a machine
that never launches a kernel: the CPU path never calls :func:`library`.

Every launch goes through :func:`launch`, which counts it, so a run can
show that it went through the kernels (:func:`launches`,
:func:`reset_launches`); a wrapper with modes (``pack_rows``' encodes,
``sw_fill``'s routes) names the mode, counted apart too
(:func:`variant_launches`).  Each launch runs on the device that holds
its tensors (``torch.cuda.device(<it>)``) and on that device's current
stream, which a device-pool slot sets to its own
(``parallel/device_pool.Slot.scope``); the counts are kept per device and
per slot beside the totals (:func:`device_launches`,
:func:`slot_launches`); a launch under a device pool's prewarm counts
apart (:func:`prewarm_launches`), in none of the others.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import shutil
import subprocess
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_BUILD_DIR = os.path.join(_CSRC, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_P = ct.c_void_p
_I = ct.c_int64
_F = ct.c_float
#: kernel name -> argtypes of its C entry ``<name>_launch`` (returns the
#: cudaError_t of the launch as an int)
_SIGNATURES = {
    "observe_hist": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P],
    "pack_rows": [_P, _P, _I, _I, _I, _P, _P, _P, _I, _P],
    "sw_fill": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, ct.c_int, _P, _P, _P, _P],
    "sw_score": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, ct.c_int, _P, _P],
}
KERNELS = tuple(_SIGNATURES)

_LOCK = threading.Lock()
_LIBS: dict = {}
_LAUNCHES = {name: 0 for name in KERNELS}
_VARIANT_LAUNCHES: dict = {}
_DEVICE_LAUNCHES: dict = {}  # (name, "cuda:K") -> launches
_SLOT_LAUNCHES: dict = {}    # (name, slot index) -> launches
_PREWARM_LAUNCHES = {name: 0 for name in KERNELS}
_SLOT_TLS = threading.local()


class slot_scope:
    """Attribute this thread's launches to pool slot ``index`` (reentrant;
    ``parallel/device_pool.Slot.scope`` enters it)."""

    def __init__(self, index):
        self.index = index

    def __enter__(self):
        self.prev = getattr(_SLOT_TLS, "index", None)
        _SLOT_TLS.index = self.index
        return self

    def __exit__(self, *exc):
        _SLOT_TLS.index = self.prev
        return False


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _so_path(name: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(_CSRC, f"{name}.cu"), "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def build(names=KERNELS) -> dict:
    """Compile every named kernel not yet built, one ``nvcc`` each, all
    started together -> {name: seconds spent building (0.0 if cached)}.
    Raises with the compiler's output when any build fails."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        so = _so_path(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(_CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        ), tmp, so, time.monotonic())
    seconds = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, so, t0) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed:\n"
                          + out.decode("utf-8", "replace"))
            continue
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def library(name: str) -> ct.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ct.CDLL(_so_path(name))
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = _SIGNATURES[name]
            fn.restype = ct.c_int
            _LIBS[name] = lib
    return lib


def _stream_handle(device) -> int:
    """The raw ``cudaStream_t`` to launch on for tensors on ``device``:
    that device's current stream, read with the device made current (a
    tensor on ``cuda:1`` must never launch on ``cuda:0``'s stream)."""
    import torch

    with torch.cuda.device(device):
        return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, *args, device, variant: str | None = None) -> None:
    """Call ``<name>_launch(*args, stream)`` with ``device`` (the device of
    the tensors behind ``args``) made current, on its current stream (the
    calling slot's), count the launch (in total, per device and per slot,
    and, where given, the launch of that ``variant``), and raise if the
    launch failed."""
    import torch

    from adam_tpu_torch.utils.compile_ledger import in_prewarm

    with torch.cuda.device(device):
        stream = _stream_handle(device)
        rc = getattr(library(name), f"{name}_launch")(*args, stream)
    prewarm = in_prewarm()
    slot = getattr(_SLOT_TLS, "index", None)
    # the counts are read-modify-writes on shared dicts, and kernels launch
    # from several threads at once (a service's jobs, its coalescer, the
    # realign's overlap work): every update and every read holds the lock
    with _LOCK:
        if prewarm:
            # a device pool's prewarm: counted apart from the main path's work
            _PREWARM_LAUNCHES[name] += 1
        else:
            _LAUNCHES[name] += 1
            dkey = (name, str(device))
            _DEVICE_LAUNCHES[dkey] = _DEVICE_LAUNCHES.get(dkey, 0) + 1
            if slot is not None:
                skey = (name, slot)
                _SLOT_LAUNCHES[skey] = _SLOT_LAUNCHES.get(skey, 0) + 1
            if variant is not None:
                key = f"{name}:{variant}"
                _VARIANT_LAUNCHES[key] = _VARIANT_LAUNCHES.get(key, 0) + 1
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch (cudaError {rc})")


def launches() -> dict:
    """Kernel name -> launches since the last :func:`reset_launches`."""
    with _LOCK:
        return dict(_LAUNCHES)


def variant_launches() -> dict:
    """``"<kernel>:<variant>"`` -> launches since the last reset."""
    with _LOCK:
        return dict(_VARIANT_LAUNCHES)


def device_launches() -> dict:
    """Kernel name -> {device ("cuda:K") -> launches} since the last reset."""
    out: dict = {}
    with _LOCK:
        items = list(_DEVICE_LAUNCHES.items())
    for (name, dev), n in items:
        out.setdefault(name, {})[dev] = n
    return out


def slot_launches() -> dict:
    """Kernel name -> {pool slot index -> launches} since the last reset
    (launches made inside a slot's scope only)."""
    out: dict = {}
    with _LOCK:
        items = list(_SLOT_LAUNCHES.items())
    for (name, slot), n in items:
        out.setdefault(name, {})[slot] = n
    return out


def prewarm_launches() -> dict:
    """Kernel name -> launches made under a device pool's prewarm since
    the last reset (in none of the other counts)."""
    with _LOCK:
        return dict(_PREWARM_LAUNCHES)


def reset_launches() -> None:
    with _LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0
            _PREWARM_LAUNCHES[name] = 0
        _VARIANT_LAUNCHES.clear()
        _DEVICE_LAUNCHES.clear()
        _SLOT_LAUNCHES.clear()
