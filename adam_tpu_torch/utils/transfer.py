"""Device->host fetches: the port's counterpart of
``adam_tpu/utils/transfer.py``.

:func:`device_fetch` brings a tensor home.  On the card it copies into
pinned host memory with ``non_blocking=True`` on the stream of the slot
that produced the tensor, in row chunks of at least 8 MiB queued back to
back, then waits on one event recorded after the last chunk: the caller's
thread blocks only on this tensor's work, never on another slot's stream.

Every fetch is also a resilience boundary, as in JAX:

* the ``device.fetch`` fault point, and its data channel: a ``corrupt``
  clause flips one bit of the fetched array
  (``utils/faults.corrupt_array``), which the SDC audit must catch;
* a deadline watchdog (``ADAM_TPU_FETCH_TIMEOUT_S``, default 300 s, ``0``
  turns it off): a hung copy surfaces as a retryable
  :class:`~adam_tpu_torch.utils.retry.DeadlineExceeded`;
* a retry with backoff for transient failures; the retries and timeouts
  feed the slot's health score;
* the ``device.d2h.bytes`` ledger and the ``device.fetch.seconds``
  histogram, when recording is on.

A numpy array returns as it is, with none of it; a CPU tensor goes
through the same fault point, watchdog and ledger (the CPU slots of the
tests), its copy being a plain ``numpy()``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from adam_tpu_torch.utils import faults
from adam_tpu_torch.utils import retry as retry_mod

_MIN_CHUNK_BYTES = 8 * 1024 * 1024
_DEFAULT_FETCH_TIMEOUT_S = 300.0


def _fetch_timeout_s() -> float:
    """The fetch deadline (seconds; <= 0 turns the watchdog off)."""
    return retry_mod.env_float("ADAM_TPU_FETCH_TIMEOUT_S", _DEFAULT_FETCH_TIMEOUT_S)


def attribution(x, slot=None):
    """The ``device=`` attribution of a fetch: the slot's id, else the
    tensor's device key (``"0"`` for ``cuda:0``, ``"cpu"``)."""
    if slot is not None:
        return getattr(slot, "id", slot)
    from adam_tpu_torch.device import device_key

    return device_key(x.device)


def _copy_home(x: torch.Tensor, stream) -> np.ndarray:
    """One fetch attempt's copy (module docstring)."""
    if x.device.type != "cuda":
        return x.detach().numpy()
    src = x.detach()
    out = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    with torch.cuda.device(src.device), torch.cuda.stream(stream):
        n = src.shape[0] if src.dim() else 0
        nbytes = src.numel() * src.element_size()
        chunks = max(1, min(n, nbytes // _MIN_CHUNK_BYTES)) if n else 1
        if chunks <= 1:
            out.copy_(src, non_blocking=True)
        else:
            bounds = [n * i // chunks for i in range(chunks + 1)]
            for i in range(chunks):
                out[bounds[i]:bounds[i + 1]].copy_(src[bounds[i]:bounds[i + 1]],
                                                   non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return out.numpy()


def device_fetch(x, slot=None, deadline_s: float | None = None,
                 threads: int | None = None) -> np.ndarray:
    """Fetch a tensor to host numpy (module docstring).  ``slot`` is the
    pool slot whose stream produced ``x`` (default: the stream current on
    ``x``'s device in the calling thread); ``deadline_s`` overrides
    ``ADAM_TPU_FETCH_TIMEOUT_S`` for this call.  ``threads`` is taken for
    JAX's call and has no effect: JAX sizes a pool of blocking chunk
    fetches with it, while here the chunks are asynchronous copies on one
    stream, so there is no pool to size (nor is ``ADAM_TPU_FETCH_THREADS``
    read)."""
    if isinstance(x, np.ndarray):
        return x
    from adam_tpu_torch.utils import telemetry as tele

    timeout = _fetch_timeout_s() if deadline_s is None else deadline_s
    pass_name = tele.current_pass()
    dev_attr = attribution(x, slot)
    stream = None
    if x.device.type == "cuda":
        stream = getattr(slot, "stream", None) or torch.cuda.current_stream(x.device)

    def once():
        faults.point("device.fetch", device=dev_attr, pass_name=pass_name)
        got = _copy_home(x, stream)
        return faults.corrupt_array("device.fetch", got, device=dev_attr,
                                    pass_name=pass_name)

    def attempt():
        if timeout and timeout > 0:
            return retry_mod.call_with_deadline(once, timeout, site="device.fetch")
        return once()

    def retryable(e: BaseException) -> bool:
        ok = retry_mod.is_retryable(e)
        if ok and slot is not None:
            from adam_tpu_torch.utils import health as health_mod

            if isinstance(e, retry_mod.DeadlineExceeded):
                health_mod.BOARD.note_timeout(slot, site="device.fetch")
            else:
                health_mod.BOARD.note_retry(slot, site="device.fetch")
        return ok

    if not tele.TRACE.recording:
        return retry_mod.retry_call(attempt, site="device.fetch", retryable=retryable)
    t0 = time.monotonic()
    out = None
    try:
        out = retry_mod.retry_call(attempt, site="device.fetch", retryable=retryable)
        return out
    finally:
        dur = time.monotonic() - t0
        tele.TRACE.observe(tele.H_FETCH_SECONDS, dur)
        if out is not None:
            tele.TRACE.record_transfer("d2h", out.nbytes, dur, device=dev_attr,
                                       pass_name=pass_name)
