"""The port's retry, fetch and compile-ledger layers against
``adam_tpu/utils/{retry,transfer,compile_ledger}.py``: ``retry_call``'s
backoff and jitter sleeps equal to JAX's for a seed, the retryable
classification (a CUDA error that may poison the context is not retried on
the same card), the deadline watchdog, ``device_fetch``'s fault point,
corruption channel and d2h ledger, and the compile ledger's hit / miss /
in-window counts for one dispatch sequence."""

import threading
import time

import numpy as np
import pytest
import torch

from adam_tpu_torch.utils import compile_ledger as tcl
from adam_tpu_torch.utils import faults as tf
from adam_tpu_torch.utils import retry as tr
from adam_tpu_torch.utils import telemetry as tele
from adam_tpu_torch.utils import transfer as tx


@pytest.mark.parametrize("jitter,seed", [(0.0, 0), (0.5, 0), (0.5, 9), (1.0, 3)])
def test_retry_call_sleeps_equal_jax(monkeypatch, jitter, seed):
    """Five transient failures, then success: both packages sleep the same
    backoff schedule (doubling, capped, stretched by the seeded jitter)."""
    from adam_tpu.utils import faults as jf
    from adam_tpu.utils import retry as jr

    schedules = []
    for mod, faults in ((jr, jf), (tr, tf)):
        sleeps = []
        monkeypatch.setattr(mod.time, "sleep", sleeps.append)
        policy = mod.RetryPolicy(attempts=6, backoff_s=0.05, max_backoff_s=0.3,
                                 jitter=jitter, jitter_seed=seed)
        calls = []

        def flaky(faults=faults, calls=calls):
            calls.append(1)
            if len(calls) < 6:
                raise faults.TransientFault("x")
            return "ok"

        assert mod.retry_call(flaky, site="device.fetch", policy=policy) == "ok"
        schedules.append(sleeps)
    assert schedules[0] == schedules[1] and len(schedules[1]) == 5
    for a in range(1, 4):
        assert tr.jitter_factor("s", a, seed=seed, amount=jitter) == __import__(
            "adam_tpu.utils.retry", fromlist=["x"]).jitter_factor("s", a, seed=seed,
                                                                   amount=jitter)


def test_retry_call_spends_its_budget_then_raises(monkeypatch):
    monkeypatch.setattr(tr.time, "sleep", lambda s: None)
    calls = []

    def always():
        calls.append(1)
        raise tf.TransientFault("x")

    with pytest.raises(tf.TransientFault):
        tr.retry_call(always, site="s", policy=tr.RetryPolicy(attempts=3))
    assert len(calls) == 3
    calls.clear()

    def permanent():
        calls.append(1)
        raise tf.PermanentFault("x")

    with pytest.raises(tf.PermanentFault):
        tr.retry_call(permanent, site="s", policy=tr.RetryPolicy(attempts=3))
    assert len(calls) == 1


def test_is_retryable_treats_a_cuda_error_as_final():
    class AcceleratorError(RuntimeError):
        pass

    assert tr.is_retryable(tf.TransientFault("x"))
    assert tr.is_retryable(tr.DeadlineExceeded("x"))
    assert tr.is_retryable(ConnectionResetError())
    assert not tr.is_retryable(tf.PermanentFault("x"))
    assert not tr.is_retryable(AcceleratorError("CUDA error: an illegal memory access"))
    assert not tr.is_retryable(RuntimeError("CUDA error: unspecified launch failure"))
    assert not tr.is_retryable(RuntimeError("CUDA kernel observe_hist failed to launch "
                                            "(cudaError 700)"))
    assert not tr.is_retryable(ValueError("a real bug"))


def test_cancel_event_cuts_backoff_short():
    ev = threading.Event()
    ev.set()
    tr.set_cancel_event(ev)
    try:
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise tf.TransientFault("x")
            return 1

        t0 = time.monotonic()
        tr.retry_call(flaky, site="s", policy=tr.RetryPolicy(attempts=3, backoff_s=5.0))
        assert time.monotonic() - t0 < 2.0
    finally:
        tr.clear_cancel_event(ev)
    assert tr.cancel_event() is None


def test_call_with_deadline():
    assert tr.call_with_deadline(lambda: 3, 1.0, site="s") == 3
    with pytest.raises(ZeroDivisionError):
        tr.call_with_deadline(lambda: 1 / 0, 1.0, site="s")
    with pytest.raises(tr.DeadlineExceeded, match="deadline"):
        tr.call_with_deadline(lambda: time.sleep(2), 0.05, site="s")
    assert tr.call_with_deadline(lambda: 4, 0, site="s") == 4


def test_device_fetch_watchdog_retries_then_raises(monkeypatch):
    """A hung copy becomes a DeadlineExceeded per attempt, retried to the
    budget, each trip scored against the slot on the health board."""
    from adam_tpu_torch.parallel import device_pool as dp
    from adam_tpu_torch.utils import health as th

    monkeypatch.setenv("ADAM_TPU_RETRY_ATTEMPTS", "2")
    monkeypatch.setenv("ADAM_TPU_RETRY_BACKOFF_S", "0.001")
    slot = dp.make_slots(["cpu"])[0]
    monkeypatch.setattr(tx, "_copy_home", lambda x, stream: time.sleep(1.0))
    try:
        with pytest.raises(tr.DeadlineExceeded):
            tx.device_fetch(torch.arange(4), slot, deadline_s=0.05)
        assert th.BOARD.status()[slot.key]["signals"]["timeout"] == 1
    finally:
        th.reset_board()


def test_device_fetch_corrupts_and_books_the_ledger():
    x = torch.arange(16, dtype=torch.int64)
    np.testing.assert_array_equal(tx.device_fetch(x), np.arange(16))
    a = np.arange(3)
    assert tx.device_fetch(a) is a  # a host array crosses no device link
    tele.TRACE.reset()
    tele.TRACE.recording = True
    tf.install("device.fetch=corrupt,seed=2,times=1")
    try:
        bad = tx.device_fetch(x)
        good = tx.device_fetch(x)
        snap = tele.TRACE.snapshot()
    finally:
        tf.clear()
        tele.TRACE.recording = False
        tele.TRACE.reset()
    assert (bad != np.arange(16)).sum() == 1
    np.testing.assert_array_equal(good, np.arange(16))
    assert snap["counters"][tele.C_D2H_BYTES] == 2 * 16 * 8
    assert snap["counters"][tele.C_FAULT_INJECTED] == 1
    assert snap["histograms"][tele.H_FETCH_SECONDS]["count"] == 2


def test_device_fetch_transient_fault_is_retried(monkeypatch):
    monkeypatch.setenv("ADAM_TPU_RETRY_BACKOFF_S", "0.001")
    tf.install("device.fetch=transient,times=2")
    try:
        np.testing.assert_array_equal(tx.device_fetch(torch.arange(3)), np.arange(3))
    finally:
        tf.clear()


def test_compile_ledger_counts_equal_jax():
    """One dispatch sequence (a prewarmed key, an in-window first launch, a
    repeat, a raising dispatch that hands its claim back, a claim) gives
    the same hit / miss / in-window counts in both ledgers."""
    from adam_tpu.utils import compile_ledger as jcl
    from adam_tpu.utils import telemetry as jt

    counts = []
    for cl, telem, dev in ((jcl, jt, None), (tcl, tele, None)):
        cl.reset()
        telem.TRACE.reset()
        telem.TRACE.recording = True
        try:
            with cl.prewarm_scope(), cl.track(("k", 1), dev):
                pass
            with cl.track(("k", 1), dev):
                pass
            with cl.track(("k", 2), dev):
                pass
            with pytest.raises(RuntimeError):
                with cl.track(("k", 3), dev):
                    raise RuntimeError("dispatch died")
            with cl.track(("k", 3), dev):
                pass
            cl.claim(("k", 4), dev)
            with cl.track(("k", 4), dev):
                pass
            c = telem.TRACE.snapshot()["counters"]
            counts.append({k: c.get(k, 0) for k in (
                telem.C_COMPILE_HITS, telem.C_COMPILE_MISSES, telem.C_COMPILE_IN_WINDOW)})
        finally:
            telem.TRACE.recording = False
            telem.TRACE.reset()
            cl.reset()
    assert counts[0] == counts[1] == {"device.compile.cache_hits": 2,
                                      "device.compile.cache_misses": 3,
                                      "device.compile.in_window": 2}


def test_compile_ledger_keys_by_slot_and_route():
    from adam_tpu_torch.parallel import device_pool as dp

    s0, s1 = dp.make_slots(["cpu", "cpu"])
    assert tcl.device_cache_key(None) == "default"
    assert tcl.device_cache_key("mesh:2") == "mesh:2"
    assert tcl.device_cache_key(s0) != tcl.device_cache_key(s1)
    assert tcl.route_of(s0) == "plain"
    assert tcl.route_of(torch.device("cuda", 0)) == "cuda"
