"""The port's device pool against ``adam_tpu/parallel/device_pool.py``
(``tests/test_device_pool.py``): the device count's resolution and cap,
round-robin placement over slots, the prewarm (once per slot, a failure
that degrades and stays retryable), span attribution, eviction and replay,
``AllDevicesEvicted`` raising, and a two-slot pool on the CPU writing the
parts, the observation table and the flagstat of JAX's ``devices=2`` run
and of the port's one-device run.  ``kernels.launch`` runs on the device
and stream of its tensors (a monkeypatched ctypes call)."""

import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from adam_tpu_torch.parallel import device_pool as dp
from adam_tpu_torch.utils import faults as tf
from adam_tpu_torch.utils import telemetry as tele

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

WINDOW = 512
JAX_ENV = {"ADAM_TPU_BQSR_BACKEND": "device", "ADAM_TPU_RESIDENT": "1"}


def _parts(d) -> dict:
    return {f: (pathlib.Path(d) / f).read_bytes()
            for f in sorted(os.listdir(d)) if f.startswith("part-")}


def _cpu_pool(n=2):
    return dp.DevicePool(dp.make_slots(["cpu"] * n))


# --------------------------------------------------------------------------
# the device count
# --------------------------------------------------------------------------
def test_resolve_device_count_env_and_cap(monkeypatch):
    """The card count is ``torch.cuda.device_count()`` (8 here, as JAX's 8
    virtual devices): explicit beats env, beyond-topology caps, malformed
    env values degrade to all attached, only an explicit < 1 raises — the
    JAX function's answers, case for case.  The CPU is one device."""
    import jax

    from adam_tpu.parallel import device_pool as jdp

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert len(jax.devices()) == 8
    monkeypatch.delenv("ADAM_TPU_DEVICES", raising=False)
    cases = [None, 2, 13]
    for env in (None, "3", "not-an-int", "0", "-3"):
        if env is None:
            monkeypatch.delenv("ADAM_TPU_DEVICES", raising=False)
        else:
            monkeypatch.setenv("ADAM_TPU_DEVICES", env)
        for req in cases:
            assert dp.resolve_device_count(req) == jdp.resolve_device_count(req), (env, req)
    with pytest.raises(ValueError, match="devices"):
        dp.resolve_device_count(0)
    monkeypatch.delenv("ADAM_TPU_DEVICES", raising=False)
    assert dp.resolve_device_count(4, "cpu") == 1
    assert dp.resolve_device_count(None, "cpu") == 1


def test_make_pool_single_device_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dp.make_pool(1) is None
    assert dp.make_pool(4) is None  # capped at the one card
    assert dp.make_pool(2, "cpu") is None
    pool = _cpu_pool(4)
    assert pool.n == 4
    # round-robin: window i -> slot i % n
    assert [pool.device_index(i) for i in range(6)] == [0, 1, 2, 3, 0, 1]
    assert pool.device(5) is pool.devices[1]


def test_slots_are_distinct_objects_keyed_apart():
    """Two slots on one device are two pool entries: distinct objects,
    distinct keys (the prewarm cache, the eviction set and the health
    board key by slot, never by ``torch.device``)."""
    slots = dp.make_slots(["cpu", "cpu"])
    assert slots[0] is not slots[1] and slots[0].device == slots[1].device
    assert slots[0].key != slots[1].key
    assert [s.id for s in slots] == [0, 1]
    with pytest.raises(ValueError, match="distinct"):
        dp.DevicePool([slots[0], slots[0]])
    assert dp.solo_slot("cpu").key == "default"


def test_pool_put_commits_to_round_robin_device():
    pool = _cpu_pool(3)
    tele.TRACE.reset()
    tele.TRACE.recording = True
    try:
        for i in range(4):
            t = pool.put(np.arange(8), i)
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            assert t.tolist() == list(range(8))
        snap = tele.TRACE.snapshot()
    finally:
        tele.TRACE.recording = False
        tele.TRACE.reset()
    # each placement is booked in the h2d ledger against its slot's id
    per_dev = snap["transfers"]["h2d"]
    assert {k: sum(e["bytes"] for e in v.values()) for k, v in per_dev.items()} == {
        "0": 128, "1": 64, "2": 64}


# --------------------------------------------------------------------------
# prewarm
# --------------------------------------------------------------------------
def test_prewarm_compiles_each_shape_once_per_device():
    dp.reset_prewarm_cache()
    try:
        pool = _cpu_pool(4)
        calls: list = []

        def make(key):
            def fn(slot):
                calls.append((key, slot.id))
            return (key, fn)

        entries = [make(("k1", 1024, 128)), make(("k2", 1024, 128))]
        tr = tele.Tracer(recording=True)
        n = pool.prewarm(entries, tracer=tr)
        assert n == 2 * pool.n
        assert sorted(calls) == sorted((key, s.id) for key, _fn in entries
                                       for s in pool.devices)
        snap = tr.snapshot()
        assert snap["spans"][tele.SPAN_POOL_PREWARM_COMPILE]["count"] == n
        assert set(snap["device_spans"][tele.SPAN_POOL_PREWARM_COMPILE]) == {
            str(k) for k in range(pool.n)}
        assert snap["counters"][tele.C_POOL_PREWARM_COMPILES] == n
        calls.clear()
        assert pool.prewarm(entries, tracer=tr) == 0 and calls == []
        # a new pool's slots with the same keys are warm too ...
        assert _cpu_pool(4).prewarm(entries, tracer=tr) == 0
        # ... but a slot the first pool did not cover is not
        assert _cpu_pool(5).prewarm(entries, tracer=tr) == 2
    finally:
        dp.reset_prewarm_cache()


def test_prewarm_failure_degrades_and_stays_retryable(monkeypatch):
    """A failed prewarm does not abort (it is an optimization), retries in
    place through the ``pool.prewarm`` fault site, and on a spent budget
    forgets its claim so a later prewarm runs it again."""
    monkeypatch.setenv("ADAM_TPU_RETRY_BACKOFF_S", "0.001")
    dp.reset_prewarm_cache()
    try:
        pool = _cpu_pool(2)
        runs: list = []
        entries = [(("k", 1), lambda slot: runs.append(slot.id))]
        tf.install("pool.prewarm=permanent,device=1")
        try:
            assert pool.prewarm(entries) == 1
        finally:
            tf.clear()
        assert runs == [0]
        assert pool.prewarm(entries) == 1  # the failed slot's claim was dropped
        assert sorted(runs) == [0, 1]
        # a transient failure is retried in place and succeeds
        dp.reset_prewarm_cache()
        runs.clear()
        tf.install("pool.prewarm=transient,times=1")
        try:
            assert pool.prewarm(entries) == 2
        finally:
            tf.clear()
        assert sorted(runs) == [0, 1]
    finally:
        dp.reset_prewarm_cache()


def test_streamed_prewarm_entries_execute():
    """The entries' dummy launches run the real bodies at the window's grid
    on every slot (a signature drift would raise here)."""
    from adam_tpu_torch.formats.batch import pack_reads

    recs = [dict(name=f"r{i}", flags=0, contig_idx=0, start=100 + i, mapq=60,
                 cigar="10M", seq="ACGTACGTAC", qual="I" * 10, read_group_idx=0)
            for i in range(4)]
    batch, _side = pack_reads(recs)
    dp.reset_prewarm_cache()
    try:
        entries = dp.streamed_prewarm_entries(batch.to_numpy(), 2)
        assert [k[0] for k, _fn in entries] == [
            "markdup.columns", "bqsr.observe_packed", "bqsr.apply_pack2"]
        assert _cpu_pool(2).prewarm(entries) == len(entries) * 2
    finally:
        dp.reset_prewarm_cache()


# --------------------------------------------------------------------------
# parity: the port's two-slot pool against JAX's devices=2 and one device
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def parity_runs(tmp_path_factory):
    from make_wgs_sam import make_wgs

    from adam_tpu.pipelines.streamed import transform_streamed as jax_transform

    from adam_tpu_torch.pipelines.streamed import transform_streamed
    from adam_tpu_torch.utils import compile_ledger

    d = tmp_path_factory.mktemp("device_pool")
    path = str(d / "in.sam")
    make_wgs(path, 2048, 100, n_contigs=2, contig_len=30_000,
             indel_every=800, snp_every=400)
    old = {k: os.environ.get(k) for k in JAX_ENV}
    os.environ.update(JAX_ENV)
    try:
        jax_transform(path, str(d / "jax2"), window_reads=WINDOW, devices=2,
                      dump_observations=str(d / "jax2.csv"))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    runs = {}
    for name, kw in (("one", {}), ("pool2", {"device_pool": _cpu_pool(2)})):
        # each run's first launches are its own (the caches are process-wide)
        dp.reset_prewarm_cache()
        compile_ledger.reset()
        tele.TRACE.reset()
        tele.TRACE.recording = True
        try:
            stats = transform_streamed(path, str(d / name), window_reads=WINDOW,
                                       dump_observations=str(d / f"{name}.csv"),
                                       device="cpu", **kw)
            snap = tele.TRACE.snapshot()
        finally:
            tele.TRACE.recording = False
            tele.TRACE.reset()
        runs[name] = (stats, snap)
    return d, runs


def test_streamed_device_pool_parts_bit_identical(parity_runs):
    d, runs = parity_runs
    one, pool2, jax2 = _parts(d / "one"), _parts(d / "pool2"), _parts(d / "jax2")
    assert len(one) >= 4
    assert pool2 == one == jax2
    assert runs["pool2"][0]["n_devices"] == 2 and runs["one"][0]["n_devices"] == 1


def test_streamed_device_pool_recal_table_identical(parity_runs):
    d, _ = parity_runs
    t1 = (d / "one.csv").read_text()
    assert len(t1.splitlines()) > 1
    assert (d / "pool2.csv").read_text() == t1 == (d / "jax2.csv").read_text()


def test_streamed_device_pool_flagstat_identical(parity_runs):
    from adam_tpu_torch.io import context
    from adam_tpu_torch.ops.flagstat import flagstat, format_flagstat

    d, _ = parity_runs
    fs1 = format_flagstat(*flagstat(context.load_alignments(str(d / "one")).batch,
                                    device="cpu"))
    fs2 = format_flagstat(*flagstat(context.load_alignments(str(d / "pool2")).batch,
                                    device="cpu"))
    assert fs1 == fs2 and "in total" in fs1


def test_streamed_device_pool_telemetry(parity_runs):
    """The pool run reports its fan-out, prewarms each shape once per slot
    (outside the windows: no in-window first launch), attributes its
    dispatches to the two slots and splits the windows between them."""
    _, runs = parity_runs
    stats, snap = runs["pool2"]
    assert stats["n_devices"] == 2 and stats["partitioner"] == "pool"
    assert 0 < stats["prewarm_s"] <= stats["total_s"]
    assert snap["gauges"][tele.G_POOL_DEVICES]["last"] == 2
    assert snap["counters"].get(tele.C_COMPILE_IN_WINDOW, 0) == 0
    assert snap["counters"][tele.C_POOL_PREWARM_COMPILES] > 0
    per_slot = snap["device_spans"][tele.SPAN_POOL_PREWARM_COMPILE]
    assert set(per_slot) == {"0", "1"} and per_slot["0"]["count"] == per_slot["1"]["count"]
    assert tele.SPAN_POOL_PREWARM in snap["spans"]
    assert tele.SPAN_POOL_PREWARM_C in snap["spans"]
    disp = snap["device_spans"][tele.SPAN_APPLY_DISPATCH]
    assert set(disp) == {"0", "1"}
    assert snap["counters"][tele.C_RESIDENT_WINDOWS] == snap["counters"][
        tele.C_RESIDENT_RELEASED]
    # the one-device run prewarms nothing and records its first launches
    # in the windows, as JAX's single-device path does
    one = runs["one"][1]
    assert tele.SPAN_POOL_PREWARM not in one["spans"]
    assert one["counters"][tele.C_COMPILE_IN_WINDOW] == one["counters"][
        tele.C_COMPILE_MISSES] > 0


# --------------------------------------------------------------------------
# attribution, eviction and replay
# --------------------------------------------------------------------------
def test_span_attrs_mark_replay_scope():
    slot = dp.make_slots(["cpu"])[0]
    base = dp.span_attrs(slot)
    assert base == {"device": 0}
    with dp.replay_scope():
        assert dp.span_attrs(slot) == {"device": 0, "replay": 1}
        with dp.replay_scope():
            assert dp.span_attrs(slot)["replay"] == 1
        assert dp.in_replay()
        # the single-device path stays attribution-free even mid-replay
        assert dp.span_attrs(None) == {} and dp.span_attrs(dp.solo_slot("cpu")) == {}
    assert not dp.in_replay()


def test_device_spans_after_evict_keep_original_and_split_replay():
    pool = _cpu_pool(2)
    tr = tele.Tracer(recording=True)
    s0, s1 = pool.devices
    with tr.span(tele.SPAN_APPLY_DISPATCH, window=0, **dp.span_attrs(s0)):
        pass
    with tr.span(tele.SPAN_APPLY_DISPATCH, window=1, **dp.span_attrs(s1)):
        pass
    try:
        assert pool.evict(s1, reason="test", tracer=tr)
        assert not pool.evict(s1, reason="again", tracer=tr)
        with tr.span(tele.SPAN_POOL_REPLAY, window=1, **dp.span_attrs(s1)), \
                dp.replay_scope():
            with tr.span(tele.SPAN_APPLY_DISPATCH, window=1, **dp.span_attrs(s0)):
                pass
    finally:
        tf.clear()  # resets the health board the eviction marked
    snap = tr.snapshot()
    disp = snap["device_spans"][tele.SPAN_APPLY_DISPATCH]
    assert disp["0"]["count"] == 1 and disp["1"]["count"] == 1
    assert disp["0:replay"]["count"] == 1
    assert snap["device_spans"][tele.SPAN_POOL_REPLAY]["1"]["count"] == 1
    assert snap["counters"][tele.C_DEVICE_EVICTED] == 1
    assert pool.alive_devices() == [s0]
    assert pool.device(7) is s0


@pytest.fixture
def small_sam(tmp_path):
    from make_wgs_sam import make_wgs

    path = str(tmp_path / "in.sam")
    make_wgs(path, 2048, 100, n_contigs=1, contig_len=20_000, indel_every=700)
    return path


def test_evict_and_replay_bit_identical(small_sam, tmp_path, monkeypatch):
    """A permanent dispatch fault on slot 1: slot 1 is evicted, its window
    replays on slot 0 under a ``device.pool.replay`` span, and the parts
    are the bytes of a clean run."""
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    monkeypatch.setenv("ADAM_TPU_RETRY_BACKOFF_S", "0.001")
    transform_streamed(small_sam, str(tmp_path / "clean"), window_reads=WINDOW,
                       device="cpu")
    tf.install("device.dispatch=permanent,device=1,times=1")
    tele.TRACE.reset()
    tele.TRACE.recording = True
    try:
        stats = transform_streamed(small_sam, str(tmp_path / "faulted"),
                                   window_reads=WINDOW, device="cpu",
                                   device_pool=_cpu_pool(2))
        snap = tele.TRACE.snapshot()
    finally:
        tele.TRACE.recording = False
        tele.TRACE.reset()
        tf.clear()
    assert _parts(tmp_path / "faulted") == _parts(tmp_path / "clean")
    assert snap["counters"][tele.C_DEVICE_EVICTED] == 1
    assert snap["counters"][tele.C_FAULT_INJECTED] == 1
    assert stats["n_devices"] == 2
    # the replay: an umbrella span on the failed slot, the replayed
    # dispatch under the survivor's replay key
    assert snap["device_spans"][tele.SPAN_POOL_REPLAY] == {
        "1": snap["device_spans"][tele.SPAN_POOL_REPLAY]["1"]}
    assert "0:replay" in snap["device_spans"][tele.SPAN_MD_COLUMNS]


def test_all_devices_evicted_raises(small_sam, tmp_path, monkeypatch):
    """Losing every slot raises ``AllDevicesEvicted``: the port never
    carries on on the CPU (JAX falls back to its host backend there), and
    no part is published."""
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    monkeypatch.setenv("ADAM_TPU_RETRY_BACKOFF_S", "0.001")
    tf.install("device.dispatch=permanent")
    try:
        with pytest.raises(dp.AllDevicesEvicted, match="evicted"):
            transform_streamed(small_sam, str(tmp_path / "out"), window_reads=WINDOW,
                               device="cpu", device_pool=_cpu_pool(2))
    finally:
        tf.clear()
    assert _parts(tmp_path / "out") == {}
    # the pool object itself refuses placement once every slot is gone
    pool = _cpu_pool(2)
    for s in list(pool.devices):
        pool.evict(s, reason="test")
    tf.clear()
    with pytest.raises(dp.AllDevicesEvicted):
        pool.device(0)


# --------------------------------------------------------------------------
# hedging and the sweep schedule's weights
# --------------------------------------------------------------------------
def test_hedged_call_first_result_wins():
    import threading

    tr = tele.Tracer(recording=True)
    got = dp.hedged_call(lambda: 1, lambda: 2, 5.0, tracer=tr)
    assert got == (1, "primary", False)
    release = threading.Event()

    def slow():
        release.wait(5)
        return "primary"

    got = dp.hedged_call(slow, lambda: "hedge", 0.01, tracer=tr)
    release.set()
    assert got == ("hedge", "hedge", True)
    c = tr.snapshot()["counters"]
    assert c[tele.C_HEDGE_FIRED] == 1 and c[tele.C_HEDGE_WON] == 1


def test_pool_lease_is_the_pool_interface():
    pool = _cpu_pool(2)
    lease = pool.lease(job="j1")
    assert lease.devices is pool.devices and lease.n == 2
    assert lease.device(1) is pool.device(1)
    assert pool.active_leases() == [lease]
    lease.release()
    lease.release()
    assert lease.released and pool.active_leases() == []


# --------------------------------------------------------------------------
# the launch repair: a kernel runs on its tensors' device and stream
# --------------------------------------------------------------------------
def test_launch_uses_the_tensors_device_and_stream(monkeypatch):
    """``kernels.launch`` hands the ctypes call the stream of the device
    that holds the tensors (made current for the call), not the stream of
    the caller's current device; it counts the launch in total, per device
    and per slot.  The CUDA runtime is a fake here (no card)."""
    import contextlib

    from adam_tpu_torch.ops import kernels

    current = {"dev": 0}
    seen = {}

    @contextlib.contextmanager
    def fake_device(d):
        prev = current["dev"]
        current["dev"] = torch.device(d).index
        try:
            yield
        finally:
            current["dev"] = prev

    class FakeStream:
        def __init__(self, idx):
            self.cuda_stream = 1000 + idx

    def fake_current_stream(device=None):
        idx = current["dev"] if device is None else torch.device(device).index
        seen.setdefault("asked", []).append((idx, current["dev"]))
        return FakeStream(idx)

    class FakeLib:
        def observe_hist_launch(self, *args):
            seen["args"] = args
            seen["dev_at_call"] = current["dev"]
            return 0

    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(torch.cuda, "current_stream", fake_current_stream)
    monkeypatch.setattr(kernels, "library", lambda name: FakeLib())
    kernels.reset_launches()
    with fake_device("cuda:0"), kernels.slot_scope(1):
        kernels.launch("observe_hist", 11, 22, device=torch.device("cuda", 1))
    assert seen["args"] == (11, 22, 1001)       # cuda:1's stream, not cuda:0's
    assert seen["dev_at_call"] == 1             # with cuda:1 made current
    assert all(idx == cur == 1 for idx, cur in seen["asked"])
    assert kernels.launches()["observe_hist"] == 1
    assert kernels.device_launches() == {"observe_hist": {"cuda:1": 1}}
    assert kernels.slot_launches() == {"observe_hist": {1: 1}}
    kernels.reset_launches()
    assert kernels.device_launches() == {} and kernels.launches()["observe_hist"] == 0


def test_prewarm_launches_count_apart(monkeypatch):
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.utils import compile_ledger

    monkeypatch.setattr(kernels, "_stream_handle", lambda device: 7)
    monkeypatch.setattr(torch.cuda, "device", lambda d: __import__("contextlib").nullcontext())

    class FakeLib:
        def pack_rows_launch(self, *args):
            return 0

    monkeypatch.setattr(kernels, "library", lambda name: FakeLib())
    kernels.reset_launches()
    with compile_ledger.prewarm_scope():
        kernels.launch("pack_rows", 1, device=torch.device("cuda", 0))
    kernels.launch("pack_rows", 1, device=torch.device("cuda", 0))
    assert kernels.launches()["pack_rows"] == 1
    assert kernels.prewarm_launches()["pack_rows"] == 1
    kernels.reset_launches()
