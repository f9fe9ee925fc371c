"""The port's slot-health board and SDC audit against
``adam_tpu/utils/health.py`` (``tests/test_health.py``): the board's
transitions under one signal sequence on a fake clock, ``audit_due`` and
the hedge threshold equal to JAX's, the known-answer probe, and the audit
in a streamed run: a ``corrupt`` at ``device.fetch`` is caught, the slot
goes to probation and the window replays on another slot (parts the bytes
of a clean run); with no other slot the run raises rather than publish
the CPU's recompute."""

import os
import pathlib
import sys

import pytest

from adam_tpu_torch.parallel import device_pool as dp
from adam_tpu_torch.utils import faults as tf
from adam_tpu_torch.utils import health as th
from adam_tpu_torch.utils import telemetry as tele

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _boards():
    from adam_tpu.utils import health as jh

    jc, tc = _Clock(), _Clock()
    kw = dict(suspect_score=3.0, probation_score=6.0, decay_halflife_s=30.0,
              cooldown_s=30.0, latency_factor=4.0)
    return (jh, jh.HealthBoard(clock=jc, **kw), jc), (th, th.HealthBoard(clock=tc, **kw), tc)


def test_board_transitions_equal_jax():
    """One sequence of signals (retries, a timeout, decay, latency walls, a
    quarantine, the probe cycle, an eviction) drives JAX's board and the
    port's to the same states and scores at every step."""
    from adam_tpu.utils import telemetry as jt

    (jh, jb, jc), (_th, tb, tc) = _boards()
    jtr, ttr = jt.Tracer(recording=True), tele.Tracer(recording=True)
    steps = []

    def both(fn):
        fn(jb, jtr)
        fn(tb, ttr)
        steps.append((jb.status(), tb.status()))

    for _ in range(4):
        both(lambda b, tr: b.note_retry("d0", site="x", tracer=tr))
    both(lambda b, tr: b.note_timeout("d0", tracer=tr))
    for c in (jc, tc):
        c.t += 45.0
    both(lambda b, tr: b.note_retry("d1", tracer=tr))
    for s in [0.01] * 10 + [0.2, 0.2, 0.2]:
        both(lambda b, tr, s=s: b.observe_latency("bqsr.apply", "d2", s, tracer=tr))
    both(lambda b, tr: b.quarantine("d3", reason="sdc", tracer=tr))
    assert jb.blocked("d3") and tb.blocked("d3")
    assert tb.due_probes() == jb.due_probes() == []
    for c in (jc, tc):
        c.t += 31.0
    assert tb.probe_maybe_due() and jb.probe_maybe_due()
    assert tb.due_probes(["d3"]) == jb.due_probes(["d3"]) == ["d3"]
    both(lambda b, tr: b.readmit("d3", tracer=tr))
    both(lambda b, tr: b.quarantine("d0", tracer=tr))
    both(lambda b, tr: b.probe_failed("d0", tracer=tr))
    both(lambda b, tr: b.mark_evicted("d1", tracer=tr))
    for j, t in steps:
        assert t == j
    assert tb.states() == jb.states()
    assert tb.states()["d3"] == th.HEALTHY and tb.states()["d0"] == th.EVICTED
    jcount, tcount = jtr.snapshot()["counters"], ttr.snapshot()["counters"]
    assert {k: v for k, v in tcount.items() if k.startswith("device.health")} == {
        k: v for k, v in jcount.items() if k.startswith("device.health")}


def test_hedge_threshold_equal_jax(monkeypatch):
    (jh, jb, _jc), (_th, tb, _tc) = _boards()
    assert tb.hedge_threshold("k") is None  # hedging off by default
    monkeypatch.setenv("ADAM_TPU_HEDGE_FACTOR", "3")
    for s in (0.01, 0.02, 0.015, 0.03, 0.012, 0.02, 0.011, 0.05, 0.013):
        jb.observe_latency("k", "d0", s)
        tb.observe_latency("k", "d0", s)
    assert tb.hedge_threshold("k") == jb.hedge_threshold("k") > 0
    assert th.hedge_factor() == jh.hedge_factor() == 3.0


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 1.0, 2.0])
@pytest.mark.parametrize("seed", [None, 0, 7])
def test_audit_due_equals_jax(rate, seed, monkeypatch):
    from adam_tpu.utils import health as jh

    monkeypatch.setenv("ADAM_TPU_AUDIT_RATE", str(rate))
    got = [th.audit_due(w, seed=seed) for w in range(200)]
    assert got == [jh.audit_due(w, seed=seed) for w in range(200)]
    assert th.audit_rate() == jh.audit_rate()
    if 0 < rate < 1:
        assert 0 < sum(got) < 200


def test_probe_known_answer_on_a_slot():
    slot = dp.make_slots(["cpu"])[0]
    assert th.probe_known_answer(slot) is True
    assert th.device_key(slot) == "cpu#0" and th.device_key(None) == "default"


def test_probation_slot_readmitted_after_a_passing_probe(monkeypatch):
    """A quarantined slot leaves placement; after the cooldown the pool's
    placement call runs its probe and takes it back."""
    monkeypatch.setattr(th.BOARD, "cooldown_s", 0.0)
    pool = dp.DevicePool(dp.make_slots(["cpu", "cpu"]))
    try:
        th.BOARD.quarantine(pool.devices[1], reason="test")
        th.BOARD.next_probe_due = float("inf")  # the probe is not due yet
        assert pool.alive_devices() == [pool.devices[0]]
        th.BOARD.next_probe_due = 0.0
        assert pool.device(1) is pool.devices[1]
        assert th.BOARD.state(pool.devices[1]) == th.HEALTHY
    finally:
        th.reset_board()


@pytest.fixture
def small_sam(tmp_path):
    from make_wgs_sam import make_wgs

    path = str(tmp_path / "in.sam")
    make_wgs(path, 2048, 100, n_contigs=1, contig_len=20_000, indel_every=700)
    return path


def _parts(d) -> dict:
    return {f: (pathlib.Path(d) / f).read_bytes()
            for f in sorted(os.listdir(d)) if f.startswith("part-")}


def test_audit_catches_corrupt_and_replays_on_another_slot(small_sam, tmp_path,
                                                           monkeypatch):
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    transform_streamed(small_sam, str(tmp_path / "clean"), window_reads=512, device="cpu")
    monkeypatch.setenv("ADAM_TPU_AUDIT_RATE", "1")
    tf.install("device.fetch=corrupt,pass=apply,times=1,seed=5")
    tele.TRACE.reset()
    tele.TRACE.recording = True
    try:
        stats = transform_streamed(small_sam, str(tmp_path / "audited"), window_reads=512,
                                   device="cpu",
                                   device_pool=dp.DevicePool(dp.make_slots(["cpu", "cpu"])))
        snap = tele.TRACE.snapshot()
        states = th.BOARD.states()
    finally:
        tele.TRACE.recording = False
        tele.TRACE.reset()
        tf.clear()
    assert _parts(tmp_path / "audited") == _parts(tmp_path / "clean")
    c = snap["counters"]
    assert c[tele.C_FAULT_INJECTED] == 1
    assert c[tele.C_AUDIT_MISMATCH] == 1
    assert c[tele.C_AUDIT_SAMPLED] == stats["n_parts"] + 1  # + the replay's audit
    assert c[tele.C_HEALTH_PROBATION] == 1
    assert states["cpu#0"] == th.PROBATION
    assert list(states.values()).count(th.PROBATION) == 1
    assert snap["spans"][tele.SPAN_AUDIT_CHECK]["count"] == c[tele.C_AUDIT_SAMPLED]
    assert tele.SPAN_POOL_REPLAY in snap["spans"]


def test_audit_never_publishes_the_cpu_result(small_sam, tmp_path, monkeypatch):
    """On one device there is no other slot to replay a mismatched window
    on: the run raises, and the CPU recompute (the audit's reference only)
    is not written in the window's place."""
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    monkeypatch.setenv("ADAM_TPU_AUDIT_RATE", "1")
    tf.install("device.fetch=corrupt,pass=apply,times=1")
    try:
        with pytest.raises(dp.AllDevicesEvicted, match="no healthy slot"):
            transform_streamed(small_sam, str(tmp_path / "out"), window_reads=512,
                               device="cpu")
    finally:
        tf.clear()
    # the corrupted window's part (the realigned part, written first) is
    # not published
    assert "part-r-00004.parquet" not in _parts(tmp_path / "out")
