"""The port's run analyzer (``adam_tpu_torch/utils/analyzer.py``) against
the JAX package's on the same artifacts: the documents of
``tests/test_analyzer.py``, built with JAX's tracer, analyze into an equal
dict and render equal text, in snapshot and in trace form; so does
``analyze_path`` beside incident bundles, an ``SLO_BUDGET.json`` and a
``PERF_LEDGER.ndjson`` written by JAX's own modules.  The read-side
helpers the port copied (``perfledger``, ``incidents``, ``slo``,
``retry``) are held against JAX's too."""

import json

import numpy as np
import pytest

S = int(1e9)


def _two_device_tracer():
    """The 10 s two-device run of ``tests/test_analyzer.py``, on JAX's tracer."""
    from adam_tpu.utils import telemetry as tele

    tr = tele.Tracer(recording=True)

    def add(name, start_s, dur_s, **attrs):
        tr.add_span(name, int(start_s * S), int(dur_s * S), **attrs)

    add(tele.SPAN_TOTAL, 0, 10)
    add(tele.SPAN_PASS_A, 0, 4)
    add(tele.SPAN_RESOLVE, 4, 1)
    add(tele.SPAN_OBS_MERGE, 5, 1)
    add(tele.SPAN_SOLVE, 6, 1)
    add(tele.SPAN_PASS_C, 7, 2)
    add(tele.SPAN_WRITE_WAIT, 9, 1)
    add(tele.SPAN_APPLY_DISPATCH, 1, 2, device=0, window=0)
    add(tele.SPAN_OBS_FETCH, 5, 1, device=0, window=0)
    add(tele.SPAN_APPLY_DISPATCH, 2, 2, device=1, window=1)
    add(tele.SPAN_APPLY_DISPATCH, 4, 3, device=1, window=3)
    add(tele.SPAN_BQSR_OBSERVE, 4, 1, device=1, window=3)
    return tr


def _replay_tracer():
    from adam_tpu.utils import telemetry as tele

    tr = _two_device_tracer()
    tr.add_span(tele.SPAN_POOL_REPLAY, 6 * S, S, device=1)
    tr.add_span(tele.SPAN_APPLY_DISPATCH, int(7.5 * S), S, device=0, replay=1)
    tr.count(tele.C_DEVICE_EVICTED)
    return tr


def _resumed_tracer():
    from adam_tpu.utils import telemetry as tele

    tr = _two_device_tracer()
    tr.count(tele.C_RESUME_WINDOWS_SKIPPED, 3)
    tr.count(tele.C_RESUME_HISTOGRAMS_LOADED, 2)
    tr.count(tele.C_READS_INGESTED, 10_000)
    with tele.pass_scope("observe"):
        tr.record_transfer("d2h", 2_000_000, 0.5, device="0")
        tr.record_transfer("d2h", 2_000_000, 0.25, device="1")
    with tele.pass_scope("apply"):
        tr.record_transfer("h2d", 8_000_000, 0.01, device="0")
    tr.record_compile("bqsr.observe", (1024, 128, 3), "cpu:1", 0.25, in_window=True)
    tr.record_compile("bqsr.apply", (32768, 128, 3, 257), "cpu:0", 0.1, in_window=False)
    tr.count(tele.C_COMPILE_HITS, 7)
    tr.record_hbm("0", 1 << 30, peak_bytes=2 << 30)
    tr.gauge(tele.G_RESOLVE_DEVICE_SORT, 1)
    tr.count(tele.C_ENCODE_BYTES_IN, 1000)
    tr.count(tele.C_ENCODE_BYTES_OUT, 1500)
    tr.count(tele.C_BYTES_WRITTEN, 500)
    return tr


def _evicted_ring_tracer():
    from adam_tpu.utils import telemetry as tele

    tr = tele.Tracer(recording=True, capacity=4)
    for i in range(10):
        tr.add_span(tele.SPAN_APPLY_DISPATCH, i * S, S, device=0, window=i)
    tr.add_span(tele.SPAN_TOTAL, 0, 10 * S)
    return tr


def _mirror_twin_tracer():
    from adam_tpu.utils import telemetry as tele

    tr = tele.Tracer(recording=True)
    tr.add_span(tele.SPAN_TOTAL, 0, 10 * S)
    tr.add_span(tele.SPAN_POOL_PREWARM_COMPILE, 0, 2 * S, thread="w0", device=0, kernel="k")
    tr.add_span(tele.SPAN_POOL_PREWARM_COMPILE, 0, 2 * S, thread="w1", device=0, kernel="k")
    return tr


def _random_run_tracer(seed=3):
    """A streamed-shaped run with seeded random windows, batching and
    health records, a fused tier and a realign tail."""
    from adam_tpu.utils import telemetry as tele

    rng = np.random.default_rng(seed)
    tr = tele.Tracer(recording=True)
    t = 0
    for name in (tele.SPAN_PASS_A, tele.SPAN_RESOLVE, tele.SPAN_SPLIT,
                 tele.SPAN_OBSERVE, tele.SPAN_TAIL, tele.SPAN_OBS_MERGE,
                 tele.SPAN_SOLVE, tele.SPAN_PASS_C, tele.SPAN_WRITE_WAIT):
        d = int(rng.integers(S // 10, 2 * S))
        tr.add_span(name, t, d)
        t += d
    for w in range(12):
        dev = int(rng.integers(0, 3))
        st = int(rng.integers(0, t))
        tr.add_span(tele.SPAN_FUSED_BC, st, int(rng.integers(S // 100, S // 2)),
                    device=dev, window=w)
        tr.add_span(tele.SPAN_APPLY_FETCH, st + S // 2, int(rng.integers(1, S // 5)),
                    device=dev, window=w)
    tr.add_span(tele.SPAN_TOTAL, 0, t)
    tr.gauge(tele.G_FUSED_BC, 1)
    tr.gauge(tele.G_OBSERVE_HIDDEN, 1)
    tr.count(tele.C_CANDIDATE_ROWS, 40)
    tr.count(tele.C_FUSED_DISPATCHED, 12)
    tr.count(tele.C_MESH_DISPATCHED, 5)
    tr.count(tele.C_BATCH_DISPATCHES, 4)
    tr.count(tele.C_BATCH_WINDOWS, 10)
    tr.count(tele.C_BATCH_ROWS_OCCUPIED, 900)
    tr.count(tele.C_BATCH_ROWS_DISPATCHED, 1024)
    for v in rng.uniform(0.2, 1.0, 8):
        tr.observe(tele.H_BATCH_FILL, float(v))
    tr.count(tele.C_HEALTH_DEMOTED, 1)
    tr.count(tele.C_HEDGE_FIRED, 2)
    tr.count(tele.C_HEDGE_WON, 1)
    tr.count(tele.C_HEDGE_WASTED, 1)
    tr.record_health("2", "probation", 0.25, reason="slow")
    tr.record_quota("t0", nbytes=100, compute_s=1.5, budget_bytes=1000)
    tr.count(tele.C_RESIDENT_WINDOWS, 12)
    tr.count(tele.C_RESIDENT_BYTES, 1 << 24)
    tr.count(tele.C_RESIDENT_RELEASED, 12)
    return tr


DOCUMENTS = {
    "two_device": _two_device_tracer,
    "replay": _replay_tracer,
    "resumed": _resumed_tracer,
    "evicted_ring": _evicted_ring_tracer,
    "mirror_twin": _mirror_twin_tracer,
    "random_run": _random_run_tracer,
}


def _canon(x) -> str:
    return json.dumps(x, sort_keys=True, default=str)


@pytest.mark.parametrize("kind", ["snapshot", "trace"])
@pytest.mark.parametrize("doc", sorted(DOCUMENTS))
def test_analyze_and_render_equal_jax(doc, kind):
    from adam_tpu.utils import analyzer as ja

    from adam_tpu_torch.utils import analyzer as ta

    tr = DOCUMENTS[doc]()
    art = tr.snapshot() if kind == "snapshot" else tr.to_chrome_trace()
    art = json.loads(json.dumps(art, default=str))  # as read back from disk
    jr, tr_ = ja.analyze(art), ta.analyze(art)
    assert _canon(tr_) == _canon(jr)
    assert ta.render_report(tr_) == ja.render_report(jr)
    assert ta.document_kind(art) == ja.document_kind(art) == kind


@pytest.mark.parametrize("doc", sorted(DOCUMENTS))
def test_utilization_from_snapshot_equal_jax(doc):
    from adam_tpu.utils import analyzer as ja

    from adam_tpu_torch.utils import analyzer as ta

    snap = DOCUMENTS[doc]().snapshot()
    assert _canon(ta.utilization_from_snapshot(snap)) == _canon(ja.utilization_from_snapshot(snap))


def test_render_of_the_port_runs_own_report_equal_jax():
    """A port tracer's export renders the same under either analyzer."""
    from adam_tpu.utils import analyzer as ja

    from adam_tpu_torch.utils import analyzer as ta
    from adam_tpu_torch.utils import telemetry as tt

    tr = tt.Tracer(recording=True)
    tr.add_span(tt.SPAN_TOTAL, 0, 4 * S)
    tr.add_span(tt.SPAN_PASS_A, 0, 2 * S)
    tr.add_span(tt.SPAN_OBS_FETCH, S, S // 4, device="0", window=0)
    tr.record_hbm("0", 1 << 28, peak_bytes=1 << 29)
    doc = json.loads(json.dumps(tr.to_chrome_trace()))
    assert ta.render_report(ta.analyze(doc)) == ja.render_report(ja.analyze(doc))
    assert "0" in ta.analyze(doc)["devices"]


def _write_siblings(root):
    """Incident bundles, an SLO budget and a perf ledger beside an
    artifact, written by the JAX package's own modules."""
    from adam_tpu.utils import incidents, perfledger, slo

    incidents._reset_for_tests()
    incidents.install(str(root))
    try:
        incidents.maybe_record("slo.burn", trace_id="ab" * 8,
                               reason="budget burning at 25.0x")
    finally:
        incidents._reset_for_tests()
    eng = slo.SLOEngine(slo.parse_slo_spec("t:p99(sched.job.run)<30s"), str(root))
    eng.observe_job("t", 1.0, ok=True)
    eng.observe_job("t", 99.0, ok=True)
    for i in range(4):
        perfledger.book(str(root), {"spans.streamed.total.total_s": (10.0, "lower")},
                        run_id=f"r{i}")
    perfledger.book(str(root), {"spans.streamed.total.total_s": (20.0, "lower")},
                    run_id="slow")


@pytest.mark.parametrize("kind", ["snapshot", "trace"])
@pytest.mark.parametrize("nested", [False, True])
def test_analyze_path_folds_sibling_sections_equal_jax(tmp_path, kind, nested):
    from adam_tpu.utils import analyzer as ja
    from adam_tpu.utils import telemetry as jt

    from adam_tpu_torch.utils import analyzer as ta

    _write_siblings(tmp_path)
    tr = _two_device_tracer()
    tr.add_span(jt.SPAN_FUSED_BC, S, S, device=0, window=0)
    tr.gauge(jt.G_FUSED_BC, 1)
    tr.count(jt.C_FUSED_DISPATCHED, 2)
    art_dir = tmp_path / "sub" if nested else tmp_path  # the parent is probed too
    art_dir.mkdir(exist_ok=True)
    art = art_dir / "m.json"
    art.write_text(json.dumps(tr.snapshot() if kind == "snapshot" else tr.to_chrome_trace()))
    jr, tr_ = ja.analyze_path(str(art)), ta.analyze_path(str(art))
    assert _canon(tr_) == _canon(jr)
    text = ta.render_report(tr_)
    assert text == ja.render_report(jr)
    for heading in ("Incidents (1 bundle(s))", "SLO", "Perf trend", "slo.burn"):
        assert heading in text


def test_read_side_helpers_equal_jax(tmp_path, monkeypatch):
    from adam_tpu.utils import incidents as ji
    from adam_tpu.utils import perfledger as jp
    from adam_tpu.utils import retry as jr
    from adam_tpu.utils import slo as js

    from adam_tpu_torch.utils import incidents as ti
    from adam_tpu_torch.utils import perfledger as tp
    from adam_tpu_torch.utils import retry as tr
    from adam_tpu_torch.utils import slo as ts

    _write_siblings(tmp_path)
    (tmp_path / "incidents" / "inc-zz-torn.json").write_text("{")
    assert ts.BUDGET_FILENAME == js.BUDGET_FILENAME
    assert ti.list_bundles(str(tmp_path)) == ji.list_bundles(str(tmp_path))
    entries = jp.read_ledger(str(tmp_path))
    assert tp.read_ledger(str(tmp_path)) == entries and len(entries) == 5
    assert tp.ledger_path(str(tmp_path)) == jp.ledger_path(str(tmp_path))
    assert _canon(tp.trend(entries)) == _canon(jp.trend(entries))
    assert _canon(tp.rolling_baseline(entries, 3)) == _canon(jp.rolling_baseline(entries, 3))
    base = jp.rolling_baseline(entries[:-1])
    assert tp.compare(entries[-1], base) == jp.compare(entries[-1], base)
    snap = _resumed_tracer().snapshot()
    assert _canon(tp.snapshot_keys(snap)) == _canon(jp.snapshot_keys(snap))
    for raw in ("", "12.5", "x", "-3"):
        monkeypatch.setenv("ADAM_TPU_PERF_THRESHOLD", raw)
        monkeypatch.setenv("ADAM_TPU_PERF_BASELINE_N", raw)
        assert tp.perf_threshold_pct() == jp.perf_threshold_pct()
        assert tp.baseline_n() == jp.baseline_n()
        assert tr.env_float("ADAM_TPU_PERF_THRESHOLD", 1.5) == \
            jr.env_float("ADAM_TPU_PERF_THRESHOLD", 1.5)
        assert tr._env_int("ADAM_TPU_PERF_BASELINE_N", 4) == \
            jr._env_int("ADAM_TPU_PERF_BASELINE_N", 4)


def test_analyze_rejects_an_unknown_document():
    from adam_tpu_torch.utils import analyzer as ta

    with pytest.raises(ValueError):
        ta.analyze({"foo": 1})
