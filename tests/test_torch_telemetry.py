"""The port's telemetry layer against the JAX package's: the name
registry, the tracer's exports, the histogram and snapshot helpers, the
heartbeat, the timers, the fault counter, the name contract over the
port's code, and the streamed run's recording (port against JAX on the
same SAM).  Every comparison is exact equality unless a line says
otherwise; the inputs come from a seeded numpy generator."""

import ast
import json
import os
import pathlib
import sys
import threading
import time

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

S = int(1e9)


@pytest.fixture
def both():
    from adam_tpu.utils import telemetry as jt

    from adam_tpu_torch.utils import telemetry as tt

    return jt, tt


# --------------------------------------------------------------------------
# names
# --------------------------------------------------------------------------
@pytest.mark.parametrize("what", ["registered_spans", "registered_metrics",
                                  "registered_names"])
def test_registered_names_equal_jax(both, what):
    jt, tt = both
    assert getattr(tt, what)() == getattr(jt, what)()


def test_constants_and_heartbeat_fields_equal_jax(both):
    jt, tt = both
    names = [n for n in dir(jt) if n.isupper() and not n.startswith("_")
             and isinstance(getattr(jt, n), (str, int, float, tuple, frozenset))]
    assert len(names) > 100
    for n in names:
        assert getattr(tt, n) == getattr(jt, n), n
    assert tt.HEARTBEAT_FIELDS == jt.HEARTBEAT_FIELDS


# --------------------------------------------------------------------------
# the tracer: one scripted sequence through both packages
# --------------------------------------------------------------------------
class _Clock:
    """A telemetry module's ``time`` with a deterministic ``monotonic_ns``
    (each call advances 1 ms); everything else is the real module."""

    def __init__(self):
        self.t = 5 * S

    def monotonic_ns(self):
        self.t += 1_000_000
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


def _script(tele, rng_seed=7):
    """Drive one tracer through every recording surface, deterministically."""
    rng = np.random.default_rng(rng_seed)
    tr = tele.Tracer(recording=True)
    tr.set_trace("ab" * 8)
    for i in range(6):
        tr.add_span(tele.SPAN_APPLY_DISPATCH, int(i * S), int(rng.integers(1, S)),
                    device=i % 2, window=i)
    tr.add_span(tele.SPAN_TOTAL, 0, 10 * S, thread="main")
    tr.add_span(tele.SPAN_POOL_REPLAY, 3 * S, S, device=1, replay=1)
    tr.add_span(tele.SPAN_OBS_FETCH, 4 * S, S // 3, device=0, replay=1)

    def nested(k):
        with tr.span(tele.SPAN_PASS_C, window=k):
            with tr.span(tele.SPAN_APPLY_FETCH, window=k, device="0"):
                pass
            with tele.trace_scope("cd" * 8):
                with tr.span(tele.SPAN_PART_WRITE, path=f"p{k}"):
                    pass

    for k in range(2):  # two named threads, one after the other
        t = threading.Thread(target=nested, args=(k,), name=f"w{k}")
        t.start()
        t.join()
    for v in rng.integers(0, 1000, 20):
        tr.count(tele.C_READS_INGESTED, int(v))
    tr.count(tele.C_PARTS_WRITTEN)
    for v in rng.integers(0, 8, 10):
        tr.gauge(tele.G_POOL_DEPTH, int(v))
    for v in rng.lognormal(-5, 2, 50):
        tr.observe(tele.H_POOL_SUBMIT_WAIT, float(v))
    tr.record_transfer("h2d", 1_000_000, 0.01, device="0", pass_name="a")
    tr.record_compile("k", (8, 4), "0", 0.25, in_window=True)
    tr.record_hbm("0", 1 << 20, peak_bytes=2 << 20)
    tr.record_quota("t0", nbytes=10, compute_s=0.5, budget_bytes=100)
    tr.record_health("0", "suspect", 0.5, reason="slow")
    other = tele.Tracer(recording=True)
    other.add_span(tele.SPAN_RESOLVE, 2 * S, S, device=0)
    other.count(tele.C_READS_INGESTED, 3)
    other.gauge(tele.G_POOL_DEPTH, 11)
    other.observe(tele.H_POOL_SUBMIT_WAIT, 0.5)
    other.record_hbm("0", 3 << 20)
    tr.absorb(other)
    return tr


def _timers(ins):
    reg = ins.TimerRegistry(recording=True)
    reg.add(ins.SAVE_OUTPUT, 2 * S)
    reg.add(ins.PARQUET_ENCODE, 3 * S)
    reg.add(ins.PARQUET_ENCODE, S // 7)
    return reg


@pytest.mark.parametrize("export", ["snapshot", "to_json", "report",
                                    "to_chrome_trace", "events"])
def test_tracer_exports_equal_jax(both, monkeypatch, export):
    from adam_tpu.utils import instrumentation as jins

    from adam_tpu_torch.utils import instrumentation as tins

    jt, tt = both
    monkeypatch.setattr(tt, "_EPOCH_NS", jt._EPOCH_NS)
    out = []
    for tele, ins in ((jt, jins), (tt, tins)):
        monkeypatch.setattr(tele, "time", _Clock())
        tr = _script(tele)
        if export == "to_json":
            out.append(json.dumps(tr.to_json(_timers(ins), include_events=True),
                                  sort_keys=True, default=str))
        else:
            out.append(json.dumps(getattr(tr, export)(), sort_keys=True, default=str))
    assert out[0] == out[1]


def test_disabled_tracer_records_nothing(both):
    _, tt = both
    tr = tt.Tracer()
    assert tr.span(tt.SPAN_TOTAL) is tt._NULL_SPAN
    tr.count(tt.C_READS_INGESTED)
    tr.add_span(tt.SPAN_TOTAL, 0, 1)
    assert tr.snapshot()["counters"] == {} and tr.events() == []


# --------------------------------------------------------------------------
# histogram and snapshot helpers
# --------------------------------------------------------------------------
def _values(seed=11, n=10_000):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.lognormal(-6, 3, n // 2), rng.uniform(0, 5, n // 2)])


@pytest.mark.parametrize("helper", ["hist_bucket_index", "hist_summary",
                                    "merge_histograms"])
def test_histogram_helpers_equal_jax(both, helper):
    jt, tt = both
    vals = _values()
    if helper == "hist_bucket_index":
        assert [tt.hist_bucket_index(v) for v in vals] == \
            [jt.hist_bucket_index(v) for v in vals]
        return
    out = []
    for tele in (jt, tt):
        a, b = tele._new_hist(), tele._new_hist()
        for v in vals[:6000]:
            tele._hist_observe(a, v)
        for v in vals[6000:]:
            tele._hist_observe(b, v)
        if helper == "hist_summary":
            out.append((tele.hist_summary(a), tele.hist_summary(b)))
        else:
            out.append(tele.merge_histograms(tele.hist_summary(a), tele.hist_summary(b)))
    assert json.dumps(out[0], sort_keys=True) == json.dumps(out[1], sort_keys=True)


@pytest.mark.parametrize("helper", ["merge_snapshots", "key_stable_snapshot",
                                    "streamed_stats_view"])
def test_snapshot_helpers_equal_jax(both, monkeypatch, helper):
    jt, tt = both
    out = []
    for tele in (jt, tt):
        monkeypatch.setattr(tele, "time", _Clock())
        tr = _script(tele)
        tr.add_span(tele.SPAN_TAIL, 0, 2 * S)
        tr.add_span(tele.SPAN_OBSERVE, 0, S)
        tr.count(tele.C_CANDIDATE_ROWS, 5)
        if helper == "merge_snapshots":
            other = tele.Tracer(recording=True)
            other.add_span(tele.SPAN_PASS_C, 0, 3 * S)
            other.record_health("0", "probation", 0.1)
            other.record_quota("t0", nbytes=5)
            got = tele.merge_snapshots([tr.snapshot(), other.snapshot()])
        elif helper == "key_stable_snapshot":
            got = tele.key_stable_snapshot(tr)
        else:
            got = tele.streamed_stats_view(tr.snapshot())
        out.append(json.dumps(got, sort_keys=True, default=str))
    assert out[0] == out[1]


# --------------------------------------------------------------------------
# the heartbeat
# --------------------------------------------------------------------------
def test_heartbeat_sample_keys_equal_jax(both, tmp_path, monkeypatch):
    jt, tt = both
    from adam_tpu.utils import incidents as ji
    from adam_tpu.utils import slo as js

    from adam_tpu_torch.utils import incidents as ti
    from adam_tpu_torch.utils import slo as ts

    monkeypatch.setenv("ADAM_TPU_INCIDENT_COOLDOWN_S", "0")
    lines = []
    try:
        for tele, inc, slo in ((jt, ji, js), (tt, ti, ts)):
            inc._reset_for_tests()
            slo._reset_for_tests()
            tr = tele.Tracer(recording=True)
            tr.count(tele.C_READS_INGESTED, 100)
            tr.count(tele.C_PARTS_WRITTEN, 2)
            hb = tele.Heartbeat([tr], sink="stderr", interval_s=60)
            hb.set_devices([])
            hb.set_total(4)
            quiet = hb.sample(done=False)
            # the judgment fields arm with the recorder and the SLO engine
            inc.install(str(tmp_path / tele.__name__))
            slo.install("*:avail>=0.9", str(tmp_path / tele.__name__), window_s=60)
            slo.observe_job("t", 1.0, ok=False)
            inc.maybe_record("hedge.fired", reason="probe")
            lines.append((quiet, hb.sample(done=True)))
    finally:
        for inc, slo in ((ji, js), (ti, ts)):
            inc._reset_for_tests()
            slo._reset_for_tests()
    (jq, jl), (tq, tl) = lines
    assert list(tl) == list(jl) == list(tt.HEARTBEAT_FIELDS)
    # nothing tracked on the health board, no incident, no SLO: None, as JAX's
    assert tq["device_health"] is None
    assert (tq["last_incident"], tq["last_incident_age_s"], tq["slo_worst_burn"]) == \
        (jq["last_incident"], jq["last_incident_age_s"], jq["slo_worst_burn"]) == \
        (None, None, None)
    assert tl["last_incident"].endswith("-hedge-fired") and jl["last_incident"].endswith(
        "-hedge-fired")
    assert 0 <= tl["last_incident_age_s"] < 60
    assert tl["slo_worst_burn"] == jl["slo_worst_burn"] == 10.0
    for k in ("windows_total", "reads_ingested", "parts_written", "done", "eta_s"):
        assert tl[k] == jl[k], k


def test_heartbeat_file_sink_rotates_at_max_bytes(both, tmp_path, monkeypatch):
    _, tt = both
    monkeypatch.setenv("ADAM_TPU_PROGRESS_MAX_BYTES", "600")
    sink = tmp_path / "hb.ndjson"
    tr = tt.Tracer(recording=True)
    hb = tt.Heartbeat([tr], sink=str(sink), interval_s=3600)
    hb.set_devices([])
    hb.start()
    for _ in range(6):
        hb._emit(done=False)
    hb.stop()
    rotated = pathlib.Path(str(sink) + ".1")
    assert rotated.exists() and rotated.stat().st_size >= 600
    last = [json.loads(x) for x in sink.read_text().splitlines()]
    assert last and last[-1]["done"] is True and last[-1]["ok"] is True
    # the rotation keeps the newest lines: the two files end the sequence
    seqs = [json.loads(x)["seq"] for x in rotated.read_text().splitlines()]
    seqs += [x["seq"] for x in last]
    assert seqs == list(range(8 - len(seqs), 8))


def test_sample_hbm_without_a_card_is_empty(both):
    import torch

    _, tt = both
    if torch.cuda.is_available():
        pytest.skip("this host has a card; tests/test_torch_cuda.py covers it")
    assert tt.sample_hbm() == {}
    assert tt.sample_hbm([torch.device("cpu")]) == {}


# --------------------------------------------------------------------------
# the timers and the device trace
# --------------------------------------------------------------------------
def test_timer_registry_report_equals_jax():
    from adam_tpu.utils import instrumentation as jins

    from adam_tpu_torch.utils import instrumentation as tins

    assert _timers(tins).report() == _timers(jins).report()
    assert tins.TimerRegistry().report() == jins.TimerRegistry().report()
    names = [n for n in dir(jins) if n.isupper() and isinstance(getattr(jins, n), str)]
    assert len(names) == 17
    assert {n: getattr(tins, n) for n in names} == {n: getattr(jins, n) for n in names}


def test_device_trace_writes_a_chrome_trace_and_nests_as_a_no_op(tmp_path, caplog):
    import torch

    from adam_tpu_torch.utils import instrumentation as tins

    with tins.device_trace(str(tmp_path / "xp")):
        with caplog.at_level("WARNING"):
            with tins.device_trace(str(tmp_path / "inner")):
                torch.ones(64).cumsum(0)
    assert "already active" in caplog.text
    assert not (tmp_path / "inner").exists()
    files = list((tmp_path / "xp").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    doc = json.loads(files[0].read_text())
    assert any("cumsum" in e.get("name", "") for e in doc["traceEvents"])
    # the flag is cleared: a later trace starts again
    with tins.device_trace(str(tmp_path / "again")):
        pass
    assert len(list((tmp_path / "again").iterdir())) == 1


def test_block_returns_its_argument():
    import torch

    from adam_tpu_torch.utils import instrumentation as tins

    x = torch.arange(3)
    assert tins.block(x) is x and tins.block(5) == 5


# --------------------------------------------------------------------------
# faults count on the global tracer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("spec", [
    "parquet.encode=delay:0,every=2",
    "parquet.write=transient,after=1,times=2;parquet.encode=delay:0,pass=observe",
])
def test_fault_injected_counts_equal_jax(spec):
    from adam_tpu.utils import faults as jf
    from adam_tpu.utils import telemetry as jt

    from adam_tpu_torch.utils import faults as tf
    from adam_tpu_torch.utils import telemetry as tt

    counts = []
    for faults, tele in ((jf, jt), (tf, tt)):
        was = tele.TRACE.recording
        tele.TRACE.recording = True
        tele.TRACE.reset()
        faults.install(spec)
        try:
            for k in range(7):
                for site in ("parquet.encode", "parquet.write"):
                    with tele.pass_scope("observe" if k % 2 else "apply"):
                        try:
                            faults.point(site)
                        except faults.TransientFault:
                            pass
            counts.append(tele.TRACE.snapshot()["counters"].get(tele.C_FAULT_INJECTED, 0))
        finally:
            faults.clear()
            tele.TRACE.reset()
            tele.TRACE.recording = was
    assert counts[0] == counts[1] > 0


# --------------------------------------------------------------------------
# the name contract over the port's code
# --------------------------------------------------------------------------
_RECORDERS = {"span", "add_span", "count", "gauge", "observe"}


def _uses():
    """(file, line, kind, value) for every telemetry name use under
    adam_tpu_torch/: attribute references to SPAN_/C_/G_/H_ constants
    and string literals passed as a recorder's name."""
    out = []
    for path in sorted((REPO / "adam_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr.startswith(
                    ("SPAN_", "C_", "G_", "H_")):
                out.append((path.name, node.lineno, "const", node.attr))
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _RECORDERS and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                out.append((path.name, node.lineno, "literal", node.args[0].value))
    return out


def test_every_name_the_port_records_is_registered():
    from adam_tpu_torch.utils import telemetry as tt

    uses = _uses()
    consts = {u[3] for u in uses if u[2] == "const"}
    assert {"SPAN_TOTAL", "C_READS_INGESTED", "G_POOL_DEPTH",
            "H_POOL_SUBMIT_WAIT"} <= consts  # the scan sees the code
    registered = tt.registered_names()
    bad = [u for u in uses if u[2] == "const"
           and getattr(tt, u[3], None) not in registered]
    bad += [u for u in uses if u[2] == "literal" and u[3] not in registered]
    assert bad == []


def test_prometheus_names_are_valid_and_distinct():
    from adam_tpu_torch.utils import telemetry as tt

    mangled = [tt.prometheus_name(n) for n in sorted(tt.registered_metrics())]
    assert all(tt.prometheus_name_valid(m) for m in mangled)
    assert len(set(mangled)) == len(mangled)


# --------------------------------------------------------------------------
# the streamed run, port against JAX
# --------------------------------------------------------------------------
#: What the JAX run records and the port does not: nothing.  The device
#: pool's, the mesh's and the ledgers' names came with ROADMAP queue 1 item
#: 4, the service's spans (``sched.job.run``, ``sched.batch.fused``,
#: ``gateway.job.submit``) with item 5's service part; a service run
#: records them (``tests/test_torch_serve.py``, ``test_torch_gateway.py``).
NOT_RECORDED = {
    "spans": {},
    "counters": {},
    "gauges": {},
}

#: The device ledger's byte counters move other bytes in the port, for
#: three deliberate reasons, each held per pass by
#: ``test_streamed_transfer_ledger_equals_jax_per_pass``: the table is
#: placed once per slot (pass ``table``) where JAX's single-device path
#: ships it with every window's apply; a packed column comes home at its
#: exact size where JAX fetches a bucket-quantized slice (``fetch_grid``,
#: its guard against one XLA compile per slice size); and a realign sweep
#: chunk holds its real pairs where JAX pads it to a fixed compiled shape.
LEDGER_BYTES = {"device.h2d.bytes", "device.d2h.bytes"}

WINDOW = 2048


def _env(**kv):
    import contextlib

    @contextlib.contextmanager
    def cm():
        old = {k: os.environ.get(k) for k in kv}
        os.environ.update(kv)
        try:
            yield
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    return cm()


def _cli(main, tele, ins, argv):
    import contextlib
    import io

    from adam_tpu.utils import compile_ledger as jcl

    from adam_tpu_torch.utils import compile_ledger as tcl

    # each run's first launches are its own: forget what earlier tests in
    # this worker launched (both ledgers are process-wide)
    jcl.reset()
    tcl.reset()
    tele.TRACE.reset()
    ins.TIMERS.reset()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    tele.TRACE.recording = False
    ins.TIMERS.recording = False
    return rc, out.getvalue(), err.getvalue()


def _parts(d) -> dict:
    return {f: (pathlib.Path(d) / f).read_bytes()
            for f in sorted(os.listdir(d)) if f.startswith("part-")}


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    from make_wgs_sam import make_wgs

    from adam_tpu.cli.main import main as jmain
    from adam_tpu.utils import instrumentation as jins
    from adam_tpu.utils import telemetry as jt

    from adam_tpu_torch.cli.main import main as tmain
    from adam_tpu_torch.utils import instrumentation as tins
    from adam_tpu_torch.utils import telemetry as tt

    d = tmp_path_factory.mktemp("tele")
    sam = str(d / "in.sam")
    make_wgs(sam, 4500, 100, n_contigs=2, contig_len=30_000)
    flags = ["-streaming", "-mark_duplicate_reads", "-realign_indels",
             "-recalibrate_base_qualities", "-window_reads", str(WINDOW)]
    runs = {}
    with _env(ADAM_TPU_BQSR_BACKEND="device", ADAM_TPU_RESIDENT="1"):
        # one device: the single-chip path the port has
        rc, out, _ = _cli(jmain, jt, jins, ["transform", sam, str(d / "jax.adam"), *flags,
                                            "--metrics-json", str(d / "jax.json"),
                                            "--devices", "1"])
    assert rc == 0
    runs["jax"] = json.loads((d / "jax.json").read_text())
    rc, out, _ = _cli(tmain, tt, tins, ["transform", sam, str(d / "on.adam"), *flags,
                                        "--metrics-json", str(d / "on.json"),
                                        "--device", "cpu"])
    assert rc == 0
    runs["on"] = json.loads((d / "on.json").read_text())
    runs["on_stats"] = json.loads(out.splitlines()[0])
    rc, out, _ = _cli(tmain, tt, tins, ["transform", sam, str(d / "off.adam"), *flags,
                                        "--device", "cpu"])
    assert rc == 0
    runs["off_stats"] = json.loads(out.splitlines()[0])
    return d, runs


def test_streamed_counters_equal_jax(streamed):
    _, runs = streamed
    j, t = runs["jax"]["counters"], runs["on"]["counters"]
    assert set(j) - set(t) == set(NOT_RECORDED["counters"]) & set(j)
    assert set(t) <= set(j)
    assert LEDGER_BYTES <= set(t)
    assert ({k: t[k] for k in t if k not in LEDGER_BYTES}
            == {k: j[k] for k in t if k not in LEDGER_BYTES})
    assert t["reads.ingested"] == 4500 and t["windows.ingested"] == 3


def test_streamed_gauges_equal_jax_but_the_overlap(streamed):
    """Every gauge equals JAX's, the overlap among them: both observe the
    windows under the realign sweeps (``overlap_work``)."""
    _, runs = streamed
    j, t = runs["jax"]["gauges"], runs["on"]["gauges"]
    assert set(j) - set(t) == set(NOT_RECORDED["gauges"]) & set(j)
    assert set(t) == set(j)
    assert j["streamed.observe_overlap_hidden"]["last"] == 1
    for k in t:  # the samples are the same; a depth's min/max follow the threads
        assert t[k]["n"] == j[k]["n"], k
    for k in ("device.dispatch.in_flight", "streamed.fused_bc",
              "streamed.resolve.device_sort", "streamed.observe_overlap_hidden",
              "device.pool.devices", "device.resident.live_bytes", "kernel.backend"):
        assert t[k] == j[k], k


def test_streamed_transfer_ledger_equals_jax_per_pass(streamed):
    """The device ledger per direction and pass: the passes that move the
    same tensors carry the same bytes as JAX's (the resident placement,
    pass A's columns, pass B's masks and histograms, the resolve's
    lexsort), and the three that differ differ as ``LEDGER_BYTES`` says."""
    _, runs = streamed

    def per_pass(snap, direction):
        out = {}
        for per in snap["transfers"][direction].values():
            for name, e in per.items():
                out[name] = out.get(name, 0) + e["bytes"]
        return out

    jh, th = per_pass(runs["jax"], "h2d"), per_pass(runs["on"], "h2d")
    jd, td = per_pass(runs["jax"], "d2h"), per_pass(runs["on"], "d2h")
    for name in ("ingest", "a", "observe", "resolve"):
        assert th[name] == jh[name], name
    for name in ("a", "observe", "resolve"):
        assert td[name] == jd[name], name
    # the table: once (pass "table") against once per applied window
    n_parts = runs["jax"]["counters"]["parquet.parts.written"]
    table = th["table"]
    assert jh["apply"] == th["apply"] + n_parts * table
    # the packed columns: their exact bytes, within JAX's buckets
    assert 0 < td["apply"] <= jd["apply"]
    # the sweep chunks: the real pairs only
    assert 0 < td["sweep"] <= jd["sweep"] and 0 < th["sweep"] <= jh["sweep"]
    assert runs["on"]["counters"]["device.h2d.bytes"] == sum(th.values())
    assert runs["on"]["counters"]["device.d2h.bytes"] == sum(td.values())


def test_streamed_span_names_are_jax_minus_the_listed(streamed):
    _, runs = streamed
    j, t = set(runs["jax"]["spans"]), set(runs["on"]["spans"])
    assert t == j - set(NOT_RECORDED["spans"])
    for name in t:
        assert runs["on"]["spans"][name]["count"] == runs["jax"]["spans"][name]["count"], name


def test_streamed_stats_are_the_view_of_the_snapshot(streamed):
    from adam_tpu_torch.utils import telemetry as tt

    _, runs = streamed
    view = tt.streamed_stats_view(runs["on"])
    stats = runs["on_stats"]
    assert view and {k: stats[k] for k in view} == view
    assert stats["obs_merge_s"] == view["obs_merge_fetch_s"]
    assert stats["apply_s"] == runs["on"]["spans"][tt.SPAN_PASS_C]["total_s"]
    # the recording-off run prints the same keys
    assert set(runs["off_stats"]) == set(stats)


def test_streamed_parts_identical_with_recording_on_off_and_jax(streamed):
    d, _ = streamed
    on, off, jax = _parts(d / "on.adam"), _parts(d / "off.adam"), _parts(d / "jax.adam")
    assert len(on) == 4
    assert on == off == jax
