"""The service's operations layer in the port against the JAX package's:
the incident recorder (``utils/incidents.py``: install, the bundle, the
cooldown and the bound, each trigger), the SLO engine
(``utils/slo.py``: the grammar, the verdicts on one event sequence, the
durable budget), the perf ledger's booking side (``utils/perfledger.py``:
a booked entry, the sentinel), the heartbeat fields they arm, and the
``incidents`` and ``perf`` verbs, which print what JAX's print."""

import contextlib
import io
import json
import os
import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))


@pytest.fixture()
def both(monkeypatch):
    """Both packages' incident recorders, SLO engines and perf ledgers,
    reset before and after (module state), with the cooldown at 0."""
    from adam_tpu.utils import incidents as ji
    from adam_tpu.utils import perfledger as jp
    from adam_tpu.utils import slo as js

    from adam_tpu_torch.utils import incidents as ti
    from adam_tpu_torch.utils import perfledger as tp
    from adam_tpu_torch.utils import slo as ts

    monkeypatch.setenv("ADAM_TPU_INCIDENT_COOLDOWN_S", "0")
    mods = {"jax": (ji, js, jp), "port": (ti, ts, tp)}
    for inc, slo, pl in mods.values():
        inc._reset_for_tests()
        slo._reset_for_tests()
        pl._reset_for_tests()
    yield mods
    for inc, slo, pl in mods.values():
        inc._reset_for_tests()
        slo._reset_for_tests()
        pl._reset_for_tests()


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


# --------------------------------------------------------------------------
# the SLO engine
# --------------------------------------------------------------------------
SPECS = [
    "tenantA:p99(sched.job.run)<30s;tenantB:avail>=0.999;*:avail>=0.99",
    "A:p90(sched.job.run)<1500ms,avail>=0.9;*:tput(reads.ingested)>=5/s",
    "oops;A:avail>=2;B:p99(x)<;C:avail>=0.5",
    "*:p50(sched.job.run)<1m",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_slo_spec_equals_jax(spec):
    from adam_tpu.utils import slo as js

    from adam_tpu_torch.utils import slo as ts

    assert [o.key for o in ts.parse_slo_spec(spec)] == [o.key for o in js.parse_slo_spec(spec)]
    assert [vars(o) for o in ts.parse_slo_spec(spec)] == [vars(o) for o in js.parse_slo_spec(spec)]


@pytest.mark.parametrize("spec", SPECS[:2] + SPECS[3:])
def test_slo_verdicts_and_budget_file_equal_jax(both, tmp_path, spec):
    docs, files = [], []
    for name, (_inc, slo, _pl) in both.items():
        root = tmp_path / name
        root.mkdir()
        eng = slo.SLOEngine(slo.parse_slo_spec(spec), str(root), window_s=60)
        for i in range(12):
            eng.observe_job("A", 0.5 + i * 0.15, ok=i % 4 != 0)
            eng.observe_job("tenantB", 2.0, ok=True)
        eng.note_bad_event(2, reason="perf regression")
        docs.append((eng.evaluate(), eng.worst_burn()))
        files.append(json.loads((root / slo.BUDGET_FILENAME).read_text()))
    assert docs[0] == docs[1]
    assert files[0] == files[1]


def test_slo_budget_resumes_and_burn_fires_an_incident(both, tmp_path):
    _inc, ts, _pl = both["port"]
    ti = both["port"][0]
    ti.install(str(tmp_path))
    eng = ts.install("A:avail>=0.99", str(tmp_path), window_s=60)
    for _ in range(3):
        ts.observe_job("A", 1.0, ok=False)
    assert ts.worst_burn() > ts.fast_burn_threshold()
    rows = ti.list_bundles(str(tmp_path))
    assert "slo.burn" in {r["trigger"] for r in rows}
    # a restart resumes the budget instead of refilling it
    again = ts.SLOEngine(ts.parse_slo_spec("A:avail>=0.99"), str(tmp_path), window_s=60)
    assert again.evaluate()["objectives"][0]["bad_total"] == \
        eng.evaluate()["objectives"][0]["bad_total"] == 3


# --------------------------------------------------------------------------
# the incident recorder
# --------------------------------------------------------------------------
def _bundle_view(doc):
    """A bundle without what differs by run (ids, times, paths)."""
    return {k: doc[k] for k in ("schema", "trigger", "reason", "device", "window",
                                "trace_id", "events_dropped")} | {
        "metric_sections": sorted(doc["metrics"]), "has_trace": doc["trace"] is not None,
        "n_events": len(doc["events"])}


def test_incident_bundle_equals_jax(both, tmp_path):
    from adam_tpu.utils import telemetry as jt

    from adam_tpu_torch.utils import telemetry as tt

    views, rows = [], []
    for (name, (inc, _slo, _pl)), tele in zip(both.items(), (jt, tt)):
        root = tmp_path / name
        inc.install(str(root))
        tr = tele.Tracer(recording=True)
        tr.set_trace("ab" * 8)
        with tr.span(tele.SPAN_APPLY_DISPATCH, window=3):
            pass
        tr.count(tele.C_AUDIT_MISMATCH)
        path = inc.maybe_record("audit.mismatch", device=1, window=3, tracer=tr,
                                reason="SDC dual-compute mismatch on window 3")
        assert path and path.startswith(str(root / "incidents"))
        views.append(_bundle_view(json.loads(open(path).read())))
        rows.append([{k: v for k, v in r.items() if k not in ("id", "ts", "path")}
                     for r in inc.list_bundles(str(root))])
        assert inc.last_incident()["trigger"] == "audit.mismatch"
    assert views[0] == views[1]
    assert rows[0] == rows[1] and len(rows[0]) == 1


def test_incident_cooldown_bound_and_uninstall_equal_jax(both, tmp_path, monkeypatch):
    monkeypatch.setenv("ADAM_TPU_INCIDENT_MAX", "2")
    got = []
    for name, (inc, _slo, _pl) in both.items():
        inc.install(str(tmp_path / name))
        paths = [inc.maybe_record("retry.exhausted", reason=f"r{i}") for i in range(4)]
        n_files = len(os.listdir(tmp_path / name / "incidents"))
        monkeypatch.setenv("ADAM_TPU_INCIDENT_COOLDOWN_S", "3600")
        cooled = inc.maybe_record("retry.exhausted", reason="again")
        monkeypatch.setenv("ADAM_TPU_INCIDENT_COOLDOWN_S", "0")
        inc.uninstall()
        off = inc.maybe_record("hedge.fired")
        got.append((sum(p is not None for p in paths), n_files, cooled, off))
    assert got[0] == got[1] == (4, 2, None, None)


def test_quota_burst_records_one_bundle_equal_jax(both, tmp_path):
    got = []
    for name, (inc, _slo, _pl) in both.items():
        inc.install(str(tmp_path / name))
        for _ in range(3):
            inc.note_quota_rejected("A")
        got.append([(r["trigger"], r["reason"]) for r in inc.list_bundles(str(tmp_path / name))])
    assert got[0] == got[1] == [("quota.burst", "3 quota rejections in 10s (tenants: A)")]


@pytest.mark.parametrize("trigger", ["health.transition", "retry.exhausted", "hedge.fired"])
def test_port_triggers_record_bundles(both, tmp_path, trigger):
    """The port's own call sites fire the triggers JAX's fire."""
    import time

    from adam_tpu_torch.parallel import device_pool as dp
    from adam_tpu_torch.utils import health, retry

    inc = both["port"][0]
    inc.install(str(tmp_path))
    if trigger == "health.transition":
        board = health.HealthBoard()
        board.quarantine(dp.make_slots(["cpu"])[0], reason="sdc audit mismatch on window 0")
    elif trigger == "retry.exhausted":
        def fail():
            raise ConnectionError("flaky link")

        with pytest.raises(ConnectionError):
            retry.retry_call(fail, site="device.fetch",
                             policy=retry.RetryPolicy(attempts=2, backoff_s=0.0))
    else:
        got = dp.hedged_call(lambda: time.sleep(0.3) or "primary", lambda: "hedge", 0.01)
        assert got[1] == "hedge"
    rows = inc.list_bundles(str(tmp_path))
    assert [r["trigger"] for r in rows] == [trigger]


def test_streamed_run_arms_the_recorder_on_its_run_dir_and_books(both, tmp_path):
    """A solo run with ``run_dir`` arms the recorder there for its life
    and books its perf keys into ``run_dir/PERF_LEDGER.ndjson``."""
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.pipelines.streamed import transform_streamed

    inc, _slo, pl = both["port"]
    path = str(tmp_path / "in.sam")
    make_wgs(path, 600, 100, n_contigs=1, contig_len=20_000, seed=2)
    transform_streamed(path, str(tmp_path / "out"), window_reads=256, realign=False,
                       run_dir=str(tmp_path / "rd"), device="cpu")
    assert not inc.installed()  # disarmed again after the run
    entries = pl.read_ledger(str(tmp_path / "rd"))
    assert len(entries) == 1
    assert entries[0]["schema"] == "adam_tpu.perf_ledger/1"
    assert "spans.streamed.total.total_s" in entries[0]["keys"]


# --------------------------------------------------------------------------
# the perf ledger's booking side
# --------------------------------------------------------------------------
def _snap(tele, total_s):
    tr = tele.Tracer(recording=True)
    tr.add_span(tele.SPAN_TOTAL, 0, int(total_s * 1e9))
    tr.add_span(tele.SPAN_PASS_C, 0, int(total_s * 0.4e9))
    tr.count(tele.C_READS_INGESTED, 1000)
    return tr.snapshot()


def test_booked_entry_equals_jax(both, tmp_path):
    from adam_tpu.utils import telemetry as jt

    from adam_tpu_torch.utils import telemetry as tt

    entries = []
    for (name, (_inc, _slo, pl)), tele in zip(both.items(), (jt, tt)):
        e = pl.book(str(tmp_path / name), _snap(tele, 2.0), run_id="r1")
        on_disk = pl.read_ledger(str(tmp_path / name))
        assert on_disk == [e]
        entries.append({k: v for k, v in e.items() if k != "ts"})
    assert entries[0] == entries[1]
    assert entries[0]["keys"]["spans.streamed.total.total_s"] == [2.0, "lower"]


def test_sentinel_flags_the_same_regression_as_jax(both, tmp_path):
    from adam_tpu.utils import telemetry as jt

    from adam_tpu_torch.utils import telemetry as tt

    got = []
    for (name, (inc, slo, pl)), tele in zip(both.items(), (jt, tt)):
        root = str(tmp_path / name)
        inc.install(root)
        slo.install("*:avail>=0.99", root, window_s=60)
        for i in range(3):
            assert pl.sentinel(root, _snap(tele, 2.0 + 0.01 * i), run_id=f"b{i}") == []
        regs = pl.sentinel(root, _snap(tele, 4.0), run_id="slow")
        got.append((regs, [r["trigger"] for r in inc.list_bundles(root)],
                    slo.status()["objectives"][0]["bad_total"]))
    assert got[0] == got[1]
    # the regression is an incident and a charge against the SLO budget,
    # whose burn is then an incident of its own
    assert got[0][0] and got[0][1] == ["perf.regression", "slo.burn"]
    assert got[0][2] == len(got[0][0])


@pytest.mark.parametrize("val", [None, "0", "off", "1"])
def test_booking_toggle_and_install_equal_jax(both, tmp_path, monkeypatch, val):
    if val is None:
        monkeypatch.delenv("ADAM_TPU_PERF_LEDGER", raising=False)
    else:
        monkeypatch.setenv("ADAM_TPU_PERF_LEDGER", val)
    got = []
    for _inc, _slo, pl in both.values():
        pl.install(str(tmp_path))
        got.append((pl.booking_enabled(), pl.installed(), pl.ledger_root()))
        pl.uninstall()
        got[-1] += (pl.installed(), pl.ledger_root())
    assert got[0] == got[1]


# --------------------------------------------------------------------------
# the heartbeat fields the recorder and the engine arm
# --------------------------------------------------------------------------
def test_heartbeat_incident_and_burn_fields_equal_jax(both, tmp_path):
    from adam_tpu.utils import telemetry as jt

    from adam_tpu_torch.utils import telemetry as tt

    lines = []
    for (name, (inc, slo, _pl)), tele in zip(both.items(), (jt, tt)):
        inc.install(str(tmp_path / name))
        slo.install("*:avail>=0.9", str(tmp_path / name), window_s=60)
        slo.observe_job("x", 1.0, ok=False)
        inc.maybe_record("hedge.fired", reason="probe")
        hb = tele.Heartbeat([tele.Tracer(recording=True)], sink="stderr", interval_s=60)
        lines.append(hb.sample(done=True))
    for line in lines:
        assert line["last_incident"].endswith("hedge-fired")
        assert 0 <= line["last_incident_age_s"] < 60
    assert lines[0]["slo_worst_burn"] == lines[1]["slo_worst_burn"] == 10.0


# --------------------------------------------------------------------------
# the incidents and perf verbs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("json_out", [False, True], ids=["table", "json"])
def test_incidents_verb_prints_as_jax(both, tmp_path, json_out):
    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    inc = both["port"][0]
    inc.install(str(tmp_path))
    inc.maybe_record("audit.mismatch", device=0, window=4, reason="probe")
    inc.maybe_record("quota.burst", reason="three in a row")
    argv = ["incidents", str(tmp_path)] + (["-json"] if json_out else [])
    jrc, jout, _ = _run(jax_main, argv)
    rc, out, _ = _run(main, argv + ["--device", "cpu"])
    assert rc == jrc == 0
    assert out == jout
    assert "audit.mismatch" in out and "quota.burst" in out
    rc, out, _ = _run(main, ["incidents", str(tmp_path / "none")])
    assert rc == 0 and out.startswith("incidents: none under")


@pytest.mark.parametrize("json_out", [False, True], ids=["table", "json"])
def test_perf_verb_prints_as_jax(both, tmp_path, json_out):
    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main
    from adam_tpu_torch.utils import telemetry as tt

    pl = both["port"][2]
    for i, t in enumerate((2.0, 2.02, 1.98, 2.01, 3.5)):
        pl.book(str(tmp_path), _snap(tt, t), run_id=f"run{i}")
    argv = ["perf", str(tmp_path)] + (["--json"] if json_out else [])
    jrc, jout, jerr = _run(jax_main, argv)
    rc, out, err = _run(main, argv)
    assert rc == jrc == 1  # the newest run regressed
    assert out == jout and err == jerr
    rc, _, err = _run(main, ["perf", str(tmp_path / "empty")])
    assert rc == 2 and "no ledger entries" in err
