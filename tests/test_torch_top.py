"""The port's ``top`` dashboard (``adam_tpu_torch/utils/top.py``) against
the JAX package's: the same heartbeat lines parse to the same samples and
render to the same frames (single run and multi-job), and the follow
loops keep the exit contract (0 on done+ok, 1 on done+!ok, 2 on no
stream) through rotation, a job joining mid-watch, the ``top`` verb, the
``--progress`` file of a streamed run on the CPU, and ``--url`` against
the port's gateway on loopback."""

import hashlib
import io
import json
import os
import pathlib
import sys
import threading
import time

import pytest

from adam_tpu_torch.cli.main import main
from adam_tpu_torch.utils import telemetry as tele
from adam_tpu_torch.utils import top as top_mod

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))


def _line(**over):
    base = {
        "schema": tele.HEARTBEAT_SCHEMA,
        "seq": 0,
        "elapsed_s": 1.5,
        "windows_ingested": 2,
        "windows_total": 4,
        "windows_resumed": 1,
        "parts_written": 1,
        "reads_ingested": 5000,
        "reads_per_s": 3333.3,
        "bytes_written": 1 << 20,
        "h2d_bytes": 10 << 20,
        "d2h_bytes": 5 << 20,
        "hbm_bytes_in_use": {"0": 1 << 30},
        "hbm_peak_bytes": 2 << 30,
        "inflight": 2,
        "inflight_per_device": {"0": 1, "1": 1},
        "retries": 3,
        "faults": 1,
        "devices_evicted": 0,
        "eta_s": 4.5,
        "done": False,
        "ok": True,
    }
    base.update(over)
    return base


def _without(line, *prefixes):
    return {k: v for k, v in line.items() if not k.startswith(prefixes)}


#: heartbeat lines of every schema and cell the dashboard renders
LINES = {
    "running /7": _line(),
    "done": _line(done=True, ok=True, eta_s=0.0),
    "failed": _line(done=True, ok=False),
    "/1 without the ledger fields": dict(
        _without(_line(), "h2d", "d2h", "hbm"), schema="adam_tpu.heartbeat/1"),
    "no card: hbm unsupported": _line(hbm_bytes_in_use={}, hbm_peak_bytes=None,
                                      inflight_per_device={}),
    "hours and minutes": _line(elapsed_s=7384.0, eta_s=61.0, windows_total=None),
    "batching /4": _line(schema="adam_tpu.heartbeat/4", batch_fill=0.625,
                         batched_jobs=3, partitioner="mesh"),
    "health /5": _line(device_health={"0": "healthy", "1": "probation"}),
    "all healthy": _line(device_health={"0": "healthy", "1": "healthy"}),
    "observe /6": _line(active_traces=2, metrics_scrapes=7,
                        last_incident="inc-0001.json", last_incident_age_s=65.0),
    "no incidents": _line(active_traces=0),
    "slo /7": _line(slo_worst_burn=14.4, perf_regressions=2),
    "regressions without slo": _line(slo_worst_burn=None, perf_regressions=1),
}


@pytest.mark.parametrize("name", list(LINES))
def test_render_frame_equals_jax(name):
    from adam_tpu.utils import top as jax_top

    line = LINES[name]
    assert top_mod.render_frame(line, source="hb.ndjson") == \
        jax_top.render_frame(line, source="hb.ndjson")
    assert top_mod.render_frame(line) == jax_top.render_frame(line)


MULTI = {
    "mixed states with a pool": (
        {"a": _line(done=True, ok=True, parts_written=3, bytes_written=100,
                    reads_ingested=10),
         "b": _line(done=False, parts_written=2, bytes_written=50,
                    reads_ingested=5, reads_per_s=7.0),
         "c": _line(done=True, ok=False, parts_written=0)},
        {"h2d_bytes": 9 << 20, "d2h_bytes": 1 << 20, "retries": 4, "faults": 2,
         "batch_fill": 0.5, "batched_jobs": 2, "active_traces": 1,
         "slo_worst_burn": 3.0},
        {"c": "interrupted"}),
    "all done, no pool": (
        {"job-with-a-very-long-name": _line(done=True), "z": _line(done=True)},
        None, None),
    "a failure": ({"a": _line(done=True, ok=False), "b": _line(done=True)},
                  {"perf_regressions": 1, "last_incident": "i.json"}, {}),
}


@pytest.mark.parametrize("name", list(MULTI))
def test_render_multi_frame_equals_jax(name):
    from adam_tpu.utils import top as jax_top

    jobs, pool, states = MULTI[name]
    assert top_mod.render_multi_frame(jobs, root="R", pool=pool, states=states) == \
        jax_top.render_multi_frame(jobs, root="R", pool=pool, states=states)


def test_parse_equals_jax_on_torn_tails_and_junk():
    from adam_tpu.utils import top as jax_top

    good = json.dumps(_line(seq=0)) + "\n" + json.dumps(_line(seq=1)) + "\n"
    v1 = dict(_without(_line(seq=3), "h2d", "d2h", "hbm"),
              schema="adam_tpu.heartbeat/1")
    future = dict(_line(seq=4), schema="adam_tpu.heartbeat/99")
    text = (good + "not json\n" + json.dumps(v1) + "\n" + json.dumps(future)
            + "\n[1, 2]\n" + json.dumps(_line(seq=2)))  # no newline
    lines = top_mod.parse_heartbeat_text(text)
    assert lines == jax_top.parse_heartbeat_text(text)
    assert [ln["seq"] for ln in lines] == [0, 1, 3]
    assert top_mod.ACCEPTED_SCHEMAS == tuple(
        f"adam_tpu.heartbeat/{i}" for i in range(1, 8))
    assert tele.HEARTBEAT_SCHEMA in top_mod.ACCEPTED_SCHEMAS


def test_follow_exit_codes(tmp_path):
    p = str(tmp_path / "hb.ndjson")
    with open(p, "w") as fh:
        fh.write(json.dumps(_line(seq=0)) + "\n")
        fh.write(json.dumps(_line(seq=1, done=True, ok=True)) + "\n")
    out = io.StringIO()
    assert top_mod.follow(p, interval=0.01, out=out) == 0
    assert "DONE" in out.getvalue()
    with open(p, "w") as fh:
        fh.write(json.dumps(_line(done=True, ok=False)) + "\n")
    assert top_mod.follow(p, interval=0.01, out=io.StringIO()) == 1
    assert top_mod.follow(str(tmp_path / "nope.ndjson"), once=True,
                          out=io.StringIO()) == 2
    empty = str(tmp_path / "empty.ndjson")
    open(empty, "w").close()
    assert top_mod.follow(empty, once=True, out=io.StringIO()) == 2
    # a live stream: one frame in -once mode; a stalled one ends at max_wait
    live = str(tmp_path / "live.ndjson")
    with open(live, "w") as fh:
        fh.write(json.dumps(_line(seq=0)) + "\n")
    out = io.StringIO()
    assert top_mod.follow(live, once=True, out=out) == 0
    assert "RUNNING" in out.getvalue()
    assert top_mod.follow(live, interval=0.01, out=io.StringIO(),
                          max_wait_s=0.05) == 2


def test_follow_survives_rotation_and_a_torn_tail(tmp_path):
    p = str(tmp_path / "hb.ndjson")
    big = json.dumps(_line(seq=0, reads_ingested=10**9)) + "\n"
    with open(p, "w") as fh:
        fh.write(big * 5)
    assert top_mod.follow(p, once=True, out=io.StringIO()) == 0

    def writer():
        time.sleep(0.1)
        # rotation: a much smaller fresh file; the final line lands torn
        # first, then completed
        final = json.dumps(_line(seq=9, done=True))
        with open(p, "w") as fh:
            fh.write(json.dumps(_line(seq=8)) + "\n" + final[:20])
        time.sleep(0.1)
        with open(p, "a") as fh:
            fh.write(final[20:] + "\n")

    t = threading.Thread(target=writer)
    t.start()
    out = io.StringIO()
    try:
        assert top_mod.follow(p, interval=0.02, out=out, max_wait_s=30) == 0
    finally:
        t.join(timeout=30)
    assert not t.is_alive()
    assert "seq 9" in out.getvalue()


def _job_stream(root, job, *lines):
    d = root / job
    d.mkdir(parents=True, exist_ok=True)
    with open(d / "heartbeat.ndjson", "w") as fh:
        for ln in lines:
            fh.write(json.dumps(ln) + "\n")


def test_follow_root_exit_codes_and_midwatch_join(tmp_path):
    root = tmp_path / "run-root"
    root.mkdir()
    assert top_mod.follow_root(str(root), interval=0.01, once=True,
                               out=io.StringIO()) == 2
    _job_stream(root, "jobA", _line(seq=0), _line(seq=1, done=True))
    _job_stream(root, "jobB", _line(seq=0, done=True))
    with open(root / "heartbeat.ndjson", "w") as fh:
        fh.write(json.dumps(_line(seq=0, done=True)) + "\n")
    out = io.StringIO()
    assert top_mod.follow_root(str(root), interval=0.01, out=out) == 0
    assert "jobA" in out.getvalue() and "2 job(s)" in out.getvalue()
    _job_stream(root, "jobB", _line(seq=0, done=True, ok=False))
    assert top_mod.follow_root(str(root), interval=0.01, out=io.StringIO()) == 1
    # a graceful drain (JOB.json interrupted) is a clean stop
    with open(root / "jobB" / "JOB.json", "w") as fh:
        json.dump({"state": "interrupted"}, fh)
    assert top_mod.follow_root(str(root), interval=0.01, out=io.StringIO()) == 0
    os.unlink(root / "jobB" / "JOB.json")
    # a job joining mid-watch; a live service stream keeps the watch open
    with open(root / "heartbeat.ndjson", "w") as fh:
        fh.write(json.dumps(_line(seq=0)) + "\n")
    _job_stream(root, "jobB", _line(seq=0))

    def late_join():
        time.sleep(0.15)
        _job_stream(root, "jobC", _line(seq=0, done=True))
        _job_stream(root, "jobB", _line(seq=1, done=True))
        with open(root / "heartbeat.ndjson", "a") as fh:
            fh.write(json.dumps(_line(seq=1, done=True)) + "\n")

    t = threading.Thread(target=late_join)
    t.start()
    out = io.StringIO()
    try:
        assert top_mod.follow_root(str(root), interval=0.02, out=out,
                                   max_wait_s=30) == 0
    finally:
        t.join(timeout=30)
    assert not t.is_alive()
    assert "jobC" in out.getvalue() and "3 job(s)" in out.getvalue()


def test_top_verb(tmp_path, capsys):
    p = str(tmp_path / "hb.ndjson")
    with open(p, "w") as fh:
        fh.write(json.dumps(_line(slo_worst_burn=2.0)) + "\n")
    assert main(["top", p, "-once"]) == 0
    assert "burn 2.0x" in capsys.readouterr().out
    with open(p, "a") as fh:
        fh.write(json.dumps(_line(seq=1, done=True, ok=False)) + "\n")
    assert main(["top", p, "--once"]) == 1
    assert "FAILED" in capsys.readouterr().out
    assert main(["top", str(tmp_path / "absent.ndjson"), "--once"]) == 2
    root = tmp_path / "serve-root"
    _job_stream(root, "j1", _line(done=True))
    assert main(["top", str(root), "-once"]) == 0
    assert "multi-job" in capsys.readouterr().out
    # exactly one of a stream and --url; top needs no card
    assert main(["top"]) == 2
    assert main(["top", p, "--url", "http://127.0.0.1:9"]) == 2
    assert main(["top", p, "-once", "--device", "cuda"]) == 1


def test_top_renders_a_cpu_streamed_runs_progress_file(tmp_path, capsys):
    """A streamed transform on the CPU writes its --progress heartbeat;
    ``top`` follows the finished file to exit 0, its last frame is the
    done frame with the "no card" hbm line, and every frame equals JAX's
    for the same lines."""
    from make_wgs_sam import make_wgs

    from adam_tpu.utils import top as jax_top

    sam, hb = tmp_path / "in.sam", tmp_path / "hb.ndjson"
    make_wgs(str(sam), 1500, 100, n_contigs=2, contig_len=30_000)
    rc = main(["transform", str(sam), str(tmp_path / "out.adam"), "-streaming",
               "-mark_duplicate_reads", "-recalibrate_base_qualities",
               "-window_reads", "512", "--progress", str(hb), "--device", "cpu"])
    assert rc == 0
    capsys.readouterr()
    lines = top_mod.parse_heartbeat_text(hb.read_text())
    assert lines and lines[-1]["done"] and lines[-1]["ok"]
    assert lines[-1]["windows_ingested"] == lines[-1]["windows_total"] == 3
    for ln in lines:
        assert top_mod.render_frame(ln, source=str(hb)) == \
            jax_top.render_frame(ln, source=str(hb))
    assert main(["top", str(hb), "-interval", "0.05", "-max_wait", "60"]) == 0
    last = capsys.readouterr().out.strip().split("\n\n")[-1]
    assert last == top_mod.render_frame(lines[-1], source=str(hb))
    assert "DONE" in last and "run complete" in last
    assert "hbm      (unsupported backend — no memory stats)" in last


def _stub_pipeline(monkeypatch):
    """The streamed pipeline replaced by a gated stub that writes a
    two-line heartbeat (the last ``done``) and two parts."""
    from adam_tpu_torch.serve import scheduler

    release = threading.Event()

    def fake(inp, out, **kw):
        assert release.wait(30), "stub never released"
        with open(kw["progress"], "w") as fh:
            for seq, done in ((0, False), (1, True)):
                fh.write(json.dumps(_line(seq=seq, done=done, parts_written=2 * seq))
                         + "\n")
        os.makedirs(out, exist_ok=True)
        seed = hashlib.sha256(os.path.basename(out).encode()).digest()
        for name in ("part-r-00000.parquet", "part-r-00001.parquet"):
            with open(os.path.join(out, name), "wb") as fh:
                fh.write(seed)
        return {"n_reads": 0, "windows_fresh": 2}

    monkeypatch.setattr(scheduler.streamed_mod, "transform_streamed", fake)
    return release


def test_top_url_follows_the_ports_gateway(monkeypatch, tmp_path):
    """``top --url`` over the port's gateway on loopback: the watch ends 0
    once both jobs are done, and the JAX dashboard's follow_url gives the
    same frames from the same gateway."""
    from adam_tpu.utils import top as jax_top

    from adam_tpu_torch.api.transform_service import TransformService
    from adam_tpu_torch.gateway import GatewayClient, GatewayServer

    release = _stub_pipeline(monkeypatch)
    svc = TransformService(str(tmp_path / "root"), max_jobs=2, device="cpu")
    gw = GatewayServer(svc)
    gw.start()
    try:
        c = GatewayClient(gw.url)
        for job in ("ja", "jb"):
            c.submit(job, {"input": "in.sam", "output": str(tmp_path / f"{job}.adam")})
        out = io.StringIO()
        assert top_mod.follow_url(gw.url, interval=0.05, once=True, out=out) == 2
        release.set()
        assert svc.wait(timeout=30)
        out = io.StringIO()
        assert top_mod.follow_url(gw.url, interval=0.05, out=out, max_wait_s=60) == 0
        frame = out.getvalue().strip().split("\n\n")[-1]
        assert "2 job(s)" in frame and "ja" in frame and "jb" in frame
        assert "all jobs finished" in frame
        jout = io.StringIO()
        assert jax_top.follow_url(gw.url, interval=0.05, out=jout, max_wait_s=60) == 0
        assert jout.getvalue() == out.getvalue()
    finally:
        release.set()
        gw.close()
        svc.wait(timeout=30)
        svc.close()
    # the gateway gone and nothing seen: exit 2
    assert top_mod.follow_url(gw.url, interval=0.01, once=True, out=io.StringIO()) == 2
