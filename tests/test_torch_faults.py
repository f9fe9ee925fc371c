"""The port's fault injection (``adam_tpu_torch/utils/faults.py``) against
the module it ports, ``adam_tpu/utils/faults.py``: the same grammar and
messages, the same arrival counting under ``every``/``after``/``times``,
``device=``, ``pass=`` and seeded ``p=`` clauses, a ``kill`` that
SIGKILLs the process, and an ``install`` that refuses what the port does
not arm yet, naming the ROADMAP item that will arm it."""

import contextlib
import io
import os
import signal
import subprocess
import sys
import textwrap

import pytest

from adam_tpu.utils import faults as jf
from adam_tpu.utils import telemetry as jtele

from adam_tpu_torch.utils import faults as tf
from adam_tpu_torch.utils import telemetry as ttele

REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True)
def _disarmed():
    jf.clear()
    tf.clear()
    yield
    jf.clear()
    tf.clear()


_SPECS = [
    # accepted
    "proc.kill=kill,device=pass_c,after=2,times=1",
    "parquet.write=transient,every=3;parquet.encode=permanent,times=1",
    "device.dispatch=transient,every=3;device.fetch=delay:2.5,after=4",
    "parquet.write=transient,p=0.5,seed=7",
    "parquet.encode=delay:0.01,pass=apply,device=1",
    " ; proc.kill=kill ; ",
    "device.fetch=corrupt,seed=3",
    "gateway.fetch=kill,device=job-1",
    # refused at parse
    "nope.site=transient",
    "device.dispatch=explode",
    "device.dispatch",
    "=transient",
    "device.dispatch=transient,every=zero",
    "device.dispatch=transient,every=0",
    "device.dispatch=transient,wat=1",
    "device.dispatch=transient,after",
    "device.dispatch=delay:soon",
    "device.dispatch=kill:9",
    "parquet.write=corrupt",
    "parquet.write=transient,p=half",
    "parquet.write=transient,seed=x",
]


def _fields(c):
    return (c.site, c.action, c.delay_s, c.every, c.after, c.times, c.device,
            c.pass_name, c.p, c.seed)


@pytest.mark.parametrize("spec", _SPECS)
def test_grammar_accepts_and_refuses_as_jax(spec):
    try:
        want = [_fields(c) for c in jf.parse_spec(spec)]
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tf.parse_spec(spec)
        assert str(got.value) == str(e)
    else:
        assert [_fields(c) for c in tf.parse_spec(spec)] == want
        assert want


def _arrivals(mod, spec, calls, scope=None):
    """Install ``spec`` in ``mod`` and return, per call of ``calls``
    (``(site, device, pass)`` triples), what the point did."""
    mod.install(spec)
    out = []
    for site, device, pass_name in calls:
        ctx = scope(pass_name) if scope and pass_name else contextlib.nullcontext()
        with ctx:
            try:
                mod.point(site, device=device)
                out.append("-")
            except mod.TransientFault:
                out.append("T")
            except mod.PermanentFault:
                out.append("P")
    mod.clear()
    return out


_COUNTING = [
    ("parquet.write=transient,every=3,times=2", [("parquet.write", None, None)] * 12),
    ("parquet.write=transient,after=4", [("parquet.write", None, None)] * 7),
    ("parquet.write=transient,every=2;parquet.write=permanent,after=5",
     [("parquet.write", None, None)] * 8),
    ("parquet.encode=permanent,device=5",
     [("parquet.encode", d, None) for d in (3, 5, 3, 5)]),
    ("parquet.encode=transient,pass=apply,every=2",
     [("parquet.encode", None, p) for p in ("observe", "apply", "apply", None,
                                             "apply", "apply")]),
    ("parquet.write=transient,times=2;parquet.encode=transient,after=1",
     [("parquet.write", None, None), ("parquet.encode", None, None)] * 3),
    ("parquet.write=transient,p=0.4,seed=42", [("parquet.write", None, None)] * 40),
    ("parquet.write=transient,p=0.4,seed=42,after=3,times=4",
     [("parquet.write", None, None)] * 40),
]


@pytest.mark.parametrize("spec,calls", _COUNTING, ids=[s for s, _ in _COUNTING])
def test_arrivals_count_as_jax(spec, calls):
    want = _arrivals(jf, spec, calls, scope=jtele.pass_scope)
    got = _arrivals(tf, spec, calls, scope=ttele.pass_scope)
    assert got == want
    assert "T" in got or "P" in got


def test_seeded_p_clause_reproduces():
    calls = [("parquet.write", None, None)] * 30
    a = _arrivals(tf, "parquet.write=transient,p=0.3,seed=9", calls)
    b = _arrivals(tf, "parquet.write=transient,p=0.3,seed=9", calls)
    c = _arrivals(tf, "parquet.write=transient,p=0.3,seed=10", calls)
    assert a == b != c


def test_disabled_point_is_a_noop():
    assert not tf.ENABLED
    tf.point("parquet.write")
    tf.point("proc.kill", device="pass_c")
    tf.install("parquet.write=transient")
    assert tf.ENABLED
    tf.install(None)
    assert not tf.ENABLED


def test_delay_sleeps(monkeypatch):
    slept = []
    monkeypatch.setattr(tf.time, "sleep", slept.append)
    tf.install("parquet.encode=delay:1.5,times=1")
    tf.point("parquet.encode")
    tf.point("parquet.encode")
    assert slept == [1.5]


def test_pass_scope_nests_and_is_per_thread():
    import threading

    assert ttele.current_pass() is None
    seen = []
    with ttele.pass_scope("a"):
        with ttele.pass_scope("observe"):
            assert ttele.current_pass() == "observe"
            t = threading.Thread(target=lambda: seen.append(ttele.current_pass()))
            t.start()
            t.join(10)
            assert not t.is_alive()
        assert ttele.current_pass() == "a"
    assert ttele.current_pass() is None
    assert seen == [None]


def test_kill_sigkills_self_in_process(monkeypatch):
    sent = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: sent.append((pid, sig)))
    tf.install("proc.kill=kill,device=pass_a,after=1,times=1")
    tf.point("proc.kill", device="ingest")  # other phase: not counted
    tf.point("proc.kill", device="pass_a")  # arrival 1: skipped
    assert sent == []
    tf.point("proc.kill", device="pass_a")
    assert sent == [(os.getpid(), signal.SIGKILL)]
    tf.point("proc.kill", device="pass_a")  # times=1 spent
    assert len(sent) == 1


@pytest.mark.parametrize("how", ["install", "env"])
def test_kill_sigkills_a_child(how):
    arm = ("faults.install('proc.kill=kill,device=x,after=1')"
           if how == "install" else "pass")
    code = textwrap.dedent(f"""
        from adam_tpu_torch.utils import faults
        {arm}
        faults.point("proc.kill", device="x")
        print("first arrival survived", flush=True)
        faults.point("proc.kill", device="x")
        print("still alive", flush=True)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("ADAM_TPU_FAULTS", None)
    if how == "env":
        env["ADAM_TPU_FAULTS"] = "proc.kill=kill,device=x,after=1"
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == -signal.SIGKILL, res.stderr
    assert res.stdout == "first arrival survived\n"


_UNARMED = {
    "sched.admit": "queue 1 item 5",
    "sched.batch": "queue 1 item 5", "sched.dispatch": "queue 1 item 5",
    "sched.drain": "queue 1 item 5", "sched.job_crash": "queue 1 item 5",
    "gateway.accept": "queue 1 item 5", "gateway.stream": "queue 1 item 5",
    "gateway.fetch": "queue 1 item 5",
}


def test_every_known_point_is_armed_or_names_its_item():
    assert tf.KNOWN_POINTS == jf.KNOWN_POINTS
    assert tf.CORRUPT_POINTS == jf.CORRUPT_POINTS
    assert set(_UNARMED) == tf.KNOWN_POINTS - tf.ARMED_POINTS
    assert tf.ARMED_POINTS == {"proc.kill", "parquet.write", "parquet.encode",
                               "device.dispatch", "device.fetch", "pool.prewarm"}


@pytest.mark.parametrize("site", sorted(_UNARMED))
def test_install_refuses_unarmed_sites(site):
    tf.install("parquet.write=transient")
    spec = f"parquet.encode=transient;{site}=transient,every=2"
    jf.install(spec)  # the JAX package arms it
    with pytest.raises(ValueError, match=_UNARMED[site]) as e:
        tf.install(spec)
    assert "not arm this fault point yet" in str(e.value)
    # a refused spec leaves the armed one as it was
    assert tf.ENABLED
    with pytest.raises(tf.TransientFault):
        tf.point("parquet.write")


def test_install_refuses_corrupt():
    """``corrupt`` at ``device.fetch`` is armed now (the SDC audit catches
    it): both packages flip the same bit of the same array for a seed, and
    the control channel (``point``) never fires a ``corrupt`` clause."""
    import numpy as np

    arr = np.arange(64, dtype=np.int64)
    jf.install("device.fetch=corrupt,seed=1")
    tf.install("device.fetch=corrupt,seed=1")
    try:
        assert tf.ENABLED
        tf.point("device.fetch")  # no raise: corrupt lives on the data channel
        got_t = tf.corrupt_array("device.fetch", arr)
        got_j = jf.corrupt_array("device.fetch", arr)
        np.testing.assert_array_equal(got_t, got_j)
        assert (got_t != arr).sum() == 1
        assert bin(int(got_t[got_t != arr][0] ^ arr[got_t != arr][0])).count("1") == 1
    finally:
        jf.clear()
        tf.clear()
    assert tf.corrupt_array("device.fetch", arr) is arr


@pytest.mark.parametrize("spec", ["nope.site=transient", "proc.kill=kill,every=0",
                                  "sched.admit=transient"])
def test_cli_refuses_a_bad_fault_spec_as_jax(spec, tmp_path):
    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    argv = ["transform", str(tmp_path / "in.sam"), str(tmp_path / "out.adam"),
            "-streaming", "--fault-spec", spec, "--device", "cpu"]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    assert rc == 2
    line = err.getvalue().strip()
    assert line.startswith("--fault-spec: fault clause")
    try:
        jf.parse_spec(spec)
    except ValueError as e:
        jerr = io.StringIO()
        with contextlib.redirect_stderr(jerr):
            assert jax_main(argv[:-2]) == 2
        assert line == jerr.getvalue().strip() == f"--fault-spec: {e}"
    else:
        assert "queue 1 item 5" in line


@pytest.mark.parametrize("site,where", [
    ("device.dispatch", "the dispatch of pass B"),
    ("device.fetch", "the fetch of the observe histograms"),
    ("pool.prewarm", "a slot's prewarm"),
])
def test_armed_device_sites_fire(site, where, tmp_path):
    """The three multi-device sites fire in the port's code: an injected
    transient fault is retried (``retry.attempts``) and the run's parts are
    the same bytes as a clean run's."""
    sys.path.insert(0, os.path.join(str(REPO), "tools"))
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.parallel import device_pool as dp
    from adam_tpu_torch.pipelines.streamed import transform_streamed
    from adam_tpu_torch.utils import telemetry as tele

    sam = str(tmp_path / "in.sam")
    make_wgs(sam, 1500, 100, n_contigs=1, contig_len=20_000)
    kw = dict(window_reads=1024, device="cpu")
    transform_streamed(sam, str(tmp_path / "clean"), **kw)
    dp.reset_prewarm_cache()
    old = os.environ.get("ADAM_TPU_RETRY_BACKOFF_S")
    os.environ["ADAM_TPU_RETRY_BACKOFF_S"] = "0.001"
    tf.install(f"{site}=transient,times=1")
    tele.TRACE.reset()
    tele.TRACE.recording = True
    try:
        transform_streamed(sam, str(tmp_path / "faulted"),
                           device_pool=dp.DevicePool(dp.make_slots(["cpu", "cpu"])), **kw)
        counters = tele.TRACE.snapshot()["counters"]
    finally:
        tele.TRACE.recording = False
        tf.clear()
        dp.reset_prewarm_cache()
        if old is None:
            os.environ.pop("ADAM_TPU_RETRY_BACKOFF_S", None)
        else:
            os.environ["ADAM_TPU_RETRY_BACKOFF_S"] = old
    assert counters[tele.C_FAULT_INJECTED] == 1, where
    assert counters[tele.C_RETRY_ATTEMPTS] == 1, where

    def parts(d):
        return {f: (tmp_path / d / f).read_bytes()
                for f in sorted(os.listdir(tmp_path / d)) if f.startswith("part-")}

    assert parts("faulted") == parts("clean")
