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
    "device.dispatch": "queue 1 item 4", "device.fetch": "queue 1 item 4",
    "pool.prewarm": "queue 1 item 4", "sched.admit": "queue 1 item 5",
    "sched.batch": "queue 1 item 5", "sched.dispatch": "queue 1 item 5",
    "sched.drain": "queue 1 item 5", "sched.job_crash": "queue 1 item 5",
    "gateway.accept": "queue 1 item 5", "gateway.stream": "queue 1 item 5",
    "gateway.fetch": "queue 1 item 5",
}


def test_every_known_point_is_armed_or_names_its_item():
    assert tf.KNOWN_POINTS == jf.KNOWN_POINTS
    assert tf.CORRUPT_POINTS == jf.CORRUPT_POINTS
    assert set(_UNARMED) == tf.KNOWN_POINTS - tf.ARMED_POINTS
    assert tf.ARMED_POINTS == {"proc.kill", "parquet.write", "parquet.encode"}


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
    jf.install("device.fetch=corrupt,seed=1")
    with pytest.raises(ValueError, match="queue 1 item 5") as e:
        tf.install("device.fetch=corrupt,seed=1")
    assert "'corrupt'" in str(e.value) and "SDC audit" in str(e.value)
    assert not tf.ENABLED


@pytest.mark.parametrize("spec", ["nope.site=transient", "proc.kill=kill,every=0",
                                  "device.dispatch=transient"])
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
        assert "queue 1 item 4" in line
