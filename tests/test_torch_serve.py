"""The port's multi-job service (``adam_tpu_torch/serve``) against the JAX
package's: the same job specs through JAX's ``JobScheduler`` (its CPU
backend, device BQSR, as its own tests run it) and the port's
(``device="cpu"``), batched and unbatched, give every job the same part
bytes; the fairness interleaver grants in JAX's order; admission,
quarantine, drain, recovery, cancel and the SIGKILL-and-resume of the
``serve`` verb keep each job's parts those of its solo run.

Every scheduler a test starts is closed in a ``finally`` after a bounded
wait, so a hung job thread fails its test instead of the suite."""

import hashlib
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import threading
import time

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

WINDOW = 512
N_READS = 2048


def _parts(d) -> dict:
    return {f: hashlib.sha256((pathlib.Path(d) / f).read_bytes()).hexdigest()
            for f in sorted(os.listdir(d)) if f.startswith("part-")}


class _Env:
    """Set environment variables for a block (restored after)."""

    def __init__(self, **kv):
        self.kv = kv

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.kv}
        os.environ.update(self.kv)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run_jobs(sched_cls, spec_cls, root, inputs, outs, **kw):
    """Two jobs (tenant A weight 2, tenant B weight 1) through one
    scheduler to completion -> status jobs."""
    sched = sched_cls(root, max_jobs=2, **kw)
    try:
        for (jid, inp), tenant, weight in zip(inputs.items(), "AB", (2.0, 1.0)):
            spec = spec_cls(job_id=jid, input=inp, output=outs[jid], tenant=tenant,
                            weight=weight, window_reads=WINDOW)
            assert type(sched.submit(spec)).__name__ == "Admitted"
        assert sched.wait(timeout=600)
        return sched.status()["jobs"]
    finally:
        sched.close()


@pytest.fixture(scope="module")
def service_runs(tmp_path_factory):
    """Two inputs, each job's solo port run, and both packages'
    schedulers unbatched and batched over the same specs."""
    from make_wgs_sam import make_wgs

    from adam_tpu.serve import JobScheduler as JaxScheduler
    from adam_tpu.serve import JobSpec as JaxSpec

    from adam_tpu_torch.pipelines.streamed import transform_streamed
    from adam_tpu_torch.serve import JobScheduler, JobSpec

    d = tmp_path_factory.mktemp("serve")
    inputs = {}
    for k, seed in (("ja", 11), ("jb", 12)):
        inputs[k] = str(d / f"{k}.sam")
        make_wgs(inputs[k], N_READS, 100, n_contigs=2, contig_len=30_000, seed=seed)
    runs = {"inputs": inputs, "dir": d, "solo": {}}
    for jid, inp in inputs.items():
        transform_streamed(inp, str(d / f"solo-{jid}"), window_reads=WINDOW, device="cpu")
        runs["solo"][jid] = _parts(d / f"solo-{jid}")
    for batching in (False, True):
        tag = "batched" if batching else "unbatched"
        with _Env(ADAM_TPU_BQSR_BACKEND="device", ADAM_TPU_RESIDENT="1"):
            outs = {j: str(d / f"jax-{tag}-{j}") for j in inputs}
            st = _run_jobs(JaxScheduler, JaxSpec, str(d / f"jroot-{tag}"), inputs, outs,
                           batching=batching)
        assert {v["state"] for v in st.values()} == {"done"}, st
        runs[f"jax-{tag}"] = {j: _parts(o) for j, o in outs.items()}
        outs = {j: str(d / f"port-{tag}-{j}") for j in inputs}
        st = _run_jobs(JobScheduler, JobSpec, str(d / f"proot-{tag}"), inputs, outs,
                       batching=batching, device="cpu")
        assert {v["state"] for v in st.values()} == {"done"}, st
        runs[f"port-{tag}"] = {j: _parts(o) for j, o in outs.items()}
    return runs


@pytest.mark.parametrize("tag", ["unbatched", "batched"])
def test_scheduler_parts_equal_jax(service_runs, tag):
    port, jax = service_runs[f"port-{tag}"], service_runs[f"jax-{tag}"]
    for jid in service_runs["inputs"]:
        assert len(port[jid]) >= 5, jid  # 4 windows + the realigned part
        assert port[jid] == jax[jid] == service_runs["solo"][jid], jid


def test_batched_run_went_through_the_coalescer(tmp_path):
    """A batched pair of jobs fuses windows of both (the coalescer's own
    counters), and every job's parts are its solo run's."""
    from adam_tpu_torch.serve import JobScheduler, JobSpec
    from adam_tpu_torch.utils import telemetry as tele

    from make_wgs_sam import make_wgs

    inputs, solo = {}, {}
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    for k, seed in (("ba", 3), ("bb", 4)):
        inputs[k] = str(tmp_path / f"{k}.sam")
        make_wgs(inputs[k], 1024, 100, n_contigs=2, contig_len=20_000, seed=seed)
        transform_streamed(inputs[k], str(tmp_path / f"s-{k}"), window_reads=256,
                           device="cpu")
        solo[k] = _parts(tmp_path / f"s-{k}")
    tele.TRACE.reset()
    sched = JobScheduler(str(tmp_path / "root"), max_jobs=2, batching=True,
                         batch_wait_ms=200, device="cpu")
    try:
        for k, inp in inputs.items():
            sched.submit(JobSpec(job_id=k, input=inp, output=str(tmp_path / f"o-{k}"),
                                 tenant=k, window_reads=256))
        assert sched.wait(timeout=300)
        coal = sched._coalescer
        groups = coal.largest_groups()
        c, _ = tele.TRACE.counters_and_gauges()
        spans = tele.TRACE.snapshot()["spans"]
    finally:
        sched.close()
    assert c["sched.batch.dispatches"] >= 3
    assert c["sched.batch.windows"] > c["sched.batch.dispatches"]
    assert c.get("sched.batch.fallbacks", 0) == 0
    # the two jobs' windows met in a fused observe: n_rg is two jobs' bins
    assert groups["observe"]["tickets"] >= 2
    assert tele.SPAN_BATCH_FUSED in spans and tele.SPAN_SCHED_JOB in spans
    for k in inputs:
        assert _parts(tmp_path / f"o-{k}") == solo[k], k


# --------------------------------------------------------------------------
# the job model, the manifest and the fairness interleaver, against JAX's
# --------------------------------------------------------------------------
def test_job_spec_round_trip_equals_jax():
    from adam_tpu.serve.job import JobSpec as JaxSpec

    from adam_tpu_torch.serve.job import JobSpec

    doc = {"job_id": "t-1", "input": "a.sam", "output": "a.adam", "tenant": "T",
           "weight": 2.5, "realign": False, "window_reads": 4096, "trace_id": "ab" * 8}
    port, jax = JobSpec.from_doc(doc), JaxSpec.from_doc(doc)
    assert port.to_doc() == jax.to_doc()
    assert json.dumps(port.to_doc(), sort_keys=True) == json.dumps(jax.to_doc(), sort_keys=True)


@pytest.mark.parametrize("bad", [
    {"job_id": "../evil", "input": "a", "output": "b"},
    {"job_id": "ok", "input": "a", "output": "b", "weight": 0},
    {"job_id": "ok", "input": "", "output": "b"},
    {"job_id": "ok", "input": "a", "output": "b", "window_reads": 0},
])
def test_job_spec_validation_equals_jax(bad):
    from adam_tpu.serve.job import JobSpec as JaxSpec

    from adam_tpu_torch.serve.job import JobSpec

    with pytest.raises(ValueError) as port:
        JobSpec.from_doc(bad)
    with pytest.raises(ValueError) as jax:
        JaxSpec.from_doc(bad)
    assert str(port.value) == str(jax.value)


@pytest.mark.parametrize("doc,match", [
    ({"jobs": [{"job_id": "a", "input": "i", "output": "o", "weight": 2.0}]}, None),
    ([{"job_id": "a", "input": "i", "output": "o"}], None),
    ({"jobs": [{"job_id": "a", "input": "i", "output": "o", "nope": 1}]}, "unknown field"),
    ({"jobs": [{"job_id": "a", "input": "i", "output": "o"},
               {"job_id": "a", "input": "i", "output": "p"}]}, "duplicate"),
    ({"jobs": "x"}, "expected a list"),
    ({"jobs": [7]}, "not an object"),
])
def test_manifest_equals_jax(tmp_path, doc, match):
    from adam_tpu.api.transform_service import load_jobs_manifest as jax_load

    from adam_tpu_torch.api.transform_service import load_jobs_manifest

    path = tmp_path / "jobs.json"
    path.write_text(json.dumps(doc))
    if match is None:
        assert ([s.to_doc() for s in load_jobs_manifest(str(path))]
                == [s.to_doc() for s in jax_load(str(path))])
        return
    with pytest.raises(ValueError, match=match) as port:
        load_jobs_manifest(str(path))
    with pytest.raises(ValueError) as jax:
        jax_load(str(path))
    assert str(port.value) == str(jax.value)


def _arbitrate(inter, n):
    """n grant decisions with every lane pinned as waiting (the saturated
    backlog view of the WFQ arbitration, as JAX's tests drive it)."""
    order = []
    for _ in range(n):
        with inter._lock:
            for seq, lane in enumerate(inter._lanes.values(), 1):
                if lane.waiting_seq is None:
                    lane.waiting_seq = seq
            lane = inter._next_waiter_locked()
            t = inter._tenants[lane.tenant]
            inter._vtime = t.vt
            t.vt += 1.0 / t.weight
            lane.waiting_seq = None
        order.append(lane.job)
    return order


@pytest.mark.parametrize("lanes", [
    [("a", "A", 3.0), ("b", "B", 1.0)],
    [("t1-a", "T1", 1.0), ("t1-b", "T1", 1.0), ("t2-z", "T2", 1.0)],
    [("A1", "A", 2.0), ("A2", "A", 2.0), ("B1", "B", 1.0), ("B2", "B", 1.0)],
])
def test_interleaver_grant_sequence_equals_jax(lanes):
    from adam_tpu.serve import WeightedInterleaver as JaxInterleaver

    from adam_tpu_torch.serve import WeightedInterleaver

    orders = []
    for cls in (WeightedInterleaver, JaxInterleaver):
        inter = cls()
        for job, tenant, weight in lanes:
            inter.register(job, tenant=tenant, weight=weight)
        orders.append(_arbitrate(inter, 60))
    assert orders[0] == orders[1]
    weights = {}
    for _job, tenant, weight in lanes:
        weights[tenant] = weight
    share = {t: sum(1 for j in orders[0] for jj, tt, _ in lanes if jj == j and tt == t)
             for t in weights}
    total = sum(weights.values())
    for t, w in weights.items():
        assert share[t] == 60 * w / total, share


def test_interleaver_threaded_liveness_and_cancel():
    from adam_tpu_torch.pipelines.streamed import RunCancelled
    from adam_tpu_torch.serve import WeightedInterleaver

    inter = WeightedInterleaver()
    inter.register("a", tenant="A", weight=2.0)
    inter.register("b", tenant="B", weight=1.0)
    ts = [threading.Thread(target=lambda j=j: [inter.turn(j, size=10) for _ in range(50)])
          for j in ("a", "b")]
    try:
        for t in ts:
            t.start()
    finally:
        for t in ts:
            t.join(30)
    assert not any(t.is_alive() for t in ts)
    grants = inter.grant_history()
    assert grants.count("a") == 50 and grants.count("b") == 50
    assert all(s == 10 for _, s in inter.grant_records())
    inter.cancel("a")
    with pytest.raises(RunCancelled):
        inter.turn("a")
    inter.turn("b")  # only one job cancelled
    inter.cancel()
    with pytest.raises(RunCancelled):
        inter.turn("b")
    inter.turn("never-registered")  # unregistered jobs free-run


# --------------------------------------------------------------------------
# admission, with a gate-controlled stub in place of the pipeline
# --------------------------------------------------------------------------
@pytest.fixture()
def stub_transform(monkeypatch):
    from adam_tpu_torch.serve import scheduler as sched_mod

    release = threading.Event()
    calls = []

    def fake(inp, out, **kw):
        calls.append(kw)
        assert release.wait(30), "stub never released"
        return {"n_reads": 0, "windows_fresh": 0}

    monkeypatch.setattr(sched_mod.streamed_mod, "transform_streamed", fake)
    yield {"release": release, "calls": calls}
    release.set()


def test_admission_capacity_and_typed_busy(tmp_path, stub_transform):
    from adam_tpu_torch.serve import Admitted, Busy, JobScheduler, JobSpec

    sched = JobScheduler(str(tmp_path / "root"), max_jobs=2, device="cpu")
    try:
        mk = lambda jid: JobSpec(job_id=jid, input="in", output="out")  # noqa: E731
        assert isinstance(sched.submit(mk("j1")), Admitted)
        assert isinstance(sched.submit(mk("j2")), Admitted)
        got = sched.submit(mk("j3"))
        assert isinstance(got, Busy) and got.kind == "capacity"
        dup = sched.submit(mk("j1"))
        assert isinstance(dup, Busy) and dup.kind == "duplicate"
        stub_transform["release"].set()
        assert sched.wait(timeout=30)
        assert isinstance(sched.submit(mk("j3")), Admitted)
        assert sched.wait(timeout=30)
        st = sched.status()["jobs"]
        assert {st[j]["state"] for j in ("j1", "j2", "j3")} == {"done"}
        # the jobs run on the scheduler's device, paced, traced
        assert {c["device"] for c in stub_transform["calls"]} == {"cpu"}
        assert all(callable(c["pacer"]) and c["trace"] for c in stub_transform["calls"])
    finally:
        stub_transform["release"].set()
        sched.wait(timeout=30)
        sched.close()


def test_admission_rejects_while_draining(tmp_path, stub_transform):
    from adam_tpu_torch.serve import Admitted, Busy, JobScheduler, JobSpec

    sched = JobScheduler(str(tmp_path / "root"), max_jobs=4, device="cpu")
    try:
        assert isinstance(sched.submit(JobSpec(job_id="j1", input="in", output="out")),
                          Admitted)
        sched.request_drain()
        got = sched.submit(JobSpec(job_id="j2", input="in", output="out"))
        assert isinstance(got, Busy) and got.kind == "draining"
    finally:
        stub_transform["release"].set()
        assert sched.wait(timeout=30)
        sched.close()


def test_submit_blocking_deadline_surfaces_busy(tmp_path, stub_transform):
    from adam_tpu_torch.api.transform_service import TransformService
    from adam_tpu_torch.serve import Admitted, Busy, JobSpec

    svc = TransformService(str(tmp_path / "root"), max_jobs=1, device="cpu")
    try:
        mk = lambda jid: JobSpec(job_id=jid, input="in", output="out")  # noqa: E731
        assert isinstance(svc.submit(mk("hold")), Admitted)
        t0 = time.monotonic()
        got = svc.submit_blocking(mk("waiter"), deadline_s=0.5, poll_s=0.05)
        assert isinstance(got, Busy) and got.kind == "capacity"
        assert 0.4 <= time.monotonic() - t0 < 5.0
        dup = svc.submit_blocking(mk("hold"), deadline_s=30.0)
        assert isinstance(dup, Busy) and dup.kind == "duplicate"
        stub_transform["release"].set()
        assert svc.wait(timeout=30)
        assert isinstance(svc.submit_blocking(mk("waiter"), deadline_s=30.0), Admitted)
    finally:
        stub_transform["release"].set()
        svc.wait(timeout=30)
        svc.close()


def test_quota_refusal_equals_jax(tmp_path, stub_transform):
    """An over-budget tenant's fresh submission is refused with the typed
    quota leg and a budget-derived Retry-After, as JAX's scheduler does."""
    from adam_tpu_torch.serve import Busy, JobScheduler, JobSpec, QuotaManager

    clock = [100.0]
    qm = QuotaManager("A:bytes=1K", window_s=60, clock=lambda: clock[0])
    sched = JobScheduler(str(tmp_path / "root"), max_jobs=4, quota=qm, device="cpu")
    try:
        qm.charge("A", nbytes=4096)
        got = sched.submit(JobSpec(job_id="qa", input="in", output="out", tenant="A"))
        assert isinstance(got, Busy) and got.kind == "quota"
        assert got.retry_after_s == 60
        assert "over its device-byte quota" in got.reason
        # other tenants are untouched
        assert type(sched.submit(JobSpec(job_id="qb", input="in", output="out",
                                         tenant="B"))).__name__ == "Admitted"
    finally:
        stub_transform["release"].set()
        sched.wait(timeout=30)
        sched.close()


@pytest.mark.parametrize("entry", ["scheduler", "service", "coalescer", "serve"])
def test_entry_points_default_to_cuda(tmp_path, entry):
    """Without ``device=`` the service runs on the card, and raises where
    there is none: ``cpu`` is asked for, never fallen to."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is attached: cuda is available")
    from adam_tpu_torch.api.transform_service import TransformService
    from adam_tpu_torch.serve import JobScheduler
    from adam_tpu_torch.serve.batching import WindowCoalescer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "scheduler":
            JobScheduler(str(tmp_path / "root"))
        elif entry == "service":
            TransformService(str(tmp_path / "root"))
        elif entry == "coalescer":
            WindowCoalescer()
        else:
            from adam_tpu_torch.cli.main import main

            main(["serve", str(tmp_path / "root")])


# --------------------------------------------------------------------------
# the real pipeline: quarantine, drain and recovery, cancel, a shared pool
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small_input(tmp_path_factory):
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.pipelines.streamed import transform_streamed

    d = tmp_path_factory.mktemp("serve-small")
    path = str(d / "in.sam")
    make_wgs(path, 1536, 100, n_contigs=2, contig_len=20_000, seed=5)
    transform_streamed(path, str(d / "solo"), window_reads=256, device="cpu")
    return {"input": path, "baseline": _parts(d / "solo")}


def _spec(jid, small_input, tmp_path, **kw):
    from adam_tpu_torch.serve import JobSpec

    return JobSpec(job_id=jid, input=small_input["input"],
                   output=str(tmp_path / f"{jid}.adam"), window_reads=256, **kw)


def test_quarantine_leaves_survivors_byte_identical(tmp_path, small_input):
    from adam_tpu_torch.serve import JobScheduler
    from adam_tpu_torch.utils import faults

    faults.install("sched.job_crash=permanent,device=bad")
    sched = JobScheduler(str(tmp_path / "root"), max_jobs=2, job_retries=1, device="cpu")
    try:
        sched.submit(_spec("ok", small_input, tmp_path, tenant="A"))
        sched.submit(_spec("bad", small_input, tmp_path, tenant="B"))
        assert sched.wait(timeout=300)
        st = sched.status()
        assert st["jobs"]["ok"]["state"] == "done"
        assert st["jobs"]["bad"]["state"] == "quarantined"
        assert st["jobs"]["bad"]["attempts"] == 2
        assert "PermanentFault" in st["jobs"]["bad"]["error"]
        assert st["active_leases"] == []
    finally:
        faults.clear()
        sched.wait(timeout=60)
        sched.close()
    assert _parts(tmp_path / "ok.adam") == small_input["baseline"]
    doc = json.loads((tmp_path / "root" / "bad" / "JOB.json").read_text())
    assert doc["state"] == "quarantined" and doc["attempts"] == 2
    # sticky across a restart: recovery does not resume poison
    sched2 = JobScheduler(str(tmp_path / "root"), max_jobs=2, device="cpu")
    try:
        assert sched2.recover() == []
        assert sched2.status()["jobs"]["bad"]["state"] == "quarantined"
    finally:
        sched2.close()


@pytest.mark.parametrize("batching", [False, True], ids=["unbatched", "batched"])
def test_drain_then_recover_resumes_bit_identically(tmp_path, small_input, batching):
    """A drain after the first part is published stops both jobs at a
    window boundary (pass C's writer closes gracefully); a fresh
    scheduler's ``recover()`` on the same run root resumes them to the
    solo run's parts, with one trace per job across the attempts."""
    from adam_tpu_torch.serve import JobScheduler

    root = str(tmp_path / "root")
    sched = JobScheduler(root, max_jobs=2, batching=batching, device="cpu")
    specs = [_spec("da", small_input, tmp_path, tenant="A", weight=2.0),
             _spec("db", small_input, tmp_path, tenant="B")]
    try:
        for s in specs:
            sched.submit(s)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not any(
                (tmp_path / f"{s.job_id}.adam").is_dir()
                and _parts(tmp_path / f"{s.job_id}.adam") for s in specs):
            time.sleep(0.01)
        assert sched.drain(timeout=120)
        st = sched.status()["jobs"]
    finally:
        sched.wait(timeout=60)
        sched.close()
    traces = {s.job_id: s.trace_id for s in specs}
    for jid in traces:
        assert st[jid]["state"] in ("interrupted", "done"), st[jid]
        doc = json.loads((tmp_path / "root" / jid / "JOB.json").read_text())
        assert doc["state"] == st[jid]["state"]
        assert doc["spec"]["trace_id"] == traces[jid]
    sched2 = JobScheduler(root, max_jobs=2, batching=batching, device="cpu")
    try:
        resumed = sched2.recover()
        assert set(resumed) == {j for j in traces if st[j]["state"] == "interrupted"}
        assert sched2.wait(timeout=300)
        st2 = sched2.status()["jobs"]
    finally:
        sched2.close()
    for jid in traces:
        assert st2[jid]["state"] == "done"
        assert st2[jid]["spec"]["trace_id"] == traces[jid]
        assert _parts(tmp_path / f"{jid}.adam") == small_input["baseline"], jid


def test_cancel_interrupts_one_job_and_resubmission_resumes(tmp_path, small_input):
    from adam_tpu_torch.serve import JobScheduler

    sched = JobScheduler(str(tmp_path / "root"), max_jobs=2, device="cpu")
    try:
        gate = threading.Event()
        inner = sched._interleaver.pacer

        def slow_pacer(job):
            pace = inner(job)

            def p(phase, index, size=0):
                if job == "cx" and phase == "pass_c":
                    gate.set()
                    time.sleep(0.2)  # each part waits: the cancel lands before the last
                pace(phase, index, size)
            return p

        sched._interleaver.pacer = slow_pacer
        sched.submit(_spec("cx", small_input, tmp_path))
        sched.submit(_spec("keep", small_input, tmp_path))
        assert gate.wait(120)
        assert sched.cancel("cx")
        assert not sched.cancel("nope")
        assert sched.wait(timeout=300)
        st = sched.status()["jobs"]
        assert st["cx"]["state"] == "interrupted"
        assert st["keep"]["state"] == "done"
        sched._interleaver.pacer = inner
        assert type(sched.submit(_spec("cx", small_input, tmp_path))).__name__ == "Admitted"
        assert sched.wait(timeout=300)
        assert sched.status()["jobs"]["cx"]["state"] == "done"
    finally:
        sched.wait(timeout=60)
        sched.close()
    for jid in ("cx", "keep"):
        assert _parts(tmp_path / f"{jid}.adam") == small_input["baseline"], jid


def test_two_cpu_slots_shared_through_leases(tmp_path, small_input):
    """A caller's two-slot pool is shared by the jobs (one lease each,
    returned at the end), and the parts are the one-device run's."""
    from adam_tpu_torch.parallel.device_pool import DevicePool, make_slots
    from adam_tpu_torch.serve import JobScheduler

    pool = DevicePool(make_slots(["cpu", "cpu"]))
    sched = JobScheduler(str(tmp_path / "root"), max_jobs=2, device_pool=pool,
                         batching=True, device="cpu")
    try:
        sched.submit(_spec("pa", small_input, tmp_path, tenant="A"))
        sched.submit(_spec("pb", small_input, tmp_path, tenant="B"))
        assert sched.wait(timeout=300)
        assert {v["state"] for v in sched.status()["jobs"].values()} == {"done"}
        assert pool.active_leases() == []
    finally:
        sched.close()
    for jid in ("pa", "pb"):
        assert _parts(tmp_path / f"{jid}.adam") == small_input["baseline"], jid


def test_job_heartbeat_and_service_records(tmp_path, small_input):
    """Each job streams its own heartbeat; the service root carries its
    heartbeat, the perf ledger booked per completed job, and the job
    records JAX's recovery scan reads."""
    from adam_tpu_torch.serve import JobScheduler
    from adam_tpu_torch.utils import perfledger

    root = tmp_path / "root"
    sched = JobScheduler(str(root), max_jobs=1, device="cpu")
    try:
        sched.submit(_spec("hb", small_input, tmp_path))
        assert sched.wait(timeout=300)
    finally:
        sched.close()
    lines = [json.loads(x) for x in (root / "hb" / "heartbeat.ndjson").read_text().splitlines()]
    assert lines[-1]["done"] is True and lines[-1]["ok"] is True
    assert lines[-1]["schema"] == "adam_tpu.heartbeat/7"
    entries = perfledger.read_ledger(str(root))
    assert len(entries) == 1 and entries[0]["kind"] == "run"
    doc = json.loads((root / "hb" / "JOB.json").read_text())
    assert doc["schema"] == "adam_tpu.serve_job/1" and doc["state"] == "done"
    from adam_tpu.pipelines.checkpoint import RunJournal as JaxJournal

    assert JaxJournal.peek(str(root / "hb" / "run"))["completed"] == len(small_input["baseline"])


# --------------------------------------------------------------------------
# the serve verb: SIGKILL mid-run, then resume
# --------------------------------------------------------------------------
def test_serve_sigkill_then_resume_gives_the_uninterrupted_parts(tmp_path, small_input):
    root = str(tmp_path / "root")
    jobs = tmp_path / "jobs.json"
    outs = {jid: str(tmp_path / f"{jid}.adam") for jid in ("ka", "kb")}
    jobs.write_text(json.dumps({"jobs": [
        {"job_id": jid, "input": small_input["input"], "output": out,
         "window_reads": 256} for jid, out in outs.items()]}))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("ADAM_TPU_FAULTS", None)
    cmd = [sys.executable, "-m", "adam_tpu_torch", "serve", root, "--jobs", str(jobs),
           "--max-jobs", "2", "--device", "cpu"]
    killed = subprocess.run(cmd + ["--fault-spec", "proc.kill=kill,device=pass_c,after=2,times=1"],
                            env=env, cwd=str(REPO), capture_output=True, timeout=300)
    assert killed.returncode == -signal.SIGKILL, killed.stderr.decode(errors="replace")
    states = {jid: json.loads(open(os.path.join(root, jid, "JOB.json")).read())["state"]
              for jid in outs}
    assert "running" in states.values()
    again = subprocess.run(cmd, env=env, cwd=str(REPO), capture_output=True, timeout=300)
    assert again.returncode == 0, again.stderr.decode(errors="replace")
    assert re.search(rb"resumed \d incomplete job", again.stdout)
    for jid, out in outs.items():
        assert _parts(out) == small_input["baseline"], jid
        assert json.loads(open(os.path.join(root, jid, "JOB.json")).read())["state"] == "done"
