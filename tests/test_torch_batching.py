"""Cross-job window batching in the port (``adam_tpu_torch/serve/batching.py``)
and the quota leg (``serve/quota.py``), on the CPU.

The fused executors against one solo dispatch per ticket: a fused
markdup, observe (kernel 1's body at ``n_rg = sum(n_rg_i)``) and apply
(kernel 2's two packs over the fused grid) give each ticket exactly the
columns, histogram band and packed bytes of its own dispatch.  A failed
fused dispatch sends every carried window back to its job's own path
(``sched.batch.fallbacks``), and the parts stay the solo run's.  The
quota grammar, the byte-rate Retry-After hint and the knob parsers equal
JAX's on the same inputs.  Every coalescer a test starts is stopped in a
``finally``."""

import dataclasses
import hashlib
import os
import pathlib
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))


def _parts(d) -> dict:
    return {f: hashlib.sha256((pathlib.Path(d) / f).read_bytes()).hexdigest()
            for f in sorted(os.listdir(d)) if f.startswith("part-")}


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    """Three windows of two inputs with different read-group counts: the
    fused grid mixes jobs, grid heights and bands."""
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.api.datasets import AlignmentDataset
    from adam_tpu_torch.io import sam as sam_io

    d = tmp_path_factory.mktemp("batching")
    out = []
    for seed, n, rg in ((21, 700, None), (22, 1300, 3)):
        path = str(d / f"in{seed}.sam")
        make_wgs(path, n, 100, n_contigs=2, contig_len=20_000, seed=seed)
        if rg:  # rewrite onto several read groups, the null group kept too
            lines = open(path).read().splitlines()
            head = [x for x in lines if x.startswith("@") and not x.startswith("@RG")]
            head += [f"@RG\tID:rg{k}\tSM:s\tLB:lib{k % 2}" for k in range(rg)]
            body = []
            for i, x in enumerate(x for x in lines if not x.startswith("@")):
                f = [t for t in x.split("\t") if not t.startswith("RG:Z:")]
                if i % 5:
                    f.append(f"RG:Z:rg{i % rg}")
                body.append("\t".join(f))
            open(path, "w").write("\n".join(head + body) + "\n")
        for batch, side, header in sam_io.iter_sam_batches(path, batch_reads=512):
            out.append(AlignmentDataset(batch, side, header))
    return out[:1] + out[-2:]


def _coalescer(wait_ms=60_000):
    from adam_tpu_torch.serve.batching import WindowCoalescer

    return WindowCoalescer(wait_ms=wait_ms, device="cpu")


def _tickets(coal, kind, windows, tables=None):
    """One ticket per window, each from its own job: with every
    registered job's ticket in, the group is ripe and fuses at once (the
    long batching delay never expires)."""
    clients = [coal.client(f"job{k}", f"t{k}") for k in range(len(windows))]
    futs = []
    for k, (c, w) in enumerate(zip(clients, windows)):
        if kind == "markdup":
            futs.append(c.submit_markdup(k, w.batch))
        elif kind == "observe":
            futs.append(c.submit_observe(k, w))
        else:
            futs.append(c.submit_apply(k, w, tables[k]))
    out = [f.result(timeout=60) for f in futs]
    for k in range(len(windows)):
        coal.deregister(f"job{k}")
    return out


def test_fused_markdup_equals_each_solo_dispatch(windows):
    from adam_tpu_torch.parallel.device_pool import ResidentWindow, solo_slot
    from adam_tpu_torch.pipelines import markdup as md

    coal = _coalescer()
    try:
        got = _tickets(coal, "markdup", windows)
    finally:
        coal.stop()
    for w, (five, score) in zip(windows, got):
        rw = ResidentWindow.place(w.batch.to_numpy(), solo_slot("cpu"))
        f2, s2 = md.fetch_columns(md.markdup_columns(w.batch, rw), w.batch.n_rows)
        np.testing.assert_array_equal(five, f2)
        np.testing.assert_array_equal(score, s2)


def test_fused_observe_bands_equal_each_solo_histogram(windows):
    from adam_tpu_torch.parallel.device_pool import ResidentWindow, solo_slot
    from adam_tpu_torch.pipelines import bqsr

    coal = _coalescer()
    try:
        got = _tickets(coal, "observe", windows)
        groups = coal.largest_groups()
    finally:
        coal.stop()
    n_rgs = [len(w.read_groups) + 1 for w in windows]
    assert groups["observe"]["n_rg"] == sum(n_rgs) and groups["observe"]["tickets"] == 3
    assert len(set(n_rgs)) == 2  # bands of different heights
    for w, (total, mism, gl) in zip(windows, got):
        rw = ResidentWindow.place(w.batch.to_numpy(), solo_slot("cpu"))
        t2, m2, g2 = bqsr.observe_window(w, rw)
        assert gl == g2 and total.dtype == np.int64
        np.testing.assert_array_equal(total, t2.numpy())
        np.testing.assert_array_equal(mism, m2.numpy())
        assert mism.sum() > 0


def test_fused_apply_bytes_equal_each_solo_apply(windows):
    """Tables of different read-group counts and cycle widths, centred in
    one fused table: each window's packed quals and bases are its solo
    apply's, byte for byte, and the OQ stash is the same."""
    import torch

    from adam_tpu_torch.io.parquet import to_arrow_alignments
    from adam_tpu_torch.parallel.device_pool import ResidentWindow, solo_slot
    from adam_tpu_torch.pipelines import bqsr

    rng = np.random.default_rng(7)
    tables = []
    for k, w in enumerate(windows):
        n_rg = len(w.read_groups) + 1
        gl = 100 + 8 * k  # the widest sets the fused cycle axis
        tables.append(rng.integers(0, 60, (n_rg, 94, 2 * gl + 1, 17), dtype=np.uint8))
    coal = _coalescer()
    try:
        got = _tickets(coal, "apply", windows, tables=tables)
        groups = coal.largest_groups()
    finally:
        coal.stop()
    assert groups["apply"]["tickets"] == 3
    for w, tbl, (ds, packed) in zip(windows, tables, got):
        rw = ResidentWindow.place(w.batch.to_numpy(), solo_slot("cpu"))
        ds2, packed2 = bqsr.apply_finish(bqsr.apply_dispatch(w, rw, torch.from_numpy(tbl)))
        assert bqsr.packed_equal(packed, packed2)
        # the records written are the same (the OQ stash included)
        assert to_arrow_alignments(ds.batch, ds.sidecar, ds.header, packed).equals(
            to_arrow_alignments(ds2.batch, ds2.sidecar, ds2.header, packed2))


def test_band_rg_resolves_null_and_clamps_per_ticket():
    import torch

    from adam_tpu_torch.serve.batching import _band_rg

    rg = torch.tensor([0, 1, -1, 5], dtype=torch.int32)
    assert _band_rg(rg, 10, 3).tolist() == [10, 11, 12, 12]


@pytest.fixture(scope="module")
def batch_input(tmp_path_factory):
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.pipelines.streamed import transform_streamed

    d = tmp_path_factory.mktemp("batch-input")
    path = str(d / "in.sam")
    make_wgs(path, 1024, 100, n_contigs=2, contig_len=20_000, seed=9)
    transform_streamed(path, str(d / "solo"), window_reads=256, device="cpu")
    return {"input": path, "baseline": _parts(d / "solo")}


@pytest.mark.parametrize("spec", ["sched.batch=transient,times=1",
                                  "sched.batch=permanent,device=observe",
                                  "sched.batch=permanent"])
def test_failed_fused_dispatch_falls_back_to_the_jobs_own_path(tmp_path, batch_input, spec):
    """A fused dispatch that fails fails only its tickets: each window
    re-dispatches on its job's own path (``sched.batch.fallbacks``), and
    every job's parts are its solo run's."""
    from adam_tpu_torch.serve import JobScheduler, JobSpec
    from adam_tpu_torch.utils import faults
    from adam_tpu_torch.utils import telemetry as tele

    tele.TRACE.reset()
    faults.install(spec)
    sched = JobScheduler(str(tmp_path / "root"), max_jobs=2, batching=True, device="cpu")
    try:
        for jid in ("fa", "fb"):
            sched.submit(JobSpec(job_id=jid, input=batch_input["input"],
                                 output=str(tmp_path / jid), tenant=jid, window_reads=256))
        assert sched.wait(timeout=300)
        st = sched.status()["jobs"]
        c, _ = tele.TRACE.counters_and_gauges()
    finally:
        faults.clear()
        sched.close()
    assert {v["state"] for v in st.values()} == {"done"}
    assert c["sched.batch.fallbacks"] >= 1
    assert c["fault.injected"] >= 1
    if spec.endswith("times=1"):
        assert c["sched.batch.dispatches"] >= 1  # the others fused
    for jid in ("fa", "fb"):
        assert _parts(tmp_path / jid) == batch_input["baseline"], jid


def test_stopped_coalescer_refuses_and_the_job_runs_alone(tmp_path, batch_input, windows):
    from adam_tpu_torch.pipelines.streamed import transform_streamed
    from adam_tpu_torch.serve.batching import CoalesceError

    coal = _coalescer(0)
    client = coal.client("solo", "t")
    coal.stop()
    with pytest.raises(CoalesceError):
        client.submit_markdup(0, windows[0].batch)
    stats = transform_streamed(batch_input["input"], str(tmp_path / "o"), window_reads=256,
                               coalescer=client, device="cpu")
    assert stats["batched"] is True and stats["fused_bc"] is False
    assert _parts(tmp_path / "o") == batch_input["baseline"]


def test_first_sight_warm_keeps_compiles_out_of_the_window(windows):
    """A new fused shape is warmed on zero tensors under the prewarm
    scope: the real dispatch is a compile-ledger hit."""
    from adam_tpu_torch.utils import compile_ledger
    from adam_tpu_torch.utils import telemetry as tele

    compile_ledger.reset()
    tele.TRACE.reset()
    was = tele.TRACE.recording
    tele.TRACE.recording = True
    coal = _coalescer()
    try:
        _tickets(coal, "observe", windows)
        _tickets(coal, "observe", windows)
        c, _ = tele.TRACE.counters_and_gauges()
    finally:
        coal.stop()
        tele.TRACE.recording = was
    assert c.get("device.compile.in_window", 0) == 0
    assert c["device.compile.cache_misses"] == 1  # the warm
    assert c["device.compile.cache_hits"] == 2


# --------------------------------------------------------------------------
# the quota leg and the knobs, against JAX's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("spec", [
    "tenantA:bytes=512M,compute=10s;tenantB:bytes=2G;*:bytes=1G",
    "oops;a:bytes=nope;b:bytes=4K",
    "a:compute=2.5;b:bytes=1.5k,compute_s=3s",
    "",
    ":bytes=1;c:;d:bytes=1T,x=2",
])
def test_parse_quota_spec_equals_jax(spec):
    from adam_tpu.serve.quota import parse_quota_spec as jax_parse

    from adam_tpu_torch.serve.quota import parse_quota_spec

    port, jax = parse_quota_spec(spec), jax_parse(spec)
    assert {k: (b.bytes, b.compute_s) for k, b in port.items()} == \
        {k: (b.bytes, b.compute_s) for k, b in jax.items()}


@pytest.mark.parametrize("deficit,recs,now", [
    (1 << 20, [(0.0, 1 << 18), (1.0, 1 << 18), (2.0, 1 << 18)], None),
    (1 << 30, [(0.0, 100), (0.5, 100)], 10.0),
    (10, [(0.0, 0), (1.0, 0)], None),
    (0, [(0.0, 5), (1.0, 5)], None),
    (5000, [(3.0, 1000)], None),
    (1 << 40, [(0.0, 1), (1.0, 1)], None),
])
def test_rate_retry_hint_equals_jax(deficit, recs, now):
    from adam_tpu.serve.quota import rate_retry_hint as jax_hint

    from adam_tpu_torch.serve.quota import rate_retry_hint

    assert rate_retry_hint(deficit, recs, now=now) == jax_hint(deficit, recs, now=now)


def test_quota_manager_window_and_throttle_equal_jax():
    from adam_tpu.serve.quota import QuotaManager as JaxQuota

    from adam_tpu_torch.serve.quota import QuotaManager

    out = []
    for cls in (QuotaManager, JaxQuota):
        clock = [0.0]
        qm = cls("A:bytes=1K,compute=1s", window_s=10, clock=lambda: clock[0])
        qm.charge("A", nbytes=600)
        clock[0] = 4.0
        qm.charge("A", nbytes=600, compute_s=0.5)
        first = dataclasses.asdict(qm.check("A"))

        slept = []

        def sleep(s):
            slept.append(s)
            clock[0] += 1.0

        waited = qm.throttle("A", sleep=sleep)
        clock[0] = 20.0
        out.append((first, qm.consumed("A"), waited, len(slept), qm.check("A"),
                    qm.status()))
    assert out[0] == out[1]
    assert out[0][0]["resource"] == "bytes" and out[0][0]["retry_after_s"] == 6


def test_knobs_equal_jax(monkeypatch):
    from adam_tpu.serve import batching as jb
    from adam_tpu.serve import quota as jq

    from adam_tpu_torch.serve import batching as tb
    from adam_tpu_torch.serve import quota as tq

    for val in (None, "7.5", "0", "soon", "-3"):
        if val is None:
            monkeypatch.delenv("ADAM_TPU_BATCH_WAIT_MS", raising=False)
            monkeypatch.delenv("ADAM_TPU_QUOTA_WINDOW_S", raising=False)
        else:
            monkeypatch.setenv("ADAM_TPU_BATCH_WAIT_MS", val)
            monkeypatch.setenv("ADAM_TPU_QUOTA_WINDOW_S", val)
        assert tb.batch_wait_ms() == jb.batch_wait_ms()
        assert tq.quota_window_s() == jq.quota_window_s()
    for val in (None, "1", "off", "yes"):
        if val is None:
            monkeypatch.delenv("ADAM_TPU_BATCH", raising=False)
        else:
            monkeypatch.setenv("ADAM_TPU_BATCH", val)
        assert tb.batching_enabled() == jb.batching_enabled()
    assert tb.MAX_GROUP_TICKETS == jb.MAX_GROUP_TICKETS == 8
