"""The port's mesh partitioner against ``adam_tpu/parallel/partitioner.py``'s
mesh half (``tests/test_mesh.py``): the execution mode's resolution, the
i64 accumulator against the window-order merge, mesh parts byte-identical
to the pool's, the one device's and JAX's mesh run, barrier 2 fetching one
table per grid width, no first launch inside a window, the fault matrix
degrading to the pool byte-identically, the sweep schedule and the realign
sweep fan-out, and the heartbeat's ``partitioner``.  Two CPU slots stand
in for two cards."""

import hashlib
import json
import os
import pathlib
import sys

import numpy as np
import pytest

from adam_tpu_torch.parallel import device_pool as dp
from adam_tpu_torch.parallel import partitioner as part_mod
from adam_tpu_torch.utils import faults as tf
from adam_tpu_torch.utils import telemetry as tele

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

WINDOW = 2048
JAX_ENV = {"ADAM_TPU_BQSR_BACKEND": "device", "ADAM_TPU_RESIDENT": "1"}


def _sha_parts(d) -> dict:
    return {f: hashlib.sha256((pathlib.Path(d) / f).read_bytes()).hexdigest()
            for f in sorted(os.listdir(d)) if f.startswith("part-")}


def _cpu_slots(n):
    return dp.make_slots(["cpu"] * n)


def test_resolve_execution_mode(monkeypatch):
    from adam_tpu.parallel import partitioner as jpart

    for env in (None, "mesh", "pool", "bogus"):
        if env is None:
            monkeypatch.delenv("ADAM_TPU_PARTITIONER", raising=False)
        else:
            monkeypatch.setenv("ADAM_TPU_PARTITIONER", env)
        for arg in (None, "mesh", "pool"):
            assert (part_mod.resolve_execution_mode(arg)
                    == jpart.resolve_execution_mode(arg)), (env, arg)
    with pytest.raises(ValueError, match="partitioner"):
        part_mod.resolve_execution_mode("bogus")


def test_mesh_accumulator_matches_window_order_merge():
    """Integer adds are exact: any accumulation order on slot 0 equals the
    host window-order merge bitwise, mixed grid widths included, and per
    shard lists sum like single tensors."""
    import torch

    from adam_tpu_torch.pipelines.bqsr import merge_observations

    rng = np.random.default_rng(7)
    n_rg = 3
    parts = []
    for gl in (32, 64, 32, 64, 32):
        shape = (n_rg, 94, 2 * gl + 1, 17)
        parts.append((rng.integers(0, 1 << 40, shape).astype(np.int64),
                       rng.integers(0, 1 << 40, shape).astype(np.int64), gl))
    ref_t, ref_m, ref_gl = merge_observations(parts)
    part = part_mod.MeshPartitioner(_cpu_slots(2))
    for k in (4, 1, 3, 0, 2):
        t, m, gl = parts[k]
        if k % 2:  # as two shards' halves
            part.accumulate([torch.from_numpy(t // 2), torch.from_numpy(t - t // 2)],
                            [torch.from_numpy(m // 2), torch.from_numpy(m - m // 2)], gl)
        else:
            part.accumulate(torch.from_numpy(t), torch.from_numpy(m), gl)
    fetched = part.fetch_accumulated(tele.Tracer(recording=False))
    assert [g for _t, _m, g in fetched] == [32, 64]
    got_t, got_m, got_gl = merge_observations(fetched)
    assert got_gl == ref_gl
    np.testing.assert_array_equal(got_t, ref_t)
    np.testing.assert_array_equal(got_m, ref_m)
    assert not part.has_accumulated()


def test_mesh_rows_and_resident_window():
    from adam_tpu_torch.formats.batch import pack_reads

    part = part_mod.MeshPartitioner(_cpu_slots(3))
    assert part.rows_for(1024) == 1026 and part.block(1026) == 342
    assert part.ledger_key() == "mesh:3" and part.route() == "plain"
    recs = [dict(name=f"r{i}", flags=0, contig_idx=0, start=100 + i, mapq=60,
                 cigar="10M", seq="ACGTACGTAC", qual="I" * 10, read_group_idx=0)
            for i in range(5)]
    batch, _ = pack_reads(recs)
    rw = part_mod.mesh_resident_window(batch.to_numpy(), 0, part)
    assert rw.slot == "mesh" and rw.g == 1026 and rw.gl == 32
    assert [t.shape[0] for t in rw.get("bases")] == [342] * 3
    assert rw.get("bases")[0][0, :10].tolist() == [0, 1, 2, 3, 0, 1, 2, 3, 0, 1]
    dp.reset_prewarm_cache()
    try:
        entries = [part_mod.mesh_markdup_prewarm_entry(batch.to_numpy(), part),
                   part_mod.mesh_observe_prewarm_entry(batch.to_numpy(), 2, part),
                   part_mod.mesh_apply_prewarm_entry(batch.to_numpy(), 2, 65, part),
                   part_mod.mesh_fused_bc_prewarm_entry(batch.to_numpy(), 2, 65, part)]
        assert [k[:2] for k, _fn in entries] == [
            ("mesh.markdup", 1026), ("mesh.observe_packed", 1026),
            ("mesh.apply_pack2", 1026), ("mesh.fused_bc", 1026)]
        tr = tele.Tracer(recording=True)
        assert part.prewarm(entries, tracer=tr) == 4
        assert part.prewarm(entries, tracer=tr) == 0
        assert set(tr.snapshot()["device_spans"][tele.SPAN_POOL_PREWARM_COMPILE]) == {"mesh"}
    finally:
        dp.reset_prewarm_cache()


def test_healthy_subset_skips_blocked_slots():
    from adam_tpu_torch.utils.health import HealthBoard

    slots = _cpu_slots(3)
    board = HealthBoard(cooldown_s=60)
    assert part_mod.healthy_subset(slots, board) == slots
    board.quarantine(slots[1], reason="test")
    assert part_mod.healthy_subset(slots, board) == [slots[0], slots[2]]
    for s in slots:
        board.quarantine(s)
    assert part_mod.healthy_subset(slots, board) == slots  # availability wins


# --------------------------------------------------------------------------
# streamed parity over the modes
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """One streamed run per (mode, slots) over one input (a ragged last
    window and a realign tail), with its snapshot; and JAX's mesh run."""
    from make_wgs_sam import make_wgs

    from adam_tpu.pipelines.streamed import transform_streamed as jax_transform

    from adam_tpu_torch.pipelines.streamed import transform_streamed
    from adam_tpu_torch.utils import compile_ledger

    d = tmp_path_factory.mktemp("mesh_parity")
    path = str(d / "in.sam")
    make_wgs(path, 4500, 100, n_contigs=2, contig_len=30_000,
             indel_every=700, snp_every=400)
    old = {k: os.environ.get(k) for k in JAX_ENV}
    os.environ.update(JAX_ENV)
    try:
        jax_transform(path, str(d / "out.jaxmesh2.adam"), window_reads=WINDOW,
                      devices=2, partitioner="mesh",
                      dump_observations=str(d / "obs.jaxmesh2.csv"))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    runs = {}
    legs = [("one", None, None), ("pool2", "pool", 2), ("mesh1", "mesh", 1),
            ("mesh2", "mesh", 2)]
    for label, mode, n in legs:
        kw = {} if n is None else {"device_pool": dp.DevicePool(_cpu_slots(n))}
        # each run's first launches are its own (the caches are process-wide)
        dp.reset_prewarm_cache()
        compile_ledger.reset()
        tele.TRACE.reset()
        tele.TRACE.recording = True
        try:
            stats = transform_streamed(
                path, str(d / f"out.{label}.adam"), window_reads=WINDOW,
                partitioner=mode, dump_observations=str(d / f"obs.{label}.csv"),
                device="cpu", **kw)
            snap = tele.TRACE.snapshot()
        finally:
            tele.TRACE.recording = False
            tele.TRACE.reset()
        runs[label] = (str(d / f"out.{label}.adam"), str(d / f"obs.{label}.csv"),
                       stats, snap)
    runs["jaxmesh2"] = (str(d / "out.jaxmesh2.adam"), str(d / "obs.jaxmesh2.csv"),
                        None, None)
    runs["sam"] = path
    return runs


def test_mesh_parts_bit_identical_across_modes(mesh_runs):
    ref = _sha_parts(mesh_runs["one"][0])
    assert len(ref) == 4
    for label in ("pool2", "mesh1", "mesh2", "jaxmesh2"):
        assert _sha_parts(mesh_runs[label][0]) == ref, label


def test_mesh_observe_table_identical(mesh_runs):
    ref = open(mesh_runs["one"][1]).read()
    assert len(ref.splitlines()) > 1
    for label in ("pool2", "mesh1", "mesh2", "jaxmesh2"):
        assert open(mesh_runs[label][1]).read() == ref, label


def test_mesh_actually_ran_collectives(mesh_runs):
    for label in ("mesh1", "mesh2"):
        _out, _csv, stats, snap = mesh_runs[label]
        assert stats["partitioner"] == "mesh", label
        assert snap["counters"].get(tele.C_MESH_DISPATCHED, 0) > 0, label
        assert snap["counters"].get(tele.C_MESH_DEGRADED, 0) == 0, label
        # mesh spans carry device="mesh"
        assert set(snap["device_spans"][tele.SPAN_MD_COLUMNS]) == {"mesh"}
    assert mesh_runs["pool2"][3]["counters"].get(tele.C_MESH_DISPATCHED, 0) == 0


def test_mesh_barrier2_fetches_one_table_not_per_window(mesh_runs):
    """The mesh leg's observe-pass d2h: one merged pair per distinct grid
    width (one here: every window's lanes are 128) against one per window
    (3 windows + the realigned part) on the pool leg."""
    def observe_d2h(snap):
        return sum(per["observe"]["bytes"]
                   for per in snap["transfers"]["d2h"].values() if "observe" in per)

    pool_b = observe_d2h(mesh_runs["pool2"][3])
    mesh_b = observe_d2h(mesh_runs["mesh2"][3])
    assert pool_b > 0 and mesh_b > 0
    assert mesh_b * 2 <= pool_b, (pool_b, mesh_b)
    obs_fetch = mesh_runs["mesh2"][3]["spans"][tele.SPAN_OBS_FETCH]
    assert obs_fetch["count"] == 1


def test_clean_run_has_no_in_window_compiles(mesh_runs):
    for label in ("pool2", "mesh2"):
        snap = mesh_runs[label][3]
        in_win = [e for e in snap.get("compiles", {}).get("entries", [])
                  if e.get("in_window")]
        assert snap["counters"].get(tele.C_COMPILE_IN_WINDOW, 0) == 0, (label, in_win)
        assert snap["counters"][tele.C_POOL_PREWARM_COMPILES] > 0


def test_mesh_resolve_used_device_sort(mesh_runs):
    g = mesh_runs["mesh2"][3]["gauges"].get(tele.G_RESOLVE_DEVICE_SORT)
    assert g and g["last"] == 1


@pytest.mark.parametrize("spec,expect_degrade", [
    # a transient fault is retried: the mesh stays up
    ("device.dispatch=transient,every=3", False),
    # a permanent fault mid-run: the mesh degrades to the pool
    ("device.dispatch=permanent,after=6,times=1", True),
    # a failed fetch of a mesh result past its retries degrades too
    ("device.fetch=permanent,pass=a,after=1,times=1", True),
])
def test_mesh_fault_matrix_degrades_bit_identically(mesh_runs, tmp_path, spec,
                                                    expect_degrade, monkeypatch):
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    ref = _sha_parts(mesh_runs["one"][0])
    out = str(tmp_path / "faulted.adam")
    monkeypatch.setenv("ADAM_TPU_RETRY_BACKOFF_S", "0.001")
    tf.install(spec)
    tele.TRACE.reset()
    tele.TRACE.recording = True
    try:
        stats = transform_streamed(mesh_runs["sam"], out, window_reads=WINDOW,
                                   partitioner="mesh", device="cpu",
                                   device_pool=dp.DevicePool(_cpu_slots(2)))
        snap = tele.TRACE.snapshot()
    finally:
        tele.TRACE.recording = False
        tele.TRACE.reset()
        tf.clear()
    assert _sha_parts(out) == ref
    assert snap["counters"].get(tele.C_FAULT_INJECTED, 0) > 0
    degraded = snap["counters"].get(tele.C_MESH_DEGRADED, 0)
    if expect_degrade:
        assert degraded == 1 and stats["partitioner"] == "pool"
        assert tele.SPAN_POOL_REPLAY in snap["spans"]
    else:
        assert degraded == 0 and stats["partitioner"] == "mesh"


# --------------------------------------------------------------------------
# the sweep fan-out
# --------------------------------------------------------------------------
def test_sweep_schedule_deficit_round_robin():
    from adam_tpu.parallel import device_pool as jdp

    devs = ["a", "b"]
    for w, k in (([3.0, 1.0], 8), ([1.0, 1.0], 4), ([1.0, 2.0, 5.0], 16)):
        ds = devs + ["c"] if len(w) == 3 else devs
        s1, s2 = dp.SweepSchedule(ds, weights=w), jdp.SweepSchedule(ds, weights=w)
        assert [s1.next_device() for _ in range(k)] == [s2.next_device() for _ in range(k)]
    sched = dp.SweepSchedule(devs, weights=[3.0, 1.0])
    got = [sched.next_device() for _ in range(8)]
    assert got.count("a") == 6 and got.count("b") == 2


def test_sweep_weights_env_override(monkeypatch):
    slots = _cpu_slots(3)
    monkeypatch.setenv("ADAM_TPU_SWEEP_TFLOPS", "2.0,1.0")
    assert dp.sweep_weights(slots) == [2.0, 1.0, 1.5]  # padded with the mean
    monkeypatch.setenv("ADAM_TPU_SWEEP_TFLOPS", "bogus")
    assert dp.sweep_weights(slots) == [1.0] * 3
    monkeypatch.delenv("ADAM_TPU_SWEEP_TFLOPS")
    # CPU slots are symmetric: no probe, equal weights
    assert dp.sweep_weights(slots) == [1.0] * 3


@pytest.mark.parametrize("model", ["reads", "smithwaterman"])
def test_realign_sweep_fans_out_bit_identically(tmp_path, model):
    """``realign_indels`` with its sweeps (and, under ``smithwaterman``, its
    Smith-Waterman fills) fanned over four slots returns the one-device
    result exactly, and runs the overlap work once: under the queued
    sweeps on the reads model, before the Python path on the other."""
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.io import context
    from adam_tpu_torch.pipelines.realign import realign_indels

    path = str(tmp_path / "in.sam")
    make_wgs(path, 1500, 100, n_contigs=1, contig_len=20_000, indel_every=600,
             snp_every=300)
    ds = context.load_alignments(path)
    one = realign_indels(ds, consensus_model=model, device="cpu")
    ran = []

    def work():
        ran.append(1)

    fan = realign_indels(ds, consensus_model=model, device="cpu",
                         sweep_devices=_cpu_slots(4), overlap_work=work)
    assert ran == [1]
    assert work.overlap_ran_in_dispatch is (model == "reads")
    b1, b2 = one.batch.to_numpy(), fan.batch.to_numpy()
    for f in ("start", "end", "mapq", "cigar_ops", "cigar_lens", "cigar_n", "flags"):
        np.testing.assert_array_equal(np.asarray(getattr(b1, f)),
                                      np.asarray(getattr(b2, f)), f)
    assert list(one.sidecar.md) == list(fan.sidecar.md)


def test_heartbeat_carries_partitioner_field(tmp_path, monkeypatch):
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.pipelines.streamed import transform_streamed

    path = str(tmp_path / "in.sam")
    make_wgs(path, 1200, 100, n_contigs=1, contig_len=20_000)
    hb_path = str(tmp_path / "hb.ndjson")
    monkeypatch.setenv("ADAM_TPU_PROGRESS_INTERVAL_S", "0.1")
    transform_streamed(path, str(tmp_path / "out.adam"), window_reads=1024,
                       partitioner="mesh", progress=hb_path, device="cpu",
                       device_pool=dp.DevicePool(_cpu_slots(2)))
    lines = [json.loads(line) for line in open(hb_path)]
    assert lines
    for line in lines:
        assert tuple(line) == tele.HEARTBEAT_FIELDS
        assert line["partitioner"] in (None, "mesh")
    assert lines[-1]["partitioner"] == "mesh"
    assert lines[-1]["done"] is True and lines[-1]["ok"] is True
