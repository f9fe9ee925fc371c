"""The port's distributed kernels (``adam_tpu_torch/parallel/dist.py``)
against ``adam_tpu/parallel/dist.py`` (``tests/test_parallel.py``'s
distributed cases): each function over a two-slot ``LocalMesh`` on the CPU
equals JAX's over two virtual devices on the same batch; the k-mer and
sort exchanges overflow their slack capacity under skew and retry exact;
and two gloo processes (``torch.multiprocessing.spawn``, a file store, so
no port can clash under xdist) run ``distributed_observe``'s i64 sums and
``distributed_sort_rows`` over a ``ProcessMesh``."""

import os
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

from adam_tpu_torch.formats import schema
from adam_tpu_torch.parallel import dist as tdist
from adam_tpu_torch.parallel.device_pool import make_slots
from adam_tpu_torch.parallel.mesh import LocalMesh

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

#: the two-process case's own limit (seconds): spawn, init, two
#: collectives, teardown; it takes a few seconds
TWO_PROCESS_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def meshes():
    import jax

    from adam_tpu.parallel.mesh import genome_mesh

    return genome_mesh(jax.devices()[:2]), LocalMesh(make_slots(["cpu", "cpu"]))


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    from make_wgs_sam import make_wgs

    from adam_tpu.io import context as jctx

    from adam_tpu_torch.io import context as tctx

    path = str(tmp_path_factory.mktemp("dist") / "in.sam")
    make_wgs(path, 600, 100, n_contigs=1, contig_len=20_000)
    return jctx.load_alignments(path), tctx.load_alignments(path)


def test_distributed_flagstat_matches_jax(meshes, reads):
    from adam_tpu.parallel import dist as jdist

    jm, tm = meshes
    jds, tds = reads
    jf, jp = jdist.distributed_flagstat(jds.batch, jm)
    tf, tp = tdist.distributed_flagstat(tds.batch, tm)
    assert str(tf) == str(jf) and str(tp) == str(jp)
    assert tp.total == len(tds.batch.to_numpy().flags) > 0


def test_distributed_kmers_match_jax(meshes, reads):
    from adam_tpu.parallel import dist as jdist

    jm, tm = meshes
    jds, tds = reads
    got = tdist.distributed_count_kmers(tds.batch, 11, tm)
    assert got == jdist.distributed_count_kmers(jds.batch, 11, jm)
    assert len(got) > 1000


def test_distributed_markdup_matches_jax(meshes, reads):
    from adam_tpu.parallel import dist as jdist

    jm, tm = meshes
    jds, tds = reads
    jf = np.asarray(jdist.distributed_markdup(jds, jm).batch.to_numpy().flags)
    tf = np.asarray(tdist.distributed_markdup(tds, tm).batch.to_numpy().flags)
    np.testing.assert_array_equal(tf, jf)
    assert ((tf & schema.FLAG_DUPLICATE) != 0).any()


def test_distributed_observe_matches_jax(meshes, reads):
    from adam_tpu.parallel import dist as jdist
    from adam_tpu.pipelines import bqsr as jbqsr

    from adam_tpu_torch.ops.mdtag import batch_md_arrays
    from adam_tpu_torch.pipelines import bqsr as tbqsr

    jm, tm = meshes
    jds, tds = reads
    b = tds.batch.to_numpy()
    is_mm, _, has_md = batch_md_arrays(b, tds.sidecar, need_ref_codes=False)
    read_ok = tbqsr.observe_read_mask(b, has_md)
    residue_ok = tbqsr.observe_residue_mask(tds, b)
    n_rg = len(tds.read_groups) + 1
    tt, tm_ = tdist.distributed_observe(tds.batch, residue_ok, is_mm, read_ok, n_rg, tm)
    jt, jmm = (np.asarray(x) for x in jdist.distributed_observe(
        jds.batch, residue_ok, is_mm, read_ok, n_rg, jm))
    assert tt.dtype == np.int64 and tt.shape == (n_rg, 94, 2 * b.lmax + 1, 17)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tm_, jmm)
    # and the local (one-device) table, on the overlapping cycle window
    local = jbqsr.build_observation_table(jds)
    gl, lm = local.lmax, b.lmax
    np.testing.assert_array_equal(tt, local.total[:, :, gl - lm: gl + lm + 1, :])
    assert tt.sum() == local.total.sum() > 0


def test_distributed_sort_rows_matches_jax(meshes):
    import jax
    import jax.numpy as jnp

    from adam_tpu.parallel import dist as jdist

    jm, tm = meshes
    rng = np.random.default_rng(3)
    n = 2 * 64
    keys = rng.integers(0, 2**40, n).astype(np.int64)
    payload = {"a": np.arange(n, dtype=np.int32),
               "m": rng.integers(0, 255, (n, 5)).astype(np.uint8)}
    jk, jr, jv = jdist.distributed_sort_rows(jnp.asarray(keys),
                                             jax.tree.map(jnp.asarray, payload), jm)
    tk, tr, tv = tdist.distributed_sort_rows(keys, payload, tm)
    np.testing.assert_array_equal(tk, np.asarray(jk))
    np.testing.assert_array_equal(tv, np.asarray(jv))
    for name in payload:
        np.testing.assert_array_equal(tr[name], np.asarray(jr[name]))
    real = tk.ravel()[tv.ravel()]
    assert len(real) == n and (np.diff(real) >= 0).all()


def test_distributed_sort_keys_matches_jax(meshes):
    from adam_tpu.parallel import dist as jdist

    jm, tm = meshes
    keys = np.random.default_rng(0).integers(0, 2**40, size=2 * 64, dtype=np.int64)
    out = tdist.distributed_sort_keys(keys, tm)
    np.testing.assert_array_equal(out, np.asarray(jdist.distributed_sort_keys(keys, jm)))
    got = out.ravel()
    np.testing.assert_array_equal(got[got != np.iinfo(np.int64).max], np.sort(keys))


def test_halo_exchange_matches_jax(meshes):
    from adam_tpu.parallel import dist as jdist

    jm, tm = meshes
    chunks = (np.arange(2 * 16, dtype=np.uint8).reshape(2, 16) % 250)
    out = tdist.halo_exchange_right(chunks, tm, 4)
    np.testing.assert_array_equal(out, np.asarray(jdist.halo_exchange_right(chunks, jm, 4)))
    assert out.shape == (2, 20)
    np.testing.assert_array_equal(out[0, 16:], chunks[1, :4])
    assert (out[1, 16:] == schema.BASE_PAD).all()


def test_capacity_overflow_retries_exact(meshes):
    """Poly-A reads route every k-mer to one shard: a small capacity drops
    rows, the exact-capacity retry still counts every key; the all-equal
    key sort does the same."""
    from adam_tpu_torch.formats.batch import pack_reads

    _jm, tm = meshes
    n, L, k = 256 * tm.n, 32, 21
    recs = [dict(name=f"r{i}", flags=0, contig_idx=0, start=i, mapq=60,
                 cigar=f"{L}M", seq="A" * L, qual="I" * L, md=str(L))
            for i in range(n)]
    batch, _ = pack_reads(recs)
    p = tdist.pad_batch_for_mesh(batch.to_numpy(), tm.n)
    per_shard = []
    for kk in tm.local_shards():
        keys = torch.full((p.n_rows // tm.n * (L - k + 1),), 7, dtype=torch.int64)
        per_shard.append((torch.zeros_like(keys), [keys]))
    _got, dropped = tdist._route(tm, per_shard, 64)
    assert dropped > 0  # the bound binds: the stress is a stress
    counts = tdist.distributed_count_kmers(batch, k, tm, cap=64)
    assert sum(counts.values()) == n * (L - k + 1) and max(counts.values()) >= n
    out = tdist.distributed_sort_keys(np.zeros(n, np.int64), tm).ravel()
    real = out[out != np.iinfo(np.int64).max]
    assert len(real) == n and (real == 0).all()


def test_gather_host_telemetry_single_process():
    from adam_tpu_torch.utils import telemetry as tele

    snap = {"counters": {"x": 1}}
    assert tdist.gather_host_telemetry(snap) == [snap]
    assert tdist.gather_host_telemetry()[0].keys() == tele.TRACE.snapshot().keys()


def test_local_mesh_collectives():
    m = LocalMesh(make_slots(["cpu"] * 3))
    xs = [torch.tensor([k, 10 * k], dtype=torch.int64) for k in range(3)]
    assert [t.tolist() for t in m.psum(xs)] == [[3, 30]] * 3
    got = m.all_to_all([[torch.tensor([10 * k + j]) for j in range(3)] for k in range(3)])
    assert [[t.item() for t in row] for row in got] == [[0, 10, 20], [1, 11, 21], [2, 12, 22]]
    assert [[t.tolist() for t in row] for row in m.all_gather(xs)][1] == [x.tolist() for x in xs]
    perm = m.ppermute(xs, [(0, 2), (1, 0)])
    assert perm[2].tolist() == [0, 0] and perm[0].tolist() == [1, 10] and perm[1] is None


# --------------------------------------------------------------------------
# two gloo processes
# --------------------------------------------------------------------------
def _two_process_worker(rank: int, store: str, out_dir: str) -> None:
    """One rank of the gloo case: join the group, run distributed_observe
    and distributed_sort_rows over a ProcessMesh on the same seeded batch
    as the other rank, save this rank's results."""
    import torch.distributed as dist

    from adam_tpu_torch.formats.batch import pack_reads
    from adam_tpu_torch.parallel import dist as d
    from adam_tpu_torch.parallel.mesh import ProcessMesh, initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(f"file://{store}", world_size=2, rank=rank, backend="gloo")
    try:
        mesh = ProcessMesh()
        rng = np.random.default_rng(11)
        n, L = 64, 24
        recs = [dict(name=f"r{i}", flags=0, contig_idx=0, start=100 + i, mapq=60,
                     cigar=f"{L}M", seq="".join(rng.choice(list("ACGT"), L)),
                     qual="".join(rng.choice(list("5?I"), L)), read_group_idx=0,
                     md=str(L))
                for i in range(n)]
        batch, _ = pack_reads(recs)
        b = batch.to_numpy()
        res_ok = rng.random((n, b.lmax)) < 0.9
        is_mm = rng.random((n, b.lmax)) < 0.1
        read_ok = np.ones(n, bool)
        t, m = d.distributed_observe(batch, res_ok, is_mm, read_ok, 2, mesh)
        keys = rng.integers(0, 2**40, 2 * 32).astype(np.int64)
        k, rows, valid = d.distributed_sort_rows(keys, {"a": np.arange(64, dtype=np.int32)},
                                                 mesh)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), t=t, m=m, k=k, a=rows["a"],
                 v=valid, keys=keys, res_ok=res_ok, is_mm=is_mm)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def test_two_process_gloo_observe_and_sort_rows(tmp_path):
    import torch.multiprocessing as mp

    from adam_tpu_torch.formats.batch import pack_reads
    from adam_tpu_torch.pipelines.bqsr import observe_kernel

    ctx = mp.spawn(_two_process_worker, args=(str(tmp_path / "store"), str(tmp_path)),
                   nprocs=2, join=False)
    deadline = time.monotonic() + TWO_PROCESS_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"two gloo processes did not finish in {TWO_PROCESS_TIMEOUT_S}s")
    r0 = np.load(tmp_path / "rank0.npz")
    r1 = np.load(tmp_path / "rank1.npz")
    # the psum leaves the same i64 sums on both ranks ...
    np.testing.assert_array_equal(r0["t"], r1["t"])
    np.testing.assert_array_equal(r0["m"], r1["m"])
    assert r0["t"].dtype == np.int64
    # ... equal to one process's histogram of the whole batch
    rng = np.random.default_rng(11)
    n, L = 64, 24
    recs = [dict(name=f"r{i}", flags=0, contig_idx=0, start=100 + i, mapq=60,
                 cigar=f"{L}M", seq="".join(rng.choice(list("ACGT"), L)),
                 qual="".join(rng.choice(list("5?I"), L)), read_group_idx=0, md=str(L))
            for i in range(n)]
    b = pack_reads(recs)[0].to_numpy()
    cols = [torch.from_numpy(np.asarray(getattr(b, f)))
            for f in ("bases", "quals", "lengths", "flags", "read_group_idx")]
    t, m = observe_kernel(*cols, torch.from_numpy(r0["res_ok"]), torch.from_numpy(r0["is_mm"]),
                          torch.ones(n, dtype=torch.bool), 2, b.lmax)
    np.testing.assert_array_equal(r0["t"], t.numpy())
    np.testing.assert_array_equal(r0["m"], m.numpy())
    assert r0["t"].sum() > 0
    # sort_rows: each rank holds its splitter bucket; together, every row
    # once, globally key-ordered, and each row attached to its own key
    k = np.concatenate([r0["k"].ravel(), r1["k"].ravel()])
    a = np.concatenate([r0["a"].ravel(), r1["a"].ravel()])
    v = np.concatenate([r0["v"].ravel(), r1["v"].ravel()])
    real = k[v]
    keys = r0["keys"]
    assert len(real) == 64 and (np.diff(real) >= 0).all()
    np.testing.assert_array_equal(np.sort(a[v]), np.arange(64))
    np.testing.assert_array_equal(keys[a[v]], real)
