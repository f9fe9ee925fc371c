"""The port's part writer pool (``adam_tpu_torch/io/parquet.PartWriterPool``)
against the JAX package's (``adam_tpu/io/parquet.PartWriterPool``): parts
shard ``i % K`` over the write threads, ``on_published`` fires once per
part after its bytes are on disk, the adaptive gate grows under a slow
writer and never past its cap, ``ADAM_TPU_WRITER_SHARDS`` /
``ADAM_TPU_WRITER_ADAPTIVE`` resolve as JAX's, the pool's shape never
changes a part's bytes, and a ``parquet.write`` fault fails a streamed run
fast, leaves no staging, and a rerun writes JAX's bytes."""

import os
import pathlib
import sys
import threading
import time

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

from adam_tpu.io import parquet as jpq

from adam_tpu_torch.io import parquet as tpq
from adam_tpu_torch.utils import faults

WINDOW = 256


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    """A small synthetic SAM, its windows as the streamed ingest cuts
    them, and the JAX streamed run's parts (device BQSR backend, resident
    windows: the environment the port's parts match)."""
    from make_synth_sam import make_sam

    from adam_tpu.pipelines.streamed import transform_streamed as jax_transform

    from adam_tpu_torch.io.sam import iter_sam_batches

    d = tmp_path_factory.mktemp("writer_pool")
    path = str(d / "in.sam")
    make_sam(path, 2048, 100)
    mp = pytest.MonkeyPatch()
    mp.setenv("ADAM_TPU_BQSR_BACKEND", "device")
    mp.setenv("ADAM_TPU_RESIDENT", "1")
    try:
        jax_transform(path, str(d / "jax.adam"), window_reads=WINDOW)
    finally:
        mp.undo()
    return d, path, list(iter_sam_batches(path, WINDOW)), _parts(d / "jax.adam")


def _parts(d) -> dict:
    return {f: (pathlib.Path(d) / f).read_bytes()
            for f in sorted(os.listdir(d)) if f.startswith("part-")}


@pytest.fixture(autouse=True)
def _disarmed():
    faults.clear()
    yield
    faults.clear()


def test_part_index_matches_jax():
    for name in ("part-r-00000.parquet", "x/part-r-00012.parquet",
                 "part-r-123456.parquet", "part-r-0001.parquet",
                 "part-r-00001.parquet.tmp", "_temporary/part-r-00002.parquet.tmp",
                 "window-00001.npz", "part-00001.parquet"):
        assert tpq.part_index(name) == jpq.part_index(name), name
    assert tpq.part_path("o", 7) == jpq.part_path("o", 7)


def test_on_published_once_per_part_after_the_bytes(windows, tmp_path):
    import pyarrow.parquet as pq

    _, _, wins, _ = windows
    seen, lock = [], threading.Lock()

    def hook(path):
        # the part is already published: complete, readable bytes
        rows = pq.read_metadata(path).num_rows
        assert not os.path.exists(os.path.join(tmp_path, tpq.TMP_DIR_NAME,
                                               os.path.basename(path) + ".tmp"))
        with lock:
            seen.append((path, rows, threading.get_ident()))

    pool = tpq.PartWriterPool(n_encoders=2, inflight_parts=3, on_published=hook,
                              n_io=3)
    for i, (b, s, h) in enumerate(wins):
        pool.submit(tpq.part_path(str(tmp_path), i), b, s, h)
    pool.close()
    assert sorted(p for p, _, _ in seen) == [
        tpq.part_path(str(tmp_path), i) for i in range(len(wins))]
    assert [r for _, r, _ in sorted(seen)] == [b.n_rows for b, _, _ in wins]
    # part i writes on shard i % 3: one thread per residue, three threads
    by_shard = {}
    for p, _, tid in seen:
        by_shard.setdefault(tpq.part_index(p) % 3, set()).add(tid)
    assert all(len(t) == 1 for t in by_shard.values())
    assert len(set().union(*by_shard.values())) == 3
    assert not (tmp_path / tpq.TMP_DIR_NAME).exists()


def test_hook_failure_is_a_worker_failure(windows, tmp_path):
    _, _, wins, _ = windows
    b, s, h = wins[0]

    def hook(path):
        raise OSError("journal disk full")

    pool = tpq.PartWriterPool(on_published=hook, n_io=1)
    pool.submit(tpq.part_path(str(tmp_path), 0), b, s, h)
    with pytest.raises(OSError, match="journal disk full"):
        pool.close()


@pytest.mark.parametrize("n_io,adaptive,inflight", [(1, False, 1), (2, True, 3),
                                                    (3, True, 2), (8, False, 5)])
def test_pool_shape_never_changes_the_bytes(windows, tmp_path, n_io, adaptive, inflight):
    _, _, wins, _ = windows
    ref = tmp_path / "ref"
    ref.mkdir()
    for i, (b, s, h) in enumerate(wins):
        jpq.save_alignments(str(ref / jpq.part_name(i)), b, s, h)
    out = tmp_path / "out"
    out.mkdir()
    pool = tpq.PartWriterPool(n_encoders=2, inflight_parts=inflight, n_io=n_io,
                              adaptive=adaptive)
    for i, (b, s, h) in enumerate(wins):
        pool.submit(tpq.part_path(str(out), i), b, s, h)
    pool.close()
    assert pool.n_io == n_io
    assert _parts(out) == _parts(ref)


@pytest.mark.parametrize("n_io", [1, 2])
@pytest.mark.parametrize("inflight", [1, 3])
@pytest.mark.parametrize("adaptive", [True, False])
def test_bounds_and_growth_match_jax(n_io, inflight, adaptive):
    kw = dict(n_encoders=1, inflight_parts=inflight, adaptive=adaptive, n_io=n_io)
    jp, tp = jpq.PartWriterPool(**kw), tpq.PartWriterPool(**kw)
    try:
        assert tp._bound_cap == jp._bound_cap
        assert tp.inflight_bound == jp.inflight_bound == inflight
        pattern = [True, False, False, True, True, False, True] * 10
        for gated in pattern:
            jp._maybe_grow(gated)
            tp._maybe_grow(gated)
            assert tp.inflight_bound == jp.inflight_bound
        assert tp.inflight_bound == (tp._bound_cap if adaptive else inflight)
    finally:
        jp.close()
        tp.close()


def test_isolated_gating_never_grows():
    pool = tpq.PartWriterPool(n_encoders=1, inflight_parts=1, adaptive=True, n_io=1)
    for _ in range(8):
        pool._maybe_grow(True)
        for _ in range(3):
            pool._maybe_grow(False)
    assert pool.inflight_bound == 1
    pool.close()


def test_slow_writer_grows_the_gate_up_to_its_cap(windows, tmp_path, monkeypatch):
    _, _, wins, _ = windows
    monkeypatch.setattr(tpq, "_affinity_cap", lambda floor=1, ceil=8: 8)
    real = tpq.write_part

    def slow(table, path, compression):
        time.sleep(0.06)  # well over the 20 ms that counts as gated
        real(table, path, compression)

    monkeypatch.setattr(tpq, "write_part", slow)
    pool = tpq.PartWriterPool(n_encoders=1, inflight_parts=2, n_io=1, adaptive=True)
    assert pool._bound_cap == min(8 + 1, 2 * 2)
    bounds = []
    b, s, h = wins[0]
    for i in range(16):
        pool.submit(tpq.part_path(str(tmp_path), i), b, s, h)
        bounds.append(pool.inflight_bound)
    pool.close()
    assert bounds[0] == 2 and max(bounds) == pool._bound_cap == 4
    assert bounds == sorted(bounds)
    assert len(_parts(tmp_path)) == 16

    fixed = tpq.PartWriterPool(n_encoders=1, inflight_parts=2, n_io=1, adaptive=False)
    for i in range(6):
        fixed.submit(tpq.part_path(str(tmp_path), 20 + i), b, s, h)
    fixed.close()
    assert fixed.inflight_bound == fixed._bound_cap == 2


@pytest.mark.parametrize("raw", [None, "", "1", "3", "8", "99", "0", "-2", "soup", " 2 "])
def test_writer_shards_resolve_as_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("ADAM_TPU_WRITER_SHARDS", raising=False)
    else:
        monkeypatch.setenv("ADAM_TPU_WRITER_SHARDS", raw)
    assert tpq.resolve_writer_shards() == jpq.resolve_writer_shards()
    for req in (1, 5, 99, 0, -3):
        assert tpq.resolve_writer_shards(req) == jpq.resolve_writer_shards(req)
    assert tpq._affinity_cap() == jpq._affinity_cap()


@pytest.mark.parametrize("raw", [None, "", "auto", "0", "off", "false", "1", "on",
                                 "TRUE", "bogus"])
def test_writer_adaptive_resolves_as_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("ADAM_TPU_WRITER_ADAPTIVE", raising=False)
    else:
        monkeypatch.setenv("ADAM_TPU_WRITER_ADAPTIVE", raw)
    for default in (True, False):
        assert (tpq.writer_adaptive_enabled(default)
                == jpq.writer_adaptive_enabled(default))


@pytest.mark.parametrize("site", ["parquet.write", "parquet.encode"])
def test_write_fault_fails_the_run_fast_and_a_rerun_writes_jax_bytes(windows, site):
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    d, path, _, want = windows
    out = d / f"fault_{site}.adam"
    faults.install(f"{site}=transient,after=2,times=1")
    with pytest.raises((faults.TransientFault, RuntimeError)) as e:
        transform_streamed(path, str(out), window_reads=WINDOW, device="cpu")
    cause = e.value if isinstance(e.value, faults.TransientFault) else e.value.__cause__
    assert isinstance(cause, faults.TransientFault)
    faults.clear()
    # nothing torn: no staging dir, no staging file, only whole parts
    assert not (out / tpq.TMP_DIR_NAME).exists()
    assert not [f for f in os.listdir(out) if f.endswith(".tmp")]
    assert 2 <= len(_parts(out)) < len(want)
    transform_streamed(path, str(out), window_reads=WINDOW, device="cpu")
    assert _parts(out) == want
