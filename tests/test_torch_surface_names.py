"""The library names and call signatures the port shares with the JAX
package, called as ``adam_tpu``'s callers call them (keywords included)
and held against JAX's result on the same seeded input, on the CPU.
Every comparison is exact.

Also the operator knobs: the shared on/off parser ``utils/retry.env_toggle``
and ``ADAM_TPU_NATIVE_THREADS``, which the port reads as JAX does;
``ADAM_TPU_RESIDENT`` and ``ADAM_TPU_RESOLVE_SORT``, which it does not
(one route per pass: resident windows, the lexsort on the card); and
``device_fetch(threads=)``, taken for JAX's call with no effect, as
``ADAM_TPU_FETCH_THREADS`` has none."""

import dataclasses
import logging
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

N_READS = 3000
WINDOW = 1024


@pytest.fixture(scope="module")
def sam(tmp_path_factory):
    from make_wgs_sam import make_wgs

    d = tmp_path_factory.mktemp("names")
    path = d / "in.sam"
    make_wgs(str(path), N_READS, 100, n_contigs=2, contig_len=30_000, seed=11)
    return path


@pytest.fixture(scope="module")
def datasets(sam):
    """(port dataset, JAX dataset) of the SAM, with some reads failing
    vendor QC so both flagstat halves count."""
    from adam_tpu.io.context import load_alignments as jax_load

    from adam_tpu_torch.io.context import load_alignments

    rng = np.random.default_rng(4)
    qc = rng.random(N_READS) < 0.1
    out = []
    for ds in (load_alignments(str(sam)), jax_load(str(sam))):
        flags = np.asarray(ds.batch.flags).copy()
        flags[qc] |= 0x200
        out.append(ds.with_batch(ds.batch.replace(flags=flags)))
    return tuple(out)


def _equal_arrays(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def _batch_arrays(b) -> dict:
    return {k: np.asarray(v) for k, v in dataclasses.asdict(b.to_numpy()).items()}


def _sidecar_lists(s) -> dict:
    return {"names": list(s.names), "attrs": list(s.attrs), "md": list(s.md),
            "orig_quals": list(s.orig_quals),
            "trimmed_from_start": list(s.trimmed_from_start),
            "trimmed_from_end": list(s.trimmed_from_end)}


# --------------------------------------------------------------------------
# Partitioning
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ci, n", [
    (np.array([0, 1, 0, 2, -1, 1]), 3),
    (np.array([7, 7, 40, 40, 1000, -1]), None),
    (np.random.default_rng(5).integers(-1, 25, 500), 6),
    (np.random.default_rng(6).integers(-1, 3, 64), None),
])
def test_partition_by_contig_equals_jax(ci, n):
    from adam_tpu.parallel import partitioner as jax_part

    from adam_tpu_torch.parallel import partitioner

    got = partitioner.partition_by_contig(ci, n_partitions=n)
    want = jax_part.partition_by_contig(ci, n_partitions=n)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # same contig, same partition; unplaced rows in the last one
    for c in np.unique(ci[ci >= 0]):
        assert len(set(got[ci == c].tolist())) == 1
    assert (got[ci < 0] == got.max()).all() or not (ci < 0).any()
    shards = 3 if n is None else n
    got_rows = partitioner.shard_rows_by_contig(ci, n_shards=shards)
    want_rows = jax_part.shard_rows_by_contig(ci, n_shards=shards)
    assert len(got_rows) == len(want_rows) == shards
    for g, w in zip(got_rows, want_rows):
        np.testing.assert_array_equal(g, w)
    assert sorted(np.concatenate(got_rows).tolist()) == list(range(len(ci)))


# --------------------------------------------------------------------------
# Flagstat
# --------------------------------------------------------------------------
def test_flagstat_halves_sum_to_the_whole_and_to_jax(datasets):
    from adam_tpu.ops import flagstat as jax_fs

    from adam_tpu_torch.ops import flagstat as fs

    ds, jds = datasets
    half = N_READS // 2
    lo, hi = np.arange(half), np.arange(half, N_READS)

    def port(rows):
        return fs.flagstat_device(ds.take_rows(rows).batch, device="cpu")

    def jax(rows):
        return jax_fs.flagstat_device(jds.take_rows(rows).batch.to_device())

    whole = [m.to_ints() for m in port(np.arange(N_READS))]
    (f1, p1), (f2, p2) = port(lo), port(hi)
    summed = [(f1 + f2).to_ints(), (p1 + p2).to_ints()]
    assert isinstance(summed[0].total, int)
    assert summed == whole
    (jf1, jp1), (jf2, jp2) = jax(lo), jax(hi)
    want = [dataclasses.asdict((jf1 + jf2).to_ints()), dataclasses.asdict((jp1 + jp2).to_ints())]
    assert [dataclasses.asdict(m) for m in summed] == want
    assert whole == list(fs.flagstat(ds.batch, device="cpu"))
    assert whole[0].total > 0 and whole[1].duplicates_primary.total >= 0
    # ints add as ints
    assert (whole[0] + whole[1]).total == N_READS


# --------------------------------------------------------------------------
# Parquet names and strings
# --------------------------------------------------------------------------
def test_part_name_and_alignment_fields_equal_jax():
    from adam_tpu.io import parquet as jax_pq

    from adam_tpu_torch.formats import fields
    from adam_tpu_torch.io import parquet as pq

    for i in (0, 7, 12345, 100000):
        assert pq.part_name(i) == jax_pq.part_name(i)
        assert pq.part_index(pq.part_path("/d", i)) == i
    assert pq.ALIGNMENT_FIELDS == jax_pq.ALIGNMENT_FIELDS
    assert set(pq.ALIGNMENT_FIELDS) == fields.ALIGNMENT_FIELDS


def _random_strings(seed, n=300):
    rng = np.random.default_rng(seed)
    pool = ["".join(rng.choice(list("ACGT:_"), rng.integers(0, 12))) for _ in range(40)]
    return [pool[i] if rng.random() > 0.1 else None for i in rng.integers(0, 40, n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_string_column_unique_inverse_and_from_matrix_equal_jax(seed):
    from adam_tpu.formats.strings import StringColumn as JaxColumn

    from adam_tpu_torch.formats.strings import StringColumn

    items = _random_strings(seed)
    u, inv = StringColumn.from_list(items).unique_inverse()
    ju, jinv = JaxColumn.from_list(items).unique_inverse()
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(inv, jinv)

    rng = np.random.default_rng(seed + 10)
    mat = rng.integers(65, 91, (50, 9), dtype=np.uint8)
    for lens in (rng.integers(0, 10, 50), np.full(50, 9)):
        valid = rng.random(50) > 0.2
        got = StringColumn.from_matrix(mat, lens, valid=valid)
        want = JaxColumn.from_matrix(mat, lens, valid=valid)
        np.testing.assert_array_equal(got.buf, want.buf)
        np.testing.assert_array_equal(got.offsets, want.offsets)
        np.testing.assert_array_equal(got.valid, want.valid)


# --------------------------------------------------------------------------
# Journal and spill
# --------------------------------------------------------------------------
def test_has_observation_and_spill_close_equal_jax(tmp_path):
    from adam_tpu.parallel import sharded_join as jax_sj
    from adam_tpu.parallel.partitioner import GenomeBins as JaxBins
    from adam_tpu.pipelines.checkpoint import RunJournal as JaxJournal
    from adam_tpu.models.dictionaries import SequenceDictionary as JaxDict
    from adam_tpu.models.dictionaries import SequenceRecord as JaxRecord

    from adam_tpu_torch.models.dictionaries import SequenceDictionary, SequenceRecord
    from adam_tpu_torch.parallel import sharded_join as sj
    from adam_tpu_torch.parallel.partitioner import GenomeBins
    from adam_tpu_torch.pipelines.checkpoint import RunJournal

    for name, cls in (("port", RunJournal), ("jax", JaxJournal)):
        j = cls(str(tmp_path / name), "fp", str(tmp_path / f"out-{name}"))
        assert not j.has_observation(win=3)
        j.save_observation(3, np.zeros((2, 94, 5, 17), np.int64),
                           np.zeros((2, 94, 5, 17), np.int64), 2)
        assert j.has_observation(win=3) and not j.has_observation(win=4)

    spills = []
    for name, mk_bins, mk_dict, rec, mod in (
            ("port", GenomeBins, SequenceDictionary, SequenceRecord, sj),
            ("jax", JaxBins, JaxDict, JaxRecord, jax_sj)):
        bins = mk_bins(1000, mk_dict((rec("c1", 5000), rec("c2", 3000))))
        sp = mod.BinnedIntervalSpill(bins, str(tmp_path / f"spill-{name}"))
        sp.append([0, 0, 1], [10, 990, 5], [20, 2500, 50], [0, 1, 2])
        sp.close()
        sp.close()
        spills.append(sp)
    assert spills[0].touched_bins() == spills[1].touched_bins()
    for b in spills[0].touched_bins():
        got = (tmp_path / "spill-port" / f"bin-{b:06d}.i64").read_bytes()
        assert got == (tmp_path / "spill-jax" / f"bin-{b:06d}.i64").read_bytes()


# --------------------------------------------------------------------------
# parallel/dist.device_lexsort
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed, n, hi", [(0, 1, 3), (1, 777, 5), (2, 3000, 1 << 40)])
def test_dist_device_lexsort_takes_jax_call(seed, n, hi):
    from adam_tpu.parallel.dist import device_lexsort as jax_lexsort

    from adam_tpu_torch.parallel import dist
    from adam_tpu_torch.pipelines import markdup

    rng = np.random.default_rng(seed)
    keys = [rng.integers(-hi, hi, n) for _ in range(4)]
    info, jinfo = {}, {}
    got = dist.device_lexsort(keys, device="cpu", info=info)
    want = jax_lexsort(keys, device=None, info=jinfo)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.lexsort(keys))
    assert info == jinfo == {"device_sort": True}
    # one implementation: the duplicate resolve calls dist's
    assert markdup.device_lexsort is dist.device_lexsort


# --------------------------------------------------------------------------
# The resident-window API
# --------------------------------------------------------------------------
def test_make_resident_window_equals_jax_placement(datasets):
    from adam_tpu.parallel import device_pool as jax_dp

    from adam_tpu_torch.parallel import device_pool as dp

    ds, jds = datasets
    rw = dp.make_resident_window(ds.batch.to_numpy(), window=5, device="cpu")
    jrw = jax_dp.make_resident_window(jds.batch.to_numpy(), window=5, device=None)
    assert (rw.window, rw.g, rw.gl, rw.nbytes) == (jrw.window, jrw.g, jrw.gl, jrw.nbytes)
    for f in dp.ResidentWindow.FIELDS:
        np.testing.assert_array_equal(rw.get(f).numpy(), np.asarray(jrw.get(f)), err_msg=f)
    assert rw.device == torch.device("cpu")


def test_resident_window_refcount_matches_jax(datasets):
    from adam_tpu.parallel import device_pool as jax_dp

    from adam_tpu_torch.parallel import device_pool as dp

    ds, jds = datasets
    b = ds.batch.take(np.arange(10)).to_numpy()
    jb = jds.batch.take(np.arange(10)).to_numpy()
    for make in (lambda: dp.make_resident_window(b, 0, device="cpu"),
                 lambda: jax_dp.make_resident_window(jb, 0)):
        rw = make()
        rw.retain()
        assert rw.release() is False and rw.alive  # one reference left
        assert rw.release() is True and not rw.alive
        assert rw.release() is False
        rw = make()
        rw.retain()
        rw.retain()
        assert rw.drop() is True and not rw.alive  # whatever the count
        assert rw.drop() is False
        rw.retain()  # a no-op once freed
        assert not rw.alive
        with pytest.raises(RuntimeError, match="released"):
            rw.get("bases")


@pytest.mark.parametrize("raw", [None, "", "auto", "1", "On", "true", "0", "off", "FALSE",
                                 "maybe", "bogus"])
def test_env_toggle_parses_as_jax(monkeypatch, raw):
    """The shared on/off parser of ``ADAM_TPU_BATCH`` and
    ``ADAM_TPU_WRITER_ADAPTIVE``: unset and ``auto`` give the default,
    ``1/on/true`` and ``0/off/false`` force in any case, anything else
    keeps the default, as JAX's parser does."""
    from adam_tpu.utils.retry import env_toggle as jax_env_toggle

    from adam_tpu_torch.utils.retry import env_toggle

    name = "ADAM_TPU_WRITER_ADAPTIVE"
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)
    for default in (True, False):
        assert env_toggle(name, default) is jax_env_toggle(name, default)
    forced = {"1": True, "On": True, "true": True, "0": False, "off": False, "FALSE": False}
    if raw in forced:
        assert env_toggle(name, not forced[raw]) is forced[raw]
    else:
        assert env_toggle(name, True) is True and env_toggle(name, False) is False


# --------------------------------------------------------------------------
# Fault (q): JAX's call signatures
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bam(sam, tmp_path_factory):
    from adam_tpu_torch.io import sam as port_sam

    path = tmp_path_factory.mktemp("bam") / "in.bam"
    port_sam.write_bam(str(path), *port_sam.read_sam(str(sam)))
    return path


@pytest.fixture(scope="module")
def part(sam, tmp_path_factory):
    from adam_tpu_torch.io.context import load_alignments

    path = tmp_path_factory.mktemp("pq") / "in.adam"
    load_alignments(str(sam)).save(str(path))
    return path


@pytest.mark.parametrize("round_rows_to", [1, 7, 1024])
@pytest.mark.parametrize("reader", ["read_sam", "read_bam", "load_alignments",
                                    "from_arrow_alignments"])
def test_readers_pad_rows_as_jax(sam, bam, part, reader, round_rows_to):
    import pyarrow.parquet as pq

    from adam_tpu.io import parquet as jax_pq
    from adam_tpu.io import sam as jax_sam

    from adam_tpu_torch.io import parquet as port_pq
    from adam_tpu_torch.io import sam as port_sam

    if reader == "from_arrow_alignments":
        table = pq.read_table(str(part))
        got = port_pq.from_arrow_alignments(table, round_rows_to=round_rows_to)
        want = jax_pq.from_arrow_alignments(table, round_rows_to=round_rows_to)
    else:
        path = {"read_sam": sam, "read_bam": bam, "load_alignments": part}[reader]
        mod, jmod = ((port_pq, jax_pq) if reader == "load_alignments"
                     else (port_sam, jax_sam))
        got = getattr(mod, reader)(str(path), round_rows_to=round_rows_to)
        want = getattr(jmod, reader)(str(path), round_rows_to=round_rows_to)
    assert got[0].n_rows == want[0].n_rows
    assert got[0].n_rows % round_rows_to == 0 and got[0].n_rows >= N_READS
    _equal_arrays(_batch_arrays(got[0]), _batch_arrays(want[0]))
    assert _sidecar_lists(got[1]) == _sidecar_lists(want[1])


def test_merge_events_takes_the_events_keyword(datasets):
    from adam_tpu.pipelines import realign as jra

    from adam_tpu_torch.pipelines import realign as ra

    ds, jds = datasets
    events = jra.extract_indel_event_arrays(jds.batch.to_numpy())
    names = jds.seq_dict.names
    got = ra.merge_events(events=events, names=names, max_target_size=3000)
    want = jra.merge_events(events=events, names=names, max_target_size=3000)
    assert [vars(t) for t in got] == [vars(t) for t in want]
    assert len(got) > 0


def test_apply_recalibration_takes_a_host_table(datasets):
    from adam_tpu.formats.batch import grid_cols
    from adam_tpu.pipelines import bqsr as jbqsr

    from adam_tpu_torch.pipelines import bqsr

    ds, jds = datasets
    gl = grid_cols(jds.batch.lmax)
    n_rg = len(jds.read_groups) + 1
    rng = np.random.default_rng(12)
    table = rng.integers(2, 60, (n_rg, 94, 2 * gl + 1, 17), dtype=np.uint8)
    got = bqsr.apply_recalibration(ds, phred_table=table, gl=gl, device="cpu")
    want = jbqsr.apply_recalibration(jds, phred_table=table, gl=gl)
    _equal_arrays(_batch_arrays(got.batch), _batch_arrays(want.batch))
    assert list(got.sidecar.orig_quals) == list(want.sidecar.orig_quals)
    assert not np.array_equal(np.asarray(got.batch.quals), np.asarray(ds.batch.quals))


def test_row_summary_computes_what_is_omitted(datasets):
    from adam_tpu.pipelines import markdup as jmd

    from adam_tpu_torch.pipelines import markdup as md

    ds, jds = datasets
    want = jmd.row_summary(jds)
    _equal_arrays(md.row_summary(ds), want)
    _equal_arrays(md.row_summary(ds, b=ds.batch.to_numpy()), want)
    five, score = md.markdup_columns_device(ds.batch, device="cpu")
    jfive, jscore = jmd.markdup_columns_device(jds.batch)
    np.testing.assert_array_equal(five, jfive)
    np.testing.assert_array_equal(score, jscore)
    _equal_arrays(md.row_summary(ds, None, five, score), want)
    _equal_arrays(md.row_summary(ds, five_prime=five, score=score), want)


@pytest.mark.parametrize("sort_device", [None, "default", "cpu"])
def test_resolve_duplicates_takes_jax_keywords(datasets, sort_device):
    from adam_tpu.pipelines import markdup as jmd

    from adam_tpu_torch.pipelines import markdup as md

    ds, jds = datasets
    want = jmd.resolve_duplicates(jmd.row_summary(jds), sort_device=None)
    info = {}
    if sort_device == "default" and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            md.resolve_duplicates(md.row_summary(ds), sort_device=sort_device)
        return
    got = md.resolve_duplicates(md.row_summary(ds), sort_device=sort_device,
                                sort_info=info)
    np.testing.assert_array_equal(got, want)
    assert want.any()
    jinfo = {}
    jmd.resolve_duplicates(jmd.row_summary(jds), sort_device=sort_device and "default",
                           sort_info=jinfo)
    assert info == jinfo == {"device_sort": sort_device is not None}


def test_flagstat_device_takes_a_batch(datasets):
    from adam_tpu.ops import flagstat as jax_fs

    from adam_tpu_torch.ops import flagstat as fs

    ds, jds = datasets
    failed, passed = fs.flagstat_device(ds.batch, device="cpu")
    assert isinstance(failed.total, torch.Tensor) and failed.total.dim() == 0
    jf, jp = jax_fs.flagstat_device(jds.batch.to_device())
    assert dataclasses.asdict(failed.to_ints()) == dataclasses.asdict(jf.to_ints())
    assert dataclasses.asdict(passed.to_ints()) == dataclasses.asdict(jp.to_ints())
    # to_device places every field, as JAX's does
    placed = ds.batch.to_device("cpu")
    assert all(isinstance(v, torch.Tensor) for v in dataclasses.asdict(placed).values())
    assert [m.to_ints() for m in fs.flagstat_device(placed, device="cpu")] == [
        failed.to_ints(), passed.to_ints()]


def test_observe_inputs_equal_jax(datasets):
    from adam_tpu.pipelines import bqsr as jbqsr

    from adam_tpu_torch.pipelines import bqsr

    ds, jds = datasets
    got = bqsr.observe_inputs(ds, known_snps=None)
    want = jbqsr.observe_inputs(jds, known_snps=None)
    _equal_arrays(_batch_arrays(got[0]), _batch_arrays(want[0]))
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4]


# --------------------------------------------------------------------------
# The operator knobs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("threads", [1, 2, 4])
def test_device_fetch_threads_equal_bits(threads):
    from adam_tpu.utils.transfer import device_fetch as jax_fetch

    from adam_tpu_torch.utils.transfer import device_fetch

    x = torch.from_numpy(np.random.default_rng(threads).integers(0, 1 << 30, (513, 7)))
    got = device_fetch(x, threads=threads)
    np.testing.assert_array_equal(got, x.numpy())
    np.testing.assert_array_equal(jax_fetch(np.asarray(x), threads=threads), got)


@pytest.mark.parametrize("raw", [None, "3", "0", "12", "x"])
def test_fetch_threads_has_no_effect(monkeypatch, caplog, raw):
    """One copy stream whatever ``threads=`` or ``ADAM_TPU_FETCH_THREADS``
    say: the copy is called alike, and a bad value is not even read."""
    from adam_tpu_torch.utils import transfer

    if raw is None:
        monkeypatch.delenv("ADAM_TPU_FETCH_THREADS", raising=False)
    else:
        monkeypatch.setenv("ADAM_TPU_FETCH_THREADS", raw)
    seen = []
    monkeypatch.setattr(transfer, "_copy_home",
                        lambda *args: seen.append(len(args)) or args[0].numpy())
    x = torch.arange(4)
    with caplog.at_level(logging.WARNING):
        for threads in (None, 1, 4):
            np.testing.assert_array_equal(transfer.device_fetch(x, threads=threads), x.numpy())
    assert seen == [2, 2, 2]
    assert "FETCH_THREADS" not in caplog.text


def test_native_threads_knob(monkeypatch, sam):
    from adam_tpu import native as jax_native

    from adam_tpu_torch import native
    from adam_tpu_torch.io import sam as port_sam

    monkeypatch.delenv("ADAM_TPU_NATIVE_THREADS", raising=False)
    default = native._nthreads()
    assert 1 <= default <= 16
    base = port_sam.read_sam(str(sam))
    for raw, want in (("1", 1), ("3", 3), ("0", 1)):
        monkeypatch.setenv("ADAM_TPU_NATIVE_THREADS", raw)
        assert native._nthreads() == jax_native._nthreads() == want
        got = port_sam.read_sam(str(sam))
        _equal_arrays(_batch_arrays(got[0]), _batch_arrays(base[0]))
        assert _sidecar_lists(got[1]) == _sidecar_lists(base[1])


def _parts(d) -> dict:
    return {p.name: p.read_bytes() for p in sorted(pathlib.Path(d).glob("part-*.parquet"))}


def _streamed(sam, out, **kw):
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    return transform_streamed(str(sam), str(out), window_reads=WINDOW, device="cpu", **kw)


@pytest.fixture(scope="module")
def default_run(sam, tmp_path_factory):
    out = tmp_path_factory.mktemp("default") / "out.adam"
    stats = _streamed(sam, out)
    return stats, _parts(out)


def test_resident_off_still_places_windows_and_writes_the_same_bytes(
        sam, tmp_path, monkeypatch, default_run):
    """``ADAM_TPU_RESIDENT=0`` changes nothing: the port does not read it."""
    stats, parts = default_run
    assert stats["resident_windows"] > 0
    monkeypatch.setenv("ADAM_TPU_RESIDENT", "0")
    got = _streamed(sam, tmp_path / "off.adam")
    assert got["resident_windows"] == stats["resident_windows"]
    assert _parts(tmp_path / "off.adam") == parts and len(parts) >= 3


@pytest.mark.parametrize("partitioner", ["pool", "mesh"])
def test_resident_off_on_two_slots_writes_the_same_bytes(
        sam, tmp_path, monkeypatch, default_run, partitioner):
    """``ADAM_TPU_RESIDENT=0`` on two slots, pooled or as a mesh: windows
    are still placed, and the parts are the one slot's bytes."""
    from adam_tpu_torch.parallel.device_pool import DevicePool, make_slots
    from adam_tpu_torch.utils import health

    monkeypatch.setenv("ADAM_TPU_RESIDENT", "0")
    try:
        got = _streamed(sam, tmp_path / "off.adam", partitioner=partitioner,
                        device_pool=DevicePool(make_slots(["cpu", "cpu"])))
    finally:
        health.reset_board()  # the two slots leave the process-wide board
    assert got["resident_windows"] > 0
    assert _parts(tmp_path / "off.adam") == default_run[1]


@pytest.mark.parametrize("raw", ["host", "device", "", "hots"])
def test_resolve_sort_knob(sam, tmp_path, monkeypatch, caplog, default_run, raw):
    """``ADAM_TPU_RESOLVE_SORT`` changes nothing: whatever it says, barrier
    1 sorts once on the card, nothing warns, and the bytes are the same."""
    from adam_tpu_torch.pipelines import markdup

    calls = []
    real = markdup.device_lexsort

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(markdup, "device_lexsort", counting)
    monkeypatch.setenv("ADAM_TPU_RESOLVE_SORT", raw)
    with caplog.at_level(logging.WARNING):
        stats = _streamed(sam, tmp_path / "out.adam")
    assert len(calls) == 1
    assert "ADAM_TPU_RESOLVE_SORT" not in caplog.text
    assert stats["n_duplicates"] == default_run[0]["n_duplicates"] > 0
    assert _parts(tmp_path / "out.adam") == default_run[1]
