"""The port end to end: the streamed markdup (+ realign) + BQSR transform
on the CPU writes Parquet parts byte-identical to the JAX package's
streamed run (device BQSR backend, resident windows) on the same SAM, and
merges the same observation histogram — without realignment, and with it
under both consensus models.  The ``smithwaterman`` reference is the JAX
run with its ``_sw_preprocess`` wrapped inside the test to refresh a
rewritten read's implied reference, the one repair the port makes (see
``tests/test_torch_realign.py``).  The command line writes the same parts
as the library call."""

import contextlib
import io
import json
import os
import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

WINDOW = 2048
SW_READS = 2500  # the JAX smithwaterman path compiles per shape: a smaller input


def _parts(d) -> dict:
    return {f: (pathlib.Path(d) / f).read_bytes()
            for f in sorted(os.listdir(d)) if f.startswith("part-")}


class _JaxDeviceBackend:
    """The JAX streamed run's environment: device BQSR, resident windows."""

    ENV = {"ADAM_TPU_BQSR_BACKEND": "device", "ADAM_TPU_RESIDENT": "1"}

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.ENV}
        os.environ.update(self.ENV)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from make_wgs_sam import make_wgs

    from adam_tpu.pipelines.streamed import transform_streamed as jax_transform

    from adam_tpu_torch.pipelines.streamed import transform_streamed

    d = tmp_path_factory.mktemp("streamed")
    path = str(d / "in.sam")
    make_wgs(path, 4500, 100, n_contigs=2, contig_len=30_000)
    stats = transform_streamed(
        path, str(d / "out.torch"), realign=False, window_reads=WINDOW,
        dump_observations=str(d / "obs.torch.csv"), device="cpu",
    )
    with _JaxDeviceBackend():
        jax_transform(path, str(d / "out.jax"), realign=False, window_reads=WINDOW,
                      dump_observations=str(d / "obs.jax.csv"))
    return d, path, stats


@pytest.fixture(scope="module", params=["reads", "smithwaterman"])
def realign_runs(request, runs, tmp_path_factory):
    """Realigning runs of both packages: the reads model on the slice's
    input, the smithwaterman model on a smaller one."""
    from make_wgs_sam import make_wgs

    from adam_tpu.pipelines import realign as jra
    from adam_tpu.pipelines.streamed import transform_streamed as jax_transform

    from adam_tpu_torch.pipelines.streamed import transform_streamed

    model = request.param
    d = tmp_path_factory.mktemp(f"realign_{model}")
    if model == "reads":
        path = runs[1]
    else:
        path = str(d / "in.sam")
        make_wgs(path, SW_READS, 100, n_contigs=2, contig_len=30_000)
    stats = transform_streamed(
        path, str(d / "out.torch"), realign=True, consensus_model=model,
        window_reads=WINDOW, dump_observations=str(d / "obs.torch.csv"), device="cpu",
    )
    orig = jra._sw_preprocess

    def refreshing(reads, reference, ref_start, weights):
        out = orig(reads, reference, ref_start, weights)
        return [new if new is old
                else jra.dc_replace(new, ref=new.md.get_reference(new.seq, new.cigar))
                for old, new in zip(reads, out)]

    mp = pytest.MonkeyPatch()
    mp.setattr(jra, "_sw_preprocess", refreshing)
    try:
        with _JaxDeviceBackend():
            jax_transform(path, str(d / "out.jax"), realign=True, consensus_model=model,
                          window_reads=WINDOW, dump_observations=str(d / "obs.jax.csv"))
    finally:
        mp.undo()
    return model, d, path, stats


def test_parts_byte_identical_to_jax(runs):
    d, _, stats = runs
    got, want = _parts(d / "out.torch"), _parts(d / "out.jax")
    assert len(want) == 3 == stats["n_windows"] == stats["n_parts"]
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name


def test_observations_equal_jax(runs):
    d, _, _ = runs
    got = (d / "obs.torch.csv").read_text()
    assert got == (d / "obs.jax.csv").read_text()
    assert len(got.splitlines()) > 1000


def test_stats_of_a_cpu_run(runs):
    _, _, stats = runs
    assert stats["device"] == "cpu"
    assert stats["n_reads"] == 4500
    assert stats["n_duplicates"] > 0
    # the CPU runs the plain versions: no kernel is launched
    assert set(stats["kernel_launches"]) >= {"observe_hist", "pack_rows", "sw_fill",
                                             "sw_score"}
    assert all(n == 0 for n in stats["kernel_launches"].values())


def test_cli_writes_the_same_parts(runs, tmp_path):
    from adam_tpu_torch.cli.main import main

    d, path, _ = runs
    out = tmp_path / "cli.adam"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["transform", path, str(out), "-streaming", "-mark_duplicate_reads",
                   "-recalibrate_base_qualities", "-window_reads", str(WINDOW),
                   "--device", "cpu"])
    assert rc == 0
    assert json.loads(buf.getvalue().splitlines()[-1])["n_reads"] == 4500
    assert _parts(out) == _parts(d / "out.torch")
    assert not (out / "_temporary").exists()


def test_realigned_parts_byte_identical_to_jax(realign_runs):
    model, d, _, stats = realign_runs
    got, want = _parts(d / "out.torch"), _parts(d / "out.jax")
    # one part per window plus the realigned part, index n_windows
    assert len(want) == stats["n_windows"] + 1 == stats["n_parts"]
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], (model, name)


def test_realigned_observations_equal_jax(realign_runs):
    _, d, _, _ = realign_runs
    got = (d / "obs.torch.csv").read_text()
    assert got == (d / "obs.jax.csv").read_text()
    assert len(got.splitlines()) > 1000


def test_stats_of_a_realigning_run(realign_runs):
    import pyarrow.parquet as pq

    model, d, _, stats = realign_runs
    assert stats["n_candidates"] > 100 and stats["n_realigned"] > 0
    assert stats["realign_s"] >= 0 and "split_s" in stats
    assert all(n == 0 for n in stats["kernel_launches"].values())
    last = pq.read_table(d / "out.torch" / f"part-r-{stats['n_windows']:05d}.parquet")
    assert last.num_rows == stats["n_candidates"]
    attrs = last.column("attributes").to_pylist()
    assert sum("OC:Z:" in (a or "") for a in attrs) > 0, model


def test_cli_realign_writes_the_library_parts(runs, tmp_path):
    """``-realign_indels`` is the library's reads-model realignment."""
    from adam_tpu_torch.cli.main import main
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    _, path, _ = runs
    out = tmp_path / "cli.adam"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = main(["transform", path, str(out), "-streaming", "-mark_duplicate_reads",
                   "-realign_indels", "-recalibrate_base_qualities",
                   "-window_reads", str(WINDOW), "--device", "cpu"])
    assert rc == 0
    stats = transform_streamed(path, str(tmp_path / "lib.adam"), realign=True,
                               consensus_model="reads", window_reads=WINDOW,
                               device="cpu")
    assert _parts(out) == _parts(tmp_path / "lib.adam")
    assert len(_parts(out)) == stats["n_windows"] + 1


@pytest.fixture(scope="module")
def default_realign_parts(runs, tmp_path_factory):
    """The port's reads-model realigning run with every tuning knob at its
    default."""
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    out = tmp_path_factory.mktemp("tuning_default") / "out.adam"
    transform_streamed(runs[1], str(out), realign=True, window_reads=WINDOW, device="cpu")
    return _parts(out)


# each library knob and the CLI flag that sets it (the JAX CLI's spelling)
_KNOB_FLAGS = {"max_indel_size": "-max_indel_size",
               "max_consensus_number": "-max_consensus_number",
               "lod_threshold": "-log_odds_threshold",
               "max_target_size": "-max_target_size"}


@pytest.mark.parametrize("knob", [
    {"max_indel_size": 3},
    {"max_consensus_number": 0},
    {"lod_threshold": 1000.0},
    {"max_target_size": 40},
])
def test_realign_tuning_knob_matches_jax(knob, runs, default_realign_parts, tmp_path):
    """A non-default value of each realignment knob changes the parts, the
    port writes the same parts as the JAX package with that value, and the
    CLI's flag for the knob writes them too."""
    from adam_tpu.pipelines.streamed import transform_streamed as jax_transform

    from adam_tpu_torch.cli.main import main
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    _, path, _ = runs
    transform_streamed(path, str(tmp_path / "torch"), realign=True, window_reads=WINDOW,
                       device="cpu", **knob)
    with _JaxDeviceBackend():
        jax_transform(path, str(tmp_path / "jax"), realign=True, window_reads=WINDOW,
                      **knob)
    got, want = _parts(tmp_path / "torch"), _parts(tmp_path / "jax")
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], (knob, name)
    assert got != default_realign_parts, knob
    ((name, value),) = knob.items()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = main(["transform", path, str(tmp_path / "cli"), "-streaming",
                   "-mark_duplicate_reads", "-realign_indels", "-recalibrate_base_qualities",
                   "-window_reads", str(WINDOW), _KNOB_FLAGS[name], str(value),
                   "--device", "cpu"])
    assert rc == 0
    assert _parts(tmp_path / "cli") == got, knob


def test_default_flags_write_the_jax_parts(runs, tmp_path):
    """With every stage flag at its default, the two packages' library
    calls write the same parts: both realign by default."""
    from adam_tpu.pipelines.streamed import transform_streamed as jax_transform

    from adam_tpu_torch.pipelines.streamed import transform_streamed

    _, path, _ = runs
    stats = transform_streamed(path, str(tmp_path / "torch"), device="cpu")
    with _JaxDeviceBackend():
        jax_transform(path, str(tmp_path / "jax"))
    got, want = _parts(tmp_path / "torch"), _parts(tmp_path / "jax")
    assert stats["n_realigned"] > 0 and stats["n_parts"] == stats["n_windows"] + 1
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name


def test_cli_refuses_what_the_slice_does_not_run(tmp_path, capsys):
    from adam_tpu_torch.cli.main import main

    sam = str(tmp_path / "x.sam")
    # the streamed pipeline runs the markdup/BQSR/realign stage set only;
    # a sort (or trim) pipeline is the dataset-level transform's
    assert main(["transform", sam, str(tmp_path / "o"), "-streaming",
                 "-mark_duplicate_reads", "-sort_reads", "--device", "cpu"]) == 2
    assert "trim/sort pipelines" in capsys.readouterr().err
    assert main(["transform", sam, str(tmp_path / "o"), "-streaming",
                 "-window_reads", "0", "--device", "cpu"]) == 2
    # the streamed transform reads windowed SAM/BAM only, as the JAX CLI's
    assert main(["transform", str(tmp_path / "x.adam"), str(tmp_path / "o"),
                 "-streaming", "--device", "cpu"]) == 2
    assert "SAM/BAM" in capsys.readouterr().err


def test_peek_header_equals_the_windows_header(runs):
    from adam_tpu_torch.io.sam import iter_sam_batches, peek_sam_header

    _, path, _ = runs
    _, _, header = next(iter_sam_batches(path, WINDOW))
    assert peek_sam_header(path) == header
    assert header.read_groups.names == ["rg1", "rg2"]


def test_writer_failure_publishes_nothing_and_reraises(runs, tmp_path, monkeypatch):
    from adam_tpu_torch.io import parquet
    from adam_tpu_torch.io.sam import iter_sam_batches

    _, path, _ = runs
    batch, side, header = next(iter_sam_batches(path, WINDOW))

    def broken(table, dst, compression):
        raise OSError("disk full")

    monkeypatch.setattr(parquet, "write_part", broken)
    pool = parquet.PartWriterPool()
    pool.submit(parquet.part_path(str(tmp_path), 0), batch, side, header)
    with pytest.raises(OSError, match="disk full"):
        pool.close()
    assert os.listdir(tmp_path) == []
