"""The slice end to end: the port's streamed markdup + BQSR transform on
the CPU writes Parquet parts byte-identical to the JAX package's streamed
run (device BQSR backend, resident windows) on the same SAM, and merges
the same observation histogram.  The command line writes the same parts
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


def _parts(d) -> dict:
    return {f: (pathlib.Path(d) / f).read_bytes()
            for f in sorted(os.listdir(d)) if f.startswith("part-")}


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
    env = {"ADAM_TPU_BQSR_BACKEND": "device", "ADAM_TPU_RESIDENT": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        jax_transform(path, str(d / "out.jax"), realign=False, window_reads=WINDOW,
                      dump_observations=str(d / "obs.jax.csv"))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return d, path, stats


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
    assert stats["kernel_launches"] == {"observe_hist": 0, "pack_rows": 0}


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


def test_cli_refuses_what_the_slice_does_not_run(tmp_path, capsys):
    from adam_tpu_torch.cli.main import main

    sam = str(tmp_path / "x.sam")
    assert main(["transform", sam, str(tmp_path / "o"), "-mark_duplicate_reads",
                 "--device", "cpu"]) == 2
    assert "-streaming" in capsys.readouterr().err
    assert main(["transform", sam, str(tmp_path / "o"), "-streaming",
                 "-window_reads", "0", "--device", "cpu"]) == 2


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
