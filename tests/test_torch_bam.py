"""BAM ingest of the port against the JAX package, on the CPU: the
whole-file readers (``read_bam``, ``read_sam`` on ``.sam`` and
``.sam.gz``), the BAM writer, the streaming ``iter_bam_batches`` window
for window (byte windows small enough that BGZF blocks and BAM records
straddle them), the errors of a truncated or foreign file, and the
streamed transform on a BAM and on a ``.sam.gz``, whose parts must be
byte-identical to the JAX package's run on the same file (device BQSR
backend, resident windows).  Exact equality throughout."""

import contextlib
import dataclasses
import functools
import gzip
import io
import json
import os
import pathlib
import shutil
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

N_READS = 4500
WINDOW = 2048


def _parts(d) -> dict:
    return {f: (pathlib.Path(d) / f).read_bytes()
            for f in sorted(os.listdir(d)) if f.startswith("part-")}


@contextlib.contextmanager
def _jax_device_backend():
    """The JAX streamed run's environment: device BQSR, resident windows."""
    env = {"ADAM_TPU_BQSR_BACKEND": "device", "ADAM_TPU_RESIDENT": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A WGS-shaped SAM, its gzip, and the BAM the JAX package writes
    from it."""
    from make_wgs_sam import make_wgs

    from adam_tpu.io import sam as jsam

    d = tmp_path_factory.mktemp("bam")
    make_wgs(str(d / "in.sam"), N_READS, 100, n_contigs=2, contig_len=30_000)
    with open(d / "in.sam", "rb") as src, gzip.open(d / "in.sam.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    jsam.write_bam(str(d / "in.bam"), *jsam.read_sam(str(d / "in.sam")))
    return d


def assert_same_reads(want, got):
    """A JAX (batch, sidecar, header) equals the port's, field by field."""
    (jb, js, jh), (tb, ts, th) = want, got
    jb = jb.to_numpy()
    for f in dataclasses.fields(tb):
        a, b = np.asarray(getattr(jb, f.name)), np.asarray(getattr(tb, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    for f in ("names", "attrs", "md", "orig_quals"):
        assert getattr(js, f).to_list() == getattr(ts, f).to_list(), f
    for f in ("trimmed_from_start", "trimmed_from_end"):
        np.testing.assert_array_equal(getattr(js, f), getattr(ts, f), err_msg=f)
    assert jh.to_lines() == th.to_lines()


@pytest.mark.parametrize("reader,name", [("read_bam", "in.bam"), ("read_sam", "in.sam"),
                                         ("read_sam", "in.sam.gz")])
def test_whole_file_readers_equal_jax(inputs, reader, name):
    from adam_tpu.io import sam as jsam

    from adam_tpu_torch.io import sam as tsam

    path = str(inputs / name)
    want = getattr(jsam, reader)(path)
    got = getattr(tsam, reader)(path)
    assert got[0].n_rows == N_READS
    assert_same_reads(want, got)


def test_bam_and_sam_read_to_the_same_reads(inputs):
    from adam_tpu_torch.io import sam as tsam

    assert_same_reads(tsam.read_sam(str(inputs / "in.sam")),
                      tsam.read_bam(str(inputs / "in.bam")))


@pytest.mark.parametrize("sort_order", [None, "coordinate"])
def test_write_bam_byte_identical_to_jax(inputs, tmp_path, sort_order):
    from adam_tpu.io import sam as jsam

    from adam_tpu_torch.io import sam as tsam

    jsam.write_bam(str(tmp_path / "j.bam"), *jsam.read_sam(str(inputs / "in.sam")),
                   sort_order=sort_order)
    tsam.write_bam(str(tmp_path / "t.bam"), *tsam.read_sam(str(inputs / "in.sam")),
                   sort_order=sort_order)
    got = (tmp_path / "t.bam").read_bytes()
    assert got == (tmp_path / "j.bam").read_bytes()
    assert got.endswith(tsam.BGZF_EOF)


def test_bgzf_round_trip_equals_jax():
    from adam_tpu.io import sam as jsam

    from adam_tpu_torch.io import sam as tsam

    data = np.random.default_rng(1).integers(0, 7, 300_000).astype(np.uint8).tobytes()
    for block in (0xFF00, 4096, 1 << 20):
        comp = tsam.bgzf_compress(data, block_size=block)
        assert comp == jsam.bgzf_compress(data, block_size=block)
        assert tsam.bgzf_decompress(comp) == data


@pytest.mark.parametrize("window_bytes,batch_reads", [
    (4096, 1000), (4096, 100_000), (65_536, 1), (32 * 1024 * 1024, 1000)])
def test_bam_windows_equal_jax(inputs, window_bytes, batch_reads):
    """Window for window: BGZF blocks (~64 KiB) and BAM records straddle
    4 KiB byte windows, and every yielded batch is whole windows."""
    from adam_tpu.io import sam as jsam

    from adam_tpu_torch.io import sam as tsam

    path = str(inputs / "in.bam")
    want = list(jsam.iter_bam_batches(path, batch_reads, window_bytes))
    got = list(tsam.iter_bam_batches(path, batch_reads, window_bytes))
    assert [w[0].n_rows for w in got] == [w[0].n_rows for w in want]
    assert sum(w[0].n_rows for w in got) == N_READS
    if window_bytes == 4096 and batch_reads == 1000:
        assert len(got) > 2
    for w, g in zip(want, got):
        assert_same_reads(w, g)


def _truncated(inputs, tmp_path, case) -> str:
    """A damaged copy of the BAM: cut inside its last data block, a BAM
    stream cut inside its last record (re-compressed whole), a stream
    whose preamble is cut, or a file that is not BGZF."""
    from adam_tpu_torch.io import sam as tsam

    comp = (inputs / "in.bam").read_bytes()
    raw = tsam.bgzf_decompress(comp)
    path = tmp_path / f"{case}.bam"
    if case == "block":
        body = comp[: -len(tsam.BGZF_EOF)]
        path.write_bytes(body[: len(body) - 100])
    elif case == "record":
        path.write_bytes(tsam.bgzf_compress(raw[:-37]))
    elif case == "preamble":
        path.write_bytes(tsam.bgzf_compress(raw[:30]))
    else:
        path.write_bytes((inputs / "in.sam").read_bytes()[:100_000])
    return str(path)


@pytest.mark.parametrize("case", ["block", "record", "preamble", "not_bgzf"])
def test_damaged_bam_raises_as_jax(inputs, tmp_path, case):
    from adam_tpu.io import sam as jsam

    from adam_tpu_torch.io import sam as tsam

    path = _truncated(inputs, tmp_path, case)
    with pytest.raises(ValueError) as want:
        list(jsam.iter_bam_batches(path, 1000, 4096))
    with pytest.raises(ValueError) as got:
        list(tsam.iter_bam_batches(path, 1000, 4096))
    assert str(got.value) == str(want.value)
    # the whole-file reader raises too (where the JAX package would try
    # its pure-Python codecs)
    with pytest.raises(ValueError):
        tsam.read_bam(path)


@pytest.fixture(scope="module", params=["full", "markdup_only"])
def bam_runs(request, inputs, tmp_path_factory):
    """Both packages' streamed transform of the BAM: in its own 32 MiB
    byte windows (one window here), and in 64 KiB byte windows (several)
    through each package's reader."""
    from adam_tpu.io import sam as jsam
    from adam_tpu.pipelines.streamed import transform_streamed as jax_transform

    from adam_tpu_torch.io import sam as tsam
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    flags = ({} if request.param == "full"
             else dict(realign=False, recalibrate=False))
    d = tmp_path_factory.mktemp(f"bam_{request.param}")
    stats = {}
    mp = pytest.MonkeyPatch()
    try:
        for wb in ("default", "64k"):
            if wb == "64k":
                for mod in (jsam, tsam):
                    mp.setattr(mod, "iter_bam_batches",
                               functools.partial(mod.iter_bam_batches, window_bytes=65_536))
            stats[wb] = transform_streamed(str(inputs / "in.bam"), str(d / f"t.{wb}"),
                                           window_reads=WINDOW, device="cpu", **flags)
            with _jax_device_backend():
                jax_transform(str(inputs / "in.bam"), str(d / f"j.{wb}"),
                              window_reads=WINDOW, **flags)
    finally:
        mp.undo()
    return request.param, d, stats


@pytest.mark.parametrize("wb", ["default", "64k"])
def test_bam_transform_byte_identical_to_jax(bam_runs, wb):
    kind, d, stats = bam_runs
    got, want = _parts(d / f"t.{wb}"), _parts(d / f"j.{wb}")
    st = stats[wb]
    assert st["n_reads"] == N_READS
    # the BAM's 290 KB fit one 32 MiB byte window; 64 KiB windows cut it
    assert (st["n_windows"] == 1) if wb == "default" else (st["n_windows"] > 1)
    assert len(want) == st["n_parts"] == st["n_windows"] + (kind == "full")
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], (kind, wb, name)


def test_sam_gz_transform_byte_identical_to_jax(inputs, tmp_path):
    from adam_tpu.pipelines.streamed import transform_streamed as jax_transform

    from adam_tpu_torch.pipelines.streamed import transform_streamed

    path = str(inputs / "in.sam.gz")
    stats = transform_streamed(path, str(tmp_path / "t"), window_reads=WINDOW,
                               device="cpu")
    with _jax_device_backend():
        jax_transform(path, str(tmp_path / "j"), window_reads=WINDOW)
    got, want = _parts(tmp_path / "t"), _parts(tmp_path / "j")
    assert len(want) == stats["n_windows"] + 1 == 4
    assert got == want


def test_cli_bam_transform_writes_the_library_parts(bam_runs, inputs, tmp_path):
    """``transform x.bam`` with markdup + realign + BQSR on the CPU writes
    the library call's parts (and so the JAX package's)."""
    from adam_tpu_torch.cli.main import main

    kind, d, _ = bam_runs
    out = tmp_path / "cli.adam"
    flags = (["-realign_indels", "-recalibrate_base_qualities"] if kind == "full" else [])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["transform", str(inputs / "in.bam"), str(out), "-streaming",
                   "-mark_duplicate_reads", *flags, "-window_reads", str(WINDOW),
                   "--device", "cpu"])
    assert rc == 0
    assert json.loads(buf.getvalue().splitlines()[-1])["n_reads"] == N_READS
    assert _parts(out) == _parts(d / "j.default")
