"""flagstat of the port against the JAX package, on the CPU: the metrics
equal JAX's ``to_ints()`` field for field, the report text is the same,
and the ``flagstat`` verb prints the same bytes on a ``.sam`` and on a
``.adam`` (read with the flag columns projected)."""

import contextlib
import dataclasses
import io
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

N_READS = 4500


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A WGS-shaped SAM after duplicate marking, with some reads marked as
    failing vendor QC, secondary, or unmapped with a mapped mate, so that
    every metric counts something; as ``.sam`` and as ``.adam``."""
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.io.context import load_alignments

    d = tmp_path_factory.mktemp("flagstat")
    make_wgs(str(d / "raw.sam"), N_READS, 100, n_contigs=2, contig_len=30_000)
    ds = load_alignments(str(d / "raw.sam")).mark_duplicates(device="cpu")
    rng = np.random.default_rng(3)
    flags = np.asarray(ds.batch.flags).copy()
    flags[rng.random(N_READS) < 0.05] |= 0x200
    flags[rng.random(N_READS) < 0.03] |= 0x100
    flags[rng.random(N_READS) < 0.02] |= 0x8
    mate = np.asarray(ds.batch.mate_contig_idx).copy()
    mate[(rng.random(N_READS) < 0.02) & (mate >= 0)] ^= 1  # mate on the other contig
    ds = ds.with_batch(ds.batch.replace(flags=flags, mate_contig_idx=mate))
    ds.save(str(d / "in.sam"))
    ds.save(str(d / "in.adam"))
    return d


def _pair(path):
    from adam_tpu.io.context import load_alignments as jax_load

    from adam_tpu_torch.io.context import load_alignments

    return load_alignments(str(path)), jax_load(str(path))


def _as_dict(m):
    return dataclasses.asdict(m) if dataclasses.is_dataclass(m) else m


@pytest.mark.parametrize("name", ["in.sam", "in.adam", "raw.sam"])
def test_metrics_equal_jax_to_ints(inputs, name):
    from adam_tpu.ops.flagstat import flagstat as jax_flagstat

    ds, jds = _pair(inputs / name)
    got = ds.flagstat(device="cpu")
    want = jax_flagstat(jds.batch)
    for g, w in zip(got, want):
        gd = dataclasses.asdict(g)
        wd = {f.name: _as_dict(getattr(w, f.name)) for f in dataclasses.fields(w)}
        wd = {k: ({kk: int(vv) for kk, vv in v.items()} if isinstance(v, dict) else int(v))
              for k, v in wd.items()}
        assert gd == wd
    failed, passed = got
    assert failed.total + passed.total == N_READS
    if name != "raw.sam":
        assert failed.total > 0 and passed.duplicates_primary.total > 0
        assert passed.duplicates_secondary.total > 0 and passed.singleton > 0
        assert passed.with_mate_mapped_to_diff_chromosome_mapq5 > 0


def test_report_text_equals_jax(inputs):
    from adam_tpu.ops.flagstat import flagstat as jax_flagstat
    from adam_tpu.ops.flagstat import format_flagstat as jax_format

    from adam_tpu_torch.ops.flagstat import format_flagstat

    ds, jds = _pair(inputs / "in.sam")
    text = format_flagstat(*ds.flagstat(device="cpu"))
    assert text == jax_format(*jax_flagstat(jds.batch))
    assert len(text.splitlines()) == 18


def test_empty_batch_reports_zeros():
    from adam_tpu_torch.formats.batch import ReadBatch
    from adam_tpu_torch.ops.flagstat import flagstat, format_flagstat

    failed, passed = flagstat(ReadBatch.empty(4, 8, 2), device="cpu")
    assert failed.total == passed.total == 0
    assert "0 + 0 mapped (0.00%:0.00%)" in format_flagstat(failed, passed)


@pytest.mark.parametrize("name", ["in.sam", "in.adam"])
def test_cli_output_equals_jax(inputs, name):
    import json

    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    outs = {}
    for who, fn, extra in (("jax", jax_main, []), ("torch", main, ["--device", "cpu"])):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert fn(["flagstat", str(inputs / name), *extra]) == 0
        outs[who] = out.getvalue()
    assert outs["torch"] == outs["jax"]
    assert outs["torch"].endswith("\n") and "in total" in outs["torch"]
    assert json.loads(err.getvalue().strip().splitlines()[-1])["n_reads"] == N_READS


def test_flagstat_defaults_to_the_card(inputs):
    import inspect

    import torch

    from adam_tpu_torch.ops.flagstat import flagstat

    assert inspect.signature(flagstat).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        ds, _ = _pair(inputs / "in.sam")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            flagstat(ds.batch)
