"""FASTQ in and out of the port (``io/fastq.py``, the FASTQ loaders of
``io/context.py``, ``AlignmentDataset.save`` to ``.fq`` and
``save_paired_fastq``) against the JAX package's, on the CPU, on files
generated from numpy seeds: the parsed batches field for field, the
written files byte for byte (the native encoder of a plain path and the
Python formatter of a ``.gz`` path write the same text), the three
stringencies of the interleaved reader and of the paired writer with the
JAX messages, and ``transform`` FASTQ in and out (``-force_load_fastq``,
``-force_load_ifastq``, ``.ifq`` by extension, ``-sort_fastq_output``)
and ``adam2fastq`` through both command lines."""

import contextlib
import gzip
import io
import logging
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

N_READS = 1200


def _records(seed, n, pair_suffix=None, wrap=0):
    """FASTQ text of ``n`` random records (N bases included); ``wrap``
    splits sequence and quality lines every ``wrap`` characters."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(rng.integers(5, 60))
        seq = "".join("ACGTN"[c] for c in rng.choice(5, L, p=[.24, .24, .24, .24, .04]))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(2, 42, L))
        name = f"r{seed}_{i}" + (f"/{pair_suffix}" if pair_suffix else "")
        if wrap:
            seq = "\n".join(seq[j: j + wrap] for j in range(0, L, wrap))
            qual = "\n".join(qual[j: j + wrap] for j in range(0, L, wrap))
        out.append(f"@{name}\n{seq}\n+\n{qual}\n")
    return out


def _interleave(seed, n, mismatch=(), odd=False):
    """Interleaved pairs; pairs in ``mismatch`` get a second mate of
    another name; ``odd`` appends one unpaired record."""
    first = _records(seed, n, 1)
    second = _records(seed + 1000, n, 2)
    lines = []
    for i in range(n):
        mate = second[i].replace(f"@r{seed + 1000}_{i}/2", f"@r{seed}_{i}/2")
        if i in mismatch:
            mate = second[i]
        lines += [first[i], mate]
    if odd:
        lines += _records(seed + 2000, 1)
    return "".join(lines)


def _assert_same(got, want):
    """Port dataset == JAX dataset, field for field."""
    g, w = got.batch.to_numpy(), want.batch.to_numpy()
    for name, arr in g.arrays().items():
        np.testing.assert_array_equal(np.asarray(arr), np.asarray(getattr(w, name)),
                                      err_msg=name)
    for col in ("names", "attrs", "md", "orig_quals"):
        assert list(getattr(got.sidecar, col)) == list(getattr(want.sidecar, col)), col
    assert got.header.seq_dict.names == want.header.seq_dict.names


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Generated FASTQ files and a WGS-shaped SAM (paired reads, reverse
    strands, unmapped pairs)."""
    from make_wgs_sam import make_wgs

    d = tmp_path_factory.mktemp("fastq")
    # junk before the first record: a split that opens mid-record
    (d / "plain.fq").write_text("ACGT\n+\nIIII\n" + "".join(_records(1, 300)))
    (d / "wrapped.fastq").write_text("".join(_records(2, 200, wrap=17)))
    with gzip.open(d / "plain.fq.gz", "wt") as fh:
        fh.write("".join(_records(3, 150)))
    (d / "mate1.fq").write_text("".join(_records(4, 120, 1)))
    (d / "mate2.fq").write_text("".join(_records(4, 120, 2)))
    (d / "pairs.ifq").write_text("junk\n" + _interleave(5, 150))
    (d / "bad_pairs.ifq").write_text(_interleave(6, 40, mismatch=(3, 9), odd=True))
    make_wgs(str(d / "in.sam"), N_READS, 100, n_contigs=2, contig_len=30_000)
    return d


# ------------------------------------------------------------------ reading
@pytest.mark.parametrize("name,kw", [
    ("plain.fq", {}), ("wrapped.fastq", {}), ("plain.fq.gz", {}),
    ("mate1.fq", {"set_first_of_pair": True}), ("mate2.fq", {"set_second_of_pair": True}),
    ("plain.fq", {"round_rows_to": 64}),
])
def test_read_fastq_equals_jax(inputs, name, kw):
    from adam_tpu.io import context as jctx

    from adam_tpu_torch.io import context as tctx

    got, want = tctx.load_fastq(str(inputs / name), **kw), jctx.load_fastq(
        str(inputs / name), **kw)
    assert got.batch.n_valid() >= 120
    _assert_same(got, want)


def test_read_paired_and_interleaved_equal_jax(inputs):
    from adam_tpu.io import context as jctx

    from adam_tpu_torch.io import context as tctx

    _assert_same(tctx.load_paired_fastq(str(inputs / "mate1.fq"), str(inputs / "mate2.fq")),
                 jctx.load_paired_fastq(str(inputs / "mate1.fq"), str(inputs / "mate2.fq")))
    got = tctx.load_interleaved_fastq(str(inputs / "pairs.ifq"))
    _assert_same(got, jctx.load_interleaved_fastq(str(inputs / "pairs.ifq")))
    assert got.batch.n_valid() == 300
    for name in ("plain.fq", "pairs.ifq", "plain.fq.gz"):  # dispatch by extension
        _assert_same(tctx.load_alignments(str(inputs / name)),
                     jctx.load_alignments(str(inputs / name)))


def test_record_split_and_resync_equal_jax():
    from adam_tpu.io import fastq as jfq

    from adam_tpu_torch.io import fastq as tfq

    lines = ("xx\n+\n!!\n" + "".join(_records(7, 30, 1, wrap=9))).splitlines()
    for interleaved in (False, True):
        assert tfq.find_record_start(lines, interleaved) == jfq.find_record_start(
            lines, interleaved) > 0
        assert (list(tfq.split_fastq_records(lines, True, interleaved))
                == list(jfq.split_fastq_records(lines, True, interleaved)))
    for bad in (["@r", "ACGT"], ["@r", "ACGT", "@s"], ["@r", "ACGT", "+", "II"], ["r"]):
        with pytest.raises(ValueError) as je:
            list(jfq.split_fastq_records(bad))
        with pytest.raises(ValueError) as te:
            list(tfq.split_fastq_records(bad))
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("stringency", ["strict", "lenient", "silent", None])
def test_interleaved_stringency_equals_jax(inputs, caplog, stringency):
    """Mismatched pair names and an odd record: STRICT raises JAX's
    message, LENIENT warns it and keeps the pairs, SILENT keeps them
    quietly; the default (None) is the reader's "strict"."""
    from adam_tpu.io import context as jctx

    from adam_tpu_torch.io import context as tctx

    path = str(inputs / "bad_pairs.ifq")
    kw = {} if stringency is None else {"stringency": stringency}
    if stringency in ("strict", None):
        with pytest.raises(ValueError) as je:
            jctx.load_alignments(path, **kw)
        with pytest.raises(ValueError) as te:
            tctx.load_alignments(path, **kw)
        assert str(te.value) == str(je.value) and "odd number" in str(te.value)
        return
    msgs = {}
    for who, ctx in (("jax", jctx), ("torch", tctx)):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="adam_tpu.validation"):
            ds = ctx.load_alignments(path, **kw)
        msgs[who] = [r.getMessage() for r in caplog.records
                     if r.name == "adam_tpu.validation"]
        if who == "jax":
            want = ds
    _assert_same(ds, want)
    assert ds.batch.n_valid() == 80
    assert msgs["torch"] == msgs["jax"]
    assert len(msgs["torch"]) == (3 if stringency == "lenient" else 0)


# ------------------------------------------------------------------ writing
@pytest.mark.parametrize("add_suffix", [True, False])
def test_write_fastq_equals_jax_native_and_python(inputs, tmp_path, add_suffix):
    """Reverse-strand reads reverse-complemented, /1 /2 suffixes: the
    port's native encoder, its Python formatter (a .gz path) and JAX's
    writer give the same text."""
    from adam_tpu.io import context as jctx
    from adam_tpu.io import fastq as jfq

    from adam_tpu_torch.io import context as tctx
    from adam_tpu_torch.io import fastq as tfq

    src = str(inputs / "in.sam")
    t, j = tctx.load_alignments(src), jctx.load_alignments(src)
    tfq.write_fastq(str(tmp_path / "t.fq"), t.batch, t.sidecar, add_suffix)
    jfq.write_fastq(str(tmp_path / "j.fq"), j.batch, j.sidecar, add_suffix)
    tfq.write_fastq(str(tmp_path / "t.fq.gz"), t.batch, t.sidecar, add_suffix)
    want = (tmp_path / "j.fq").read_bytes()
    assert (tmp_path / "t.fq").read_bytes() == want
    assert gzip.decompress((tmp_path / "t.fq.gz").read_bytes()) == want
    assert want.count(b"\n") == 4 * N_READS
    assert (b"/1\n" in want) == add_suffix
    flags = np.asarray(t.batch.flags)
    assert ((flags & 0x10) != 0).sum() > 100  # reverse-strand reads were exported


def test_write_fastq_row_mask_and_predicate_equal_jax(inputs, tmp_path):
    from adam_tpu.io import context as jctx
    from adam_tpu.io import fastq as jfq

    from adam_tpu_torch.io import context as tctx
    from adam_tpu_torch.io import fastq as tfq

    src = str(inputs / "in.sam")
    t, j = tctx.load_alignments(src), jctx.load_alignments(src)
    mask = np.random.default_rng(3).random(t.batch.n_rows) < 0.5
    kw = dict(row_mask=mask, predicate=lambda f: bool(f & 0x40))
    tfq.write_fastq(str(tmp_path / "t.fq"), t.batch, t.sidecar, **kw)
    jfq.write_fastq(str(tmp_path / "j.fq"), j.batch, j.sidecar, **kw)
    assert (tmp_path / "t.fq").read_bytes() == (tmp_path / "j.fq").read_bytes()


def test_save_fastq_by_extension_equals_jax(inputs, tmp_path):
    from adam_tpu.io import context as jctx

    from adam_tpu_torch.io import context as tctx

    src = str(inputs / "in.sam")
    tctx.load_alignments(src).save(str(tmp_path / "t.fastq"))
    jctx.load_alignments(src).save(str(tmp_path / "j.fastq"))
    assert (tmp_path / "t.fastq").read_bytes() == (tmp_path / "j.fastq").read_bytes()


def _broken_pairs(ds, both_row=None):
    """Drop every 7th row (its mate loses its pair) and optionally set
    both mate flags on one row."""
    keep = np.flatnonzero(np.arange(ds.batch.n_rows) % 7 != 3)
    out = ds.take_rows(keep)
    if both_row is not None:
        flags = np.asarray(out.batch.flags).copy()
        flags[both_row] |= 0xC0
        out = out.with_batch(out.batch.replace(flags=flags))
    return out


@pytest.mark.parametrize("stringency", ["strict", "lenient", "silent", "default"])
def test_paired_write_stringency_equals_jax(inputs, tmp_path, caplog, stringency):
    """``save_paired_fastq``: STRICT raises JAX's "don't occur exactly
    twice" report, LENIENT logs it and writes the proper pairs, SILENT
    writes them quietly; the default is LENIENT."""
    from adam_tpu.io import context as jctx

    from adam_tpu_torch.io import context as tctx

    src = str(inputs / "in.sam")
    dss = {"torch": _broken_pairs(tctx.load_alignments(src), both_row=10),
           "jax": _broken_pairs(jctx.load_alignments(src), both_row=10)}
    kw = {} if stringency == "default" else {"stringency": stringency}
    if stringency == "strict":
        errs = {}
        for who, ds in dss.items():
            with pytest.raises(ValueError) as e:
                ds.save_paired_fastq(str(tmp_path / f"{who}1.fq"),
                                     str(tmp_path / f"{who}2.fq"), **kw)
            errs[who] = str(e.value)
        assert errs["torch"] == errs["jax"]
        assert "don't occur exactly twice" in errs["torch"]
        assert not list(tmp_path.iterdir())
        return
    msgs = {}
    for who, ds in dss.items():
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="adam_tpu.validation"):
            ds.save_paired_fastq(str(tmp_path / f"{who}1.fq"), str(tmp_path / f"{who}2.fq"),
                                 **kw)
        msgs[who] = [r.getMessage() for r in caplog.records
                     if r.name == "adam_tpu.validation"]
    assert msgs["torch"] == msgs["jax"]
    assert len(msgs["torch"]) == (0 if stringency == "silent" else 2)
    for k in ("1", "2"):
        got = (tmp_path / f"torch{k}.fq").read_bytes()
        assert got == (tmp_path / f"jax{k}.fq").read_bytes()
        assert got.count(b"\n") > 4 * N_READS // 3


def test_fastq_round_trip_pairs(inputs, tmp_path):
    """Mate files written by the port load back (paired and interleaved)
    as the same pairs the JAX loaders give."""
    from adam_tpu.io import context as jctx

    from adam_tpu_torch.io import context as tctx

    ds = tctx.load_alignments(str(inputs / "in.sam"))
    ds.save_paired_fastq(str(tmp_path / "a.fq"), str(tmp_path / "b.fq"))
    got = tctx.load_paired_fastq(str(tmp_path / "a.fq"), str(tmp_path / "b.fq"))
    _assert_same(got, jctx.load_paired_fastq(str(tmp_path / "a.fq"), str(tmp_path / "b.fq")))
    assert got.batch.n_valid() == N_READS


# ----------------------------------------------------------- the two CLIs
def _run_cli(main, argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


TRANSFORM_CASES = {
    "fq_in.adam": ("plain.fq", ["-force_load_fastq"]),
    "ifq_in.adam": ("bad_pairs.ifq", ["-force_load_ifastq"]),
    "ifq_ext.sam": ("pairs.ifq", ["-stringency", "silent"]),
    "ifq_silent.adam": ("bad_pairs.ifq", ["-force_load_ifastq", "-stringency", "silent"]),
    "sam_out.fq": ("in.sam", ["-mark_duplicate_reads"]),
    "sorted_out.fq": ("in.sam", ["-mark_duplicate_reads", "-sort_fastq_output"]),
    "fq_to_sorted.fastq": ("wrapped.fastq", ["-sort_fastq_output"]),
}


@pytest.mark.parametrize("case", list(TRANSFORM_CASES))
def test_cli_transform_fastq_equals_jax(inputs, tmp_path, case):
    """``transform`` with FASTQ in or out: the output byte-identical to
    the JAX CLI's with the same flags."""
    import json

    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    src, flags = TRANSFORM_CASES[case]
    ext = case[case.index("."):]
    outs = {}
    for who, fn, extra in (("jax", jax_main, []), ("torch", main, ["--device", "cpu"])):
        outs[who] = tmp_path / f"{who}{ext}"
        rc, stdout, _ = _run_cli(fn, ["transform", str(inputs / src), str(outs[who]),
                                      *flags, *extra])
        assert rc == 0, who
    stats = json.loads(stdout.strip().splitlines()[-1])
    assert outs["torch"].read_bytes() == outs["jax"].read_bytes()
    assert stats["n_reads"] >= 80
    if "-sort_fastq_output" in flags:
        names = outs["torch"].read_text().splitlines()[::4]
        assert names == sorted(names) and len(names) == stats["n_rows_out"]


def test_cli_transform_strict_ifastq_fails_as_jax(inputs, tmp_path):
    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    errs = {}
    for who, fn, extra in (("jax", jax_main, []), ("torch", main, ["--device", "cpu"])):
        argv = ["transform", str(inputs / "bad_pairs.ifq"), str(tmp_path / f"{who}.adam"),
                "-force_load_ifastq", "-stringency", "strict", *extra]
        with pytest.raises(ValueError) as e:
            _run_cli(fn, argv)
        errs[who] = str(e.value)
    assert errs["torch"] == errs["jax"]
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("form", ["single", "paired", "paired_strict", "adam", "adam_noproj"])
def test_cli_adam2fastq_equals_jax(inputs, tmp_path, form):
    """``adam2fastq`` on a SAM and on a Parquet file (projected, and with
    ``-no-projection``), single and split into mate files."""
    from adam_tpu.cli.main import main as jax_main
    from adam_tpu.io import context as jctx

    from adam_tpu_torch.cli.main import main

    src = inputs / "in.sam"
    if form.startswith("adam"):
        src = tmp_path / "in.adam"
        jctx.load_alignments(str(inputs / "in.sam")).save(str(src))
    flags = {"paired_strict": ["-stringency", "strict"],
             "adam_noproj": ["-no-projection"]}.get(form, [])
    two = form.startswith("paired")
    for who, fn, extra in (("jax", jax_main, []), ("torch", main, ["--device", "cpu"])):
        argv = ["adam2fastq", str(src), str(tmp_path / f"{who}1.fq")]
        argv += [str(tmp_path / f"{who}2.fq")] if two else []
        rc, stdout, err = _run_cli(fn, argv + flags + extra)
        assert rc == 0 and stdout == ""
    for k in ("1", "2") if two else ("1",):
        got = (tmp_path / f"torch{k}.fq").read_bytes()
        assert got == (tmp_path / f"jax{k}.fq").read_bytes()
        assert got.count(b"\n") == 4 * N_READS // (2 if two else 1)
    assert '"n_reads": %d' % N_READS in err


def test_cli_verbs_default_to_the_card(inputs, tmp_path):
    import torch

    from adam_tpu_torch.cli.main import main

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for argv in (["adam2fastq", str(inputs / "in.sam"), str(tmp_path / "o.fq")],
                 ["transform", str(inputs / "plain.fq"), str(tmp_path / "o.adam"),
                  "-force_load_fastq"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    assert not list(tmp_path.iterdir())
