"""The port's load dispatcher (``io/context.py``) and Parquet read path
against the JAX package's, on the CPU: ``load_alignments`` and
``load_header`` on a ``.sam``, a ``.sam.gz``, a ``.bam``, a directory of
two SAMs with different contigs and read groups (the header merge and
re-indexing), and a part directory the port wrote (whole, projected and
filtered), field by field with exact equality; the FASTQ and FASTA
inputs, once refused, load as JAX's.  ``iter_alignment_batches`` yields JAX's
windows, window for window: SAM and BAM windows, one window per part of a
part directory (projected too), a directory of SAMs that share one
dictionary streamed file by file with the read groups remapped, and the
resident fallback for divergent dictionaries."""

import dataclasses
import gzip
import pathlib
import shutil
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

CASES = ["sam", "sam_gz", "bam", "sam_dir", "sam_glob", "parts", "parts_projected",
         "parts_filtered", "part_file"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A WGS-shaped SAM, its gzip and its BAM (the port's writer); a
    directory of two SAMs, the second with a third contig and read
    groups of other names; the port's part directory of the first."""
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.io import sam as tsam
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    d = tmp_path_factory.mktemp("context")
    make_wgs(str(d / "in.sam"), 3000, 100, n_contigs=2, contig_len=30_000)
    with open(d / "in.sam", "rb") as src, gzip.open(d / "in.sam.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    tsam.write_bam(str(d / "in.bam"), *tsam.read_sam(str(d / "in.sam")))
    # two SAMs sharing the first's dictionary, the second with read
    # groups of other names
    (d / "shared").mkdir()
    shutil.copy(d / "in.sam", d / "shared" / "a.sam")
    (d / "shared" / "b.sam").write_text(
        (d / "in.sam").read_text().replace("rg1", "rgC"))
    (d / "dir").mkdir()
    shutil.copy(d / "in.sam", d / "dir" / "a.sam")
    make_wgs(str(d / "b.sam"), 1500, 100, seed=3, n_contigs=3, contig_len=30_000)
    text = (d / "b.sam").read_text()
    (d / "dir" / "b.sam").write_text(
        text.replace("rg1", "rgA").replace("rg2", "rgB").replace("lib", "libB"))
    transform_streamed(str(d / "in.sam"), str(d / "out.adam"), realign=False,
                       window_reads=1024, device="cpu")
    return d


def _args(d, case):
    """(path, keyword arguments) of a case."""
    if case in ("parts", "parts_projected", "parts_filtered"):
        kw = {"parts_projected": {"projection": ["sequence", "qual", "readName"]},
              "parts_filtered": {"predicate": [("flags", "<", 1024)]}}.get(case, {})
        return str(d / "out.adam"), kw
    if case == "part_file":
        return str(d / "out.adam" / "part-r-00001.parquet"), {}
    return {"sam": str(d / "in.sam"), "sam_gz": str(d / "in.sam.gz"),
            "bam": str(d / "in.bam"), "sam_dir": str(d / "dir"),
            "sam_glob": str(d / "dir" / "*.sam")}[case], {}


def _assert_same_batch(want, got):
    """Port (batch, sidecar, header) == JAX's, field by field."""
    jb, tb = want[0].to_numpy(), got[0]
    for f in dataclasses.fields(tb):
        a, b = np.asarray(getattr(jb, f.name)), np.asarray(getattr(tb, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    for f in ("names", "attrs", "md", "orig_quals"):
        assert getattr(want[1], f).to_list() == getattr(got[1], f).to_list(), f
    for f in ("trimmed_from_start", "trimmed_from_end"):
        np.testing.assert_array_equal(getattr(want[1], f), getattr(got[1], f))
    _assert_same_header(want[2], got[2])


def _assert_same_header(want, got):
    assert [dataclasses.astuple(r) for r in want.seq_dict] == \
        [dataclasses.astuple(r) for r in got.seq_dict]
    assert [dataclasses.astuple(g) for g in want.read_groups] == \
        [dataclasses.astuple(g) for g in got.read_groups]
    assert (want.hd_line, want.program_lines, want.comment_lines) == \
        (got.hd_line, got.program_lines, got.comment_lines)


@pytest.mark.parametrize("case", CASES)
def test_load_alignments_equals_jax(inputs, case):
    from adam_tpu.io import context as jctx

    from adam_tpu_torch.io import context as tctx

    path, kw = _args(inputs, case)
    want = jctx.load_alignments(path, **kw)
    got = tctx.load_alignments(path, **kw)
    jb = want.batch.to_numpy()
    for f in dataclasses.fields(got.batch):
        a, b = np.asarray(getattr(jb, f.name)), np.asarray(getattr(got.batch, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    for f in ("names", "attrs", "md", "orig_quals"):
        assert getattr(want.sidecar, f).to_list() == getattr(got.sidecar, f).to_list(), f
    for f in ("trimmed_from_start", "trimmed_from_end"):
        np.testing.assert_array_equal(getattr(want.sidecar, f), getattr(got.sidecar, f))
    _assert_same_header(want.header, got.header)
    n = got.batch.n_rows
    assert n == {"sam_dir": 4500, "sam_glob": 4500, "part_file": 1024}.get(case, n)
    if case in ("sam", "sam_gz", "bam", "parts", "parts_projected"):
        assert n == 3000
    if case == "parts_filtered":
        assert 0 < n < 3000  # the duplicates are filtered out
    if case == "sam_dir":
        assert got.header.read_groups.names == ["rg1", "rg2", "rgA", "rgB"]
        assert len(got.header.seq_dict) == 3
        assert set(np.unique(got.batch.read_group_idx[3000:])) == {2, 3}


@pytest.mark.parametrize("case", CASES[:6] + ["part_file"])
def test_load_header_equals_jax(inputs, case):
    from adam_tpu.io import context as jctx

    from adam_tpu_torch.io import context as tctx

    path, _ = _args(inputs, case)
    _assert_same_header(jctx.load_header(path), tctx.load_header(path))


def test_dataset_load_is_the_dispatcher(inputs):
    from adam_tpu_torch.api.datasets import AlignmentDataset
    from adam_tpu_torch.io import context as tctx

    got = AlignmentDataset.load(str(inputs / "in.bam"))
    want = tctx.load_alignments(str(inputs / "in.bam"))
    np.testing.assert_array_equal(got.batch.bases, want.batch.bases)
    assert got.sidecar.names == want.sidecar.names


def test_merge_refuses_a_conflicting_contig(tmp_path):
    from adam_tpu_torch.io import context as tctx

    for name, ln in (("a.sam", 100), ("b.sam", 200)):
        (tmp_path / name).write_text(f"@SQ\tSN:chr1\tLN:{ln}\n")
    with pytest.raises(ValueError, match="incompatible"):
        tctx.load_header(str(tmp_path))


@pytest.mark.parametrize("name", ["r.fq", "r.fastq", "r.fq.gz", "r.ifq", "g.fa",
                                  "g.fasta", "g.fa.gz"])
def test_unported_formats_raise(tmp_path, name):
    """The inputs this test once saw refused now load, through
    ``load_alignments`` and ``load_header``, as the JAX package loads
    them.  The one-record ``.ifq`` holds no first-of-pair (``/1``) record
    for the interleaved reader to start at, so it loads empty in both."""
    import gzip

    from adam_tpu.io import context as jctx

    from adam_tpu_torch.io import context as tctx

    path = tmp_path / name
    fasta = name.startswith("g.")
    text = ">c\nACGT\n" if fasta else "@r\nACGT\n+\nIIII\n"
    if name.endswith(".gz"):
        with gzip.open(path, "wt") as fh:
            fh.write(text)
    else:
        path.write_text(text)
    _assert_same_header(jctx.load_header(str(path)), tctx.load_header(str(path)))
    got, want = tctx.load_alignments(str(path)), jctx.load_alignments(str(path))
    _assert_same_batch((want.batch, want.sidecar, want.header),
                       (got.batch, got.sidecar, got.header))
    n = 0 if name == "r.ifq" else 1
    assert got.batch.n_valid() == n
    assert list(got.sidecar.names) == [("c" if fasta else "r")] * n


def test_contig_fragment_parquet_raises(tmp_path):
    """A file with ``fragmentSequence`` is sniffed as a contig-fragment
    store, in both packages; this one lacks the store's ``contig`` column,
    so both loaders raise the same error."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from adam_tpu.io import context as jctx

    from adam_tpu_torch.io import context as tctx

    path = str(tmp_path / "contigs.adam")
    pq.write_table(pa.table({"fragmentSequence": ["ACGT"], "contigName": ["c"]}), path)
    with pytest.raises(KeyError) as je:
        jctx.load_alignments(path)
    with pytest.raises(KeyError) as te:
        tctx.load_alignments(path)
    assert str(te.value) == str(je.value)


ITER_CASES = {
    # case: (path under the inputs, keyword arguments, windows expected)
    "sam": ("in.sam", {"batch_reads": 1024}, 3),
    "sam_gz": ("in.sam.gz", {"batch_reads": 1000}, 3),
    "bam": ("in.bam", {"batch_reads": 1024}, 1),
    "parts": ("out.adam", {}, 3),
    "parts_projected": ("out.adam", {"projection": ["contig", "start", "end", "flags"]}, 3),
    "part_file": ("out.adam/part-r-00001.parquet", {}, 1),
    "shared_dir": ("shared", {"batch_reads": 2048}, 4),
    "shared_glob": ("shared/*", {"batch_reads": 2048}, 4),
    "divergent_dir": ("dir", {}, 1),
}


@pytest.mark.parametrize("case", sorted(ITER_CASES))
def test_iter_alignment_batches_equals_jax(inputs, case):
    from adam_tpu.io import context as jctx

    from adam_tpu_torch.io import context as tctx

    rel, kw, n_windows = ITER_CASES[case]
    path = str(inputs / rel)
    want = list(jctx.iter_alignment_batches(path, **kw))
    got = list(tctx.iter_alignment_batches(path, **kw))
    assert len(got) == len(want) == n_windows
    for w, g in zip(want, got):
        _assert_same_batch(w, g)
    if case.startswith("shared"):
        # the second file's read groups land in the merged dictionary
        assert got[-1][2].read_groups.names == ["rg1", "rg2", "rgC"]
        assert set(np.unique(got[-1][0].read_group_idx)) <= {1, 2, -1}
    if case == "parts_projected":
        assert not any(got[0][1].names.to_list())
