"""FASTA and the contig-fragment store of the port (``io/fasta.py``,
``formats/fragments.py``, the fragment half of ``io/parquet.py``, the
FASTA and fragment-store branches of ``io/context.load_alignments``) and
``count_contig_kmers`` against the JAX package's, on the CPU, on FASTA
files generated from numpy seeds (descriptions, ``;`` comments, blank
lines, N runs, contigs shorter than a fragment): arrays element for
element, files byte for byte, k-mer tables entry for entry in the same
order, and the ``fasta2adam`` and ``count_contig_kmers`` verbs through
both command lines."""

import contextlib
import io
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

FRAG = 500


def _genome(seed, lengths, n_runs=3):
    """Contig sequences from a seed, each with ``n_runs`` runs of N."""
    rng = np.random.default_rng(seed)
    out = []
    for L in lengths:
        s = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L)].copy()
        for _ in range(n_runs if L > 50 else 0):
            at = int(rng.integers(0, L - 20))
            s[at: at + int(rng.integers(1, 20))] = ord("N")
        out.append(s.tobytes().decode())
    return out


def _fasta_text(seqs, width=60, descs=None):
    lines = ["; a comment line", ""]
    for i, s in enumerate(seqs):
        d = (descs or {}).get(i)
        lines.append(f">ctg{i}" + (f" {d}" if d else ""))
        lines += [s[j: j + width] for j in range(0, len(s), width)]
        if i == 1:
            lines += ["", "; between contigs"]
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fasta")
    seqs = _genome(11, [2345, 180, 1000, 37, 3001])
    (d / "g.fa").write_text(_fasta_text(seqs, descs={0: "chromosome one", 2: "x y z"}))
    (d / "g.fasta").write_text(_fasta_text(_genome(12, [999, 1501]), width=80))
    import gzip

    with gzip.open(d / "g.fa.gz", "wt") as fh:
        fh.write(_fasta_text(_genome(13, [1200, 40])))
    return d


def _assert_fragments_equal(got, want):
    g, w = got.to_numpy(), want.to_numpy()
    for name in ("bases", "lengths", "contig_idx", "start", "fragment_number",
                 "num_fragments", "valid"):
        a, b = np.asarray(getattr(g, name)), np.asarray(getattr(w, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _records(sd):
    return [(r.name, r.length, r.md5, r.url) for r in sd.records]


# ------------------------------------------------------------------ FASTA
@pytest.mark.parametrize("name", ["g.fa", "g.fasta", "g.fa.gz"])
@pytest.mark.parametrize("frag", [FRAG, 10_000])
def test_read_fasta_equals_jax(inputs, name, frag):
    from adam_tpu.io import fasta as jfa

    from adam_tpu_torch.io import fasta as tfa

    tf, tsd, tdesc = tfa.read_fasta(str(inputs / name), frag)
    jf, jsd, jdesc = jfa.read_fasta(str(inputs / name), frag)
    _assert_fragments_equal(tf, jf)
    assert _records(tsd) == _records(jsd) and tdesc == jdesc
    assert (np.asarray(tf.bases) == 4).any()  # N runs are base code 4


def test_parse_fasta_equals_jax():
    from adam_tpu.io import fasta as jfa

    from adam_tpu_torch.io import fasta as tfa

    for text in ("ACGT\n>a desc\nAC\n\nGT\n;c\n>b\n", ">x\n>y  two  words \nNNNA\n", ""):
        assert tfa.parse_fasta(text) == jfa.parse_fasta(text)


def test_write_fasta_equals_jax(inputs, tmp_path):
    from adam_tpu.io import fasta as jfa

    from adam_tpu_torch.io import fasta as tfa

    frags, sd, _ = tfa.read_fasta(str(inputs / "g.fa"), FRAG)
    jfrags, jsd, _ = jfa.read_fasta(str(inputs / "g.fa"), FRAG)
    for width in (60, 77):
        tfa.write_fasta(str(tmp_path / "t.fa"), frags, sd, width)
        jfa.write_fasta(str(tmp_path / "j.fa"), jfrags, jsd, width)
        assert (tmp_path / "t.fa").read_bytes() == (tmp_path / "j.fa").read_bytes()
    # a round trip gives back the sequences
    assert [s for _, _, s in tfa.parse_fasta((tmp_path / "t.fa").read_text())] == [
        s for _, _, s in tfa.parse_fasta((inputs / "g.fa").read_text())]


# -------------------------------------------------------------- fragments
def test_from_sequences_flank_and_records_equal_jax():
    from adam_tpu.formats import fragments as jfr

    from adam_tpu_torch.formats import fragments as tfr

    seqs = list(enumerate(_genome(21, [1234, 90, 777])))
    t = tfr.FragmentBatch.from_sequences(seqs, 100)
    j = jfr.FragmentBatch.from_sequences(seqs, 100)
    _assert_fragments_equal(t, j)
    # a subset with a coordinate gap, shuffled rows and an invalid row
    idx = np.random.default_rng(5).permutation(t.n_rows)[:-3]
    ts, js = t.take(idx), j.take(idx)
    ts = ts.replace(valid=np.asarray(ts.valid).copy())
    js = js.replace(valid=np.asarray(js.valid).copy())
    ts.valid[4] = js.valid[4] = False
    for flank in (0, 1, 4, 20, 150):
        _assert_fragments_equal(tfr.flank_fragments(ts, flank), jfr.flank_fragments(js, flank))
    for sub_t, sub_j in ((t, j), (ts, js)):
        assert tfr.to_read_records(sub_t, ["a", "b"]) == jfr.to_read_records(sub_j, ["a", "b"])


def test_extract_region_equals_jax():
    from adam_tpu.formats import fragments as jfr

    from adam_tpu_torch.formats import fragments as tfr

    seqs = list(enumerate(_genome(22, [1000, 333])))
    t = tfr.FragmentBatch.from_sequences(seqs, 128)
    j = jfr.FragmentBatch.from_sequences(seqs, 128)
    for c, s, e in ((0, 0, 1000), (0, 120, 400), (1, 5, 6), (1, 300, 333), (0, 127, 129)):
        assert t.extract_region(c, s, e) == j.extract_region(c, s, e) == seqs[c][1][s:e]
    gap_t, gap_j = t.take(np.array([0, 2, 3])), j.take(np.array([0, 2, 3]))
    for c, s, e in ((0, 100, 300), (0, 900, 1001), (5, 0, 1)):
        with pytest.raises(KeyError) as je:
            gap_j.extract_region(c, s, e)
        with pytest.raises(KeyError) as te:
            gap_t.extract_region(c, s, e)
        assert str(te.value) == str(je.value)


def test_fragment_batch_moves_to_a_device():
    import torch

    from adam_tpu_torch.formats.fragments import FragmentBatch

    b = FragmentBatch.from_sequences([(0, "ACGTN" * 30)], 64)
    on = b.to("cpu")
    assert all(isinstance(v, torch.Tensor) for v in on.arrays().values())
    back = on.to_numpy()
    for name, arr in b.arrays().items():
        np.testing.assert_array_equal(getattr(back, name), arr)
    assert on.take(np.array([2, 0])).n_rows == 2


# ------------------------------------------------------ the fragment store
@pytest.mark.parametrize("codec", ["zstd", "snappy"])
def test_save_fragments_byte_identical_and_loads_back(inputs, tmp_path, codec):
    from adam_tpu.io import fasta as jfa
    from adam_tpu.io import parquet as jpq

    from adam_tpu_torch.io import fasta as tfa
    from adam_tpu_torch.io import parquet as tpq

    tf, tsd, tdesc = tfa.read_fasta(str(inputs / "g.fa"), FRAG)
    jf, jsd, jdesc = jfa.read_fasta(str(inputs / "g.fa"), FRAG)
    tpq.save_fragments(str(tmp_path / "t.adam"), tf, tsd, tdesc, compression=codec)
    jpq.save_fragments(str(tmp_path / "j.adam"), jf, jsd, jdesc, compression=codec)
    assert (tmp_path / "t.adam").read_bytes() == (tmp_path / "j.adam").read_bytes()
    got = tpq.load_fragments(str(tmp_path / "j.adam"))
    want = jpq.load_fragments(str(tmp_path / "j.adam"))
    _assert_fragments_equal(got[0], want[0])
    assert _records(got[1]) == _records(want[1]) and got[2] == want[2] == {
        0: "chromosome one", 2: "x y z"}
    _assert_fragments_equal(got[0], tf)


@pytest.mark.parametrize("projection,filters", [
    (["contig", "fragmentSequence"], None),
    (["description"], [("fragmentNumber", ">=", 2)]),
    (None, [("contig", "==", "ctg4")]),
])
def test_load_fragments_projection_and_filters_equal_jax(inputs, tmp_path, projection,
                                                         filters):
    from adam_tpu.io import parquet as jpq

    from adam_tpu_torch.io import fasta as tfa
    from adam_tpu_torch.io import parquet as tpq

    path = str(tmp_path / "g.adam")
    tpq.save_fragments(path, *tfa.read_fasta(str(inputs / "g.fa"), FRAG))
    got = tpq.load_fragments(path, projection=projection, filters=filters)
    want = jpq.load_fragments(path, projection=projection, filters=filters)
    _assert_fragments_equal(got[0], want[0])
    assert _records(got[1]) == _records(want[1]) and got[2] == want[2]
    assert 0 < got[0].n_rows
    with pytest.raises(ValueError, match="unknown fragment projection"):
        tpq.load_fragments(path, projection=["fragmentSeq"])


def test_load_fragments_extends_a_stripped_dictionary(tmp_path):
    import pyarrow.parquet as pq

    from adam_tpu.io import parquet as jpq

    from adam_tpu_torch.formats.fragments import FragmentBatch
    from adam_tpu_torch.io import parquet as tpq
    from adam_tpu_torch.models.dictionaries import SequenceDictionary, SequenceRecord

    f = FragmentBatch.from_sequences([(0, "ACGT" * 40), (1, "GGA" * 9)], 50)
    sd = SequenceDictionary((SequenceRecord("a", 160), SequenceRecord("b", 27)))
    tpq.save_fragments(str(tmp_path / "f.adam"), f, sd)
    t = pq.read_table(str(tmp_path / "f.adam")).replace_schema_metadata(None)
    pq.write_table(t, str(tmp_path / "stripped.adam"))
    got = tpq.load_fragments(str(tmp_path / "stripped.adam"))
    want = jpq.load_fragments(str(tmp_path / "stripped.adam"))
    _assert_fragments_equal(got[0], want[0])
    assert _records(got[1]) == _records(want[1]) == [("a", 0, None, None),
                                                     ("b", 0, None, None)]


# -------------------------------------------------- loading as alignments
def _assert_datasets_equal(got, want):
    g, w = got.batch.to_numpy(), want.batch.to_numpy()
    for name, arr in g.arrays().items():
        np.testing.assert_array_equal(np.asarray(arr), np.asarray(getattr(w, name)),
                                      err_msg=name)
    assert list(got.sidecar.names) == list(want.sidecar.names)
    assert _records(got.header.seq_dict) == _records(want.header.seq_dict)


@pytest.mark.parametrize("name", ["g.fa", "g.fasta", "g.fa.gz"])
def test_load_alignments_on_a_fasta_equals_jax(inputs, name):
    from adam_tpu.io import context as jctx

    from adam_tpu_torch.io import context as tctx

    got = tctx.load_alignments(str(inputs / name))
    _assert_datasets_equal(got, jctx.load_alignments(str(inputs / name)))
    assert got.batch.n_valid() == len(got.header.seq_dict.names)  # one read a contig
    _assert_datasets_equal(tctx.load_fasta_reads(str(inputs / name), 100),
                           jctx.load_fasta_reads(str(inputs / name), 100))


def test_load_alignments_on_a_fragment_store_file_and_directory(inputs, tmp_path):
    """A store file is sniffed by its schema and loads as synthetic reads;
    a directory holding one is read as alignment parts, in both packages
    (the sniff reads the path's own schema)."""
    from adam_tpu.io import context as jctx

    from adam_tpu_torch.io import context as tctx
    from adam_tpu_torch.io import fasta as tfa
    from adam_tpu_torch.io import parquet as tpq

    path = tmp_path / "renamed.parquet"
    tpq.save_fragments(str(path), *tfa.read_fasta(str(inputs / "g.fa"), FRAG))
    got = tctx.load_alignments(str(path))
    _assert_datasets_equal(got, jctx.load_alignments(str(path)))
    _assert_datasets_equal(got, tctx.load_alignments(str(inputs / "g.fa")))
    d = tmp_path / "store.adam"
    d.mkdir()
    (d / "part-r-00000.parquet").write_bytes(path.read_bytes())
    as_parts = tctx.load_alignments(str(d))
    _assert_datasets_equal(as_parts, jctx.load_alignments(str(d)))
    # read as alignment columns: one row a fragment, none of them a read
    assert as_parts.batch.n_rows == tpq.load_fragments(str(path))[0].n_rows
    assert int(np.asarray(as_parts.batch.lengths).sum()) == 0


# ---------------------------------------------------------- contig k-mers
@pytest.mark.parametrize("k", [5, 21])
def test_count_contig_kmers_equals_jax(inputs, k):
    """Flanks across fragment joins: every window of every contig counted
    once, N windows distinct; the same table, in the same order."""
    from adam_tpu.formats import fragments as jfr
    from adam_tpu.io import fasta as jfa

    from adam_tpu_torch.formats import fragments as tfr
    from adam_tpu_torch.io import fasta as tfa

    tf, _, _ = tfa.read_fasta(str(inputs / "g.fa"), FRAG)
    jf, _, _ = jfa.read_fasta(str(inputs / "g.fa"), FRAG)
    got = tfr.count_contig_kmers(tf, k, device="cpu")
    want = jfr.count_contig_kmers(jf, k)
    assert list(got.items()) == list(want.items())
    seqs = [s for _, _, s in tfa.parse_fasta((inputs / "g.fa").read_text())]
    assert sum(got.values()) == sum(max(len(s) - k + 1, 0) for s in seqs)
    brute = {}
    for s in seqs:
        for i in range(len(s) - k + 1):
            brute[s[i: i + k]] = brute.get(s[i: i + k], 0) + 1
    assert got == brute and any("N" in m for m in got)


def test_count_contig_kmers_defaults_to_the_card():
    import inspect

    import torch

    from adam_tpu_torch.formats.fragments import FragmentBatch, count_contig_kmers

    assert inspect.signature(count_contig_kmers).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            count_contig_kmers(FragmentBatch.from_sequences([(0, "ACGT" * 9)], 10), 5)


# --------------------------------------------------------- the two CLIs
def _run_cli(main, argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("flags", [[], ["-fragment_length", "300", "-verbose"],
                                   ["-reads", "in.sam", "-parquet_compression_codec",
                                    "gzip"]])
def test_cli_fasta2adam_equals_jax(inputs, tmp_path, flags):
    from make_wgs_sam import make_wgs

    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    if "-reads" in flags:
        make_wgs(str(tmp_path / "in.sam"), 50, 100, n_contigs=5, contig_len=3_000)
        flags = [str(tmp_path / f) if f.endswith(".sam") else f for f in flags]
    outs = {}
    for who, fn, extra in (("jax", jax_main, []), ("torch", main, ["--device", "cpu"])):
        rc, stdout, _ = _run_cli(fn, ["fasta2adam", str(inputs / "g.fa"),
                                      str(tmp_path / f"{who}.adam"), *flags, *extra])
        assert rc == 0
        outs[who] = stdout
    assert outs["torch"] == outs["jax"]
    assert ("Loaded dictionary:" in outs["torch"]) == ("-verbose" in flags)
    assert (tmp_path / "torch.adam").read_bytes() == (tmp_path / "jax.adam").read_bytes()


@pytest.mark.parametrize("source", ["g.fa", "g.fa.gz", "store"])
def test_cli_count_contig_kmers_equals_jax(inputs, tmp_path, source):
    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    src = inputs / source
    if source == "store":
        src = tmp_path / "g.adam"
        rc, _, _ = _run_cli(main, ["fasta2adam", str(inputs / "g.fa"), str(src),
                                   "--device", "cpu"])
        assert rc == 0
    outs = {}
    for who, fn, extra in (("jax", jax_main, []), ("torch", main, ["--device", "cpu"])):
        rc, stdout, err = _run_cli(fn, ["count_contig_kmers", str(src),
                                        str(tmp_path / f"{who}.txt"), "11",
                                        "-printHistogram", *extra])
        assert rc == 0
        outs[who] = stdout
    assert outs["torch"] == outs["jax"] and outs["torch"].startswith("(")
    got = (tmp_path / "torch.txt").read_bytes()
    assert got == (tmp_path / "jax.txt").read_bytes() and got.count(b"\n") > 1000
    assert '"n_kmers": %d' % got.count(b"\n") in err
