"""Features of the port (``formats/features.py``, ``io/features.py``, the
feature store of ``io/parquet.py``, ``models/genes.py``,
``api/datasets.FeatureDataset``) against the JAX package's, on the CPU,
on GTF, GFF3, BED and narrowPeak files generated from numpy seeds: the
parsed columns and sidecars, ``write_bed`` and the feature store byte
for byte, the gene models, the region filter and the join intervals,
``wigfix2bed`` (scientific notation, a malformed line, stdin and stdout)
and ``features2adam`` through both command lines.  BED and narrowPeak
rows take random UUIDs as ids in both packages, so those tests draw the
UUIDs from one seeded sequence."""

import contextlib
import io
import uuid

import numpy as np
import pytest


def _gtf(seed, n_genes, n_tx=2, n_exons=3):
    """GTF text: genes with transcripts, exons (some without exon_id,
    which fall back to transcriptId_exonNumber), CDS and UTR blocks on
    both strands, a GFF3-style mRNA block, comments and a blank line."""
    rng = np.random.default_rng(seed)
    out = ["#!genome-build test", ""]
    for g in range(n_genes):
        chrom = f"chr{1 + g % 3}"
        strand = "+-."[int(rng.integers(0, 3))]
        start = int(rng.integers(1, 50_000))
        gid = f"G{seed}_{g}"
        score = "." if g % 2 else f"{rng.random() * 100:.3f}"
        end = start + 1000 * n_tx * n_exons
        out.append(f'{chrom}\tsrc\tgene\t{start}\t{end}\t{score}\t{strand}\t.\t'
                   f'gene_id "{gid}"; gene_name "N{g}";')
        for t in range(n_tx):
            tid = f"{gid}.t{t}"
            out.append(f'{chrom}\tsrc\ttranscript\t{start}\t{end}\t.\t{strand}\t.\t'
                       f'gene_id "{gid}"; transcript_id "{tid}";')
            for e in range(n_exons):
                s = start + 1000 * (t * n_exons + e)
                eid = f' exon_id "{tid}.e{e}";' if e % 2 == 0 else ""
                out.append(f'{chrom}\tsrc\texon\t{s}\t{s + 400}\t.\t{strand}\t.\t'
                           f'gene_id "{gid}"; transcript_id "{tid}"; exon_number "{e + 1}";'
                           + eid)
                ftype = "CDS" if e else "UTR"
                out.append(f'{chrom}\tsrc\t{ftype}\t{s + 10}\t{s + 300}\t.\t{strand}\t0\t'
                           f'gene_id "{gid}"; transcript_id "{tid}";')
    out += ["chr9\tgff\tgene\t100\t900\t.\t+\t.\tID=gff1",
            "chr9\tgff\tmRNA\t100\t900\t.\t+\t.\tID=gtx1;Parent=gff1",
            "chr9\tgff\texon\t100\t200\t.\t+\t.\tID=gex1;Parent=gtx1",
            "chr9\tgff\texon\t300\t900\t.\t+\t.\tID=gex2;Parent=gtx1",
            "chr9\tgff\tregion\t1\t1000\t.\t.\t.\tID=r1"]
    return "\n".join(out) + "\n"


def _bed(seed, n, narrow=False):
    rng = np.random.default_rng(seed)
    out = ["track name=t", "browser position chr1", "# comment"]
    for i in range(n):
        s = int(rng.integers(0, 10_000))
        cols = [f"chr{1 + i % 2}", str(s), str(s + int(rng.integers(1, 500)))]
        width = 10 if narrow else int(rng.integers(3, 13))
        extra = [f"peak{i}", "." if i % 4 == 0 else str(int(rng.integers(0, 1000))),
                 "+-."[i % 3]]
        extra += ([f"{rng.random():.4f}", "-1", f"{rng.random() * 9:.2f}", "17"] if narrow
                  else [str(s), str(s + 1), "255,0,0", "1", "50,", "0,"])
        out.append("\t".join(cols + extra[: width - 3]))
    return "\n".join(out) + "\n"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("features")
    (d / "a.gtf").write_text(_gtf(1, 40))
    (d / "b.gff3").write_text(_gtf(2, 5, n_tx=1))
    (d / "p.bed").write_text(_bed(3, 120))
    (d / "p.narrowPeak").write_text(_bed(4, 80, narrow=True))
    import gzip

    with gzip.open(d / "a.gtf.gz", "wt") as fh:
        fh.write(_gtf(5, 10))
    return d


@pytest.fixture
def seeded_uuid(monkeypatch):
    """uuid.uuid4 from a counter; ``reset()`` starts the sequence over."""
    state = {"n": 0}

    def fake():
        state["n"] += 1
        return uuid.UUID(int=state["n"])

    monkeypatch.setattr(uuid, "uuid4", fake)
    return lambda: state.update(n=0)


def _assert_feats_equal(got, want):
    for name in ("contig_idx", "start", "end", "strand", "score"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.contig_names == want.contig_names
    for col in ("feature_id", "feature_type", "source", "parent_ids", "attributes"):
        assert getattr(got.sidecar, col) == getattr(want.sidecar, col), col


@pytest.mark.parametrize("name", ["a.gtf", "b.gff3", "a.gtf.gz", "p.bed", "p.narrowPeak"])
def test_read_features_equals_jax(inputs, seeded_uuid, name):
    from adam_tpu.io import features as jfi

    from adam_tpu_torch.io import features as tfi

    seeded_uuid()
    got = tfi.read_features(str(inputs / name))
    seeded_uuid()
    want = jfi.read_features(str(inputs / name))
    _assert_feats_equal(got, want)
    assert len(got) > 40 and np.isnan(got.score).any()


def test_read_features_format_argument_and_unknown_extension(inputs, tmp_path):
    from adam_tpu.io import features as jfi

    from adam_tpu_torch.io import features as tfi

    (tmp_path / "x.txt").write_text((inputs / "a.gtf").read_text())
    _assert_feats_equal(tfi.read_features(str(tmp_path / "x.txt"), "gtf"),
                        jfi.read_features(str(tmp_path / "x.txt"), "GTF"))
    with pytest.raises(ValueError) as je:
        jfi.read_features(str(tmp_path / "x.txt"))
    with pytest.raises(ValueError) as te:
        tfi.read_features(str(tmp_path / "x.txt"))
    assert str(te.value) == str(je.value) and "cannot infer" in str(te.value)


@pytest.mark.parametrize("name", ["a.gtf", "p.bed"])
def test_write_bed_equals_jax(inputs, tmp_path, seeded_uuid, name):
    from adam_tpu.api.datasets import FeatureDataset as JF

    from adam_tpu_torch.api.datasets import FeatureDataset as TF

    seeded_uuid()
    TF.load(str(inputs / name)).save(str(tmp_path / "t.bed"))
    seeded_uuid()
    JF.load(str(inputs / name)).save(str(tmp_path / "j.bed"))
    assert (tmp_path / "t.bed").read_bytes() == (tmp_path / "j.bed").read_bytes()


@pytest.mark.parametrize("name", ["a.gtf", "p.narrowPeak"])
@pytest.mark.parametrize("codec", ["zstd", "gzip"])
def test_save_features_byte_identical(inputs, tmp_path, seeded_uuid, name, codec):
    from adam_tpu.io import features as jfi
    from adam_tpu.io import parquet as jpq

    from adam_tpu_torch.io import features as tfi
    from adam_tpu_torch.io import parquet as tpq

    seeded_uuid()
    tpq.save_features(str(tmp_path / "t.adam"), tfi.read_features(str(inputs / name)),
                      compression=codec)
    seeded_uuid()
    jpq.save_features(str(tmp_path / "j.adam"), jfi.read_features(str(inputs / name)),
                      compression=codec)
    assert (tmp_path / "t.adam").read_bytes() == (tmp_path / "j.adam").read_bytes()


@pytest.mark.parametrize("projection,filters", [
    (None, None),
    (["featureType", "parentIds"], None),
    (["score", "strand"], [("featureType", "==", "exon")]),
    (None, [("start", ">", 20_000)]),
])
def test_load_features_equals_jax(inputs, tmp_path, projection, filters):
    from adam_tpu.io import parquet as jpq

    from adam_tpu_torch.io import features as tfi
    from adam_tpu_torch.io import parquet as tpq

    path = str(tmp_path / "f.adam")
    tpq.save_features(path, tfi.read_features(str(inputs / "a.gtf")))
    got = tpq.load_features(path, projection=projection, filters=filters)
    _assert_feats_equal(got, jpq.load_features(path, projection=projection,
                                               filters=filters))
    assert len(got) > 10
    with pytest.raises(ValueError, match="unknown feature projection"):
        tpq.load_features(path, projection=["featureID"])


def _gene_tuple(g):
    reg = lambda r: (r.referenceName, r.start, r.end)  # noqa: E731
    return (g.id, g.names, g.strand, [reg(r) for r in g.regions], [
        (t.id, t.names, t.gene_id, t.strand, reg(t.region),
         [(e.id, e.transcript_id, e.strand, reg(e.region)) for e in t.exons],
         [(c.transcript_id, c.strand, reg(c.region)) for c in t.cds],
         [(u.transcript_id, u.strand, reg(u.region)) for u in t.utrs])
        for t in g.transcripts])


@pytest.mark.parametrize("name", ["a.gtf", "b.gff3"])
def test_as_genes_equals_jax(inputs, name):
    from adam_tpu.api.datasets import FeatureDataset as JF

    from adam_tpu_torch.api.datasets import FeatureDataset as TF

    got = TF.load(str(inputs / name)).as_genes()
    want = JF.load(str(inputs / name)).as_genes()
    assert [_gene_tuple(g) for g in got] == [_gene_tuple(g) for g in want]
    assert sum(len(g.transcripts) for g in got) >= len(got) > 4
    ref = "".join(np.random.default_rng(0).choice(list("ACGT"), 70_000))
    for tg, jg in zip(got, want):
        for tt, jt in zip(tg.transcripts, jg.transcripts):
            assert tt.extract_spliced_mrna_sequence(ref) == jt.extract_spliced_mrna_sequence(ref)
            assert tt.extract_coding_sequence(ref) == jt.extract_coding_sequence(ref)
            assert (tt.extract_transcribed_rna_sequence(ref)
                    == jt.extract_transcribed_rna_sequence(ref))


def test_filter_and_intervals_equal_jax(inputs):
    from adam_tpu.api.datasets import FeatureDataset as JF

    from adam_tpu_torch.api.datasets import FeatureDataset as TF

    t, j = TF.load(str(inputs / "a.gtf")), JF.load(str(inputs / "a.gtf"))
    for region in (("chr1", 5_000, 30_000), ("chr2", 0, 10**9), ("chrZ", 0, 10)):
        _assert_feats_equal(t.filter_by_overlapping_region(*region).batch,
                            j.filter_by_overlapping_region(*region).batch)
    for names in (None, ["chr2", "chr1", "chrX"]):
        got, want = t.intervals(names, device="cpu"), j.intervals(names)
        for col in ("contig", "start", "end"):
            np.testing.assert_array_equal(getattr(got, col).numpy(), getattr(want, col))


# ------------------------------------------------------------------ wigFix
WIG = ["track type=wiggle_0", "fixedStep chrom=chr1 start=10 step=5 span=3", "1.5",
       "2e-3", "", "0", "fixedStep chrom=chr2 start=1 step=1", "7", "-4.25E+2",
       "fixedStep chrom=chr3 start=100 step=10 span=2 extra", "8"]


def test_wigfix_lines_equal_jax():
    from adam_tpu.io.features import wigfix_to_bed_lines as jw

    from adam_tpu_torch.io.features import wigfix_to_bed_lines as tw

    got = list(tw(WIG))
    assert got == list(jw(WIG)) and len(got) == 6
    # the JAX package's own cases: scientific notation keeps the cursor,
    # a malformed data line raises
    rows = list(tw(["fixedStep chrom=chr1 start=10 step=1", "1e-5", "0.5"]))
    assert [r.split("\t")[:3] for r in rows] == [["chr1", "9", "10"], ["chr1", "10", "11"]]
    assert rows[0].split("\t")[4] == "1e-5"
    for bad in (["fixedStep chrom=chr1 start=10 step=1", "."], ["x y"]):
        with pytest.raises(ValueError):
            list(jw(bad))
        with pytest.raises(ValueError):
            list(tw(bad))


def _run_cli(main, argv, stdin=None) -> tuple:
    import sys

    out, err = io.StringIO(), io.StringIO()
    old = sys.stdin
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        sys.stdin = old
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("form", ["file_to_file", "stdin_to_stdout"])
def test_cli_wigfix2bed_equals_jax(tmp_path, form):
    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    text = "\n".join(WIG) + "\n"
    (tmp_path / "in.wig").write_text(text)
    outs = {}
    for who, fn, extra in (("jax", jax_main, []), ("torch", main, ["--device", "cpu"])):
        if form == "file_to_file":
            argv = ["wigfix2bed", str(tmp_path / "in.wig"), "-o", str(tmp_path / f"{who}.bed")]
            rc, stdout, _ = _run_cli(fn, argv + extra)
            outs[who] = (tmp_path / f"{who}.bed").read_text()
            assert stdout == ""
        else:
            rc, outs[who], _ = _run_cli(fn, ["wigfix2bed", *extra], stdin=text)
        assert rc == 0
    assert outs["torch"] == outs["jax"] and outs["torch"].count("\n") == 6


def test_cli_wigfix2bed_malformed_fails_as_jax(tmp_path):
    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    (tmp_path / "bad.wig").write_text("fixedStep chrom=chr1 start=1 step=1\n1\nnan?\n")
    errs = {}
    for who, fn, extra in (("jax", jax_main, []), ("torch", main, ["--device", "cpu"])):
        with pytest.raises(ValueError) as e:
            _run_cli(fn, ["wigfix2bed", str(tmp_path / "bad.wig"), *extra])
        errs[who] = str(e.value)
    assert errs["torch"] == errs["jax"]


@pytest.mark.parametrize("name", ["a.gtf", "p.bed", "p.narrowPeak"])
def test_cli_features2adam_equals_jax(inputs, tmp_path, seeded_uuid, name):
    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    for who, fn, extra in (("jax", jax_main, []), ("torch", main, ["--device", "cpu"])):
        seeded_uuid()
        rc, stdout, _ = _run_cli(fn, ["features2adam", str(inputs / name),
                                      str(tmp_path / f"{who}.adam"),
                                      "-parquet_compression_codec", "snappy", *extra])
        assert rc == 0 and stdout == ""
    assert (tmp_path / "torch.adam").read_bytes() == (tmp_path / "jax.adam").read_bytes()


def test_conversion_verbs_default_to_the_card(inputs, tmp_path):
    import torch

    from adam_tpu_torch.cli.main import main

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for argv in (["features2adam", str(inputs / "a.gtf"), str(tmp_path / "o.adam")],
                 ["wigfix2bed", str(inputs / "a.gtf")]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    assert not list(tmp_path.iterdir())
