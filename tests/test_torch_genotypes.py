"""Genotypes, variants and the conversion verbs around them in the port
(``formats/annotations.py``, the rest of ``formats/variants.py``, the
genotype store of ``io/parquet.py``, ``io/vcf.write_vcf``,
``api/datasets.GenotypeDataset``; ``vcf2adam``, ``anno2adam``,
``adam2vcf`` and ``bam2adam``) against the JAX package's, on the CPU, on
VCFs generated from a numpy seed (multi-allelic sites, gVCF ``<NON_REF>``
rows, typed and untyped INFO keys, filters, phased and missing calls)
and on a generated SAM and its BAM: the stores and the written files
byte for byte, the loaded batches field for field."""

import contextlib
import io
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

SAMPLES = ("NA12878", "NA12891", "NA12892")


def _vcf_text(seed, n_sites, samples=SAMPLES, contigs=("chr1", "chr2", "chrM"),
              shuffled=True, canonical=False):
    """A VCF 4.1 text from a seed: SNPs, indels, multi-allelic and gVCF
    reference-model sites, typed INFO keys (ints, floats with many digits,
    flags, strings, '.' values) beside unknown ones, PASS / filtered /
    unfiltered sites, QUAL '.', phased, missing and haploid calls, FT.

    ``canonical`` keeps to what a VCF -> store -> VCF round trip returns
    as it was: bi-allelic sites only, shortest float digits, FT on every
    call."""
    rng = np.random.default_rng(seed)
    out = ["##fileformat=VCFv4.1"]
    out += [f"##contig=<ID={c},length={100_000 * (i + 1)}>" for i, c in enumerate(contigs)]
    out.append("\t".join(["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]
                         + (["FORMAT", *samples] if samples else [])))
    pos = {c: 100 for c in contigs}
    rows = []
    for i in range(n_sites):
        c = contigs[int(rng.integers(0, len(contigs)))]
        pos[c] += int(rng.integers(1, 400))
        ref = "".join(rng.choice(list("ACGT"), int(rng.integers(1, 4))))
        kind = rng.random()
        if canonical:
            alts = ["".join(rng.choice(list("ACGT"), int(rng.integers(1, 4))))]
        elif kind < 0.08:
            alts = ["<NON_REF>"]
        elif kind < 0.2:
            alts = ["".join(rng.choice(list("ACGT"), int(rng.integers(1, 5)))) for _ in range(2)]
        else:
            alts = ["".join(rng.choice(list("ACGT"), int(rng.integers(1, 4))))]
        qual = "." if i % 11 == 0 else f"{rng.random() * 500:.2f}"
        filt = ["PASS", ".", "LowQual", "LowQual;q10"][i % 4]
        mq, vqslod = rng.random() * 60, rng.normal() * 1000
        if canonical:
            mq, vqslod = repr(round(mq, 5)), repr(round(vqslod, 4))
        else:
            mq, vqslod = f"{mq:.6f}", f"{vqslod:.7f}"
        info = [f"DP={int(rng.integers(1, 900))}", f"MQ={mq}", f"AC={int(rng.integers(0, 6))}"]
        if i % 3 == 0:
            info += [f"VQSLOD={vqslod}", "culprit=MQ"]
        if i % 5 == 0:
            info += ["NEGATIVE_TRAIN_SITE", "QD=."]
        if alts == ["<NON_REF>"]:
            info.append(f"END={pos[c] + 50}")
        vid = "." if i % 2 else f"rs{1000 + i}"
        cols = [c, str(pos[c]), vid, ref, ",".join(alts), qual, filt, ";".join(info)]
        if samples:
            with_ft = canonical or i % 7 == 0
            cols.append("GT:AD:DP:GQ:PL" + (":FT" if with_ft else ""))
            n_al = len(alts) + 1
            n_pl = n_al * (n_al + 1) // 2
            for s in range(len(samples)):
                a, b = rng.integers(0, n_al, 2)
                sep = "|" if rng.random() < 0.3 else "/"
                gt = "./." if rng.random() < 0.05 else f"{a}{sep}{b}"
                if rng.random() < 0.03:
                    gt = str(a)
                ad = ",".join(str(int(x)) for x in rng.integers(0, 40, n_al))
                pl = ",".join(str(int(x)) for x in rng.integers(0, 300, n_pl))
                f = [gt, ad, str(int(rng.integers(0, 99))), str(int(rng.integers(0, 99))), pl]
                if with_ft:
                    f.append("PASS" if s else "lowGQ")
                cols.append(":".join(f))
        rows.append("\t".join(cols))
    if shuffled:
        rows = [rows[k] for k in rng.permutation(len(rows))]
    return "\n".join(out + rows) + "\n"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.io import sam as sam_io

    d = tmp_path_factory.mktemp("genotypes")
    (d / "calls.vcf").write_text(_vcf_text(1, 400))
    (d / "canonical.vcf").write_text(_vcf_text(4, 300, canonical=True))
    (d / "sites.vcf").write_text(_vcf_text(2, 150, samples=()))
    # an annotation update: half the sites of calls.vcf again, re-annotated,
    # plus new ones on a new contig
    old = (d / "calls.vcf").read_text().splitlines()
    body = [ln for ln in old if not ln.startswith("#")][::2]
    upd = [ln.replace("DP=", "DP=1") for ln in body]
    new = [ln for ln in _vcf_text(3, 40, samples=(), contigs=("chrX",)).splitlines()
           if not ln.startswith("#")]
    header = ["##fileformat=VCFv4.1", "##contig=<ID=chrX,length=5000>",
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    (d / "update.vcf").write_text(
        "\n".join(header + ["\t".join(ln.split("\t")[:8]) for ln in upd] + new) + "\n")
    make_wgs(str(d / "in.sam"), 1500, 100, n_contigs=2, contig_len=30_000)
    sam_io.write_bam(str(d / "in.bam"), *sam_io.read_sam(str(d / "in.sam")))
    return d


def _assert_variants_equal(got, want):
    gv, wv = got[0], want[0]
    for name in ("contig_idx", "start", "end", "ref_len", "alt_len", "qual",
                 "filters_applied", "passing"):
        a, b = np.asarray(getattr(gv, name)), np.asarray(getattr(wv, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for col in ("ref_allele", "alt_allele", "names", "filters", "info"):
        assert getattr(gv.sidecar, col) == getattr(wv.sidecar, col), col
    gg, wg = got[1], want[1]
    for name in ("variant_idx", "sample_idx", "alleles", "gq", "dp", "ref_depth",
                 "alt_depth", "phased", "pl", "nonref_pl", "split_from_multiallelic"):
        a, b = np.asarray(getattr(gg, name)), np.asarray(getattr(wg, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert gg.samples == wg.samples and gg.genotype_filters == wg.genotype_filters
    assert ([(r.name, r.length, r.md5, r.url) for r in got[2].records]
            == [(r.name, r.length, r.md5, r.url) for r in want[2].records])


def _both(path, **kw):
    from adam_tpu.api.datasets import GenotypeDataset as JG

    from adam_tpu_torch.api.datasets import GenotypeDataset as TG

    return TG.load(str(path), **kw), JG.load(str(path), **kw)


def _tuple(ds):
    return ds.variants, ds.genotypes, ds.seq_dict


# ------------------------------------------------------------ annotations
def test_split_and_merge_typed_equal_jax(inputs):
    from adam_tpu.formats import annotations as ja

    from adam_tpu_torch.formats import annotations as ta

    t, _ = _both(inputs / "calls.vcf")
    infos = t.variants.sidecar.info + [{"DP": "1.5", "MQ": True, "X": "y"},
                                       {"NEGATIVE_TRAIN_SITE": "true"}, {}]
    got, want = ta.split_typed(infos), ja.split_typed(infos)
    assert got == want and "readDepth" in got[0] and "vqslod" in got[0]
    assert ta.merge_typed(got[0], got[1]) == ja.merge_typed(*want)
    f32 = {"rmsMapQ": [np.float32(2.31), None, np.float32(60.0)]}
    assert ta.merge_typed(f32, [{}, {}, {}]) == ja.merge_typed(f32, [{}, {}, {}])
    assert ta.merge_typed(None, infos) is infos
    for key in list(got[0]) + ["unknownKey"]:
        assert ta.arrow_type(key) == ja.arrow_type(key)


def test_site_statistics_equal_jax():
    from adam_tpu.formats import variants as jv

    from adam_tpu_torch.formats import variants as tv

    rng = np.random.default_rng(4)
    for v in (rng.random(17), np.zeros(0), np.array([0.5])):
        assert tv.rms_doubles(v) == jv.rms_doubles(v)
        assert tv.variant_quality_from_genotypes(v) == jv.variant_quality_from_genotypes(v)
    for p in (rng.integers(0, 60, 23), np.zeros(0), np.array([99, 3])):
        assert tv.rms_phred(p) == jv.rms_phred(p)


# ---------------------------------------------------------- the store
@pytest.mark.parametrize("name", ["calls.vcf", "sites.vcf"])
@pytest.mark.parametrize("typed", [None, {}])
def test_save_genotypes_byte_identical(inputs, tmp_path, name, typed):
    from adam_tpu.io import parquet as jpq

    from adam_tpu_torch.io import parquet as tpq

    t, j = _both(inputs / name)
    tpq.save_genotypes(str(tmp_path / "t"), *_tuple(t), typed_annotations=typed)
    jpq.save_genotypes(str(tmp_path / "j"), *_tuple(j), typed_annotations=typed)
    for f in ("variants.parquet", "genotypes.parquet"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
    got = tpq.load_genotypes(str(tmp_path / "j"))
    _assert_variants_equal(got, jpq.load_genotypes(str(tmp_path / "j")))
    # the typed INFO columns merge back under their VCF keys
    assert [set(d) for d in got[0].sidecar.info] == [set(d) for d in t.variants.sidecar.info]


@pytest.mark.parametrize("projection,filters", [
    (["annotations", "genotypeQuality"], None),
    (["qual", "name", "readDepth", "genotypeLikelihoods"], None),
    (None, [("contig", "==", "chr2")]),
    (["filters"], [("start", ">", 20_000)]),
])
def test_load_genotypes_projection_and_filters_equal_jax(inputs, tmp_path, projection,
                                                         filters):
    from adam_tpu.io import parquet as jpq

    from adam_tpu_torch.io import parquet as tpq

    path = str(tmp_path / "g")
    tpq.save_genotypes(path, *_tuple(_both(inputs / "calls.vcf")[0]))
    got = tpq.load_genotypes(path, projection=projection, filters=filters)
    _assert_variants_equal(got, jpq.load_genotypes(path, projection=projection,
                                                   filters=filters))
    assert 0 < len(got[0]) and len(got[1]) == 3 * len(got[0])
    names = ["chr2", "chr9"]
    _assert_variants_equal(tpq.load_genotypes(path, contig_names=names),
                           jpq.load_genotypes(path, contig_names=names))
    with pytest.raises(ValueError, match="unknown genotype/variant projection"):
        tpq.load_genotypes(path, projection=["genotypeQual"])


def test_genotype_dataset_load_and_save_round_trip(inputs, tmp_path):
    """``GenotypeDataset.load`` of a store (the Parquet branch) and
    ``save`` to a store and to a VCF, sorted and not."""
    t, j = _both(inputs / "calls.vcf")
    for sort in (False, True):
        t.save(str(tmp_path / f"t{sort}"), sort_on_save=sort)
        j.save(str(tmp_path / f"j{sort}"), sort_on_save=sort)
        for f in ("variants.parquet", "genotypes.parquet"):
            assert ((tmp_path / f"t{sort}" / f).read_bytes()
                    == (tmp_path / f"j{sort}" / f).read_bytes())
        t.save(str(tmp_path / f"t{sort}.vcf"), sort_on_save=sort)
        j.save(str(tmp_path / f"j{sort}.vcf"), sort_on_save=sort)
        assert (tmp_path / f"t{sort}.vcf").read_bytes() == (tmp_path / f"j{sort}.vcf").read_bytes()
    back_t, back_j = _both(tmp_path / "jTrue")
    _assert_variants_equal(_tuple(back_t), _tuple(back_j))
    assert len(back_t) == len(t)


# ------------------------------------------------------------ write_vcf
@pytest.mark.parametrize("name", ["calls.vcf", "sites.vcf"])
@pytest.mark.parametrize("sort", [False, True])
def test_write_vcf_equals_jax(inputs, tmp_path, name, sort):
    from adam_tpu.io import vcf as jvcf

    from adam_tpu_torch.io import vcf as tvcf

    t, j = _both(inputs / name)
    tvcf.write_vcf(str(tmp_path / "t.vcf"), *_tuple(t), sort_on_save=sort)
    jvcf.write_vcf(str(tmp_path / "j.vcf"), *_tuple(j), sort_on_save=sort)
    got = (tmp_path / "t.vcf").read_bytes()
    assert got == (tmp_path / "j.vcf").read_bytes()
    assert b"<NON_REF>" in got and got.count(b"\n") > len(t)
    # a written VCF reads back to the same sites and calls
    back_t, back_j = _both(tmp_path / "t.vcf")
    _assert_variants_equal(_tuple(back_t), _tuple(back_j))


# ------------------------------------------------------- the dataset API
def test_dataset_analyses_equal_jax(inputs):
    t, j = _both(inputs / "calls.vcf")
    assert t.callset_samples() == j.callset_samples() == list(SAMPLES)
    assert t.allele_count() == j.allele_count() and len(t.allele_count()) > 100
    keys = t.variant_keys()
    np.testing.assert_array_equal(keys, j.variant_keys())
    ann_keys, ann_values = keys[::3][::-1], [f"v{i}" for i in range(len(keys[::3]))]
    got = t.join_annotations(ann_keys, ann_values)
    assert got == j.join_annotations(ann_keys, ann_values)
    assert sum(v is not None for v in got) == len(ann_values)
    st, sj = t.sorted_by_position(), j.sorted_by_position()
    _assert_variants_equal(_tuple(st), _tuple(sj))
    order = np.lexsort((st.variants.start, st.variants.contig_idx))
    np.testing.assert_array_equal(order, np.arange(len(order)))


# ----------------------------------------------------------- the two CLIs
def _run_cli(main, argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _cli_both(argv_of, tmp_path):
    """Run ``argv_of(who)`` through the JAX and the port CLI -> stdouts."""
    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    outs = {}
    for who, fn, extra in (("jax", jax_main, []), ("torch", main, ["--device", "cpu"])):
        rc, outs[who], _ = _run_cli(fn, argv_of(who) + extra)
        assert rc == 0, who
    return outs


def _same_store(a, b):
    for f in ("variants.parquet", "genotypes.parquet"):
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.mark.parametrize("flags", [[], ["-onlyvariants"],
                                   ["-parquet_compression_codec", "snappy"]])
def test_cli_vcf2adam_equals_jax(inputs, tmp_path, flags):
    _cli_both(lambda who: ["vcf2adam", str(inputs / "calls.vcf"), str(tmp_path / who),
                           *flags], tmp_path)
    _same_store(tmp_path / "torch", tmp_path / "jax")
    from adam_tpu_torch.io import parquet as tpq

    v, g, _ = tpq.load_genotypes(str(tmp_path / "torch"))
    assert len(g) == (0 if "-onlyvariants" in flags else 3 * len(v))


@pytest.mark.parametrize("current_db", [False, True])
def test_cli_anno2adam_equals_jax(inputs, tmp_path, current_db):
    if current_db:
        _cli_both(lambda who: ["anno2adam", str(inputs / "calls.vcf"),
                               str(tmp_path / f"db.{who}")], tmp_path)
        _same_store(tmp_path / "db.torch", tmp_path / "db.jax")
    _cli_both(lambda who: ["anno2adam", str(inputs / "update.vcf"), str(tmp_path / who)]
              + (["-current-db", str(tmp_path / f"db.{who}")] if current_db else []),
              tmp_path)
    _same_store(tmp_path / "torch", tmp_path / "jax")
    from adam_tpu_torch.io import parquet as tpq

    v, g, sd = tpq.load_genotypes(str(tmp_path / "torch"))
    n_new = len(_both(inputs / "update.vcf")[0])
    assert len(g) == 0
    if current_db:  # the old sites whose keys the update does not carry
        assert n_new < len(v) < n_new + len(_both(inputs / "calls.vcf")[0])
    else:
        assert len(v) == n_new
    assert "chrX" in sd.names and len(sd.names) == 4


@pytest.mark.parametrize("sort", [False, True])
def test_cli_adam2vcf_equals_jax(inputs, tmp_path, sort):
    from adam_tpu_torch.cli.main import main

    rc, _, _ = _run_cli(main, ["vcf2adam", str(inputs / "canonical.vcf"),
                               str(tmp_path / "store"), "--device", "cpu"])
    assert rc == 0
    _cli_both(lambda who: ["adam2vcf", str(tmp_path / "store"), str(tmp_path / f"{who}.vcf")]
              + (["-sort_on_save"] if sort else []), tmp_path)
    got = (tmp_path / "torch.vcf").read_bytes()
    assert got == (tmp_path / "jax.vcf").read_bytes()
    back, orig = _both(tmp_path / "torch.vcf")[0], _both(inputs / "canonical.vcf")[1]
    if sort:  # the sites in (contig, start) order
        order = np.lexsort((back.variants.start, back.variants.contig_idx))
        np.testing.assert_array_equal(order, np.arange(len(back)))
        assert len(back) == len(orig)
    else:  # vcf2adam then adam2vcf gives back the same records
        _assert_variants_equal(_tuple(back), _tuple(orig))


@pytest.mark.parametrize("name", ["in.bam", "in.sam"])
def test_cli_bam2adam_equals_jax(inputs, tmp_path, name):
    outs = _cli_both(lambda who: ["bam2adam", str(inputs / name), str(tmp_path / f"{who}.adam"),
                                  "-parquet_compression_codec", "zstd"], tmp_path)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"] == ("bam2adam: streamed 1500 reads\n" if name == "in.bam" else "")
    assert (tmp_path / "torch.adam").read_bytes() == (tmp_path / "jax.adam").read_bytes()


def test_cli_bam2adam_empty_bam_falls_through_as_jax(inputs, tmp_path):
    """A BAM without reads: no window streams, the whole-file path writes
    the header-only store."""
    from adam_tpu_torch.formats.batch import ReadBatch, ReadSidecar
    from adam_tpu_torch.io import sam as sam_io

    header = sam_io.read_sam(str(inputs / "in.sam"))[2]
    sam_io.write_bam(str(tmp_path / "empty.bam"), ReadBatch.empty(), ReadSidecar(), header)
    outs = _cli_both(lambda who: ["bam2adam", str(tmp_path / "empty.bam"),
                                  str(tmp_path / f"{who}.adam")], tmp_path)
    assert outs["torch"] == outs["jax"] == ""
    assert (tmp_path / "torch.adam").read_bytes() == (tmp_path / "jax.adam").read_bytes()
