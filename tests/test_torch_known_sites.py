"""The known-sites workflow of the port against the JAX package, on the
CPU: the VCF reader, the known-SNP and known-indel tables, the known-SNP
mask of the BQSR observe, the ``knowns`` realignment consensus model with
a known-indel table, and the streamed transform with known SNPs, known
indels and a known recalibration table — fused and unfused.  Exact
equality throughout; the JAX streamed runs use the device BQSR backend
with resident windows, as ``tests/test_torch_streamed.py`` runs them."""

import contextlib
import gzip
import io
import json
import os
import pathlib
import random
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

WINDOW = 2048
N_READS = 4500

HAND_VCF = (
    "##fileformat=VCFv4.2\n"
    "##contig=<ID=chr17,length=30000>\n"
    "##contig=<ID=chrUn,length=500>\n"
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\ts2\n"
    "chr17\t101\trs1\tA\tC,G\t40\tPASS\tDP=10;DB\tGT:AD:DP:GQ:PL\t"
    "1/2:2,5,3:10:20:90,30,0,60,10,50\t0|1:4,.,0:10:.:10,0,40,20,30,50\n"
    "chr17\t150\t.\tG\t<NON_REF>\t.\t.\tEND=180\tGT:PL\t0/0:0,30,300\t./.:.\n"
    "chr17\t200\t.\tAT\tA\t30\tLowQual\t.\tGT\t0/1\t1\n"
    "chr18\t301\t.\tC\tCTT\t.\tPASS\t.\tGT:FT\t1|1:PASS\t0/1:q10\n"
    "chrX\t50\t.\tT\tA,<NON_REF>\t20\tq10;s50\t.\tGT:PL\t0/1:20,0,30,40,50,60\t./.:.\n"
    "chr18\t400\t.\tACG\tTCA\t10\tPASS\t.\tGT\t./.\t0/0\n"
)


def _parts(d) -> dict:
    return {f: (pathlib.Path(d) / f).read_bytes()
            for f in sorted(os.listdir(d)) if f.startswith("part-")}


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _jax_env(**kv):
    """The JAX streamed run's environment: device BQSR, resident windows."""
    return _env(ADAM_TPU_BQSR_BACKEND="device", ADAM_TPU_RESIDENT="1", **kv)


class _CountingRandom(random.Random):
    """A ``random.Random`` that counts its ``sample`` calls."""

    def __init__(self, seed):
        super().__init__(seed)
        self.samples = 0

    def sample(self, *a, **k):
        self.samples += 1
        return super().sample(*a, **k)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The slice's input: a WGS-shaped SAM with its known-SNP VCF, the
    helper's known-indel VCF, the known-SNP VCF gzipped, and a known-indel
    VCF with a decoy deletion beside each indel (so targets carry more
    consensuses than a small ``max_consensus_number``)."""
    from make_known_indels_vcf import make_known_indels_vcf
    from make_wgs_sam import make_wgs

    d = tmp_path_factory.mktemp("known_sites")
    sam, snps, indels = str(d / "in.sam"), str(d / "snps.vcf"), str(d / "indels.vcf")
    make_wgs(sam, N_READS, 100, n_contigs=2, contig_len=30_000, known_sites_out=snps)
    assert make_known_indels_vcf(sam, indels) > 5
    with open(snps, "rb") as src, gzip.open(str(d / "snps.vcf.gz"), "wb") as dst:
        shutil.copyfileobj(src, dst)
    lines = pathlib.Path(indels).read_text().splitlines(keepends=True)
    decoys = []
    for line in lines:
        if not line.startswith("#"):
            c, pos = line.split("\t")[:2]
            decoys.append(f"{c}\t{int(pos) + 2}\t.\tAC\tA\t10\tPASS\t.\n")
    (d / "decoys.vcf").write_text("".join(lines) + "".join(decoys))
    (d / "hand.vcf").write_text(HAND_VCF)
    with gzip.open(str(d / "hand.vcf.gz"), "wt") as fh:
        fh.write(HAND_VCF)
    return d


def _names(d):
    from adam_tpu_torch.io.sam import peek_sam_header

    return peek_sam_header(str(d / "in.sam")).seq_dict.names


def _tables(d, vcf, kind):
    """(port table, JAX table) of ``kind`` ("snp" or "indel") from ``vcf``
    in the SAM header's contig space; JAX reads a ``.vcf.gz``'s plain
    twin (its reader takes plain text only)."""
    from adam_tpu.api.datasets import GenotypeDataset as JG

    from adam_tpu_torch.api.datasets import GenotypeDataset as TG

    names = _names(d)
    got = TG.load(str(d / vcf), contig_names=names)
    want = JG.load(str(d / vcf.removesuffix(".gz")), contig_names=names)
    return ((got.snp_table(), want.snp_table()) if kind == "snp"
            else (got.indel_table(), want.indel_table()))


# --------------------------------------------------------------- VCF reader


def _assert_same_vcf(want, got):
    (vj, gj, sdj), (vt, gt, sdt) = want, got
    for f in ("contig_idx", "start", "end", "ref_len", "alt_len", "qual",
              "filters_applied", "passing"):
        a, b = getattr(vj, f), getattr(vt, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("ref_allele", "alt_allele", "names", "filters", "info"):
        assert getattr(vj.sidecar, f) == getattr(vt.sidecar, f), f
    for f in ("variant_idx", "sample_idx", "alleles", "gq", "dp", "ref_depth",
              "alt_depth", "phased", "pl", "nonref_pl", "split_from_multiallelic"):
        a, b = getattr(gj, f), getattr(gt, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert gj.samples == gt.samples and gj.genotype_filters == gt.genotype_filters
    assert [(r.name, r.length) for r in sdj.records] == \
        [(r.name, r.length) for r in sdt.records]


@pytest.mark.parametrize("case", ["generated", "hand", "hand_gz", "header_space"])
def test_vcf_reader_equals_jax(inputs, case):
    """The port reads every column the JAX reader does: the generated
    known sites, a hand-written multi-allelic + gVCF file (and the same
    file gzipped, against the JAX reading of the plain one), and that
    file in the SAM header's contig space, where its contigs absent from
    the header are appended in first-seen order."""
    from adam_tpu.io.vcf import read_vcf as jread

    from adam_tpu_torch.io.vcf import read_vcf

    d = inputs
    kw = {"contig_names": _names(d)} if case == "header_space" else {}
    src = {"generated": "snps.vcf", "hand_gz": "hand.vcf.gz"}.get(case, "hand.vcf")
    plain = src.removesuffix(".gz")
    got = read_vcf(str(d / src), **kw)
    want = jread(str(d / plain), **kw)
    _assert_same_vcf(want, got)
    v, g, sd = got
    if case == "generated":
        assert len(v) > 50 and bool(v.is_snp.all())
    else:
        # the multi-allelic record splits in two, the gVCF blocks lose
        # their <NON_REF>, and chrX (in no header) gets the next index
        assert len(v) == 7 and v.sidecar.alt_allele.count(None) == 1
        assert int(g.split_from_multiallelic.sum()) == 4
        names = [r.name for r in sd.records]
        assert names.index("chrX") == len(names) - 1
        if case == "header_space":
            assert names[:2] == _names(d) and "chrUn" in names


def test_genotype_dataset_refuses_what_it_does_not_read(tmp_path):
    """A path that is not a VCF is read as a genotype Parquet store (the
    branch once refused); a missing one fails as in the JAX package."""
    from adam_tpu.api.datasets import GenotypeDataset as JG

    from adam_tpu_torch.api.datasets import GenotypeDataset

    with pytest.raises(FileNotFoundError) as je:
        JG.load(str(tmp_path / "calls.parquet"))
    with pytest.raises(FileNotFoundError) as te:
        GenotypeDataset.load(str(tmp_path / "calls.parquet"))
    assert str(te.value) == str(je.value)


# ------------------------------------------------------------------ tables


@pytest.mark.parametrize("vcf", ["snps.vcf", "snps.vcf.gz", "hand.vcf"])
def test_snp_table_equals_jax(inputs, vcf):
    """site_keys and mask_positions over every residue of the input, in the
    header's contig space and in one that lacks a contig (which then masks
    nothing)."""
    from adam_tpu_torch.io.sam import iter_sam_batches
    from adam_tpu_torch.ops import cigar as cigar_ops

    d = inputs
    got, want = _tables(d, vcf, "snp")
    assert len(got) == len(want) > 0
    assert got.table.keys() == want.table.keys()
    (b, _, header), = list(iter_sam_batches(str(d / "in.sam"), 1 << 30))
    ref_pos = cigar_ops.reference_positions_np(b.cigar_ops, b.cigar_lens, b.cigar_n,
                                               b.start, b.lmax)
    for names in (header.seq_dict.names, header.seq_dict.names[:1] + ["chrX"]):
        keys = got.site_keys(names)
        assert keys.dtype == np.int64
        np.testing.assert_array_equal(keys, want.site_keys(names))
        m = got.mask_positions(names, b.contig_idx, ref_pos)
        np.testing.assert_array_equal(m, want.mask_positions(names, b.contig_idx, ref_pos))
    if vcf != "hand.vcf":
        assert int(m.sum()) > 100
        # the second contig is out of that space: none of its reads masks
        assert not m[np.asarray(b.contig_idx) == 1].any()


def test_snp_table_from_file_equals_jax(inputs):
    """The sites-only reader: every REF base of each line masks a site, as
    in JAX, and the known-sites VCF gives the VCF route's table."""
    from adam_tpu.models.snp_table import SnpTable as JSnpTable

    from adam_tpu_torch.models.snp_table import SnpTable

    d = inputs
    for f in ("snps.vcf", "hand.vcf"):
        got, want = SnpTable.from_file(str(d / f)), JSnpTable.from_file(str(d / f))
        assert got.table.keys() == want.table.keys()
        for k in want.table:
            np.testing.assert_array_equal(got.table[k], want.table[k])
    vcf_route = _tables(d, "snps.vcf", "snp")[0]
    got = SnpTable.from_file(str(d / "snps.vcf"))
    assert all(np.array_equal(got.table[k], vcf_route.table[k]) for k in vcf_route.table)
    with pytest.raises(ValueError, match="malformed"):
        SnpTable.from_lines(["chr17\t0\t.\tA\n"])


def test_indel_table_equals_jax(inputs):
    """get_indels_in_region, by overlap and in table order, over every
    window of 300 bp (and some 1 bp) on both contigs."""
    from adam_tpu.models.positions import ReferenceRegion as JRegion

    from adam_tpu_torch.models.positions import ReferenceRegion

    d = inputs
    got, want = _tables(d, "decoys.vcf", "indel")
    n = 0
    for name in _names(d) + ["chrX"]:
        for lo, width in [(s, 300) for s in range(0, 30_000, 150)] + [(s, 1) for s in range(0, 30_000, 97)]:
            g = got.get_indels_in_region(ReferenceRegion(name, lo, lo + width))
            w = want.get_indels_in_region(JRegion(name, lo, lo + width))
            assert [(r.region.referenceName, r.region.start, r.region.end, r.consensus)
                    for r in g] == [(r.region.referenceName, r.region.start, r.region.end,
                                     r.consensus) for r in w]
            n += len(g)
    assert n > 50
    kinds = {bool(r.consensus) for recs in got.table.values() for r in recs}
    assert kinds == {True, False}  # insertions and deletions


def test_known_indels_helper_reads_cigar_and_md():
    from make_known_indels_vcf import _read_events

    # 5M, delete AC, 3M, insert T, 4M; a leading insertion has no anchor
    ev = _read_events("2S5M2D3M1I4M", "NNACGTACGGTTACG", 99, "5^AC7")
    assert ev == [("D", 103, "A", "AC"), ("I", 108, "G", "T")]
    assert _read_events("1I5M", "TACGTA", 0, "5") == []


# ------------------------------------------------------------ BQSR observe


def test_snp_mask_and_observe_histograms_equal_jax(inputs):
    """A window with known SNPs: the residue mask, and the observe
    histograms (the port's plain version of kernel 1) equal JAX's device
    backend; the mask removes residues the unmasked observe counts."""
    from adam_tpu.io import load_alignments
    from adam_tpu.pipelines import bqsr as jbqsr

    from adam_tpu_torch.api.datasets import AlignmentDataset
    from adam_tpu_torch.io.sam import iter_sam_batches
    from adam_tpu_torch.parallel.device_pool import ResidentWindow
    from adam_tpu_torch.pipelines import bqsr

    d = inputs
    ks, jks = _tables(d, "snps.vcf", "snp")
    (batch, side, header), = list(iter_sam_batches(str(d / "in.sam"), 1 << 30))
    ds = AlignmentDataset(batch, side, header)
    ds_j = load_alignments(str(d / "in.sam"))
    b, bj = ds.batch.to_numpy(), ds_j.batch.to_numpy()
    got = bqsr.observe_residue_mask(ds, b, ks)
    np.testing.assert_array_equal(got, jbqsr.observe_residue_mask(ds_j, bj, jks))
    unmasked = bqsr.observe_residue_mask(ds, b)
    assert int(unmasked.sum()) - int(got.sum()) > 100
    rw = ResidentWindow.place(b, torch.device("cpu"))
    total, mism, gl = bqsr.observe_window(ds, rw, ks)
    jt, jm, _rg, jgl = jbqsr._observe_device(ds_j, jks, "device")
    assert gl == jgl
    np.testing.assert_array_equal(total.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(mism.numpy(), np.asarray(jm))
    assert int(total.sum()) < int(bqsr.observe_window(ds, rw)[0].sum())


# ------------------------------------------------------- knowns realignment


@pytest.mark.parametrize("path", ["native", "python"])
def test_knowns_realign_with_a_table_equals_jax(inputs, path):
    """The ``knowns`` model with the decoy indel table and
    max_consensus_number 1, so the rng samples on many targets: the
    realigned batch equals JAX's on the same path, the rng saw the same
    number of samples, and reads moved."""
    from adam_tpu.io import load_alignments
    from adam_tpu.pipelines import realign as jra

    from adam_tpu_torch.api.datasets import AlignmentDataset
    from adam_tpu_torch.io.sam import iter_sam_batches
    from adam_tpu_torch.pipelines import realign as tra

    d = inputs
    it, jit = _tables(d, "decoys.vcf", "indel")
    (batch, side, header), = list(iter_sam_batches(str(d / "in.sam"), 1 << 30))
    ds = AlignmentDataset(batch, side, header)
    ds_j = load_alignments(str(d / "in.sam"))
    rng, jrng = _CountingRandom(0), _CountingRandom(0)
    args = (jra.MAX_INDEL_SIZE, 1, jra.LOD_THRESHOLD, jra.MAX_TARGET_SIZE)
    if path == "native":
        got = tra.realign_indels(ds, consensus_model="knowns", known_indels=it,
                                 max_consensus_number=1, rng=rng, device="cpu")
        want = jra._realign_indels_native(ds_j, "knowns", jit, *args, jrng, "overlap")
    else:
        got = tra._realign_indels_py(ds, "knowns", it, *args, rng=rng,
                                     device=torch.device("cpu"))
        want = jra._realign_indels_py(ds_j, "knowns", jit, *args, rng=jrng)
    b0, bw, bg = ds.batch.to_numpy(), want.batch.to_numpy(), got.batch.to_numpy()
    for f in ("start", "end", "mapq", "cigar_n", "flags", "cigar_ops", "cigar_lens",
              "bases", "quals", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(bw, f)),
                                      np.asarray(getattr(bg, f)), err_msg=f)
    assert list(want.sidecar.md) == list(got.sidecar.md)
    assert list(want.sidecar.attrs) == list(got.sidecar.attrs)
    assert rng.samples == jrng.samples > 5
    assert int((np.asarray(b0.start) != np.asarray(bg.start)).sum()) > 0


# ------------------------------------------------------- streamed transform


@pytest.fixture(scope="module")
def known_runs(inputs):
    """Streamed runs of both packages with known SNPs + known indels (the
    JAX run keeps its run directory, whose table.npz is the known table
    of the runs below)."""
    from adam_tpu.pipelines.streamed import transform_streamed as jax_transform

    from adam_tpu_torch.pipelines.streamed import transform_streamed

    d = inputs
    ks, jks = _tables(d, "snps.vcf", "snp")
    ki, jki = _tables(d, "indels.vcf", "indel")
    stats = transform_streamed(
        str(d / "in.sam"), str(d / "known.torch"), realign=True, known_snps=ks,
        known_indels=ki, window_reads=WINDOW, dump_observations=str(d / "known.torch.csv"),
        device="cpu",
    )
    with _jax_env():
        jax_transform(str(d / "in.sam"), str(d / "known.jax"), realign=True,
                      known_snps=jks, known_indels=jki, window_reads=WINDOW,
                      dump_observations=str(d / "known.jax.csv"), run_dir=str(d / "rd"))
    return d, stats


def test_known_sites_parts_byte_identical_to_jax(known_runs):
    d, stats = known_runs
    got, want = _parts(d / "known.torch"), _parts(d / "known.jax")
    assert len(want) == stats["n_windows"] + 1 == stats["n_parts"]
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    assert stats["n_realigned"] > 0 and stats["fused_bc"] is False


def test_known_sites_observations_equal_jax(known_runs):
    d, _ = known_runs
    got = (d / "known.torch.csv").read_text()
    assert got == (d / "known.jax.csv").read_text()
    assert len(got.splitlines()) > 1000


def _known_table(d, kind):
    """The JAX run's solved table (``rd/table.npz``) as it is, stored as
    i32, with a stored ``gl`` that disagrees with its cycle axis (the
    apply centres on the axis, as JAX's gather does), widened by 40
    cycles each side (a cohort table), or, both ineligible for the fused
    tier, narrowed by 30 cycles each side or with one read-group bin more
    than the input has (the gather clamps to the table)."""
    with np.load(str(d / "rd" / "table.npz")) as z:
        table, gl = np.asarray(z["table"], np.uint8), int(z["gl"])
    if kind == "i32":
        return table.astype(np.int32), gl
    if kind == "gl_off":
        return table, gl + 7
    if kind == "wide":
        w = 40
        wide = np.full(table.shape[:2] + (2 * (gl + w) + 1, table.shape[3]), 33, np.uint8)
        wide[:, :, w:w + 2 * gl + 1] = table
        return wide, gl + w
    if kind == "narrow":
        return np.ascontiguousarray(table[:, :, 30:-30]), gl - 30
    if kind == "extra_rg":
        rng = np.random.default_rng(3)
        extra = rng.integers(0, 60, (1,) + table.shape[1:]).astype(np.uint8)
        return np.concatenate([table, extra]), gl
    return table, gl


@pytest.fixture(scope="module", params=["own", "i32", "gl_off", "wide", "narrow",
                                        "extra_rg"])
def table_runs(request, known_runs):
    """Known-table runs: the port fused and unfused, JAX unfused."""
    from adam_tpu.pipelines.streamed import transform_streamed as jax_transform

    from adam_tpu_torch.pipelines.streamed import transform_streamed

    d, _ = known_runs
    kind = request.param
    table = _known_table(d, kind)
    out = {}
    for leg, flag in (("fused", "1"), ("unfused", "0")):
        with _env(ADAM_TPU_FUSED_BC=flag):
            out[leg] = transform_streamed(
                str(d / "in.sam"), str(d / f"t.{kind}.{leg}"), realign=True,
                known_table=table, window_reads=WINDOW,
                dump_observations=str(d / f"t.{kind}.{leg}.csv"), device="cpu",
            )
    with _jax_env(ADAM_TPU_FUSED_BC="0"):
        jax_transform(str(d / "in.sam"), str(d / f"t.{kind}.jax"), realign=True,
                      known_table=table, window_reads=WINDOW,
                      dump_observations=str(d / f"t.{kind}.jax.csv"))
    return d, kind, out


def test_known_table_parts_byte_identical_to_jax(table_runs):
    d, kind, stats = table_runs
    want = _parts(d / f"t.{kind}.jax")
    assert len(want) == stats["fused"]["n_parts"] == stats["fused"]["n_windows"] + 1
    for leg in ("fused", "unfused"):
        got = _parts(d / f"t.{kind}.{leg}")
        assert list(got) == list(want), leg
        for name in want:
            assert got[name] == want[name], (kind, leg, name)
        # the histograms are merged and dumped, not solved
        assert (d / f"t.{kind}.{leg}.csv").read_text() == \
            (d / f"t.{kind}.jax.csv").read_text()


def test_known_table_fused_tier_counts(table_runs):
    """The fused leg fuses every observed part (windows and the realigned
    part) when the table is eligible, none when its read groups differ
    or its cycle axis is narrower than the windows'; the unfused leg never
    fuses."""
    _, kind, stats = table_runs
    f, u = stats["fused"], stats["unfused"]
    assert f["fused_bc"] is True and u["fused_bc"] is False
    assert u["n_fused_windows"] == 0
    eligible = kind in ("own", "i32", "gl_off", "wide")
    assert f["n_fused_windows"] == (f["n_parts"] if eligible else 0)
    assert all(n == 0 for n in f["kernel_launches"].values())


def test_fused_bc_body_equals_the_separate_passes():
    """The fused body is the observe then the apply + pack, bit for bit,
    on a window whose table is wider than its grid."""
    from adam_tpu_torch.ops.colpack import pack_mask_bits
    from adam_tpu_torch.pipelines import bqsr

    rng = np.random.default_rng(5)
    g, gl, n_rg = 64, 32, 3
    lengths = rng.integers(20, gl + 1, g).astype(np.int32)
    in_read = np.arange(gl)[None, :] < lengths[:, None]
    quals = np.where(in_read, rng.integers(2, 41, (g, gl)), 255).astype(np.uint8)
    t = [torch.from_numpy(a) for a in (
        rng.integers(0, 5, (g, gl)).astype(np.uint8), quals, lengths,
        (0x1 | rng.choice([0x40, 0x80], g) | rng.choice([0, 0x10], g)).astype(np.int32),
        rng.integers(-1, 2, g).astype(np.int32))]
    res = in_read & (rng.random((g, gl)) < 0.9)
    masks = [torch.from_numpy(pack_mask_bits(res)),
             torch.from_numpy(pack_mask_bits(res & (rng.random((g, gl)) < 0.1))),
             torch.from_numpy(rng.random(g) < 0.9)]
    hq, vd = torch.from_numpy(rng.random(g) < 0.95), torch.from_numpy(rng.random(g) < 0.95)
    table = torch.from_numpy(rng.integers(0, 60, (n_rg, 94, 2 * 48 + 1, 17)).astype(np.uint8))
    got = bqsr.fused_bc_body(*t, *masks, hq, vd, table, n_rg, gl, g * gl)
    want = (*bqsr.observe_packed_body(*t, *masks, n_rg, gl),
            *bqsr.apply_pack2_body(*t, hq, vd, table, gl, g * gl))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("raw", ["", "auto", "1", "On", "true", "0", "off", "FALSE", "maybe"])
def test_fused_bc_toggle_parses_as_jax(raw):
    from adam_tpu.pipelines import bqsr as jbqsr

    from adam_tpu_torch.pipelines import bqsr

    with _env(ADAM_TPU_FUSED_BC=raw):
        for default in (True, False):
            assert bqsr.fused_bc_enabled(default) == jbqsr.fused_bc_enabled(default)


def test_cli_known_flags_write_the_library_parts(known_runs, tmp_path):
    """``-known_snps`` (gzipped), ``-known_indels`` and
    ``-known_recalibration_table`` write what the library call writes."""
    from adam_tpu_torch.cli.main import main
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    d, _ = known_runs
    ks, _ = _tables(d, "snps.vcf.gz", "snp")
    ki, _ = _tables(d, "indels.vcf", "indel")
    out = tmp_path / "cli.adam"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["transform", str(d / "in.sam"), str(out), "-streaming",
                   "-mark_duplicate_reads", "-realign_indels", "-recalibrate_base_qualities",
                   "-known_snps", str(d / "snps.vcf.gz"), "-known_indels", str(d / "indels.vcf"),
                   "-known_recalibration_table", str(d / "rd" / "table.npz"),
                   "-window_reads", str(WINDOW), "--device", "cpu"])
    assert rc == 0
    stats = json.loads(buf.getvalue().splitlines()[-1])
    assert stats["fused_bc"] is True and stats["n_fused_windows"] == stats["n_parts"]
    lib = transform_streamed(str(d / "in.sam"), str(tmp_path / "lib.adam"), realign=True,
                             known_snps=ks, known_indels=ki,
                             known_table=_known_table(d, "own"), window_reads=WINDOW,
                             device="cpu")
    assert _parts(out) == _parts(tmp_path / "lib.adam")
    assert len(_parts(out)) == lib["n_parts"]
