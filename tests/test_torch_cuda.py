"""The port's CUDA kernels on the card: each equals its plain PyTorch
version bit for bit, counts exactly one launch per call, and carries the
streamed transform to the same bytes as the CPU run.

This file imports nothing of JAX or ``adam_tpu``, so it runs on a GPU
machine without them (``python -m pytest tests/test_torch_cuda.py -m
cuda``).  Without a card every test skips."""

import os
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

GRIDS = [(16, 24), (48, 40), (96, 96), (4096, 128)]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _window(seed, g, gl, n_rg=3):
    from adam_tpu_torch.ops.colpack import pack_mask_bits

    rng = np.random.default_rng(seed)
    arrays = dict(
        bases=rng.integers(0, 6, (g, gl)).astype(np.uint8),
        quals=rng.integers(0, 60, (g, gl)).astype(np.uint8),
        lengths=rng.integers(1, gl, g).astype(np.int32),
        flags=rng.integers(0, 256, g).astype(np.int32),
        rg=rng.integers(-1, n_rg - 1, g).astype(np.int32),
        res_bits=pack_mask_bits(rng.random((g, gl)) < 0.6),
        mm_bits=pack_mask_bits(rng.random((g, gl)) < 0.2),
        read_ok=rng.random(g) < 0.8,
        has_qual=rng.random(g) < 0.9,
        valid=rng.random(g) < 0.95,
        table=rng.integers(2, 43, (n_rg, 94, 2 * gl + 1, 17)).astype(np.uint8),
    )
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


_WINDOW = ("bases", "quals", "lengths", "flags", "rg")


@pytest.mark.parametrize("g,gl", GRIDS)
def test_kernels_equal_plain_versions(cuda_device, g, gl):
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.ops.colpack import pack_rows, pack_rows_plain
    from adam_tpu_torch.ops.observe import observe_hist, observe_hist_plain
    from adam_tpu_torch.pipelines.bqsr import covariate_keys

    w = {k: v.to(cuda_device) for k, v in _window(11 + g, g, gl).items()}
    size = 3 * 94 * (2 * gl + 1) * 17
    keys = covariate_keys(*(w[n] for n in _WINDOW), 3, gl)
    masks = (w["res_bits"], w["mm_bits"], w["read_ok"])
    before = kernels.launches()
    got = observe_hist(keys, *masks, size, (2 * gl + 1) * 17)
    want = observe_hist_plain(keys, *masks, size)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(want[0].sum()) > 0
    lens = torch.where(w["valid"], w["lengths"].long(), 0)
    for n in (g * gl, int(lens.sum()) // 2):  # full payload, and one cut short
        assert torch.equal(pack_rows(w["quals"], lens, n),
                           pack_rows_plain(w["quals"], lens, n))
    after = kernels.launches()
    assert after["observe_hist"] == before["observe_hist"] + 1
    assert after["pack_rows"] == before["pack_rows"] + 2


# (g, gl, n_rg, case): widths up to 1,024 lanes (two bin parts of u32
# records per slab), 100 read groups (two slab groups), every residue on
# one key, no read counted, one row
OBSERVE_CASES = [(3000, 24, 3, "random"), (3000, 128, 3, "random"),
                 (1500, 256, 3, "random"), (300, 1024, 3, "random"),
                 (2000, 24, 100, "random"), (3000, 128, 3, "hot"),
                 (3000, 128, 3, "none_ok"), (1, 128, 3, "random"),
                 (700, 100, 3, "random")]


@pytest.mark.parametrize("g,gl,n_rg,case", OBSERVE_CASES)
def test_observe_hist_equals_plain(cuda_device, g, gl, n_rg, case):
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.ops.colpack import pack_mask_bits
    from adam_tpu_torch.ops.observe import observe_hist, observe_hist_plain
    from adam_tpu_torch.pipelines.bqsr import covariate_keys

    w = _window(13 + g + gl, g, gl, n_rg)
    keys = covariate_keys(*(w[n] for n in _WINDOW), n_rg, gl)
    if case == "hot":
        keys[:] = keys[0, 0]
        w["res_bits"] = torch.from_numpy(pack_mask_bits(np.ones((g, gl), bool)))
        w["read_ok"][:] = True
    elif case == "none_ok":
        w["read_ok"][:] = False
    slab_w = (2 * gl + 1) * 17
    size = n_rg * 94 * slab_w
    args = (keys, w["res_bits"], w["mm_bits"], w["read_ok"], size)
    want = observe_hist_plain(*args)
    before = kernels.launches()["observe_hist"]
    got = observe_hist(*(a.to(cuda_device) for a in args[:4]), size, slab_w)
    torch.cuda.synchronize()
    assert kernels.launches()["observe_hist"] == before + 1
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and torch.equal(a.cpu(), b)
    assert (int(want[0].sum()) > 0) == (case != "none_ok")


@pytest.mark.parametrize("encode", ["none", "sanger", "base_decode"])
@pytest.mark.parametrize("g,gl,case", [(4096, 128, "read_lengths"), (1000, 100, "long_rows"),
                                       (333, 40, "read_lengths"), (500, 64, "zero"),
                                       (77, 3000, "read_lengths")])
@pytest.mark.parametrize("cut", ["exact", "short", "past"])
def test_pack_rows_equals_plain(cuda_device, encode, g, gl, case, cut):
    """Every encode mode on the card equals its plain version: rows longer
    than the width, row counts that are no multiple of the tile, all-zero
    lengths, rows too wide for the shared buffers, and a size cut short of
    or past sum(lens)."""
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.ops.colpack import pack_rows

    rng = np.random.default_rng(g + gl)
    mat = torch.from_numpy((rng.integers(0, 6, (g, gl)) if encode == "base_decode"
                            else rng.integers(0, 256, (g, gl))).astype(np.uint8))
    lens = rng.integers(0, gl + 1, g).astype(np.int64)
    if case == "long_rows":
        lens[::3] = gl + rng.integers(1, 300, len(lens[::3]))
    elif case == "zero":
        lens[:] = 0
    total = int(lens.sum())
    size = {"exact": total, "short": total // 2, "past": total + 1000}[cut]
    lens = torch.from_numpy(lens)
    want = pack_rows(mat, lens, size, encode=encode)
    before = kernels.launches()["pack_rows"]
    got = pack_rows(mat.to(cuda_device), lens.to(cuda_device), size, encode=encode)
    torch.cuda.synchronize()
    assert kernels.launches()["pack_rows"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("g,gl", GRIDS[1:])
def test_apply_pack2_on_the_card_equals_the_cpu(cuda_device, g, gl):
    from adam_tpu_torch.pipelines.bqsr import apply_pack2_body

    w = _window(5 + g, g, gl)
    args = [w[n] for n in (*_WINDOW, "has_qual", "valid", "table")]
    want = apply_pack2_body(*args, gl, g * gl)
    got = apply_pack2_body(*(a.to(cuda_device) for a in args), gl, g * gl)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_wrappers_refuse_bad_cuda_inputs(cuda_device):
    from adam_tpu_torch.ops.colpack import pack_rows
    from adam_tpu_torch.ops.observe import observe_hist

    keys = torch.zeros((4, 16), dtype=torch.int32, device=cuda_device)
    bits = torch.zeros((4, 2), dtype=torch.uint8, device=cuda_device)
    ok = torch.ones(4, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        observe_hist(keys, bits, bits, ok.cpu(), 10, 5)
    with pytest.raises(ValueError):
        pack_rows(bits, torch.zeros(4, dtype=torch.int64), 8)


def test_transform_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.pipelines.streamed import transform_streamed

    path = str(tmp_path / "in.sam")
    make_wgs(path, 4500, 100, n_contigs=2, contig_len=30_000)
    stats = {}
    for dev in ("cuda", "cpu"):
        stats[dev] = transform_streamed(path, str(tmp_path / dev), realign=False,
                                        window_reads=2048, device=dev)
    launched = stats["cuda"]["kernel_launches"]
    assert (launched["observe_hist"], launched["pack_rows"]) == (3, 6)
    assert launched["sw_fill"] == launched["sw_score"] == 0
    parts = sorted(f for f in os.listdir(tmp_path / "cpu") if f.startswith("part-"))
    assert len(parts) == 3
    for f in parts:
        assert (tmp_path / "cuda" / f).read_bytes() == (tmp_path / "cpu" / f).read_bytes()


def test_fused_window_equals_separate_passes_and_plain(cuda_device):
    """One fused B->C window at the main path's shape (g = 262,144, gl =
    128, a cohort table 32 cycles wider each side): the fused body on the
    card equals the separate observe and apply + pack on the card, and the
    plain versions (the same bodies on the CPU); it launches kernel 1 once
    and kernel 2 once per encode."""
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.pipelines import bqsr

    g, gl, n_rg = 262_144, 128, 3
    w = _window(21, g, gl, n_rg)
    w["table"] = torch.from_numpy(np.random.default_rng(22).integers(
        2, 43, (n_rg, 94, 2 * (gl + 32) + 1, 17)).astype(np.uint8))
    obs = [w[n] for n in (*_WINDOW, "res_bits", "mm_bits", "read_ok")]
    app = [w[n] for n in ("has_qual", "valid", "table")]
    dev = [a.to(cuda_device) for a in obs + app]
    kernels.reset_launches()
    got = bqsr.fused_bc_body(*dev, n_rg, gl, g * gl)
    torch.cuda.synchronize()
    assert kernels.launches()["observe_hist"] == 1
    assert kernels.variant_launches() == {"pack_rows:sanger": 1, "pack_rows:base_decode": 1}
    sep = (*bqsr.observe_packed_body(*dev[:8], n_rg, gl),
           *bqsr.apply_pack2_body(*dev[:5], *dev[8:], gl, g * gl))
    plain = bqsr.fused_bc_body(*obs, *app, n_rg, gl, g * gl)
    for a, b, c in zip(got, sep, plain):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    assert int(plain[0].sum()) > 0


def test_known_sites_transform_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    """Known SNPs + known indels + a known table, fused, on the card and on
    the CPU: the same parts; every observed part fused."""
    from make_known_indels_vcf import make_known_indels_vcf
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.api.datasets import GenotypeDataset
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    path, snps, indels = (str(tmp_path / f) for f in ("in.sam", "k.vcf", "i.vcf"))
    make_wgs(path, 4500, 100, n_contigs=2, contig_len=30_000, known_sites_out=snps)
    make_known_indels_vcf(path, indels)
    names = ["chr17", "chr18"]
    kw = dict(realign=True, window_reads=2048,
              known_snps=GenotypeDataset.load(snps, contig_names=names).snp_table(),
              known_indels=GenotypeDataset.load(indels, contig_names=names).indel_table(),
              known_table=(np.random.default_rng(4).integers(
                  2, 43, (3, 94, 2 * 160 + 1, 17)).astype(np.uint8), 160))
    stats = {dev: transform_streamed(path, str(tmp_path / dev), device=dev, **kw)
             for dev in ("cuda", "cpu")}
    st = stats["cuda"]
    assert st["fused_bc"] and st["n_fused_windows"] == st["n_parts"] == st["n_windows"] + 1
    launched = st["kernel_launches"]
    assert (launched["observe_hist"], launched["pack_rows"]) == (st["n_parts"], 2 * st["n_parts"])
    parts = sorted(f for f in os.listdir(tmp_path / "cpu") if f.startswith("part-"))
    assert len(parts) == st["n_parts"]
    for f in parts:
        assert (tmp_path / "cuda" / f).read_bytes() == (tmp_path / "cpu" / f).read_bytes()


def _sw_pairs(seed, B, lx, ly, x_len=None):
    """Random pairs; ``x_len`` "one" or "full" pins every x length."""
    rng = np.random.default_rng(seed)
    xl = rng.integers(1, lx + 1, B).astype(np.int32)
    yl = rng.integers(1, ly + 1, B).astype(np.int32)
    xl[0], yl[0] = lx, ly
    if x_len is not None:
        xl[:] = 1 if x_len == "one" else lx
    xc = rng.integers(0, 5, (B, lx)).astype(np.int32)
    yc = rng.integers(0, 5, (B, ly)).astype(np.int32)
    xc[np.arange(lx)[None, :] >= xl[:, None]] = 5
    yc[np.arange(ly)[None, :] >= yl[:, None]] = 5
    return [torch.from_numpy(a) for a in (xc, xl, yc, yl)]


# the third set is the order trap: w_delete not a dyadic fraction, where
# the doubling delete chain and the sequential one round apart in f32
SW_W = [(1.0, -0.333, -0.5, -0.5), (2.0, -1.0, -1.0, -1.0), (1.0, -0.333, -0.3, -0.3)]


# (B, lx, ly, x_len): the warp route's edges (lx 1, 31, 32, 33 and its
# limit 128), the block route (limit + 1, 1500), B = 1 and B not a
# multiple of the four pairs a block, every x_len 1 or lx
@pytest.mark.parametrize("w", SW_W)
@pytest.mark.parametrize("B,lx,ly,x_len", [
    (9, 37, 29, None), (64, 100, 300, None), (3, 1, 5, None), (2, 1500, 90, None),
    (700, 128, 512, None), (1, 31, 40, None), (5, 32, 33, None), (6, 33, 70, None),
    (1, 128, 128, None), (130, 129, 200, None), (13, 128, 256, "one"),
    (13, 128, 256, "full"), (7, 129, 64, "full"), (11, 64, 96, "one")])
def test_sw_fill_equals_plain(cuda_device, B, lx, ly, x_len, w):
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.ops.smith_waterman import SW_FILL_WARP_MAX_LX, sw_fill, sw_fill_plain

    args = _sw_pairs(lx + ly, B, lx, ly, x_len)
    want = sw_fill_plain(*args, *w, lx, ly)
    route = "warp" if lx <= SW_FILL_WARP_MAX_LX else "block"
    before = kernels.launches()["sw_fill"]
    before_route = kernels.variant_launches().get(f"sw_fill:{route}", 0)
    got = sw_fill(*(a.to(cuda_device) for a in args), *w, lx, ly)
    torch.cuda.synchronize()
    assert kernels.launches()["sw_fill"] == before + 1
    assert kernels.variant_launches()[f"sw_fill:{route}"] == before_route + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("dtype_name,w", [("f32", SW_W[0]), ("f32", SW_W[1]),
                                          ("i32", SW_W[1]), ("i16", SW_W[1]),
                                          ("bf16", SW_W[0]), ("bf16", SW_W[1]),
                                          ("f32", SW_W[2]), ("bf16", SW_W[2])])
@pytest.mark.parametrize("B,lx,ly,x_len", [
    (24, 31, 45, None), (300, 127, 127, None), (5, 1, 9, None), (7, 1000, 60, None),
    (1, 32, 40, None), (9, 33, 50, None), (6, 128, 64, None), (3, 129, 30, None),
    (2, 1024, 20, None), (17, 64, 70, "one"), (17, 64, 70, "full")])
def test_sw_score_equals_plain(cuda_device, B, lx, ly, x_len, dtype_name, w):
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.ops.smith_waterman import sw_best_scores

    args = _sw_pairs(lx * 3 + ly, B, lx, ly, x_len)
    want = sw_best_scores(*args, *w, dtype_name=dtype_name)
    before = kernels.launches()["sw_score"]
    got = sw_best_scores(*(a.to(cuda_device) for a in args), *w, dtype_name=dtype_name)
    torch.cuda.synchronize()
    assert kernels.launches()["sw_score"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert float(want.max()) > 0


def test_alignments_on_the_card_equal_the_cpu(cuda_device):
    from adam_tpu_torch.ops.smith_waterman import smith_waterman_many

    rng = np.random.default_rng(4)
    pairs = []
    for _ in range(50):
        y = rng.integers(0, 4, int(rng.integers(150, 400))).astype(np.uint8)
        s = int(rng.integers(0, len(y) - 100))
        x = y[s:s + 100].copy()
        x[rng.random(100) < 0.05] = 4
        pairs.append((x, y))
    assert smith_waterman_many(pairs, device="cuda") == smith_waterman_many(pairs, device="cpu")


@pytest.mark.parametrize("model", ["reads", "smithwaterman"])
def test_realigning_transform_on_the_card_equals_the_cpu(cuda_device, tmp_path, model):
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.pipelines.streamed import transform_streamed

    path = str(tmp_path / "in.sam")
    make_wgs(path, 4500, 100, n_contigs=2, contig_len=30_000)
    stats = {}
    for dev in ("cuda", "cpu"):
        stats[dev] = transform_streamed(path, str(tmp_path / dev), realign=True,
                                        consensus_model=model, window_reads=2048,
                                        device=dev)
    launched = stats["cuda"]["kernel_launches"]
    assert launched["observe_hist"] == 4 and launched["pack_rows"] == 8
    assert (launched["sw_fill"] > 0) == (model == "smithwaterman")
    parts = sorted(f for f in os.listdir(tmp_path / "cpu") if f.startswith("part-"))
    assert len(parts) == stats["cpu"]["n_windows"] + 1
    for f in parts:
        assert (tmp_path / "cuda" / f).read_bytes() == (tmp_path / "cpu" / f).read_bytes()


@pytest.mark.parametrize("k", [1, 21])
def test_kmer_bodies_on_the_card_equal_the_cpu(cuda_device, k):
    """The k-mer histogram and the q-mer weights at a window's size
    (262,144 reads x 100 bases, N bases and short reads among them),
    card vs CPU, bit for bit."""
    from adam_tpu_torch.ops import kmer

    rng = np.random.default_rng(k)
    g, L = 262_144, 100
    lengths = np.where(rng.random(g) < 0.9, L, rng.integers(10, L, g)).astype(np.int32)
    past = np.arange(L)[None, :] >= lengths[:, None]
    bases = np.where(past, 5, rng.choice(5, (g, L), p=[0.249, 0.25, 0.25, 0.25, 0.001]))
    quals = np.where(past, 255, rng.integers(2, 41, (g, L)))
    cpu = [torch.from_numpy(a) for a in (bases.astype(np.uint8), quals.astype(np.uint8),
                                         lengths, rng.random(g) < 0.98)]
    card = [a.to(cuda_device) for a in cpu]
    for got, want in ((kmer.device_kmer_histogram(card[0], *card[2:], k),
                       kmer.device_kmer_histogram(cpu[0], *cpu[2:], k)),
                      (kmer.device_qmer_weights(*card, k), kmer.device_qmer_weights(*cpu, k))):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


def test_bam_transform_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.io import sam
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    make_wgs(str(tmp_path / "in.sam"), 4500, 100, n_contigs=2, contig_len=30_000)
    sam.write_bam(str(tmp_path / "in.bam"), *sam.read_sam(str(tmp_path / "in.sam")))
    stats = {dev: transform_streamed(str(tmp_path / "in.bam"), str(tmp_path / dev),
                                     window_reads=2048, device=dev)
             for dev in ("cuda", "cpu")}
    launched = stats["cuda"]["kernel_launches"]
    n_parts = stats["cpu"]["n_parts"]
    assert n_parts == stats["cpu"]["n_windows"] + 1
    assert launched["observe_hist"] >= n_parts and launched["pack_rows"] == 2 * n_parts
    parts = sorted(f for f in os.listdir(tmp_path / "cpu") if f.startswith("part-"))
    assert len(parts) == n_parts
    for f in parts:
        assert (tmp_path / "cuda" / f).read_bytes() == (tmp_path / "cpu" / f).read_bytes()


@pytest.mark.parametrize("out,flags", [
    ("full.adam", ["-mark_duplicate_reads", "-realign_indels",
                   "-recalibrate_base_qualities", "-sort_reads"]),
    ("trim.sam", ["-trimReads", "-trimFromStart", "2", "-trimFromEnd", "1",
                  "-qualityBasedTrim", "-mark_duplicate_reads", "-realign_indels",
                  "-recalibrate_base_qualities", "-sort_reads"]),
    ("markdup.bam", ["-mark_duplicate_reads"]),
])
def test_dataset_transform_on_the_card_equals_the_cpu(cuda_device, tmp_path, out, flags):
    """The non-streaming transform through the CLI, card vs CPU: the same
    output bytes and flagstat text; kernel 1 launched once per BQSR run
    on the card."""
    import contextlib
    import io
    import json

    from make_wgs_sam import make_wgs

    from adam_tpu_torch.cli.main import main

    make_wgs(str(tmp_path / "in.sam"), 4500, 100, n_contigs=2, contig_len=30_000)
    got = {}
    for dev in ("cuda", "cpu"):
        path = str(tmp_path / f"{dev}.{out}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["transform", str(tmp_path / "in.sam"), path, *flags,
                         "--device", dev]) == 0
        stats = json.loads(buf.getvalue().strip().splitlines()[-1])
        assert stats["device"].startswith(dev)
        if dev == "cuda":
            bqsr = "-recalibrate_base_qualities" in flags
            assert stats["kernel_launches"]["observe_hist"] == int(bqsr)
            assert stats["kernel_launches"]["pack_rows"] == 0
        text = io.StringIO()
        with contextlib.redirect_stdout(text), contextlib.redirect_stderr(io.StringIO()):
            assert main(["flagstat", path, "--device", dev]) == 0
        with open(path, "rb") as fh:
            got[dev] = (fh.read(), text.getvalue())
    assert got["cuda"] == got["cpu"]
    assert "4500 + 0 in total" in got["cuda"][1]


def test_quality_profile_on_the_card_equals_the_cpu(cuda_device):
    from adam_tpu_torch.formats.batch import ReadBatch
    from adam_tpu_torch.pipelines.trim import quality_profile

    rng = np.random.default_rng(5)
    n, L = 20_000, 120
    b = ReadBatch.empty(n, L, 1).replace(
        quals=rng.integers(0, 42, (n, L)).astype(np.uint8),
        lengths=rng.integers(1, L + 1, n).astype(np.int32),
        read_group_idx=rng.integers(-1, 3, n).astype(np.int32),
        has_qual=rng.random(n) < 0.95, valid=rng.random(n) < 0.98)
    sums, counts = quality_profile(b, 3, device="cuda")
    want_sums, want_counts = quality_profile(b, 3, device="cpu")
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(sums, want_sums)


def test_journaled_run_killed_in_pass_c_resumes_on_the_card(cuda_device, tmp_path):
    """A journaled run on the card SIGKILLed at its third pass-C submit,
    then ``--resume`` on the card: the parts equal the CPU run's, and the
    resume launches ``observe_hist`` never (the table was journaled) and
    ``pack_rows`` twice per part it writes."""
    import json
    import signal
    import subprocess

    from make_wgs_sam import make_wgs

    from adam_tpu_torch.pipelines.streamed import transform_streamed

    repo = pathlib.Path(__file__).resolve().parent.parent
    path = str(tmp_path / "in.sam")
    make_wgs(path, 4500, 100, n_contigs=2, contig_len=30_000)
    cpu = transform_streamed(path, str(tmp_path / "cpu"), window_reads=1024, device="cpu")
    out, rd = str(tmp_path / "cuda"), str(tmp_path / "rd")
    argv = [sys.executable, "-m", "adam_tpu_torch", "transform", path, out, "-streaming",
            "-mark_duplicate_reads", "-realign_indels", "-recalibrate_base_qualities",
            "-window_reads", "1024", "--run-dir", rd, "--device", "cuda"]
    env = dict(os.environ, PYTHONPATH=str(repo),
               ADAM_TPU_FAULTS="proc.kill=kill,device=pass_c,after=2,times=1")
    res = subprocess.run(argv, env=env, cwd=str(repo), capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == -signal.SIGKILL, res.stderr[-2000:]
    env.pop("ADAM_TPU_FAULTS")
    res = subprocess.run(argv + ["--resume"], env=env, cwd=str(repo), capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    stats = json.loads(res.stdout.strip().splitlines()[-1])
    launched = stats["kernel_launches"]
    assert launched["observe_hist"] == 0
    assert launched["pack_rows"] == 2 * stats["windows_fresh"]
    assert stats["windows_resumed"] + stats["windows_fresh"] == cpu["n_parts"]
    parts = sorted(f for f in os.listdir(tmp_path / "cpu") if f.startswith("part-"))
    assert len(parts) == cpu["n_parts"]
    assert sorted(f for f in os.listdir(out) if f.startswith("part-")) == parts
    for f in parts:
        assert (tmp_path / "cuda" / f).read_bytes() == (tmp_path / "cpu" / f).read_bytes()


def _interval_columns(seed, n, n_contigs=3, span=5_000):
    rng = np.random.default_rng(seed)
    contig = rng.integers(-1, n_contigs + 1, n)  # -1 and one past: outside
    start = rng.integers(0, span, n)
    end = start + rng.integers(1, 300, n)
    return contig, start, end


@pytest.mark.parametrize("n_left,n_right", [(0, 50), (50, 0), (400, 300), (5_000, 2_000)])
def test_interval_functions_on_the_card_equal_the_cpu(cuda_device, n_left, n_right):
    """Every interval function and join on the card returns the CPU's
    tensors element for element, in order."""
    from adam_tpu_torch.models.dictionaries import SequenceDictionary, SequenceRecord
    from adam_tpu_torch.ops import intervals as iv
    from adam_tpu_torch.pipelines import region_join as rj

    sd = SequenceDictionary(tuple(SequenceRecord(f"c{i}", n)
                                  for i, n in enumerate((5_000, 0, 3_000))))
    lcols, rcols = _interval_columns(1, n_left), _interval_columns(2, n_right)
    res = {}
    for dev in ("cuda", "cpu"):
        left, right = rj.IntervalArrays.of(*lcols, device=dev), rj.IntervalArrays.of(
            *rcols, device=dev)
        out = [iv.sort_intervals(left.contig, left.start, left.end),
               *iv.merge_intervals(left.contig, left.start, left.end),
               *iv.merge_intervals(left.contig, left.start, left.end, adjacent=False),
               iv.point_depth(left.contig, left.start, left.end, right.contig, right.start),
               *rj.broadcast_region_join(left, right),
               *rj.broadcast_region_join(right, left),
               *rj.shuffle_region_join(left, right, sd, 700)]
        cov = rj.find_coverage_regions(left)
        out += [cov.contig, cov.start, cov.end]
        for t in out:
            assert t.device.type == dev and t.dtype == torch.int64
        res[dev] = [t.cpu() for t in out]
    for a, b in zip(res["cuda"], res["cpu"]):
        assert torch.equal(a, b)


def test_sharded_transform_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    """``transform_sharded`` in 4 shards on the card writes the CPU run's
    parts; kernel 1 launches once per observed shard (one row chunk each
    here) and once for the realigned part, kernel 2 never."""
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.parallel.sharded import transform_sharded

    path = str(tmp_path / "in.sam")
    make_wgs(path, 4500, 100, n_contigs=2, contig_len=30_000)
    stats = {dev: transform_sharded(path, str(tmp_path / dev), 4, batch_reads=1024,
                                    device=dev) for dev in ("cuda", "cpu")}
    launched = stats["cuda"]["kernel_launches"]
    assert launched["observe_hist"] == stats["cuda"]["n_observed"] == stats["cuda"]["n_shards"] + 1
    assert launched["pack_rows"] == launched["sw_fill"] == launched["sw_score"] == 0
    parts = sorted(f for f in os.listdir(tmp_path / "cpu") if f.startswith("part-"))
    assert len(parts) == stats["cpu"]["n_parts"] >= 4
    assert sorted(f for f in os.listdir(tmp_path / "cuda") if f.startswith("part-")) == parts
    for f in parts:
        assert (tmp_path / "cuda" / f).read_bytes() == (tmp_path / "cpu" / f).read_bytes()


@pytest.mark.parametrize("k", [5, 21])
def test_contig_kmers_on_the_card_equal_the_cpu(cuda_device, k):
    """``count_contig_kmers`` on the card: the table of the CPU run, entry
    for entry in the same order (fragments of 1 kb with N runs, windows
    across the joins included), and the CLI's k-mer file byte for byte,
    from a FASTA and from the fragment store."""
    import contextlib
    import io

    from adam_tpu_torch.cli.main import main
    from adam_tpu_torch.formats.fragments import FragmentBatch, count_contig_kmers

    rng = np.random.default_rng(k)
    seqs = []
    for L in (25_000, 9_999, 1_001, 30):
        s = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L)].copy()
        s[L // 3: L // 3 + 7] = ord("N")
        seqs.append(s.tobytes().decode())
    frags = FragmentBatch.from_sequences(list(enumerate(seqs)), 1_000)
    got = count_contig_kmers(frags, k, device="cuda")
    want = count_contig_kmers(frags, k, device="cpu")
    assert list(got.items()) == list(want.items())
    assert sum(got.values()) == sum(max(len(s) - k + 1, 0) for s in seqs)

    import tempfile

    with tempfile.TemporaryDirectory() as d:
        fa = os.path.join(d, "g.fa")
        with open(fa, "w") as fh:
            fh.write("".join(f">c{i}\n{s}\n" for i, s in enumerate(seqs)))
        out = {}
        with contextlib.redirect_stderr(io.StringIO()):
            assert main(["fasta2adam", fa, os.path.join(d, "g.adam"), "--device", "cpu"]) == 0
            for src in ("g.fa", "g.adam"):
                for dev in ("cuda", "cpu"):
                    path = os.path.join(d, f"{src}.{dev}.txt")
                    assert main(["count_contig_kmers", os.path.join(d, src), path, str(k),
                                 "--device", dev]) == 0
                    with open(path, "rb") as fh:
                        out[src, dev] = fh.read()
        assert len(set(out.values())) == 1 and out["g.fa", "cuda"].count(b"\n") == len(got)


@pytest.mark.parametrize("n,lmax,n_rg", [(256, 100, 2), (65_536, 100, 3)])
def test_transform_step_on_the_card_equals_the_cpu(cuda_device, n, lmax, n_rg):
    """``transform_step`` on the card launches kernel 1 once and equals,
    output for output, the CPU run with the plain version."""
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.pipelines.transform_step import (
        synthetic_batch,
        synthetic_masks,
        transform_step,
    )

    b = synthetic_batch(n, lmax, seed=n_rg)
    res, mm = synthetic_masks(b)
    before = kernels.launches()
    gout, gaux = transform_step(b, res, mm, n_rg, lmax, device="cuda")
    torch.cuda.synchronize()
    after = kernels.launches()
    assert after["observe_hist"] == before["observe_hist"] + 1
    assert after["pack_rows"] == before["pack_rows"]
    cout, caux = transform_step(b, res, mm, n_rg, lmax, device="cpu")
    assert gout.quals.device.type == "cuda"
    assert torch.equal(gout.quals.cpu(), cout.quals)
    for key in ("five_prime", "dup_score", "obs_total", "obs_mism"):
        assert torch.equal(gaux[key].cpu(), caux[key]), key
    assert gaux["flagstat"] == caux["flagstat"]
    assert int(caux["obs_total"].sum()) > 0


def test_spark_serve_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    """The Spark executor's ``serve`` on the card returns, for two
    partitions, the batches of the CPU run, with kernel 1 launched once
    per partition (the dataset-level BQSR of each)."""
    import io

    import pyarrow as pa
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.api.spark_executor import StageConfig, serve
    from adam_tpu_torch.io import context
    from adam_tpu_torch.ops import kernels

    sam = str(tmp_path / "in.sam")
    make_wgs(sam, 4000, 100, seed=9, n_contigs=2, contig_len=40_000)
    ds = context.load_alignments(sam)
    buf = io.BytesIO()
    writer = None
    for rows in (np.arange(0, 2000), np.arange(2000, ds.batch.n_rows)):
        rb = ds.take_rows(rows).to_arrow().combine_chunks().to_batches()[0]
        writer = writer or pa.ipc.new_stream(buf, rb.schema)
        writer.write_batch(rb)
    writer.close()
    out = {}
    for dev in ("cuda", "cpu"):
        cfg = StageConfig(mark_duplicates=True, realign=True, recalibrate=True, device=dev)
        sink = io.BytesIO()
        before = kernels.launches()["observe_hist"]
        assert serve(cfg, io.BytesIO(buf.getvalue()), sink) == 2
        out[dev] = list(pa.ipc.open_stream(io.BytesIO(sink.getvalue())))
        launched = kernels.launches()["observe_hist"] - before
        assert launched == (2 if dev == "cuda" else 0)
    assert len(out["cuda"]) == 2
    for got, want in zip(out["cuda"], out["cpu"]):
        assert got.equals(want)


#: Device-side names of the two main-path kernels' CUDA functions, as the
#: profiler reports them (each name is a substring of the demangled one).
OBSERVE_KERNEL_NAMES = ("count_kernel", "scatter_kernel", "accum_kernel")
PACK_KERNEL_NAMES = ("pack_kernel",)


def test_sample_hbm_is_keyed_by_the_cuda_index(cuda_device):
    from adam_tpu_torch.utils import telemetry as tele

    x = torch.ones(1 << 20, device=cuda_device)
    got = tele.sample_hbm()
    key = str(torch.cuda.current_device())
    assert key == "0" or torch.cuda.device_count() > 1
    assert got[key]["bytes_in_use"] >= x.numel() * 4
    assert got[key]["peak_bytes_in_use"] >= got[key]["bytes_in_use"]
    assert tele.sample_hbm([torch.device("cpu")]) == {}
    assert tele.sample_hbm([cuda_device])[key]["bytes_in_use"] >= x.numel() * 4


def test_device_trace_captures_a_kernel_1_launch(cuda_device, tmp_path):
    import json

    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.ops.observe import observe_hist
    from adam_tpu_torch.pipelines.bqsr import covariate_keys
    from adam_tpu_torch.utils import instrumentation as ins

    g, gl, n_rg = 256, 24, 3
    w = {k: v.to(cuda_device) for k, v in _window(5, g, gl, n_rg).items()}
    keys = covariate_keys(*(w[k] for k in _WINDOW), n_rg, gl)
    size = n_rg * 94 * (2 * gl + 1) * 17
    before = kernels.launches()["observe_hist"]
    with ins.device_trace(str(tmp_path / "xp")):
        observe_hist(keys, w["res_bits"], w["mm_bits"], w["read_ok"], size,
                     (2 * gl + 1) * 17)
        torch.cuda.synchronize()
    assert kernels.launches()["observe_hist"] == before + 1
    (f,) = list((tmp_path / "xp").iterdir())
    names = {e.get("name", "") for e in json.loads(f.read_text())["traceEvents"]}
    assert any(k in n for n in names for k in OBSERVE_KERNEL_NAMES), sorted(names)[:40]


def test_streamed_run_report_has_a_device_0_row(cuda_device, tmp_path):
    import contextlib
    import io
    import json

    from make_wgs_sam import make_wgs

    from adam_tpu_torch.cli.main import main
    from adam_tpu_torch.utils import instrumentation as ins
    from adam_tpu_torch.utils import telemetry as tele

    path = str(tmp_path / "in.sam")
    make_wgs(path, 4500, 100, n_contigs=2, contig_len=30_000)
    tele.TRACE.reset()
    ins.TIMERS.reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["transform", path, str(tmp_path / "o.adam"), "-streaming",
                   "-mark_duplicate_reads", "-recalibrate_base_qualities",
                   "-window_reads", "2048", "--report", str(tmp_path / "r.txt"),
                   "--metrics-json", str(tmp_path / "m.json"),
                   "--progress", str(tmp_path / "p.ndjson")])
    tele.TRACE.recording = ins.TIMERS.recording = False
    assert rc == 0
    key = str(torch.cuda.current_device())
    snap = json.loads((tmp_path / "m.json").read_text())
    assert key in snap["device_spans"][tele.SPAN_OBS_FETCH]
    assert snap["counters"][tele.C_READS_INGESTED] == 4500
    text = (tmp_path / "r.txt").read_text()
    rows = [ln.split() for ln in text.splitlines()]
    assert any(r and r[0] == key for r in rows), text
    beats = [json.loads(x) for x in (tmp_path / "p.ndjson").read_text().splitlines()]
    assert beats[-1]["done"] is True
    assert any(b["hbm_bytes_in_use"].get(key, 0) > 0 for b in beats)


def test_launch_runs_on_the_tensors_device_and_stream(cuda_device):
    """Kernel 1 launched inside ``torch.cuda.device(0)`` with a second
    stream current (a pool slot's scope): it queues on that stream and
    equals its plain version."""
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.ops.observe import observe_hist, observe_hist_plain
    from adam_tpu_torch.pipelines.bqsr import covariate_keys

    gl = 128
    w = _window(31, 4096, gl)
    keys = covariate_keys(*(w[n] for n in _WINDOW), 3, gl)
    args = (keys, w["res_bits"], w["mm_bits"], w["read_ok"])
    size, slab_w = 3 * 94 * (2 * gl + 1) * 17, (2 * gl + 1) * 17
    want = observe_hist_plain(*args, size)
    side = torch.cuda.Stream(torch.device("cuda", 0))
    kernels.reset_launches()
    with torch.cuda.device(0), torch.cuda.stream(side), kernels.slot_scope(1):
        on = [a.to("cuda:0") for a in args]
        got = observe_hist(*on, size, slab_w)
        done = torch.cuda.Event()
        done.record(side)
    done.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert kernels.device_launches()["observe_hist"] == {"cuda:0": 1}
    assert kernels.slot_launches()["observe_hist"] == {1: 1}


@pytest.fixture(scope="module")
def pool_sam(tmp_path_factory):
    from make_wgs_sam import make_wgs

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    d = tmp_path_factory.mktemp("pool_card")
    path = str(d / "in.sam")
    make_wgs(path, 65_536, 100, n_contigs=2, contig_len=2_000_000)
    return d, path


@pytest.mark.parametrize("partitioner", ["pool", "mesh"])
def test_two_slots_on_the_card_equal_one_device(pool_sam, partitioner):
    """A two-slot pool and a two-shard mesh over ``cuda:0``, 65,536 reads:
    the parts of the one-device run, with kernel 1 and kernel 2 launched
    from both slots."""
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.parallel import device_pool as dp
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    d, path = pool_sam
    one = d / "one"
    if not one.exists():
        transform_streamed(path, str(one), window_reads=16_384, device="cuda")
    out = d / partitioner
    kernels.reset_launches()
    stats = transform_streamed(path, str(out), window_reads=16_384,
                               partitioner=partitioner,
                               device_pool=dp.DevicePool(dp.make_slots(["cuda:0", "cuda:0"])))
    assert stats["partitioner"] == partitioner and stats["n_devices"] == 2
    per_slot = kernels.slot_launches()
    assert set(per_slot["observe_hist"]) == {0, 1}
    assert set(per_slot["pack_rows"]) == {0, 1}
    parts = sorted(f for f in os.listdir(one) if f.startswith("part-"))
    assert parts and parts == sorted(f for f in os.listdir(out) if f.startswith("part-"))
    for f in parts:
        assert (out / f).read_bytes() == (one / f).read_bytes(), f


def test_launch_counts_are_exact_under_threads(cuda_device):
    """Eight threads launch ``pack_rows`` 200 times each: every count the
    wrappers keep (total, per device, per variant) is exactly 1,600."""
    import threading

    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.ops.colpack import pack_rows

    mat = torch.randint(0, 60, (64, 32), dtype=torch.uint8, device="cuda")
    lens = torch.randint(0, 33, (64,), dtype=torch.int64, device="cuda")
    kernels.reset_launches()
    pack_rows(mat, lens, 64 * 32, encode="sanger")  # build and load first
    kernels.reset_launches()
    errors = []

    def hammer():
        try:
            for _ in range(200):
                pack_rows(mat, lens, 64 * 32, encode="sanger")
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    try:
        for t in threads:
            t.start()
    finally:
        for t in threads:
            t.join(120)
    torch.cuda.synchronize()
    assert not errors and not any(t.is_alive() for t in threads)
    assert kernels.launches()["pack_rows"] == 1600
    assert kernels.device_launches()["pack_rows"] == {"cuda:0": 1600}
    assert kernels.variant_launches()["pack_rows:sanger"] == 1600


def _tickets(seed, n_rgs, g, gl, device):
    """One ticket per entry of ``n_rgs``: its window's five columns, its
    masks, has_qual/valid, and its own table, on ``device``."""
    out = []
    for k, n_rg in enumerate(n_rgs):
        w = _window(seed + k, g, gl, n_rg=n_rg)
        out.append({n: v.to(device) for n, v in w.items()})
    return out


@pytest.mark.parametrize("n_rgs", [(3, 4), (7,) * 8], ids=["two_tickets", "n_rg_56"])
def test_fused_observe_on_the_card_equals_solo_dispatches(cuda_device, n_rgs):
    """The coalescer's fused observe on the card, one ``observe_hist``
    launch over every ticket, against one solo observe per ticket on the
    card and the plain version on the CPU: each band bit for bit.  Eight
    tickets of 7 read-group bins (n_rg = 56, 5,264 slabs) take the kernel's
    grouped route."""
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.pipelines.bqsr import observe_packed_body
    from adam_tpu_torch.serve.batching import fused_observe_body

    g, gl = 2048, 128
    tickets = _tickets(50, n_rgs, g, gl, "cuda")
    segs, base = [], 0
    for n in n_rgs:
        segs.append((base, n))
        base += n
    cols = tuple(tuple(t[n] for n in _WINDOW) for t in tickets)
    masks = tuple((t["res_bits"], t["mm_bits"], t["read_ok"]) for t in tickets)
    kernels.reset_launches()
    total, mism = fused_observe_body(cols, masks, tuple(segs), base, gl)
    assert kernels.launches()["observe_hist"] == 1
    cpu_t, cpu_m = fused_observe_body(
        tuple(tuple(x.cpu() for x in c) for c in cols),
        tuple(tuple(x.cpu() for x in m) for m in masks), tuple(segs), base, gl)
    assert torch.equal(total.cpu(), cpu_t) and torch.equal(mism.cpu(), cpu_m)
    for t, (b0, n) in zip(tickets, segs):
        st, sm = observe_packed_body(*(t[x] for x in _WINDOW), t["res_bits"],
                                     t["mm_bits"], t["read_ok"], n, gl)
        assert torch.equal(total[b0:b0 + n], st) and torch.equal(mism[b0:b0 + n], sm)


@pytest.mark.parametrize("n_rgs", [(3, 4), (7,) * 8], ids=["two_tickets", "n_rg_56"])
def test_fused_apply_on_the_card_equals_solo_dispatches(cuda_device, n_rgs):
    """The fused apply on the card: one table gather over the concatenated
    tables and one ``pack_rows`` launch per column over every ticket; each
    ticket's byte range is its solo apply's packed bytes."""
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.pipelines.bqsr import apply_pack2_body
    from adam_tpu_torch.serve.batching import fused_apply_body

    g, gl = 2048, 128
    tickets = _tickets(80, n_rgs, g, gl, "cuda")
    segs, base = [], 0
    for n in n_rgs:
        segs.append((base, n))
        base += n
    table = torch.cat([t["table"] for t in tickets], dim=0)
    cols = tuple(tuple(t[n] for n in _WINDOW) for t in tickets)
    extras = tuple((t["has_qual"], t["valid"]) for t in tickets)
    size = g * gl * len(tickets)
    kernels.reset_launches()
    pq, pb = fused_apply_body(cols, extras, table, tuple(segs), gl, size)
    assert kernels.launches()["pack_rows"] == 2
    oq = ob = 0
    for t in tickets:
        sq, sb = apply_pack2_body(*(t[x] for x in _WINDOW), t["has_qual"], t["valid"],
                                  t["table"], gl, g * gl)
        lens = t["lengths"].to(torch.int64)
        nq = int(torch.where(t["valid"] & t["has_qual"], lens, 0).sum())
        nb = int(torch.where(t["valid"], lens, 0).sum())
        assert torch.equal(pq[oq:oq + nq], sq[:nq]) and torch.equal(pb[ob:ob + nb], sb[:nb])
        oq += nq
        ob += nb


def test_service_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    """Two jobs through the batched scheduler on the card and on the CPU:
    the same parts, the fused dispatches on the card going through kernels
    1 and 2, and no fallback."""
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.serve import JobScheduler, JobSpec
    from adam_tpu_torch.utils import telemetry as tele

    inputs = {}
    for k, seed in (("ca", 31), ("cb", 32)):
        inputs[k] = str(tmp_path / f"{k}.sam")
        make_wgs(inputs[k], 8192, 100, n_contigs=2, contig_len=200_000, seed=seed)
    outs = {}
    for device in ("cpu", "cuda"):
        tele.TRACE.reset()
        kernels.reset_launches()
        sched = JobScheduler(str(tmp_path / f"root-{device}"), max_jobs=2, batching=True,
                             device=device)
        try:
            for k, inp in inputs.items():
                sched.submit(JobSpec(job_id=k, input=inp, output=str(tmp_path / f"{device}-{k}"),
                                     tenant=k, window_reads=2048))
            assert sched.wait(timeout=600)
            assert {v["state"] for v in sched.status()["jobs"].values()} == {"done"}
        finally:
            sched.close()
        c, _ = tele.TRACE.counters_and_gauges()
        assert c["sched.batch.dispatches"] >= 1 and c.get("sched.batch.fallbacks", 0) == 0
        if device == "cuda":
            assert kernels.launches()["observe_hist"] >= 1
            assert kernels.launches()["pack_rows"] >= 2
        outs[device] = {k: sorted(os.listdir(tmp_path / f"{device}-{k}")) for k in inputs}
    assert outs["cpu"] == outs["cuda"]
    for k, names in outs["cpu"].items():
        for f in names:
            if f.startswith("part-"):
                assert (tmp_path / f"cuda-{k}" / f).read_bytes() == \
                    (tmp_path / f"cpu-{k}" / f).read_bytes(), (k, f)
