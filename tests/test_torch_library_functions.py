"""The public functions the ported modules lacked, each against its JAX
twin on the same seeded inputs, exact (every result here is an integer,
a boolean, a string or an f64 table the two packages compute with the
same operations): the CIGAR walks and the phred conversions on tensors,
``ReadBatch.flag_set``/``is_primary``/``pad_rows``,
``SequenceDictionary.from_lists``, ``regions_from_arrays``,
``SnpTable.contains``, BQSR's ``observe_kernel``, ``recalibrate_kernel``,
``recalibration_phred_table`` and ``build_observation_table``,
``load_vcf``/``load_genotypes``, ``iter_sam_records``, and realignment's
``extract_indel_events`` with the faithful target mapping
(``map_reads_to_targets``, ``map_batch_to_targets(mode="faithful")``,
``realign_indels(target_mapping="faithful")``)."""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))


def _random_cigars(seed: int, n: int = 200) -> list:
    """Seeded CIGARs: clips at either end (S, H), M/=/X blocks, I, D, N, P."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        parts = []
        if rng.random() < 0.3:
            parts.append(f"{rng.integers(1, 4)}H")
        if rng.random() < 0.4:
            parts.append(f"{rng.integers(1, 9)}S")
        for _k in range(rng.integers(1, 5)):
            parts.append(f"{rng.integers(1, 30)}{rng.choice(list('M=X'))}")
            if rng.random() < 0.5:
                parts.append(f"{rng.integers(1, 6)}{rng.choice(list('IDNP'))}")
        parts.append(f"{rng.integers(1, 20)}M")
        if rng.random() < 0.4:
            parts.append(f"{rng.integers(1, 9)}S")
        if rng.random() < 0.3:
            parts.append(f"{rng.integers(1, 4)}H")
        out.append("".join(parts))
    out += ["*", "10S", "5H3S"]  # no alignment block at all
    return out


def _cigar_batches(seed: int):
    from adam_tpu.formats import schema as jschema
    from adam_tpu.formats.batch import pack_reads as jpack

    from adam_tpu_torch.formats.batch import pack_reads

    rng = np.random.default_rng(seed + 1)
    recs = []
    for i, c in enumerate(_random_cigars(seed)):
        qlen = jschema.cigar_str_stats(c)[0] if c != "*" else 10
        recs.append(dict(name=f"r{i}", flags=int(rng.choice([0, 16, 0x4])), contig_idx=0,
                         start=int(rng.integers(0, 10_000)), mapq=60, cigar=c,
                         seq="A" * max(qlen, 1), qual=None))
    return jpack(recs)[0], pack_reads(recs)[0]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fn", ["reference_length", "query_length", "leading_clip",
                                "trailing_clip", "unclipped_start", "unclipped_end",
                                "five_prime_position", "first_real_op",
                                "reference_positions"])
def test_cigar_walks_equal_jax(seed, fn):
    import jax.numpy as jnp

    from adam_tpu.ops import cigar as jc

    from adam_tpu_torch.ops import cigar as tc

    jb, tb = _cigar_batches(seed)
    cols = ("cigar_ops", "cigar_lens", "cigar_n")
    jargs = [jnp.asarray(getattr(jb, c)) for c in cols]
    targs = [_t(getattr(tb, c)) for c in cols]
    if fn == "first_real_op":
        jargs, targs = [jargs[0], jargs[2]], [targs[0], targs[2]]
    elif fn in ("unclipped_start", "unclipped_end"):
        col = "start" if fn == "unclipped_start" else "end"
        jargs = [jnp.asarray(getattr(jb, col))] + jargs
        targs = [_t(getattr(tb, col))] + targs
    elif fn == "five_prime_position":
        jargs = [jnp.asarray(getattr(jb, c)) for c in ("start", "end", "flags")] + jargs
        targs = [_t(getattr(tb, c)) for c in ("start", "end", "flags")] + targs
    elif fn == "reference_positions":
        lmax = tb.lmax + 3
        jargs = jargs + [jnp.asarray(jb.start), lmax]
        targs = targs + [_t(tb.start), lmax]
    want = np.asarray(getattr(jc, fn)(*jargs))
    got = getattr(tc, fn)(*targs).numpy()
    if fn == "first_real_op":
        got, want = got.astype(np.int64), want.astype(np.int64)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)
    if fn == "reference_positions":  # the native host walk agrees as well
        np.testing.assert_array_equal(
            tc.reference_positions_np(tb.cigar_ops, tb.cigar_lens, tb.cigar_n, tb.start,
                                      tb.lmax + 3), want)


def test_cigar_walks_on_jax_test_cases():
    """``tests/test_ops.py``'s hand-checked values."""
    from adam_tpu_torch.formats import schema
    from adam_tpu_torch.formats.batch import pack_reads
    from adam_tpu_torch.ops import cigar as tc

    cigs = ["10M", "2S8M", "3M2I3M2D2M", "2H4M3S"]
    recs = [dict(name=f"r{i}", flags=0, contig_idx=0, start=100, mapq=60, cigar=c,
                 seq="A" * schema.cigar_str_stats(c)[0], qual=None)
            for i, c in enumerate(cigs)]
    b = pack_reads(recs)[0].to("cpu")
    args = (b.cigar_ops, b.cigar_lens, b.cigar_n)
    assert tc.reference_length(*args).tolist() == [10, 8, 10, 4]
    assert tc.query_length(*args).tolist() == [10, 10, 10, 7]
    assert tc.leading_clip(*args).tolist() == [0, 2, 0, 2]
    assert tc.trailing_clip(*args).tolist() == [0, 0, 0, 3]
    assert tc.unclipped_start(b.start, *args).tolist() == [100, 98, 100, 98]


@pytest.mark.parametrize("fn", ["phred_to_error_probability", "phred_to_success_probability",
                                "error_probability_to_phred",
                                "success_probability_to_phred"])
def test_phred_conversions_equal_jax(fn):
    import jax.numpy as jnp

    from adam_tpu.ops import phred as jp

    from adam_tpu_torch.ops import phred as tp

    rng = np.random.default_rng(3)
    if fn.startswith("phred_to"):
        x = np.concatenate([np.arange(-3, 260), rng.integers(0, 94, 500)]).astype(np.int32)
    else:
        x = np.concatenate([10.0 ** (-np.arange(0, 94) / 10.0), rng.random(500),
                            [0.0005, 0.001, 0.999, 1.0, 0.0]])
    want = np.asarray(getattr(jp, fn)(jnp.asarray(x)))
    got = getattr(tp, fn)(x).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert int(tp.error_probability_to_phred(0.0005)) == 33
    assert int(tp.success_probability_to_phred(0.999)) == 30


def _synth_batches(seed: int, n: int = 64):
    """The same host batch in both packages, with varied flags."""
    from adam_tpu.formats.batch import ReadBatch as JB

    from adam_tpu_torch.pipelines.transform_step import synthetic_batch

    tb = synthetic_batch(n, 30, seed=seed)
    rng = np.random.default_rng(seed)
    tb = tb.replace(flags=rng.integers(0, 4096, n).astype(np.int32))
    return JB(**tb.arrays()), tb


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_flag_helpers_and_pad_rows_equal_jax(seed):
    jb, tb = _synth_batches(seed)
    for bit in (0x1, 0x4, 0x10, 0x100, 0x400, 0x800):
        np.testing.assert_array_equal(tb.flag_set(bit), np.asarray(jb.flag_set(bit)))
        np.testing.assert_array_equal(tb.to("cpu").flag_set(bit).numpy(),
                                      np.asarray(jb.flag_set(bit)))
    np.testing.assert_array_equal(tb.is_primary, np.asarray(jb.is_primary))
    for n in (64, 65, 100):
        got, want = tb.pad_rows(n), jb.pad_rows(n)
        assert got.n_rows == n
        for k, v in got.arrays().items():
            w = np.asarray(getattr(want, k))
            assert v.dtype == w.dtype, k
            np.testing.assert_array_equal(v, w, err_msg=k)
    with pytest.raises(ValueError, match="cannot pad 64 rows down to 10"):
        tb.pad_rows(10)
    from adam_tpu_torch.formats.batch import ReadBatch

    assert ReadBatch.empty().pad_rows(5).n_valid() == 0


def test_sequence_dictionary_and_regions_equal_jax():
    from adam_tpu.models import dictionaries as jd
    from adam_tpu.models import positions as jpos

    from adam_tpu_torch.models import dictionaries as td
    from adam_tpu_torch.models import positions as tpos

    names, lengths = ["chr1", "chr2", "chrM"], np.array([5000, 2500, 16571])
    got, want = td.SequenceDictionary.from_lists(names, lengths), \
        jd.SequenceDictionary.from_lists(names, lengths)
    assert [dataclasses.astuple(r) for r in got.records] == \
        [dataclasses.astuple(r) for r in want.records]
    assert got.names == want.names and got["chr2"].length == want["chr2"].length == 2500
    assert "chrM" in got and "chrX" not in got
    with pytest.raises(KeyError):
        got["chrX"]
    rng = np.random.default_rng(5)
    starts = rng.integers(0, 1000, 50)
    ends = starts + rng.integers(0, 100, 50)
    rn = [names[i] for i in rng.integers(0, 3, 50)]
    assert [dataclasses.astuple(r) for r in tpos.regions_from_arrays(rn, starts, ends)] == \
        [dataclasses.astuple(r) for r in jpos.regions_from_arrays(rn, starts, ends)]


@pytest.fixture(scope="module")
def wgs(tmp_path_factory):
    from make_wgs_sam import make_wgs

    from adam_tpu.io import context as jctx

    from adam_tpu_torch.io import context as tctx

    d = tmp_path_factory.mktemp("libfns")
    sam = str(d / "in.sam")
    make_wgs(sam, 3000, 100, seed=13, n_contigs=2, contig_len=30_000,
             known_sites_out=str(d / "snps.vcf"))
    return d, jctx.load_alignments(sam), tctx.load_alignments(sam)


def test_snp_table_contains_equals_jax(wgs):
    from adam_tpu.models.snp_table import SnpTable as JS

    from adam_tpu_torch.models.snp_table import SnpTable as TS

    d, _, _ = wgs
    js, ts = JS.from_file(str(d / "snps.vcf")), TS.from_file(str(d / "snps.vcf"))
    rng = np.random.default_rng(0)
    for contig in ("chr17", "chr18", "chrZ"):
        for pos in list(js.table.get(contig, [])[:50]) + list(rng.integers(0, 30_000, 200)):
            assert ts.contains(contig, int(pos)) is bool(js.contains(contig, int(pos)))
    assert sum(ts.contains("chr17", int(p)) for p in js.table["chr17"]) == len(js.table["chr17"])


@pytest.mark.parametrize("known", [False, True])
def test_build_observation_table_equals_jax(wgs, known):
    from adam_tpu.models.snp_table import SnpTable as JS
    from adam_tpu.pipelines import bqsr as jb

    from adam_tpu_torch.models.snp_table import SnpTable as TS
    from adam_tpu_torch.pipelines import bqsr as tb

    d, jds, tds = wgs
    snps = str(d / "snps.vcf")
    want = jb.build_observation_table(jds, JS.from_file(snps) if known else None)
    got = tb.build_observation_table(tds, TS.from_file(snps) if known else None,
                                     device="cpu")
    np.testing.assert_array_equal(got.total, np.asarray(want.total))
    np.testing.assert_array_equal(got.mismatches, np.asarray(want.mismatches))
    assert got.rg_names == want.rg_names and got.lmax == want.lmax
    assert got.to_csv() == want.to_csv()
    assert int(got.total.sum()) > 0


def test_recalibration_phred_table_equals_jax(wgs):
    import jax.numpy as jnp

    from adam_tpu.pipelines import bqsr as jb

    from adam_tpu_torch.pipelines import bqsr as tb

    _, jds, tds = wgs
    obs = tb.build_observation_table(tds, device="cpu")
    rng = np.random.default_rng(1)
    sparse_t = rng.integers(0, 3, obs.total.shape) * (rng.random(obs.total.shape) < 0.01)
    sparse_m = np.minimum(sparse_t, rng.integers(0, 2, obs.total.shape))
    for total, mism in ((obs.total, obs.mismatches), (sparse_t, sparse_m),
                        (np.zeros_like(obs.total), np.zeros_like(obs.total))):
        want = np.asarray(jb.recalibration_phred_table(jnp.asarray(total), jnp.asarray(mism)))
        got = tb.recalibration_phred_table(torch.from_numpy(total), torch.from_numpy(mism))
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)


def _kernel_inputs(seed: int, n: int = 200, lmax: int = 48, n_rg: int = 3):
    rng = np.random.default_rng(seed)
    return dict(
        bases=rng.integers(0, 6, (n, lmax)).astype(np.uint8),
        quals=rng.integers(0, 60, (n, lmax)).astype(np.uint8),
        lengths=rng.integers(1, lmax + 1, n).astype(np.int32),
        flags=rng.integers(0, 256, n).astype(np.int32),
        rg=rng.integers(-1, n_rg - 1, n).astype(np.int32),
        residue_ok=rng.random((n, lmax)) < 0.7,
        is_mm=rng.random((n, lmax)) < 0.1,
        read_ok=rng.random(n) < 0.8,
        has_qual=rng.random(n) < 0.9,
        valid=rng.random(n) < 0.95,
    ), n_rg, lmax


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_observe_and_recalibrate_kernels_equal_jax(seed):
    import jax.numpy as jnp

    from adam_tpu.pipelines import bqsr as jb

    from adam_tpu_torch.pipelines import bqsr as tb

    k, n_rg, lmax = _kernel_inputs(seed)
    head = ("bases", "quals", "lengths", "flags", "rg")
    jt, jm = jb.observe_kernel(*(jnp.asarray(k[c]) for c in head + (
        "residue_ok", "is_mm", "read_ok")), n_rg, lmax)
    tt, tm = tb.observe_kernel(*(_t(k[c]) for c in head + ("residue_ok", "is_mm",
                                                           "read_ok")), n_rg, lmax)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    want = jb.recalibrate_kernel(*(jnp.asarray(k[c]) for c in head + ("has_qual", "valid")),
                                 jt, jm, lmax)
    got = tb.recalibrate_kernel(*(_t(k[c]) for c in head + ("has_qual", "valid")), tt, tm,
                                lmax)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pack_bits_is_numpy_packbits():
    from adam_tpu_torch.ops.observe import pack_bits, unpack_bits

    rng = np.random.default_rng(2)
    for shape in ((5, 1), (7, 8), (9, 13), (3, 100)):
        m = rng.random(shape) < 0.5
        got = pack_bits(torch.from_numpy(m))
        np.testing.assert_array_equal(got.numpy(), np.packbits(m, axis=1))
        assert torch.equal(unpack_bits(got, shape[1]), torch.from_numpy(m))


def test_load_vcf_and_genotypes_equal_jax(wgs, tmp_path):
    from adam_tpu.io import context as jctx

    from adam_tpu_torch.io import context as tctx

    d, _, _ = wgs
    vcf = str(d / "snps.vcf")
    for fn in ("load_vcf", "load_genotypes"):
        want, got = getattr(jctx, fn)(vcf), getattr(tctx, fn)(vcf)
        assert type(got).__name__ == "GenotypeDataset"
        assert got.contig_names == want.contig_names and len(got) == len(want) > 0
        for f in ("contig_idx", "start", "end", "ref_len", "alt_len", "qual"):
            np.testing.assert_array_equal(getattr(got.variants, f),
                                          np.asarray(getattr(want.variants, f)), err_msg=f)
        assert list(got.variants.sidecar.alt_allele) == list(want.variants.sidecar.alt_allele)
    names = ["chr18", "chr17", "chrX"]
    got = tctx.load_vcf(vcf, contig_names=names)
    want = jctx.load_vcf(vcf, contig_names=names)
    np.testing.assert_array_equal(got.variants.contig_idx, np.asarray(want.variants.contig_idx))
    got.save(str(tmp_path / "g"))  # the store loads back through the same call
    again = tctx.load_genotypes(str(tmp_path / "g"))
    np.testing.assert_array_equal(again.variants.start, got.variants.start)


def test_iter_sam_records_equals_jax(wgs):
    from adam_tpu.io import sam as jsam

    from adam_tpu_torch.io import sam as tsam

    d, jds, tds = wgs
    lines = (d / "in.sam").read_text().splitlines()
    extra = [
        "x1\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\t*",
        "x2\t1\tchr17\t5\t60\t4M\t=\t9\t8\tACGT\tIIII\tRG:Z:nope\tOQ:Z:####\tMD:Z:4\tXA:i:1",
        "x3\t65\tchr18\t5\t60\t4M\tchr17\t9\t0\tACGT\tIIII\tRG:Z:rg1\tRG:Z:rg2",
    ]
    want = list(jsam.iter_sam_records(lines + extra, jds.header))
    got = list(tsam.iter_sam_records(lines + extra, tds.header))
    assert got == want and len(got) == 3000 + 3


@pytest.mark.parametrize("max_indel", [500, 3])
def test_extract_indel_events_equals_jax(wgs, max_indel):
    from adam_tpu.pipelines import realign as jra

    from adam_tpu_torch.pipelines import realign as tra

    _, jds, tds = wgs
    want = jra.extract_indel_events(jds.batch.to_numpy(), max_indel)
    got = tra.extract_indel_events(tds.batch.to_numpy(), max_indel)
    assert [vars(t) for t in got] == [vars(t) for t in want] and len(got) > 10
    names = tds.seq_dict.names
    for events in (got, got[::-1], []):  # merge_events takes the object form too
        merged = tra.merge_events(events, names, 3000)
        assert [vars(t) for t in merged] == \
            [vars(t) for t in jra.merge_events([jra.RealignmentTarget(**vars(t))
                                                for t in events], names, 3000)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_map_reads_to_targets_equals_jax(seed):
    from adam_tpu.pipelines import realign as jra

    from adam_tpu_torch.pipelines import realign as tra

    rng = np.random.default_rng(seed)
    nt = int(rng.integers(1, 40))
    t_rank = np.sort(rng.integers(0, 3, nt))
    t_start = np.sort(rng.integers(0, 20_000, nt))
    t_end = t_start + rng.integers(10, 400, nt)
    n = 500
    r_rank = rng.integers(-1, 3, n)
    r_start = np.where(r_rank >= 0, rng.integers(0, 20_000, n), -1)
    r_end = r_start + 100
    mapped = r_rank >= 0
    args = (r_rank, r_start, r_end, mapped, t_rank, t_start, t_end)
    got = tra.map_reads_to_targets(*args)
    np.testing.assert_array_equal(got, jra.map_reads_to_targets(*args))
    np.testing.assert_array_equal(tra.map_reads_to_targets_overlap(*args),
                                  jra.map_reads_to_targets_overlap(*args))
    assert (got[~mapped] == -1).all()


@pytest.mark.parametrize("mode", ["faithful", "overlap"])
def test_map_batch_and_realign_with_target_mapping_equal_jax(wgs, mode):
    from adam_tpu.pipelines import realign as jra

    from adam_tpu_torch.pipelines import realign as tra

    _, jds, tds = wgs
    names = tds.seq_dict.names
    targets, jtargets = tra.find_targets(tds), jra.find_targets(jds)
    got = tra.map_batch_to_targets(tds.batch.to_numpy(), targets, names, mode=mode)
    want = jra.map_batch_to_targets(jds.batch.to_numpy(), jtargets, names, mode=mode)
    np.testing.assert_array_equal(got, want)
    out = tra.realign_indels(tds, target_mapping=mode, device="cpu")
    jout = jra.realign_indels(jds, target_mapping=mode)
    assert out.to_arrow().equals(jout.to_arrow())
    if mode == "faithful":  # the reference's search drops most overlapping reads
        overlap = tra.map_batch_to_targets(tds.batch.to_numpy(), targets, names)
        assert (got >= 0).sum() < (overlap >= 0).sum()
        assert not out.to_arrow().equals(tra.realign_indels(tds, device="cpu").to_arrow())
    with pytest.raises(ValueError, match="target mapping"):
        tra.realign_indels(tds, target_mapping="nearest", device="cpu")
