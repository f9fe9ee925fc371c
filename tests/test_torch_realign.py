"""Realignment parity: the port's indel realignment on the CPU equals the
JAX package's on the same WGS-shaped SAM — the MD engine, the targets,
the f32 sweep, and the realigned batches (columns, MD and attributes)
under both consensus models.

The ``smithwaterman`` comparison is against the JAX package's Python path
with one repair applied by a wrapper inside the test, never in
``adam_tpu``: its ``_sw_preprocess`` keeps a rewritten read's stale
implied reference, so the left-normalization after it can walk the new
CIGAR over the old reference and raise ``IndexError``
(``test_jax_smithwaterman_crashes_without_the_refresh`` pins that crash
on this input).  The port refreshes the reference from the read's new MD,
and the wrapper does the same to the JAX output."""

import pathlib
import random
import sys

import numpy as np
import pytest
import torch

from adam_tpu.io import load_alignments
from adam_tpu.ops import mdtag as jmd
from adam_tpu.pipelines import realign as jra

from adam_tpu_torch.api.datasets import AlignmentDataset
from adam_tpu_torch.formats import schema
from adam_tpu_torch.io.sam import iter_sam_batches
from adam_tpu_torch.ops import mdtag as tmd
from adam_tpu_torch.pipelines import realign as tra

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

READS_N = 4500   # the reads model's input
SW_N = 2500      # the smithwaterman model's input (the JAX path compiles per shape)


def _port_ds(path):
    (batch, side, header), = list(iter_sam_batches(path, 1 << 30))
    return AlignmentDataset(batch, side, header)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from make_wgs_sam import make_wgs

    d = tmp_path_factory.mktemp("realign")
    out = {}
    for n in (READS_N, SW_N):
        path = str(d / f"in{n}.sam")
        make_wgs(path, n, 100, n_contigs=2, contig_len=30_000)
        out[n] = (load_alignments(path), _port_ds(path))
        out["sam", n] = path
    return out


def _refreshing(orig):
    """The JAX ``_sw_preprocess`` with the port's repair: a read it
    rewrites gets its implied reference from its new MD."""

    def wrapped(reads, reference, ref_start, weights):
        out = orig(reads, reference, ref_start, weights)
        return [
            new if new is old
            else jra.dc_replace(new, ref=new.md.get_reference(new.seq, new.cigar))
            for old, new in zip(reads, out)
        ]

    return wrapped


def _assert_same_dataset(want, got):
    bw, bg = want.batch.to_numpy(), got.batch.to_numpy()
    for f in ("start", "end", "mapq", "cigar_n", "flags", "cigar_ops", "cigar_lens",
              "bases", "quals", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(bw, f)),
                                      np.asarray(getattr(bg, f)), err_msg=f)
    assert list(want.sidecar.md) == list(got.sidecar.md)
    assert list(want.sidecar.attrs) == list(got.sidecar.attrs)


# ------------------------------------------------------------- MD engine


def _md_cases(ds, n=200):
    """The first ``n`` rows with an MD tag and every row with an indel."""
    b = ds.batch.to_numpy()
    has = [i for i in range(b.n_rows) if ds.sidecar.md[i] is not None and b.cigar_n[i] > 0]
    indel = np.isin(b.cigar_ops, (schema.CIGAR_I, schema.CIGAR_D)).any(axis=1)
    for i in sorted(set(has[:n]) | {i for i in has if indel[i]}):
        cig = schema.decode_cigar(b.cigar_ops[i], b.cigar_lens[i], int(b.cigar_n[i]))
        seq = schema.decode_bases(b.bases[i], int(b.lengths[i]))
        yield ds.sidecar.md[i], int(b.start[i]), seq, cig


def test_mdtag_methods_equal_jax(inputs):
    _, ds = inputs[READS_N]
    n_indel = 0
    for md, start, seq, cig in _md_cases(ds):
        assert tmd.parse_cigar(cig) == jmd.parse_cigar(cig)
        t, j = tmd.MdTag.parse(md, start), jmd.MdTag.parse(md, start)
        assert (t.to_string(), t.end(), t.matches, t.mismatches, t.deletions) == \
            (j.to_string(), j.end(), j.matches, j.mismatches, j.deletions)
        assert t.to_string() == md
        ref = t.get_reference(seq, cig)
        assert ref == j.get_reference(seq, cig)
        assert t.from_alignment(seq, ref, cig, start) == t
        assert str(jmd.MdTag.from_alignment(seq, ref, cig, start)) == str(t)
        moved = tmd.MdTag.move_alignment(ref, seq, cig, start)
        assert moved.to_string() == jmd.MdTag.move_alignment(ref, seq, cig, start).to_string()
        assert moved == t
        n_indel += ("I" in cig) or ("D" in cig)
    assert n_indel > 5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mdtag_on_seeded_strings(seed):
    rng = random.Random(seed)
    for _ in range(50):
        parts = [str(rng.randrange(0, 30))]
        for _ in range(rng.randrange(0, 6)):
            if rng.random() < 0.3:
                parts.append("^" + "".join(rng.choice("ACGTN") for _ in range(rng.randrange(1, 4))))
            else:
                parts.append(rng.choice("ACGTNR"))
            parts.append(str(rng.randrange(0, 20)))
        md = "".join(parts)
        start = rng.randrange(0, 10_000)
        t, j = tmd.MdTag.parse(md, start), jmd.MdTag.parse(md, start)
        assert (t.to_string(), t.end(), t == tmd.MdTag.parse(t.to_string(), start)) == \
            (j.to_string(), j.end(), j == jmd.MdTag.parse(j.to_string(), start))


def test_batch_md_arrays_equal_jax(inputs):
    ds_j, ds = inputs[READS_N]
    got = tmd.batch_md_arrays(ds.batch, ds.sidecar, need_ref_codes=True)
    want = jmd.batch_md_arrays(ds_j.batch, ds_j.sidecar, need_ref_codes=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tmd.batch_md_arrays(ds.batch, ds.sidecar, need_ref_codes=False)[1] is None


# ---------------------------------------------------------------- targets


def test_targets_and_mapping_equal_jax(inputs):
    ds_j, ds = inputs[READS_N]
    b, bj = ds.batch.to_numpy(), ds_j.batch.to_numpy()
    ev = tra.extract_indel_event_arrays(b)
    np.testing.assert_array_equal(ev, jra.extract_indel_event_arrays(bj))
    names = ds.seq_dict.names
    # events merged in windows' order (the streamed barrier) and at once
    for events in (ev, np.concatenate([ev[1::2], ev[::2]])):
        got = tra.merge_events(events, names, 3000)
        want = jra.merge_events(events, names, 3000)
        assert [vars(t) for t in got] == [vars(t) for t in want]
    targets = tra.find_targets(ds)
    assert [vars(t) for t in targets] == [vars(t) for t in jra.find_targets(ds_j)]
    assert len(targets) > 10
    np.testing.assert_array_equal(
        tra.map_batch_to_targets(b, targets, names),
        jra.map_batch_to_targets(bj, jra.find_targets(ds_j), names, mode="overlap"),
    )
    cand, rest, n_valid = tra.split_realign_candidates(ds, targets, names)
    cand_j, rest_j, n_valid_j = jra.split_realign_candidates(
        ds_j, jra.find_targets(ds_j), names)
    assert n_valid == n_valid_j and cand.batch.n_rows == cand_j.batch.n_rows > 0
    _assert_same_dataset(cand_j, cand)
    np.testing.assert_array_equal(rest.batch.valid, np.asarray(rest_j.batch.valid))


def test_resolve_tuning_equals_jax():
    for args in [(None,) * 4, (10, 5, 2.5, 900)]:
        assert tra.resolve_tuning(*args) == jra.resolve_tuning(*args)


# ------------------------------------------------------------------ sweep


def _sweep_inputs(seed, rt, lr, off, n, read_len, cons_len, qual=40):
    rng = np.random.default_rng(seed)
    # periodic for its first 60% (a periodic read ties at every 5th
    # offset there), mutated after
    cons = np.tile(np.array([0, 1, 2, 3, 1], np.uint8), cons_len // 5 + 1)[:cons_len]
    mut = rng.random(cons_len) < 0.3
    mut[: int(cons_len * 0.6)] = False
    cons[mut] = rng.integers(0, 5, int(mut.sum()))
    rc = np.full((rt, lr), schema.BASE_PAD, np.uint8)
    rq = np.zeros((rt, lr), np.uint8)
    rl = np.zeros(rt, np.int32)
    pm = np.zeros(rt, bool)
    for i in range(n):
        s = int(rng.integers(0, cons_len - read_len))
        r = cons[s:s + read_len].copy()
        if i % 3 == 1:
            r = np.tile(np.array([0, 1, 2, 3, 1], np.uint8), read_len // 5 + 1)[:read_len]
        elif i % 3 == 2:
            r[rng.random(read_len) < 0.2] = rng.integers(0, 4)
        rc[i, :read_len] = r
        rq[i, :read_len] = rng.integers(qual - 5, qual + 5, read_len)
        rl[i] = read_len
        pm[i] = True
    ct = np.full((1, off + lr), schema.BASE_PAD, np.uint8)
    ct[0, :cons_len] = cons
    return rc, rq, rl, pm, ct, np.array([cons_len], np.int32)


@pytest.mark.parametrize("rt,lr,off,n,read_len,cons_len",
                         [(16, 128, 512, 9, 100, 300), (16, 32, 384, 16, 30, 200),
                          (128, 128, 384, 40, 100, 250)])
def test_f32_sweep_equals_jax_gemm_and_scan(rt, lr, off, n, read_len, cons_len):
    """Exact against the JAX package's bf16-input GEMM and f32 conv sweep,
    with totals far above 256 (quals ~40 over 100 bases) and tied offsets
    (a periodic consensus: the smallest tied offset wins)."""
    import jax.numpy as jnp

    args = _sweep_inputs(rt + off, rt, lr, off, n, read_len, cons_len)
    got_q, got_o = tra.sweep_gemm(*(torch.from_numpy(a) for a in args), off, rt, lr)
    want_q, want_o = jra.sweep_gemm_kernel(*(jnp.asarray(a) for a in args), off, rt, lr)
    assert got_q.dtype == torch.float32 and got_o.dtype == torch.int32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    rc, rq, rl, _, ct, cl = args
    total = rq[:n].astype(np.int64).sum(axis=1)
    assert total.min() > 256
    q = got_q.numpy()[0, :n]
    # the periodic reads match at several offsets: the smallest wins
    assert (q[1::3] == 0).all() and (got_o.numpy()[0, 1:n:3] == 0).all()
    # the per-task scan sweep over the same pairs
    lr2, lc2 = jra.sweep_bucket_shape(read_len, cons_len)
    rc2 = np.full((n, lr2), schema.BASE_PAD, np.uint8)
    rc2[:, :read_len] = rc[:n, :read_len]
    rq2 = np.zeros((n, lr2), np.uint8)
    rq2[:, :read_len] = rq[:n, :read_len]
    ct2 = np.full((n, lc2), schema.BASE_PAD, np.uint8)
    ct2[:, :cons_len] = ct[0, :cons_len]
    targs = (rc2, rq2, np.full(n, read_len, np.int32), ct2, np.full(n, cons_len, np.int32))
    sq, so = tra.sweep_kernel(*(torch.from_numpy(a) for a in targs), lr2, lc2)
    jq, jo = jra.sweep_kernel(*(jnp.asarray(a) for a in targs), lr2, lc2)
    np.testing.assert_array_equal(sq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(so.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(sq.numpy(), q)
    idx = torch.zeros(n, dtype=torch.int64)
    gq, go = tra.sweep_kernel_gather(*(torch.from_numpy(a) for a in targs[:3]),
                                     torch.from_numpy(ct2[:1]), torch.from_numpy(cl),
                                     idx, lr2, lc2)
    np.testing.assert_array_equal(gq.numpy(), q)
    np.testing.assert_array_equal(go.numpy(), so.numpy())


def test_bf16_bmm_rounds_the_sweep_totals():
    """Why the sweep's inputs are f32: ``torch.bmm`` of bf16 tensors returns
    bf16, and a sum of 300 products 93 x 1 (27,900) comes back 27,904."""
    a = torch.full((1, 2, 300), 93.0)
    b = torch.ones((1, 300, 2))
    assert torch.bmm(a, b)[0, 0, 0].item() == 27_900
    rounded = torch.bmm(a.bfloat16(), b.bfloat16())
    assert rounded.dtype == torch.bfloat16 and rounded[0, 0, 0].item() == 27_904


# -------------------------------------------------------- realigned batches


def test_reads_model_equals_jax_native(inputs):
    ds_j, ds = inputs[READS_N]
    want = jra._realign_indels_native(
        ds_j, "reads", None, jra.MAX_INDEL_SIZE, jra.MAX_CONSENSUS_NUMBER,
        jra.LOD_THRESHOLD, jra.MAX_TARGET_SIZE, None, "overlap",
    )
    got = tra.realign_indels(ds, consensus_model="reads", device="cpu")
    _assert_same_dataset(want, got)
    assert sum("OC:Z:" in (a or "") for a in got.sidecar.attrs) > 5
    # knowns without a table falls back to read consensuses, as in JAX
    _assert_same_dataset(got, tra.realign_indels(ds, consensus_model="knowns", device="cpu"))
    # and a dataset method serves the same call
    _assert_same_dataset(got, ds.realign_indels(device="cpu"))


def test_reads_model_python_path_equals_native(inputs):
    """The Python path (which serves smithwaterman) makes the native path's
    decisions under the reads model, as the JAX package's two paths do."""
    _, ds = inputs[READS_N]
    _assert_same_dataset(
        tra.realign_indels(ds, device="cpu"),
        tra._realign_indels_py(ds, "reads", device=torch.device("cpu")),
    )


def test_smithwaterman_equals_jax_with_the_refresh(inputs, monkeypatch):
    ds_j, ds = inputs[SW_N]
    monkeypatch.setattr(jra, "_sw_preprocess", _refreshing(jra._sw_preprocess))
    want = jra._realign_indels_py(ds_j, consensus_model="smithwaterman")
    got = tra.realign_indels(ds, consensus_model="smithwaterman", device="cpu")
    _assert_same_dataset(want, got)
    b0, b1 = ds.batch.to_numpy(), got.batch.to_numpy()
    assert int((np.asarray(b0.start) != np.asarray(b1.start)).sum()) > 5
    assert sum("OC:Z:" in (a or "") for a in got.sidecar.attrs) > 5


def test_jax_smithwaterman_crashes_without_the_refresh(inputs):
    """The divergence on record: the unrepaired JAX path fails here."""
    ds_j, _ = inputs[SW_N]
    with pytest.raises(IndexError, match="string index out of range"):
        jra._realign_indels_py(ds_j, consensus_model="smithwaterman")


def test_realign_refuses_what_it_does_not_run(inputs, tmp_path):
    """The knowns model with a known-indel table (the helper's VCF of the
    input's indels) runs and equals the JAX native path; an unknown
    consensus model is refused."""
    from adam_tpu.api.datasets import GenotypeDataset as JG
    from make_known_indels_vcf import make_known_indels_vcf

    from adam_tpu_torch.api.datasets import GenotypeDataset as TG

    ds_j, ds = inputs[READS_N]
    vcf = str(tmp_path / "indels.vcf")
    make_known_indels_vcf(inputs["sam", READS_N], vcf)
    names = ds.seq_dict.names
    want = jra._realign_indels_native(
        ds_j, "knowns", JG.load(vcf, contig_names=names).indel_table(),
        jra.MAX_INDEL_SIZE, jra.MAX_CONSENSUS_NUMBER, jra.LOD_THRESHOLD,
        jra.MAX_TARGET_SIZE, None, "overlap",
    )
    got = tra.realign_indels(ds, consensus_model="knowns",
                             known_indels=TG.load(vcf, contig_names=names).indel_table(),
                             device="cpu")
    _assert_same_dataset(want, got)
    assert sum("OC:Z:" in (a or "") for a in got.sidecar.attrs) > 0
    with pytest.raises(ValueError, match="consensus_model"):
        tra.realign_indels(ds, consensus_model="bayes", device="cpu")


def test_native_prep_binding_equals_jax(inputs):
    from adam_tpu import native as jnative

    from adam_tpu_torch import native

    ds_j, ds = inputs[READS_N]
    b = ds.batch.to_numpy()
    targets = tra.find_targets(ds)
    tidx = tra.map_batch_to_targets(b, targets, ds.seq_dict.names)
    mapped = ((b.flags & schema.FLAG_UNMAPPED) == 0) & b.valid
    srows, goff, _ = tra._group_candidates(b, tidx, mapped)
    md = ds.sidecar.md
    args = (md.buf, md.offsets, (md.valid & b.valid).astype(np.uint8), srows, goff, True)
    got = native.realign_prep(b, *args)
    want = jnative.realign_prep(ds_j.batch.to_numpy(), *args)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["r_row"]) > 0


def test_dataset_pieces_equal_jax(inputs):
    from adam_tpu.api.datasets import AlignmentDataset as JDataset
    from adam_tpu.formats import strings as jstrings

    from adam_tpu_torch.formats import strings as tstrings

    ds_j, ds = inputs[READS_N]
    idx = np.arange(0, ds.batch.n_rows, 7)
    parts = [ds.take_rows(idx[:40]), ds.take_rows(idx[40:])]
    parts_j = [ds_j.take_rows(idx[:40]), ds_j.take_rows(idx[40:])]
    _assert_same_dataset(JDataset.concat(parts_j), AlignmentDataset.concat(parts))
    col = ds.sidecar.attrs
    over = {3: "XX:Z:a", 10: None, 11: ""}
    assert list(tstrings.with_overrides(col, over)) == \
        list(jstrings.with_overrides(jstrings.StringColumn.of(list(col)), over))
    assert list(tstrings.StringColumn.concat([col, col])) == list(col) * 2
    assert len(tstrings.StringColumn.concat([])) == 0
