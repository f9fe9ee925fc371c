"""``transform_step`` against the JAX package's
(``adam_tpu/pipelines/transform_step.py``) on the CPU: the same batch and
residue masks, made from a seed with numpy, through JAX's ``jit`` step
(its default XLA backend) and the port's plain-torch step with
``device="cpu"``; every output exact — the recalibrated quals, the
5' positions, the duplicate scores, both observe histograms and the
flagstat metrics.  At the graft entry's shape (256 x 100,
``__graft_entry__.py``) and on a ragged batch (short reads, clips, pairs,
duplicates, QC-failed, secondary, unmapped, qual-less and invalid rows,
three read-group bins).  A second case holds the observe totals to the
JAX package's Pallas kernel in interpret mode, as its own tests run it."""

import dataclasses

import numpy as np
import pytest


def _ragged(seed: int, n: int = 300, lmax: int = 100):
    """Host arrays of a ragged batch: every field set from ``seed``."""
    from adam_tpu_torch.formats import schema
    from adam_tpu_torch.pipelines.transform_step import synthetic_batch

    rng = np.random.default_rng(seed)
    arr = {k: np.array(v) for k, v in synthetic_batch(n, lmax, seed=seed).arrays().items()}
    lengths = rng.integers(30, lmax + 1, n).astype(np.int32)
    lane = np.arange(lmax)[None, :]
    arr["bases"] = np.where(lane < lengths[:, None], rng.integers(0, 5, (n, lmax)),
                            schema.BASE_PAD).astype(np.uint8)
    arr["quals"] = np.where(lane < lengths[:, None], rng.integers(0, 45, (n, lmax)),
                            schema.QUAL_PAD).astype(np.uint8)
    arr["lengths"] = lengths
    lead = np.where(rng.random(n) < 0.2, rng.integers(1, 6, n), 0)
    trail = np.where(rng.random(n) < 0.2, rng.integers(1, 6, n), 0)
    ops = np.full((n, 4), schema.CIGAR_PAD, np.uint8)
    lens = np.zeros((n, 4), np.int32)
    ncig = np.zeros(n, np.int32)
    for i in range(n):
        parts = [(schema.CIGAR_S, lead[i])] if lead[i] else []
        parts.append((schema.CIGAR_M, lengths[i] - lead[i] - trail[i]))
        if trail[i]:
            parts.append((schema.CIGAR_H if i % 2 else schema.CIGAR_S, trail[i]))
        for k, (o, ln) in enumerate(parts):
            ops[i, k], lens[i, k] = o, ln
        ncig[i] = len(parts)
    arr["cigar_ops"], arr["cigar_lens"], arr["cigar_n"] = ops, lens, ncig
    arr["end"] = arr["start"] + lengths - lead - trail
    bits = [0x1, 0x2, 0x10, 0x20, 0x40, 0x80, 0x100, 0x200, 0x400, 0x800, 0x8, 0x4]
    flags = np.zeros(n, np.int64)
    for bit in bits:
        flags |= np.where(rng.random(n) < 0.15, bit, 0)
    arr["flags"] = flags.astype(np.int32)
    arr["mapq"] = rng.choice([0, 3, 20, 60, 255], n).astype(np.int32)
    arr["mate_contig_idx"] = rng.integers(-1, 4, n).astype(np.int32)
    arr["read_group_idx"] = rng.integers(-1, 2, n).astype(np.int32)
    arr["has_qual"] = rng.random(n) < 0.9
    arr["valid"] = rng.random(n) < 0.95
    return arr


def _graft(seed: int):
    from adam_tpu_torch.pipelines.transform_step import synthetic_batch

    return {k: np.array(v) for k, v in synthetic_batch(256, 100, seed=seed).arrays().items()}


def _masks(arr, seed: int):
    rng = np.random.default_rng(seed + 100)
    n, L = arr["bases"].shape
    residue_ok = (arr["quals"] > 0) & (arr["bases"] < 4) & (rng.random((n, L)) < 0.97)
    return residue_ok, rng.random((n, L)) < 0.02


def _jax_step(arr, residue_ok, is_mm, n_rg, lmax):
    import jax.numpy as jnp

    from adam_tpu.formats.batch import ReadBatch as JaxBatch
    from adam_tpu.pipelines.transform_step import transform_step

    batch = JaxBatch(**arr).to_device()
    out, aux = transform_step(batch, jnp.asarray(residue_ok), jnp.asarray(is_mm),
                              n_rg=n_rg, lmax=lmax)
    failed, passed = aux["flagstat"]
    return out, aux, (failed.to_ints(), passed.to_ints())


def _port_step(arr, residue_ok, is_mm, n_rg, lmax):
    from adam_tpu_torch.formats.batch import ReadBatch
    from adam_tpu_torch.pipelines.transform_step import transform_step

    return transform_step(ReadBatch(**arr), residue_ok, is_mm, n_rg, lmax, device="cpu")


def _as_dict(m) -> dict:
    return {f.name: (_as_dict(getattr(m, f.name)) if dataclasses.is_dataclass(getattr(m, f.name))
                     else int(getattr(m, f.name))) for f in dataclasses.fields(m)}


@pytest.mark.parametrize("case,seed,n_rg", [("graft", 0, 2), ("graft", 5, 1),
                                            ("ragged", 1, 3), ("ragged", 2, 3),
                                            ("ragged", 3, 4)])
def test_transform_step_equals_jax(case, seed, n_rg):
    arr = _graft(seed) if case == "graft" else _ragged(seed)
    lmax = arr["bases"].shape[1]
    residue_ok, is_mm = _masks(arr, seed)
    jout, jaux, jflag = _jax_step(arr, residue_ok, is_mm, n_rg, lmax)
    tout, taux = _port_step(arr, residue_ok, is_mm, n_rg, lmax)
    np.testing.assert_array_equal(tout.quals.numpy(), np.asarray(jout.quals))
    for key in ("five_prime", "dup_score", "obs_total", "obs_mism"):
        got, want = taux[key].numpy(), np.asarray(jaux[key])
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert [_as_dict(m) for m in taux["flagstat"]] == [_as_dict(m) for m in jflag]
    assert int(taux["obs_total"].sum()) > 0 and int(taux["obs_mism"].sum()) > 0
    assert (tout.quals.numpy() != arr["quals"]).any()
    # the rest of the batch is the input's
    for k, v in arr.items():
        if k != "quals":
            np.testing.assert_array_equal(getattr(tout, k).numpy(), v, err_msg=k)


@pytest.mark.parametrize("case,seed", [("graft", 0), ("ragged", 4)])
def test_observe_totals_equal_the_pallas_kernel_in_interpret_mode(case, seed):
    import jax.numpy as jnp

    from adam_tpu.formats import schema
    from adam_tpu.ops.colpack import pack_mask_bits
    from adam_tpu.ops.kernel_backend import backend_scope
    from adam_tpu.pipelines import bqsr as jbqsr

    arr = _graft(seed) if case == "graft" else _ragged(seed)
    lmax = arr["bases"].shape[1]
    n_rg = 3
    residue_ok, is_mm = _masks(arr, seed)
    flags = arr["flags"]
    read_ok = (arr["valid"] & ((flags & schema.FLAG_UNMAPPED) == 0)
               & ((flags & (schema.FLAG_SECONDARY | schema.FLAG_SUPPLEMENTARY)) == 0)
               & ((flags & schema.FLAG_DUPLICATE) == 0)
               & ((flags & schema.FLAG_FAILED_QC) == 0) & arr["has_qual"]
               & (arr["mapq"] > 0) & (arr["mapq"] != 255))
    with backend_scope("pallas"):
        want_t, want_m = jbqsr.observe_packed_body(
            *(jnp.asarray(arr[k]) for k in ("bases", "quals", "lengths", "flags",
                                             "read_group_idx")),
            jnp.asarray(pack_mask_bits(residue_ok)), jnp.asarray(pack_mask_bits(is_mm)),
            jnp.asarray(read_ok), n_rg, lmax)
    _, taux = _port_step(arr, residue_ok, is_mm, n_rg, lmax)
    np.testing.assert_array_equal(taux["obs_total"].numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(taux["obs_mism"].numpy(), np.asarray(want_m))


def test_synthetic_inputs_equal_jax():
    from adam_tpu.pipelines import transform_step as jts

    from adam_tpu_torch.pipelines import transform_step as tts

    for n, L, seed in ((256, 100, 0), (100, 37, 9)):
        want, got = jts.synthetic_batch(n, L, seed=seed), tts.synthetic_batch(n, L, seed=seed)
        for k, v in got.arrays().items():
            w = np.asarray(getattr(want, k))
            assert v.dtype == w.dtype, k
            np.testing.assert_array_equal(v, w, err_msg=k)
        for a, b in zip(tts.synthetic_masks(got, seed=seed + 1),
                        jts.synthetic_masks(want, seed=seed + 1)):
            np.testing.assert_array_equal(a, np.asarray(b))
