"""Kernel parity: the port's observe histogram and row-prefix pack (the
plain PyTorch versions, which run on the CPU) are bit-equal to the JAX
package's Pallas kernels (interpret mode) and XLA bodies on the same
numpy-seeded inputs; the port's fused apply + double pack is bit-equal
to ``jit_variant("apply_pack2")``.  The CUDA kernels are held against
the plain versions in ``test_torch_cuda.py``, on a machine with a card."""

import numpy as np
import pytest
import torch

from adam_tpu.ops.kernel_backend import backend_scope

GRIDS = [(16, 24), (48, 40), (96, 96)]


def _inputs(seed, g, gl, n_rg=3):
    """The inputs of tests/test_megakernel.py's kernel-parity grid."""
    from adam_tpu_torch.ops.colpack import pack_mask_bits

    rng = np.random.default_rng(seed)
    return dict(
        g=g, gl=gl, n_rg=n_rg,
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


def _t(k, *names):
    return [torch.from_numpy(np.ascontiguousarray(k[n])) for n in names]


_WINDOW = ("bases", "quals", "lengths", "flags", "rg")


def _port_keys(k):
    from adam_tpu_torch.pipelines.bqsr import covariate_keys

    return covariate_keys(*_t(k, *_WINDOW), k["n_rg"], k["gl"])


def _jax_keys(k):
    """The flat keys observe_packed_body's pallas branch computes."""
    import jax.numpy as jnp

    from adam_tpu.pipelines import bqsr

    gl, n_rg = k["gl"], k["n_rg"]
    cycles = bqsr.compute_cycles(jnp.asarray(k["lengths"]), jnp.asarray(k["flags"]), gl)
    dinucs = bqsr.compute_dinucs(jnp.asarray(k["bases"]), jnp.asarray(k["lengths"]),
                                 jnp.asarray(k["flags"]), gl)
    q = jnp.clip(jnp.asarray(k["quals"]).astype(jnp.int32), 0, 93)
    rg = jnp.where(k["rg"] >= 0, k["rg"], n_rg - 1).astype(jnp.int32)
    return np.array((((rg[:, None] * 94 + q) * (2 * gl + 1) + (cycles + gl)) * 17
                     + dinucs).astype(jnp.int32))


def _size(k):
    return k["n_rg"] * 94 * (2 * k["gl"] + 1) * 17


@pytest.mark.parametrize("g,gl", GRIDS)
def test_covariate_keys_match_jax(g, gl):
    k = _inputs(11 + g, g, gl)
    np.testing.assert_array_equal(_port_keys(k).numpy(), _jax_keys(k))


# (g, gl, n_rg, hot): the kernel-parity grid, 40 read groups (3,760
# slabs), and every residue on one key
OBSERVE_CASES = [(g, gl, 3, False) for g, gl in GRIDS] + [(48, 40, 40, False),
                                                         (48, 40, 3, True)]


@pytest.mark.parametrize("g,gl,n_rg,hot", OBSERVE_CASES)
def test_observe_hist_plain_equals_pallas_interpret(g, gl, n_rg, hot):
    from adam_tpu.ops.pallas_observe import observe_hist_pallas

    from adam_tpu_torch.ops.colpack import pack_mask_bits
    from adam_tpu_torch.ops.observe import observe_hist

    k = _inputs(11 + g, g, gl, n_rg)
    keys = _jax_keys(k)
    if hot:
        keys[:] = keys[0, 0]
        k["res_bits"] = pack_mask_bits(np.ones((g, gl), bool))
    want = observe_hist_pallas(keys, k["res_bits"], k["mm_bits"], k["read_ok"], _size(k))
    got = observe_hist(torch.from_numpy(keys), *_t(k, "res_bits", "mm_bits", "read_ok"),
                       _size(k), (2 * gl + 1) * 17)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[0].sum()) > 0
    if hot:
        assert int(got[0][keys[0, 0]]) == int(k["read_ok"].sum()) * gl


@pytest.mark.parametrize("g,gl", GRIDS)
def test_observe_packed_body_equals_xla(g, gl):
    from adam_tpu.pipelines.bqsr import jit_variant

    from adam_tpu_torch.pipelines.bqsr import observe_packed_body

    k = _inputs(11 + g, g, gl)
    with backend_scope("xla"):
        want = jit_variant("observe_packed", False)(
            k["bases"], k["quals"], k["lengths"], k["flags"], k["rg"],
            k["res_bits"], k["mm_bits"], k["read_ok"], k["n_rg"], gl,
        )
    got = observe_packed_body(*_t(k, *_WINDOW, "res_bits", "mm_bits", "read_ok"),
                              k["n_rg"], gl)
    for a, b in zip(got, want):
        assert a.dtype == torch.int64 and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("g,gl", GRIDS)
def test_pack_rows_plain_equals_pallas_and_xla(g, gl):
    from adam_tpu.ops.colpack import pack_rows_body, pack_rows_pallas

    from adam_tpu_torch.ops.colpack import pack_rows

    k = _inputs(11 + g, g, gl)
    lens = np.where(k["valid"], k["lengths"].astype(np.int64), 0)
    got = pack_rows(torch.from_numpy(k["quals"]), torch.from_numpy(lens), g * gl).numpy()
    np.testing.assert_array_equal(got, np.asarray(pack_rows_pallas(k["quals"], lens, g * gl)))
    with backend_scope("xla"):
        np.testing.assert_array_equal(got, np.asarray(pack_rows_body(k["quals"], lens, g * gl)))
    # a payload cut shorter than the rows drops the tail, as the XLA scatter does
    short = int(lens.sum()) // 2
    with backend_scope("xla"):
        want = np.asarray(pack_rows_body(k["quals"], lens, short))
    got = pack_rows(torch.from_numpy(k["quals"]), torch.from_numpy(lens), short).numpy()
    np.testing.assert_array_equal(got, want)


def _pack_lens(g, gl, seed, case):
    """Row lengths of one pack edge case: the read lengths, some rows
    longer than the row width, or none at all."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, gl + 1, g).astype(np.int64)
    if case == "long_rows":
        lens[::3] = gl + rng.integers(1, 40, len(lens[::3]))
    elif case == "zero":
        lens[:] = 0
    return lens


@pytest.mark.parametrize("encode", ["none", "sanger", "base_decode"])
@pytest.mark.parametrize("case", ["read_lengths", "long_rows", "zero"])
@pytest.mark.parametrize("cut", ["exact", "short", "past"])
def test_pack_rows_encodes_equal_jax(encode, case, cut):
    """pack_rows(..., encode=) equals the JAX pack of the encoded matrix
    (pack_rows_body of sanger_body / base_decode_body), with rows longer
    than the width, a size cut short of sum(lens) and one past it."""
    from adam_tpu.ops.colpack import base_decode_body, pack_rows_body, sanger_body

    from adam_tpu_torch.ops.colpack import pack_rows

    g, gl = 37, 40
    rng = np.random.default_rng(5)
    mat = (rng.integers(0, 6, (g, gl)) if encode == "base_decode"
           else rng.integers(0, 256, (g, gl))).astype(np.uint8)
    lens = _pack_lens(g, gl, 7, case)
    total = int(lens.sum())
    size = {"exact": total, "short": total // 2, "past": total + 77}[cut]
    jax_encode = {"none": lambda m: m, "sanger": sanger_body,
                  "base_decode": base_decode_body}[encode]
    with backend_scope("xla"):
        want = np.asarray(pack_rows_body(jax_encode(mat), lens, size))
    got = pack_rows(torch.from_numpy(mat), torch.from_numpy(lens), size, encode=encode)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (size,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("g,gl", GRIDS)
def test_apply_pack2_equals_jit_variant(g, gl):
    from adam_tpu.pipelines.bqsr import jit_variant

    from adam_tpu_torch.convert import table_from_numpy
    from adam_tpu_torch.pipelines.bqsr import apply_pack2_body

    k = _inputs(11 + g, g, gl)
    with backend_scope("xla"):
        want = jit_variant("apply_pack2", False)(
            k["bases"], k["quals"], k["lengths"], k["flags"], k["rg"],
            k["has_qual"], k["valid"], k["table"], gl, g * gl,
        )
    got = apply_pack2_body(*_t(k, *_WINDOW, "has_qual", "valid"),
                           table_from_numpy(k["table"]), gl, g * gl)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_apply_gathers_from_the_middle_of_a_wider_table():
    """A merged table wider than the window (cycle axis centred on the
    widest window's gl) gathers exactly as the JAX body does."""
    from adam_tpu.pipelines.bqsr import jit_variant

    from adam_tpu_torch.convert import table_from_numpy
    from adam_tpu_torch.pipelines.bqsr import apply_pack2_body

    k = _inputs(9, 48, 32)
    k["table"] = np.random.default_rng(3).integers(
        2, 43, (3, 94, 2 * 48 + 1, 17)).astype(np.uint8)
    with backend_scope("xla"):
        want = jit_variant("apply_pack2", False)(
            k["bases"], k["quals"], k["lengths"], k["flags"], k["rg"],
            k["has_qual"], k["valid"], k["table"], 32, 48 * 32,
        )
    got = apply_pack2_body(*_t(k, *_WINDOW, "has_qual", "valid"),
                           table_from_numpy(k["table"]), 32, 48 * 32)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_wrappers_check_their_inputs():
    from adam_tpu_torch.ops.colpack import pack_rows
    from adam_tpu_torch.ops.observe import observe_hist

    keys = torch.zeros((4, 16), dtype=torch.int32)
    bits = torch.zeros((4, 2), dtype=torch.uint8)
    ok = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        observe_hist(keys.long(), bits, bits, ok, 10, 5)
    with pytest.raises(ValueError):
        observe_hist(keys, bits[:, :1], bits, ok, 10, 5)
    with pytest.raises(ValueError):
        observe_hist(keys, bits, bits, ok.int(), 10, 5)
    with pytest.raises(ValueError, match="slab width"):
        observe_hist(keys, bits, bits, ok, 10, 3)
    with pytest.raises(ValueError):
        pack_rows(bits, torch.zeros(4, dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        pack_rows(keys, torch.zeros(4, dtype=torch.int64), 8)
    with pytest.raises(ValueError, match="encode"):
        pack_rows(bits, torch.zeros(4, dtype=torch.int64), 8, encode="phred")
