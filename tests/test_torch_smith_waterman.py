"""Smith-Waterman parity: the port's plain fills (which run on the CPU) are
bit-equal to the JAX package's scan fills and its Pallas kernels
(interpret mode) on the same numpy-seeded inputs — moves, per-row best
scores and diagonals for the full fill; best scores in f32, i32, i16 and
bf16 for the score-only fill — and the batched alignment equals the JAX
package's per-pair ``smith_waterman``.  The CUDA kernels are held against
the plain versions in ``test_torch_cuda.py``, on a machine with a card."""

from dataclasses import astuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_tpu.ops import smith_waterman as jsw

from adam_tpu_torch.formats import schema
from adam_tpu_torch.ops import smith_waterman as tsw

DEFAULT_W = (1.0, -0.333, -0.5, -0.5)
WEIGHTS = [DEFAULT_W, (1.0, 0.0, -0.333, -0.333), (2.0, -1.0, -1.0, -1.0)]
FILL_SHAPES = [(9, 37, 29), (12, 100, 157), (4, 1, 12), (6, 20, 1)]


def _pairs(seed, B, lx, ly, min_len=1):
    """Codes 0..4 (N included), padded variable lengths (PAD beyond)."""
    rng = np.random.default_rng(seed)
    xl = rng.integers(min(min_len, lx), lx + 1, B).astype(np.int32)
    yl = rng.integers(min(min_len, ly), ly + 1, B).astype(np.int32)
    xl[0], yl[0] = lx, ly
    xc = rng.integers(0, 5, (B, lx)).astype(np.int32)
    yc = rng.integers(0, 5, (B, ly)).astype(np.int32)
    xc[np.arange(lx)[None, :] >= xl[:, None]] = schema.BASE_PAD
    yc[np.arange(ly)[None, :] >= yl[:, None]] = schema.BASE_PAD
    return xc, xl, yc, yl


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("w", WEIGHTS, ids=["default", "suite", "integral"])
@pytest.mark.parametrize("B,lx,ly", FILL_SHAPES)
def test_fill_plain_equals_scan_and_pallas(B, lx, ly, w):
    xc, xl, yc, yl = _pairs(lx * 7 + ly, B, lx, ly)
    got = tsw.sw_fill(*_t(xc, xl, yc, yl), *w, lx, ly)
    scan = jsw._sw_fill_scan_best(*_j(xc, xl, yc, yl), *w, lx, ly)
    pallas = jsw._sw_fill_pallas(*_j(xc, xl, yc, yl), lx, ly, *w, interpret=True)
    assert got[0].dtype == torch.uint8 and tuple(got[0].shape) == (B, lx + ly + 1, lx + 1)
    assert got[1].dtype == torch.float32 and got[2].dtype == torch.int32
    for want in (scan, pallas):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int((got[0] == tsw.MOVE_B).sum()) > 0


@pytest.mark.parametrize("B,lx,ly,seed", [(24, 31, 45, 7), (40, 63, 70, 13), (6, 130, 40, 2)])
def test_score_plain_equals_scan_and_pallas_f32(B, lx, ly, seed):
    xc, xl, yc, yl = _pairs(seed, B, lx, ly, min_len=4)
    got = tsw.sw_best_scores(*_t(xc, xl, yc, yl), *DEFAULT_W)
    scan = jsw._sw_score_scan(*_j(xc, xl, yc, yl), *DEFAULT_W, lx, ly)
    pallas = jsw._sw_score_pallas(*_j(xc, xl, yc, yl), lx, ly, *DEFAULT_W,
                                  interpret=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(scan))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    # the score-only fill agrees with the full fill's best scores
    _, best_sc, _ = tsw.sw_fill(*_t(xc, xl, yc, yl), *DEFAULT_W, lx, ly)
    np.testing.assert_array_equal(got.numpy(), best_sc.numpy().max(axis=1))


# w_delete not a dyadic fraction: the doubling delete chain and the
# sequential one (H[i] = max(tmp[i], H[i-1] + wd)) round apart in f32
ORDER_TRAP_W = (1.0, -0.333, -0.3, -0.3)


@pytest.mark.parametrize("B,lx,ly,seed", [(24, 31, 45, 7), (40, 63, 70, 13), (6, 130, 40, 2),
                                          (64, 127, 127, 3)])
def test_score_plain_equals_scan_and_pallas_f32_order_trap(B, lx, ly, seed):
    """Under weights where the order of the delete chain's sums shows,
    the plain score fill still equals the JAX scan and Pallas kernel."""
    xc, xl, yc, yl = _pairs(seed, B, lx, ly, min_len=4)
    got = tsw.sw_best_scores(*_t(xc, xl, yc, yl), *ORDER_TRAP_W)
    scan = jsw._sw_score_scan(*_j(xc, xl, yc, yl), *ORDER_TRAP_W, lx, ly)
    pallas = jsw._sw_score_pallas(*_j(xc, xl, yc, yl), lx, ly, *ORDER_TRAP_W,
                                  interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(scan))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("w,differ", [(ORDER_TRAP_W, True), (DEFAULT_W, False)])
def test_doubling_and_sequential_delete_chains_differ_under_the_trap(w, differ):
    """The full fill chains one + w_delete per row; the score fill doubles.
    Under the trap weights the two disagree on some of 256 random pairs, so
    a score kernel that took the sequential chain would fail its parity
    tests; under ADAM's defaults (w_delete -0.5, exact) they agree."""
    B, lx, ly = 256, 127, 127
    args = _t(*_pairs(11, B, lx, ly, min_len=lx))
    score = tsw.sw_score_plain(*args, *w, lx, ly)
    _, best_sc, _ = tsw.sw_fill_plain(*args, *w, lx, ly)
    n_differ = int((score != best_sc.max(dim=1).values).sum())
    assert (n_differ > 0) == differ, n_differ


@pytest.mark.parametrize("lx,route", [(1, "warp"), (31, "warp"), (32, "warp"), (33, "warp"),
                                      (128, "warp"), (129, "block"), (1500, "block")])
def test_fill_route_and_shared_memory(lx, route):
    """The fill kernel's route follows lx alone (warp up to its limit of
    128 rows), and its shared memory per pair: on the warp route a staging
    tile of 32 diagonals plus 16 bytes of alignment and y as i32, each
    rounded to 16 bytes; on the block route three f32 diagonals and both
    code rows as i32."""
    assert tsw.sw_fill_route(lx) == route
    assert tsw.SW_FILL_WARP_MAX_LX == 128
    ly = 384
    want = ((-(-(32 * (lx + 1) + 16) // 16) * 16 + 4 * ly) if route == "warp"
            else 12 * (lx + 1) + 4 * (lx + ly))
    assert tsw.sw_fill_smem_bytes(lx, ly) == want
    assert tsw.sw_fill_smem_bytes(128, 384) == 4144 + 1536


@pytest.mark.parametrize("dtype_name", ["i16", "i32", "bf16"])
@pytest.mark.parametrize("B,lx,ly,seed", [(40, 63, 70, 13), (8, 127, 127, 0)])
def test_score_integer_types_equal_pallas_and_scan(B, lx, ly, seed, dtype_name):
    # with these weights every score is an integer below 256, which bf16
    # holds exactly, so the bf16 fill equals the scan too
    xc, xl, yc, yl = _pairs(seed, B, lx, ly, min_len=4)
    w = (2.0, -1.0, -1.0, -1.0)
    got = tsw.sw_best_scores(*_t(xc, xl, yc, yl), *w, dtype_name=dtype_name)
    pallas = jsw._sw_score_pallas(*_j(xc, xl, yc, yl), lx, ly, *w, interpret=True,
                                  dtype_name=dtype_name)
    scan = jsw._sw_score_scan(*_j(xc, xl, yc, yl), *w, lx, ly)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    np.testing.assert_array_equal(got.numpy(), np.asarray(scan))
    assert float(got.max()) > 0


@pytest.mark.parametrize("B,lx,ly,seed", [(24, 31, 45, 7), (40, 63, 70, 13),
                                          (8, 127, 127, 0), (6, 130, 40, 2)])
def test_score_bf16_default_weights_equal_pallas(B, lx, ly, seed):
    """The measurement-only bf16 fill with ADAM's fractional defaults,
    every add and max rounded once to bf16, equals the Pallas kernel in
    bf16 (interpret mode) bit for bit."""
    xc, xl, yc, yl = _pairs(seed, B, lx, ly, min_len=4)
    got = tsw.sw_best_scores(*_t(xc, xl, yc, yl), *DEFAULT_W, dtype_name="bf16")
    pallas = jsw._sw_score_pallas(*_j(xc, xl, yc, yl), lx, ly, *DEFAULT_W,
                                  interpret=True, dtype_name="bf16")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    # bf16 rounds: the f32 fill gives other scores on these pairs
    f32 = tsw.sw_best_scores(*_t(xc, xl, yc, yl), *DEFAULT_W)
    assert not torch.equal(got, f32)


def test_score_type_guards():
    xc, xl, yc, yl = _t(*_pairs(3, 4, 31, 40))
    for dtype_name in ("i16", "i32"):
        with pytest.raises(ValueError, match="integral"):
            tsw.sw_best_scores(xc, xl, yc, yl, *DEFAULT_W, dtype_name=dtype_name)
    with pytest.raises(ValueError, match="overflow"):
        tsw.sw_best_scores(xc, xl, yc, yl, 2.0, -1.0, -1.0, -600.0, dtype_name="i16")
    for lx, ly, w in [(127, 127, (2, -1, -1, -1)), (127, 127, DEFAULT_W),
                      (300, 9000, (2, -1, -1, -1)), (129, 100, (1, -1, -1, -70))]:
        assert tsw._i16_safe(lx, ly, *w) == jsw._i16_safe(lx, ly, *w)


def test_wrappers_check_their_inputs():
    xc, xl, yc, yl = _t(*_pairs(3, 4, 10, 12))
    with pytest.raises(ValueError):
        tsw.sw_fill(xc.float(), xl, yc, yl, *DEFAULT_W, 10, 12)
    with pytest.raises(ValueError):
        tsw.sw_fill(xc, xl[:3], yc, yl, *DEFAULT_W, 10, 12)
    with pytest.raises(ValueError):
        tsw.sw_fill(xc, xl, yc, yl, *DEFAULT_W, 11, 12)
    with pytest.raises(ValueError):
        tsw.sw_best_scores(xc[:, :0], xl, yc, yl)


def _random_pairs(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        y = rng.integers(0, 4, int(rng.choice([40, 57]))).astype(np.uint8)
        lx = int(rng.choice([12, 20]))
        s = int(rng.integers(0, len(y) - lx))
        x = y[s:s + lx].copy()
        x[rng.random(lx) < 0.1] = rng.integers(0, 5)  # mismatches, N
        if k % 2:
            x = np.concatenate([x[:5], rng.integers(0, 4, 2).astype(np.uint8), x[5:]])
        out.append((x, y))
    return out


def test_batched_alignment_equals_per_pair_jax():
    """One padded batch per shape bucket equals the JAX package's per-pair
    ``smith_waterman`` on every field."""
    pairs = _random_pairs(5, 10)
    got = tsw.smith_waterman_many(pairs, *DEFAULT_W, device="cpu")
    for (x, y), a in zip(pairs, got):
        want = jsw.smith_waterman(schema.decode_bases(x), schema.decode_bases(y), *DEFAULT_W)
        assert astuple(a) == astuple(want)
    assert any("I" in a.cigar_x for a in got)
    # one batch of all pairs padded to one shape gives the same alignments
    lx = max(len(x) for x, _ in pairs)
    ly = max(len(y) for _, y in pairs)
    xc = np.full((len(pairs), lx), schema.BASE_PAD, np.uint8)
    yc = np.full((len(pairs), ly), schema.BASE_PAD, np.uint8)
    for k, (x, y) in enumerate(pairs):
        xc[k, :len(x)], yc[k, :len(y)] = x, y
    batch = tsw.smith_waterman_batch(
        xc, np.array([len(x) for x, _ in pairs]), yc,
        np.array([len(y) for _, y in pairs]), *DEFAULT_W, device="cpu",
    )
    assert batch == got


def test_many_chunks_the_moves_matrix(monkeypatch):
    pairs = _random_pairs(9, 7)
    want = tsw.smith_waterman_many(pairs, device="cpu")
    monkeypatch.setattr(tsw, "MOVES_BYTES_PER_LAUNCH", 1)  # one pair per fill
    calls = []
    real = tsw.smith_waterman_batch

    def counting(*a, **k):
        calls.append(len(a[0]))
        return real(*a, **k)

    monkeypatch.setattr(tsw, "smith_waterman_batch", counting)
    assert tsw.smith_waterman_many(pairs, device="cpu") == want
    assert calls == [1] * len(pairs)


# End-to-end vectors of the reference's SmithWatermanSuite, as the JAX
# package's tests/test_ops.py holds them.
SUITE = [
    ("AAAA", "AAAA", (1.0, 0.0, -1.0, -1.0), "4M", "4M", 0, 0),
    ("ACATGA", "ACGA", (1.0, 0.0, -0.333, -0.333), "2M2I2M", "2M2D2M", None, None),
    ("ATTAGACTACTTAATATACAGATTTACCCCAATAGA", "ATTAGACTACTTAATATACAGAATTACCCCAATAGA",
     (1.0, 0.0, -0.333, -0.333), "36M", "36M", None, None),
    ("ATTAGACTACTTAATATACAGATTTACCCCAATAGA", "ATTAGACTACTTAATATACAGATACCCCAATAGA",
     (1.0, 0.0, -0.333, -0.333), "22M2I12M", "22M2D12M", None, None),
    ("ATTAGACTACTTAATATACAGATTTACCCCAATAGA", "ACTTAATATACAGATTTACC",
     (1.0, 0.0, -0.333, -0.333), "20M", None, 8, 0),
]


@pytest.mark.parametrize("x,y,w,cx,cy,xs,ys", SUITE)
def test_reference_suite_vectors(x, y, w, cx, cy, xs, ys):
    a = tsw.smith_waterman(x, y, *w, device="cpu")
    assert a.cigar_x == cx
    if cy is not None:
        assert a.cigar_y == cy
    if xs is not None:
        assert (a.x_start, a.y_start) == (xs, ys)
    assert astuple(a) == astuple(jsw.smith_waterman(x, y, *w))


def test_reference_suite_padded_batch():
    xs, ys = ["AAAA", "ACATGA"], ["AAAA", "ACGA"]
    xc = np.stack([np.pad(schema.encode_bases(s), (0, 6 - len(s)),
                          constant_values=schema.BASE_PAD) for s in xs])
    yc = np.stack([np.pad(schema.encode_bases(s), (0, 4 - len(s)),
                          constant_values=schema.BASE_PAD) for s in ys])
    res = tsw.smith_waterman_batch(xc, np.array([4, 6]), yc, np.array([4, 4]),
                                   1.0, 0.0, -0.333, -0.333, device="cpu")
    assert [r.cigar_x for r in res] == ["4M", "2M2I2M"]


def test_benchmark_gcups_runs_on_the_cpu():
    assert tsw.benchmark_gcups(B=8, lx=16, ly=16, reps=1, trials=1, device="cpu") > 0
    assert tsw.benchmark_gcups(B=8, lx=16, ly=16, reps=1, trials=1,
                               dtype_name="i16", device="cpu") > 0
