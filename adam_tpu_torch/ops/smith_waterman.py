"""Batched Smith-Waterman local alignment — the port's counterpart of
``adam_tpu/ops/smith_waterman.py`` (kernels 3 and 4, ``csrc/sw_fill.cu``
and ``csrc/sw_score.cu``).

Semantics match ``algorithms/smithwaterman/`` in the reference:
constant-gap scoring with the exact move priority and tie-breaking of
``SmithWatermanGapScoringFromFn.buildScoringMatrix`` (B if m>=d && m>=in
&& m>0, else J if d>=in && d>0, else I if in>0, else terminate) and
``SmithWaterman.maxCoordinates`` (on score ties the *later* row/column
wins), and the same trackback emission (B -> M/M, J -> I in x / D in y,
I -> D in x / I in y).

Two fills, each with a plain PyTorch version beside its CUDA kernel:

* :func:`sw_fill` — the full fill in diagonal layout: moves u8
  ``[B, D, lx+1]`` (``matrix[i, j] == diag[i + j, i]``, D = lx+ly+1) and
  each matrix row's running best score and diagonal.  The host trackback
  (:func:`_trackback`) reads the moves directly.
* :func:`sw_best_scores` — the score-only fill (the GCUPS path): the
  column recurrence with the same-row delete chain solved by doubling
  steps, f32 for fractional weights or i32/i16 for integral ones.

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version, which the CPU tests hold against the
JAX package's scan fills and Pallas kernels (interpret mode).  All
arithmetic is float32 in the JAX order, so results are bit-equal.
"""

from __future__ import annotations

import ctypes as ct
import time
from dataclasses import dataclass

import numpy as np
import torch

from adam_tpu_torch.device import resolve_device
from adam_tpu_torch.formats import schema
from adam_tpu_torch.ops import kernels

# move codes in the move matrix
MOVE_T = 0  # terminate
MOVE_B = 1  # both (diagonal)
MOVE_J = 2  # consume x only
MOVE_I = 3  # consume y only

_LANE = 128  # the TPU kernels' lane padding, kept in the i16 overflow guard
_DTYPES = {"f32": torch.float32, "i32": torch.int32, "i16": torch.int16,
           "bf16": torch.bfloat16}
_DTYPE_CODES = {"f32": 0, "i32": 1, "i16": 2, "bf16": 3}
SMEM_LIMIT = 232_448  # bytes of shared memory a Hopper block can use


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _f32(w: float) -> float:
    """``w`` rounded to float32 once, as ``jnp.float32(w)`` does."""
    return float(np.float32(w))


def _check_pair_inputs(x_codes, x_len, y_codes, y_len):
    if x_codes.dim() != 2 or y_codes.dim() != 2:
        raise ValueError("x_codes and y_codes must be [B, len] code matrices")
    B, lx = x_codes.shape
    if y_codes.shape[0] != B or tuple(x_len.shape) != (B,) or tuple(y_len.shape) != (B,):
        raise ValueError(f"inconsistent batch sizes: x {tuple(x_codes.shape)}, "
                         f"y {tuple(y_codes.shape)}, lens {tuple(x_len.shape)} "
                         f"{tuple(y_len.shape)}")
    for t in (x_codes, x_len, y_codes, y_len):
        if t.dtype.is_floating_point or t.dtype == torch.bool:
            raise ValueError("codes and lengths must be integer tensors")
    devs = {t.device for t in (x_codes, x_len, y_codes, y_len)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if lx < 1 or y_codes.shape[1] < 1:
        raise ValueError("lx and ly must be at least 1")


# ------------------------------------------------------------- full fill


def sw_fill_plain(x_codes, x_len, y_codes, y_len, w_match, w_mismatch,
                  w_insert, w_delete, lx: int, ly: int):
    """Plain PyTorch version of the diagonal-layout fill: a Python loop
    over the D diagonals of ``[B, lx+1]`` ops (the JAX package's
    ``_sw_fill_scan`` + ``_per_lane_best``, with the per-lane best kept
    as a running max, ties to the later diagonal).

    -> (moves u8[B, D, lx+1], best_sc f32[B, lx+1], best_d i32[B, lx+1])."""
    dev = x_codes.device
    B = x_codes.shape[0]
    D = lx + ly + 1
    f32 = torch.float32
    wm, wx, wi, wd = (torch.tensor(_f32(w), dtype=f32, device=dev)
                      for w in (w_match, w_mismatch, w_insert, w_delete))
    zero = torch.zeros((), dtype=f32, device=dev)
    ninf = torch.full((), float("-inf"), dtype=f32, device=dev)
    ii = torch.arange(lx + 1, device=dev)
    xlen = x_len.to(torch.int64)[:, None]
    ylen = y_len.to(torch.int64)[:, None]
    xc = x_codes[:, torch.clamp(ii - 1, 0, lx - 1)]
    d1 = torch.zeros((B, lx + 1), dtype=f32, device=dev)
    d2 = torch.zeros((B, lx + 1), dtype=f32, device=dev)
    best_sc = torch.full((B, lx + 1), float("-inf"), dtype=f32, device=dev)
    best_d = torch.zeros((B, lx + 1), dtype=torch.int32, device=dev)
    moves = torch.empty((B, D, lx + 1), dtype=torch.uint8, device=dev)
    mv_b, mv_j, mv_i, mv_t = (torch.tensor(m, dtype=torch.uint8, device=dev)
                              for m in (MOVE_B, MOVE_J, MOVE_I, MOVE_T))

    def shift_i(v):  # v[i-1] with 0 at i=0
        return torch.nn.functional.pad(v[:, :-1], (1, 0))

    for d in range(D):
        jj = d - ii
        valid = (ii >= 1) & (jj >= 1) & (ii[None, :] <= xlen) & (jj[None, :] <= ylen)
        yc = y_codes[:, torch.clamp(jj - 1, 0, ly - 1)]
        sub = torch.where(xc == yc, wm, wx)
        m = shift_i(d2) + sub
        dd = shift_i(d1) + wd
        inn = d1 + wi
        take_b = (m >= dd) & (m >= inn) & (m > 0.0)
        take_j = ~take_b & (dd >= inn) & (dd > 0.0)
        take_i = ~take_b & ~take_j & (inn > 0.0)
        score = torch.where(take_b, m, torch.where(take_j, dd, torch.where(take_i, inn, zero)))
        move = torch.where(take_b, mv_b, torch.where(take_j, mv_j,
                                                     torch.where(take_i, mv_i, mv_t)))
        score = torch.where(valid, score, zero)
        moves[:, d, :] = torch.where(valid, move, mv_t)
        in_region = (ii[None, :] <= xlen) & (jj[None, :] >= 0) & (jj[None, :] <= ylen)
        cur = torch.where(in_region, score, ninf)
        upd = cur >= best_sc
        best_sc = torch.where(upd, cur, best_sc)
        best_d = torch.where(upd, torch.tensor(d, dtype=torch.int32, device=dev), best_d)
        d2, d1 = d1, score
    return moves, best_sc, best_d


#: the fill's warp route (a warp per pair, R = ceil(lx/32) rows a lane in
#: registers) takes lx up to this; longer rows take the block route
SW_FILL_WARP_MAX_LX = 128
_SW_FILL_TILE_DIAGS = 32  # diagonals per staged move tile (warp route)
_SW_FILL_ROUTES = {"warp": 0, "block": 1}


def sw_fill_route(lx: int) -> str:
    """The fill kernel's route for rows of ``lx``: "warp" or "block"."""
    return "warp" if lx <= SW_FILL_WARP_MAX_LX else "block"


def sw_fill_smem_bytes(lx: int, ly: int) -> int:
    """Shared memory the fill kernel needs for one pair.  Warp route: the
    staging tile of 32 diagonals x (lx+1) move bytes plus 16 bytes to
    align it, and y as i32, each rounded up to 16 bytes (a block holds up
    to four such warps, as many as fit).  Block route: three rolling f32
    diagonals of lx+1 lanes and both code rows as i32."""
    if sw_fill_route(lx) == "warp":
        return (_round_up(_SW_FILL_TILE_DIAGS * (lx + 1) + 16, 16)
                + _round_up(4 * ly, 16))
    return 3 * (lx + 1) * 4 + (lx + ly) * 4


def sw_fill(x_codes, x_len, y_codes, y_len, w_match, w_mismatch, w_insert,
            w_delete, lx: int, ly: int):
    """Diagonal-layout fill -> (moves u8[B, D, lx+1], best_sc f32[B, lx+1],
    best_d i32[B, lx+1]); the CUDA kernel for CUDA tensors (on the route
    :func:`sw_fill_route` picks, counted as its variant), the plain
    version for CPU tensors."""
    _check_pair_inputs(x_codes, x_len, y_codes, y_len)
    if tuple(x_codes.shape[1:]) != (lx,) or tuple(y_codes.shape[1:]) != (ly,):
        raise ValueError(f"code matrices {tuple(x_codes.shape)}, {tuple(y_codes.shape)} "
                         f"do not match lx={lx}, ly={ly}")
    dev = x_codes.device
    if dev.type == "cpu":
        return sw_fill_plain(x_codes, x_len, y_codes, y_len, w_match,
                             w_mismatch, w_insert, w_delete, lx, ly)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if lx + 1 > 8192 or sw_fill_smem_bytes(lx, ly) > SMEM_LIMIT:
        raise ValueError(f"sw_fill kernel: lx={lx}, ly={ly} exceed its "
                         "8,192-row / shared-memory limits")
    route = sw_fill_route(lx)
    B = x_codes.shape[0]
    D = lx + ly + 1
    xc = x_codes.to(torch.int32).contiguous()
    yc = y_codes.to(torch.int32).contiguous()
    xl = x_len.to(torch.int32).contiguous()
    yl = y_len.to(torch.int32).contiguous()
    moves = torch.empty((B, D, lx + 1), dtype=torch.uint8, device=dev)
    best_sc = torch.empty((B, lx + 1), dtype=torch.float32, device=dev)
    best_d = torch.empty((B, lx + 1), dtype=torch.int32, device=dev)
    if B:
        kernels.launch(
            "sw_fill", xc.data_ptr(), yc.data_ptr(), xl.data_ptr(), yl.data_ptr(),
            B, lx, ly, *(ct.c_float(_f32(w)) for w in
                         (w_match, w_mismatch, w_insert, w_delete)),
            _SW_FILL_ROUTES[route], moves.data_ptr(), best_sc.data_ptr(),
            best_d.data_ptr(), device=xc.device, variant=route,
        )
    return moves, best_sc, best_d


# ------------------------------------------------------- score-only fill


def _score_weights(dtype_name, w_match, w_mismatch, w_insert, w_delete, lx, ly):
    """Validate a score type against the weights -> the per-shift decay
    constants of the delete chain (shifts s = 1, 2, 4, ... < lx), each
    computed as the TPU kernel computes it: ``np.float32(s) *
    np.float32(w_delete)`` for f32 and bf16 (rounded once more to bf16
    where used), ``T(s * w_delete)`` for the integer types."""
    if dtype_name not in _DTYPES:
        raise ValueError(f"unknown score type {dtype_name!r} (f32, i32, i16, bf16)")
    weights = (w_match, w_mismatch, w_insert, w_delete)
    if dtype_name in ("i16", "i32"):
        for w in weights:
            if not float(w).is_integer():
                raise ValueError(
                    f"integer SW dtype {dtype_name} needs integral weights, got {w}"
                )
        if dtype_name == "i16" and not _i16_safe(lx, ly, *weights):
            raise ValueError(
                "i16 SW overflow risk for these weights/lengths "
                f"(lx={lx}, ly={ly}) — use f32 or i32"
            )
    shifts = []
    s = 1
    while s < lx:
        shifts.append(s)
        s *= 2
    if dtype_name in ("f32", "bf16"):
        decays = [float(np.float32(s) * np.float32(w_delete)) for s in shifts]
    else:
        decays = [int(s * w_delete) for s in shifts]
    return shifts, decays


def sw_score_plain(x_codes, x_len, y_codes, y_len, w_match, w_mismatch,
                   w_insert, w_delete, lx: int, ly: int, dtype_name: str = "f32"):
    """Plain PyTorch version of the score-only fill -> f32[B]: a Python
    loop over the ly columns of ``[B, lx]`` ops in the score type, the
    same-row delete chain H[i] = max(tmp[i], H[i-1] + wd) solved by the
    doubling steps of the JAX package's ``_sw_score_scan`` /
    ``_sw_score_kernel`` (pad -inf, or -16384 for the integer types,
    then a clamp at 0).  In bf16 every torch op rounds once to bf16, as
    the kernel's ``__hadd``/``__hmax``/``__hmul`` do."""
    shifts, decays = _score_weights(dtype_name, w_match, w_mismatch,
                                    w_insert, w_delete, lx, ly)
    dt = _DTYPES[dtype_name]
    dev = x_codes.device
    B = x_codes.shape[0]
    integral = dtype_name in ("i16", "i32")

    def const(v):
        return torch.tensor(int(v) if integral else _f32(v), dtype=dt, device=dev)

    wm, wx, wi = const(w_match), const(w_mismatch), const(w_insert)
    dec = [const(d) for d in decays]
    zero = torch.zeros((), dtype=dt, device=dev)
    pad = -16384 if integral else float("-inf")
    in_x = (torch.arange(1, lx + 1, device=dev)[None, :]
            <= x_len.to(torch.int64)[:, None])
    yl = y_len.to(torch.int64)
    h_prev = torch.zeros((B, lx + 1), dtype=dt, device=dev)
    best = torch.zeros((B, lx), dtype=dt, device=dev)
    for j in range(ly):
        jok = (j + 1) <= yl
        sub = torch.where(x_codes == y_codes[:, j:j + 1], wm, wx)
        m = h_prev[:, :-1] + sub
        inn = h_prev[:, 1:] + wi
        h = torch.maximum(torch.maximum(m, inn), zero)
        for s, d in zip(shifts, dec):
            shifted = torch.cat(
                [torch.full((B, s), pad, dtype=dt, device=dev), h[:, :-s]], dim=1
            ) + d
            h = torch.maximum(h, shifted)
        h = torch.maximum(h, zero)
        h = torch.where(in_x & jok[:, None], h, zero)
        best = torch.maximum(best, h)
        h_prev = torch.nn.functional.pad(h, (1, 0))
    return best.max(dim=1).values.to(torch.float32)


def _i16_safe(lx: int, ly: int, w_match: float, w_mismatch: float,
              w_insert: float, w_delete: float) -> bool:
    """Whether the i16 score fill cannot overflow for these shapes and
    (integral) weights: score magnitudes, and the delete chain's decay
    constants, whose shift distance the JAX package bounds by the
    128-lane-padded L (kept here, so both accept the same inputs)."""
    if not all(
        float(w).is_integer()
        for w in (w_match, w_mismatch, w_insert, w_delete)
    ):
        return False
    wmax = max(abs(w_match), abs(w_mismatch), abs(w_insert), abs(w_delete))
    L = _round_up(lx, _LANE)
    return (max(lx, ly) + 1) * wmax < 16000 and L * abs(w_delete) < 16000


def sw_best_scores(x_codes, x_len, y_codes, y_len,
                   w_match: float = 1.0, w_mismatch: float = -0.333,
                   w_insert: float = -0.5, w_delete: float = -0.5,
                   dtype_name: str = "f32"):
    """Best local-alignment score per pair (no trackback) -> f32[B].

    ``dtype_name`` is the score type: "f32" (exact for the fractional
    default weights), or "i32"/"i16" for integral weights ("i16" only
    within :func:`_i16_safe`), or the JAX package's measurement-only
    "bf16" (integer scores above 256 round).  The CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check_pair_inputs(x_codes, x_len, y_codes, y_len)
    lx = int(x_codes.shape[1])
    ly = int(y_codes.shape[1])
    dev = x_codes.device
    if dev.type == "cpu":
        return sw_score_plain(x_codes, x_len, y_codes, y_len, w_match,
                              w_mismatch, w_insert, w_delete, lx, ly, dtype_name)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _score_weights(dtype_name, w_match, w_mismatch, w_insert, w_delete, lx, ly)
    if lx > 1024:
        raise ValueError(f"sw_score kernel: lx={lx} exceeds its 1,024 rows")
    B = x_codes.shape[0]
    out = torch.empty(B, dtype=torch.float32, device=dev)
    if B:
        xc = x_codes.to(torch.int32).contiguous()
        yc = y_codes.to(torch.int32).contiguous()
        xl = x_len.to(torch.int32).contiguous()
        yl = y_len.to(torch.int32).contiguous()
        kernels.launch(
            "sw_score", xc.data_ptr(), yc.data_ptr(), xl.data_ptr(), yl.data_ptr(),
            B, lx, ly, *(ct.c_float(_f32(w)) for w in
                         (w_match, w_mismatch, w_insert, w_delete)),
            _DTYPE_CODES[dtype_name], out.data_ptr(), device=xc.device,
        )
    return out


def benchmark_gcups(B: int = 8192, lx: int = 127, ly: int = 127, reps: int = 6,
                    dtype_name: str = "f32", trials: int = 3,
                    device: str = "cuda") -> float:
    """Measured score-only fill throughput in GCUPS (giga cell updates per
    second, B·lx·ly over the time of one fill), the best of ``trials``
    timed runs of ``reps`` fills each.  Integer score types and bf16 use the
    integral scheme (2, -1, -1, -1) SW search tools bench with, f32 the
    fractional defaults.  On the card the time comes from CUDA events."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    xc = torch.from_numpy(rng.integers(0, 4, (B, lx)).astype(np.int32)).to(dev)
    yc = torch.from_numpy(rng.integers(0, 4, (B, ly)).astype(np.int32)).to(dev)
    xl = torch.full((B,), lx, dtype=torch.int32, device=dev)
    yl = torch.full((B,), ly, dtype=torch.int32, device=dev)
    args = (1.0, -0.333, -0.5, -0.5) if dtype_name == "f32" else (2.0, -1.0, -1.0, -1.0)

    def run():
        for _ in range(reps):
            sw_best_scores(xc, xl, yc, yl, *args, dtype_name=dtype_name)

    run()  # warm (builds the kernel on first use)
    best_s = float("inf")
    for _ in range(max(1, trials)):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            stop.record()
            torch.cuda.synchronize()
            secs = start.elapsed_time(stop) / 1e3
        else:
            t0 = time.perf_counter()
            run()
            secs = time.perf_counter() - t0
        best_s = min(best_s, secs / reps)
    return B * lx * ly / best_s / 1e9


# ------------------------------------------------------------ trackback


@dataclass(frozen=True)
class SWAlignment:
    cigar_x: str
    cigar_y: str
    x_start: int
    y_start: int
    x_end: int  # exclusive end of the aligned span in x
    y_end: int
    score: float


def _max_coordinates(
    best_sc: np.ndarray, best_d: np.ndarray, x_len: int
) -> tuple[int, int, float]:
    """Reference tie rule from the per-lane best arrays: the global max
    with the LAST row i winning ties, then the LAST column j
    (maxCoordinates' right-biased fold; the per-lane max already kept
    the largest diagonal = largest j within each row)."""
    lanes = best_sc[: x_len + 1]
    best = lanes.max()
    i = int(np.flatnonzero(lanes == best).max())
    j = int(best_d[i]) - i
    return i, j, float(best)


def _rnn_to_cigar(ops: list[str]) -> str:
    """Reversed unit-length op list -> run-length CIGAR string."""
    if not ops:
        return ""
    out = []
    last, run = ops[0], 1
    for c in ops[1:]:
        if c == last:
            run += 1
        else:
            out.append(f"{run}{last}")
            last, run = c, 1
    out.append(f"{run}{last}")
    return "".join(reversed(out))


def _trackback(
    diag_moves: np.ndarray, best_sc: np.ndarray, best_d: np.ndarray,
    x_len: int,
) -> SWAlignment:
    i, j, score = _max_coordinates(best_sc, best_d, x_len)
    end_i, end_j = i, j
    cx: list[str] = []
    cy: list[str] = []
    while diag_moves[i + j, i] != MOVE_T:
        mv = diag_moves[i + j, i]
        if mv == MOVE_B:
            cx.append("M")
            cy.append("M")
            i -= 1
            j -= 1
        elif mv == MOVE_J:
            cx.append("I")
            cy.append("D")
            i -= 1
        else:
            cx.append("D")
            cy.append("I")
            j -= 1
    return SWAlignment(
        cigar_x=_rnn_to_cigar(cx),
        cigar_y=_rnn_to_cigar(cy),
        x_start=i,
        y_start=j,
        x_end=end_i,
        y_end=end_j,
        score=score,
    )


def smith_waterman_batch(
    x_codes,
    x_len,
    y_codes,
    y_len,
    w_match: float = 1.0,
    w_mismatch: float = -0.333,
    w_insert: float = -0.5,
    w_delete: float = -0.5,
    device: str = "cuda",
    slot=None,
) -> list[SWAlignment]:
    """Align each x[i] against y[i] (padded code matrices + true lengths,
    numpy or tensors): the fill on ``device`` (or on a device pool's
    ``slot``, on its stream), the trackback on the host."""
    from adam_tpu_torch.parallel.device_pool import as_slot
    from adam_tpu_torch.utils.transfer import device_fetch

    slot = slot if slot is not None else as_slot(resolve_device(device))

    def put(a):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).to(slot.device)

    with slot.scope():
        x_codes, x_len, y_codes, y_len = (put(a) for a in (x_codes, x_len, y_codes, y_len))
        moves, best_sc, best_d = sw_fill(
            x_codes, x_len, y_codes, y_len, w_match, w_mismatch, w_insert, w_delete,
            int(x_codes.shape[1]), int(y_codes.shape[1]),
        )
    moves, best_sc, best_d, xl = (device_fetch(t, slot)
                                  for t in (moves, best_sc, best_d, x_len))
    return [
        _trackback(moves[b], best_sc[b], best_d[b], int(xl[b]))
        for b in range(moves.shape[0])
    ]


def smith_waterman(
    x: str,
    y: str,
    w_match: float = 1.0,
    w_mismatch: float = -0.333,
    w_insert: float = -0.5,
    w_delete: float = -0.5,
    device: str = "cuda",
) -> SWAlignment:
    """Single-pair convenience wrapper (strings in, CIGARs out)."""
    return smith_waterman_batch(
        schema.encode_bases(x)[None, :], np.array([len(x)]),
        schema.encode_bases(y)[None, :], np.array([len(y)]),
        w_match, w_mismatch, w_insert, w_delete, device=device,
    )[0]


#: bytes of moves one fill may write; larger batches are chunked
MOVES_BYTES_PER_LAUNCH = 256 << 20


def smith_waterman_many(pairs, w_match: float = 1.0, w_mismatch: float = -0.333,
                        w_insert: float = -0.5, w_delete: float = -0.5,
                        device: str = "cuda", sweep_devices=None) -> list[SWAlignment]:
    """Align many (x, y) pairs of base-code arrays -> one alignment per
    pair, in input order.  Pairs are grouped into padded-shape buckets
    (x to a multiple of 32, y to a multiple of 128) and each bucket runs
    as one :func:`smith_waterman_batch`, chunked so that its moves matrix
    stays within :data:`MOVES_BYTES_PER_LAUNCH`.  Every pair's cells are
    computed alone, and padding lies outside its valid region, so each
    result equals the pair's own unpadded call.  With ``sweep_devices``
    (two or more pool slots) the launches go round the slots of a
    ``parallel/device_pool.SweepSchedule``; the results are the same."""
    from adam_tpu_torch.parallel.device_pool import SweepSchedule

    sched = (SweepSchedule(sweep_devices)
             if sweep_devices is not None and len(sweep_devices) > 1 else None)
    buckets: dict = {}
    for k, (x, y) in enumerate(pairs):
        key = (_round_up(max(len(x), 1), 32), _round_up(max(len(y), 1), 128))
        buckets.setdefault(key, []).append(k)
    out: list = [None] * len(pairs)
    for (lx, ly), idx in sorted(buckets.items()):
        per_pair = (lx + ly + 1) * (lx + 1)
        chunk = max(1, MOVES_BYTES_PER_LAUNCH // per_pair)
        for c0 in range(0, len(idx), chunk):
            part = idx[c0:c0 + chunk]
            xc = np.full((len(part), lx), schema.BASE_PAD, np.uint8)
            yc = np.full((len(part), ly), schema.BASE_PAD, np.uint8)
            xl = np.zeros(len(part), np.int32)
            yl = np.zeros(len(part), np.int32)
            for r, k in enumerate(part):
                x, y = pairs[k]
                xc[r, :len(x)] = x
                yc[r, :len(y)] = y
                xl[r], yl[r] = len(x), len(y)
            alns = smith_waterman_batch(
                xc, xl, yc, yl, w_match, w_mismatch, w_insert, w_delete, device=device,
                slot=sched.next_device() if sched is not None else None)
            for k, a in zip(part, alns):
                out[k] = a
    return out
