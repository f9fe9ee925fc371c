// Smith-Waterman fill with moves, in diagonal layout, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel adam_tpu/ops/smith_waterman.py:
// _sw_fill_pallas (body _sw_kernel).  For every pair b, cell (i, j) of the
// (lx+1) x (ly+1) matrix lives at diagonal d = i + j, lane i:
//   moves[b, d, i]   u8 move code (0 T, 1 B, 2 J, 3 I)
// and for every matrix row i the running best over its diagonals:
//   best_sc[b, i]    f32 max score over the row's cells inside the pair's
//                    region (-inf when none), ties to the later diagonal
//   best_d[b, i]     i32 diagonal of that cell (D - 1 when none: -inf ties
//                    update on every diagonal).
// The recurrence is the JAX one, in float32 and in the same order:
//   m = d2[i-1] + sub, dd = d1[i-1] + w_delete, inn = d1[i] + w_insert,
// take B if m >= dd && m >= inn && m > 0, else J if dd >= inn && dd > 0,
// else I if inn > 0, else terminate.  Only additions and comparisons, so
// (built without fast-math, adds written as __fadd_rn) every value is
// bit-equal to the plain version and to the XLA scan.
//
// Bound: the output contract makes the kernel write all B*D*(lx+1) move
// bytes (268 MB at the smithwaterman path's median launch, ~0.08 ms at
// 3.35 TB/s); the pairs' own cells, one byte each, and ~12 operations per
// interior cell at the card's issue rate bound it lower (chip_smoke.py).
//
// Two routes, picked by the wrapper from lx alone:
//
// * warp (lx <= kWarpMaxRows): one warp per pair, no block barrier, so
//   the warps of a block are independent pairs.  Lane t holds matrix rows
//   1 + R*t .. R + R*t (R = ceil(lx/32), a template parameter) in
//   registers: each row's scores on diagonals d-1 and d-2, its x code, its
//   running best.  Row 0 is the border (score 0, move T).  A row's first
//   cell reads row i-1 of lane t-1: one __shfl_up_sync of the last row's
//   new score per diagonal, kept one diagonal more for d-2.  The y code of
//   cell (i, j) is the one row i-1 used on the diagonal before, so the
//   codes move down the rows one per diagonal (a shuffle at the lane edge,
//   lane 0 taking y[d-2] from the warp's i32 copy of y in shared memory).
//   Move bytes go into a staging tile in the warp's shared memory,
//   kTileDiags diagonals x (lx+1) bytes, which is one contiguous span of
//   the pair's slab; the warp flushes it with 16-byte stores aligned to
//   the span's global 16-byte boundaries, byte stores only at its two
//   ends (as pack_rows.cu does), so no two warps ever write one byte.
//   Diagonals past x_len + y_len hold no cell of the pair: they are not
//   computed, only written as T with 16-byte stores.
// * block (longer rows): one CTA per pair, threads over rows (each owns up
//   to kRowsPerThread rows, strided by blockDim), three rotating shared
//   diagonals and one barrier per diagonal; byte stores, coalesced.
//
// The wrapper allocates every output; each route writes every element.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerThread = 8;
constexpr int kWarpMaxRows = 128;  // the warp route's lx limit: R <= 4
constexpr int kTileDiags = 32;     // diagonals per staged tile
constexpr int kWarpsPerBlock = 4;
constexpr int kSmemLimit = 232448;  // shared bytes a Hopper block can use
constexpr unsigned kFull = 0xffffffffu;
constexpr uint8_t kMoveT = 0, kMoveB = 1, kMoveJ = 2, kMoveI = 3;

// The move rule of one valid cell -> (score, move): B if m >= dd && m >=
// inn && m > 0, else J if dd >= inn && dd > 0, else I if inn > 0, else T
// with score 0.  Whichever it takes is the largest of m, dd, inn when that
// is positive (ties to B, then J), so the score is max(m, dd, inn, 0) and
// the move follows from which one equals it: the same bits without
// branches, since no value here is NaN or -0 (the scores start at +0 and
// every add of a score and a weight rounds to nearest).
__device__ __forceinline__ float move_rule(float m, float dd, float inn,
                                           uint8_t& mv) {
  const float s = fmaxf(fmaxf(m, dd), fmaxf(inn, 0.f));
  mv = s > 0.f ? (m == s ? kMoveB : (dd == s ? kMoveJ : kMoveI)) : kMoveT;
  return s;
}

// shared bytes of one warp on the warp route: the staging tile (plus the
// up-to-15-byte shift that aligns it to the span) and y as i32
__host__ __device__ constexpr int warp_stage_bytes(int L) {
  return (kTileDiags * L + 16 + 15) / 16 * 16;
}
__host__ __device__ constexpr int warp_smem_bytes(int L, int ly) {
  return warp_stage_bytes(L) + (4 * ly + 15) / 16 * 16;
}

// Write n bytes at dst: dst[k] = stage[(dst & 15) + k], or 0 when stage is
// null.  16-byte chunks of the aligned interior are one vector store each;
// the partial chunks at the two ends take byte stores.
__device__ __forceinline__ void flush_span(const uint8_t* stage, uint8_t* dst,
                                           int64_t n, int lane) {
  const int pad = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
  uint8_t* base = dst - pad;
  const int64_t end = pad + n;
  const int64_t chunks = (end + 15) >> 4;
  for (int64_t c = lane; c < chunks; c += 32) {
    const int64_t lo = c << 4;
    if (lo >= pad && lo + 16 <= end) {
      const uint4 v = stage ? *reinterpret_cast<const uint4*>(stage + lo)
                            : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(base + lo) = v;
    } else {
      const int64_t k1 = lo + 16 < end ? lo + 16 : end;
      for (int64_t k = lo > pad ? lo : pad; k < k1; ++k)
        base[k] = stage ? stage[k] : (uint8_t)0;
    }
  }
}

// at most 64 registers a thread: 32 warps an SM, so the 4,056 pairs of
// the smithwaterman path's median launch run in one wave
template <int R>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 8)
    sw_fill_warp_kernel(const int32_t* __restrict__ x,
                        const int32_t* __restrict__ y,
                        const int32_t* __restrict__ x_len,
                        const int32_t* __restrict__ y_len, int64_t B, int lx,
                        int ly, float wm, float wx, float wi, float wd,
                        uint8_t* __restrict__ moves,
                        float* __restrict__ best_sc,
                        int32_t* __restrict__ best_d) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp
  const int L = lx + 1;
  const int D = lx + ly + 1;
  uint8_t* stage = smem + (size_t)warp * warp_smem_bytes(L, ly);
  int32_t* ys = reinterpret_cast<int32_t*>(stage + warp_stage_bytes(L));
  const int xl = x_len[b];
  const int yl = y_len[b];
  for (int k = lane; k < ly; k += 32) ys[k] = y[b * ly + k];

  const int i0 = 1 + R * lane;  // the lane's first matrix row
  const int rows = lx - i0 + 1;  // the lane's rows r < rows exist
  int xr[R], yc[R], bd[R];
  unsigned lim[R];  // cell (i, j) is valid iff (unsigned)(j - 1) < lim
  float s1[R], s2[R], bsc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    const bool live = i <= lx && i <= xl && yl >= 0;
    xr[r] = i <= lx ? x[b * lx + i - 1] : -1;
    lim[r] = live ? (unsigned)yl : 0u;
    s1[r] = s2[r] = 0.f;
    // a live row's region starts at its border cell j = 0 (score 0 on
    // diagonal i); only its valid cells follow.  A row without one ends
    // at -inf and D - 1, as -inf ties update on every diagonal.
    bsc[r] = live ? 0.f : -INFINITY;
    bd[r] = live ? i : D - 1;
    yc[r] = -1;
  }
  float up1 = 0.f, up2 = 0.f;  // lane t-1's last row on d-1 and d-2
  const bool edge = lane == 0;
  __syncwarp();

  // Diagonal d: n1 holds the rows' scores on d-1, n2 on d-2 and takes d's;
  // e1 / e2 the same for lane t-1's last row.  Two calls per pair of
  // diagonals swap the roles, so no score is copied.
  const auto diagonal = [&](int d, uint8_t* row, float(&n1)[R], float(&n2)[R],
                            float& e1, float& e2) {
    const int yn = (unsigned)(d - 2) < (unsigned)ly ? ys[d - 2] : -1;
    const int ytop = __shfl_up_sync(kFull, yc[R - 1], 1);
#pragma unroll
    for (int q = 1; q < R; ++q) yc[R - q] = yc[R - q - 1];
    yc[0] = edge ? yn : ytop;
    const float a1 = edge ? 0.f : e1;
    const float a2 = edge ? 0.f : e2;
    const int jm = d - i0 - 1;  // j - 1 of the lane's first row
#pragma unroll
    for (int q = 0; q < R; ++q) {  // rows below r still hold d-1 and d-2
      const int r = R - 1 - q;
      const bool valid = (unsigned)(jm - r) < lim[r];
      const float sub = xr[r] == yc[r] ? wm : wx;
      uint8_t mv;
      float score = move_rule(__fadd_rn(r ? n2[r - 1] : a2, sub),
                              __fadd_rn(r ? n1[r - 1] : a1, wd),
                              __fadd_rn(n1[r], wi), mv);
      if (!valid) {
        score = 0.f;
        mv = kMoveT;
      }
      if (valid && score >= bsc[r]) {
        bsc[r] = score;
        bd[r] = d;
      }
      n2[r] = score;
      if (r < rows) row[r] = mv;
      // the last row: lane t+1 reads it on the next diagonal (a2 is taken)
      if (q == 0) e2 = __shfl_up_sync(kFull, score, 1);
    }
    if (edge) row[-1] = kMoveT;  // row 0
  };

  uint8_t* slab = moves + b * (int64_t)D * L;
  // the last diagonal with a cell of the pair is x_len + y_len
  const int64_t last = (int64_t)xl + yl;
  const int d_stop = last < 0 ? 0 : (last + 1 < D ? (int)last + 1 : D);
  for (int d0 = 0; d0 < d_stop; d0 += kTileDiags) {
    const int dn = d_stop - d0 < kTileDiags ? d_stop - d0 : kTileDiags;
    uint8_t* dst = slab + (int64_t)d0 * L;
    uint8_t* tile = stage + (reinterpret_cast<uintptr_t>(dst) & 15) + i0;
    int t = 0;
    for (; t + 1 < dn; t += 2) {
      diagonal(d0 + t, tile + t * L, s1, s2, up1, up2);
      diagonal(d0 + t + 1, tile + (t + 1) * L, s2, s1, up2, up1);
    }
    if (t < dn) {  // an odd tile (the last): one diagonal, then s1 newest
      diagonal(d0 + t, tile + t * L, s1, s2, up1, up2);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = s1[r];
        s1[r] = s2[r];
        s2[r] = v;
      }
      const float v = up1;
      up1 = up2;
      up2 = v;
    }
    __syncwarp();
    flush_span(stage, dst, (int64_t)dn * L, lane);
    __syncwarp();
  }
  flush_span(nullptr, slab + (int64_t)d_stop * L, (int64_t)(D - d_stop) * L,
             lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r;
    if (i <= lx) {
      best_sc[b * L + i] = bsc[r];
      best_d[b * L + i] = bd[r];
    }
  }
  if (lane == 0) {  // row 0: score 0 on diagonals 0..y_len when x_len >= 0
    const bool any = xl >= 0 && yl >= 0;
    best_sc[b * L] = any ? 0.f : -INFINITY;
    best_d[b * L] = any && yl < D - 1 ? yl : D - 1;
  }
}

__global__ void sw_fill_block_kernel(const int32_t* __restrict__ x,
                                     const int32_t* __restrict__ y,
                                     const int32_t* __restrict__ x_len,
                                     const int32_t* __restrict__ y_len, int lx,
                                     int ly, float wm, float wx, float wi,
                                     float wd, uint8_t* __restrict__ moves,
                                     float* __restrict__ best_sc,
                                     int32_t* __restrict__ best_d) {
  extern __shared__ float smem_f[];
  const int L = lx + 1;
  float* diag = smem_f;                                          // 3 * L
  int32_t* ys = reinterpret_cast<int32_t*>(smem_f + 3 * L);      // ly
  int32_t* xs = ys + ly;                                         // lx
  const int64_t b = blockIdx.x;
  const int xl = x_len[b];
  const int yl = y_len[b];
  const int D = lx + ly + 1;
  for (int k = threadIdx.x; k < 3 * L; k += blockDim.x) diag[k] = 0.f;
  for (int k = threadIdx.x; k < ly; k += blockDim.x) ys[k] = y[b * ly + k];
  for (int k = threadIdx.x; k < lx; k += blockDim.x) xs[k] = x[b * lx + k];
  float bsc[kRowsPerThread];
  int bd[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    bsc[r] = -INFINITY;
    bd[r] = 0;
  }
  __syncthreads();

  uint8_t* mv_pair = moves + b * (int64_t)D * L;
  for (int d = 0; d < D; ++d) {
    float* cur = diag + (d % 3) * L;
    const float* d1 = diag + ((d + 2) % 3) * L;
    const float* d2 = diag + ((d + 1) % 3) * L;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int i = threadIdx.x + r * blockDim.x;
      if (i <= lx) {
        const int j = d - i;
        float score = 0.f;
        uint8_t mv = kMoveT;
        if (i >= 1 && j >= 1 && i <= xl && j <= yl) {
          const float sub = xs[i - 1] == ys[j - 1] ? wm : wx;
          score = move_rule(__fadd_rn(d2[i - 1], sub), __fadd_rn(d1[i - 1], wd),
                            __fadd_rn(d1[i], wi), mv);
        }
        cur[i] = score;
        mv_pair[(int64_t)d * L + i] = mv;
        // running best over the region (incl. the zero borders i == 0 /
        // j == 0); ties -> later diagonal (larger j)
        const float c = (i <= xl && j >= 0 && j <= yl) ? score : -INFINITY;
        if (c >= bsc[r]) {
          bsc[r] = c;
          bd[r] = d;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = threadIdx.x + r * blockDim.x;
    if (i <= lx) {
      best_sc[b * L + i] = bsc[r];
      best_d[b * L + i] = bd[r];
    }
  }
}

template <int R>
int launch_warp(const void* x, const void* y, const void* x_len,
                const void* y_len, int64_t B, int lx, int ly, float wm,
                float wx, float wi, float wd, void* moves, void* best_sc,
                void* best_d, cudaStream_t stream) {
  // up to kWarpsPerBlock warps a block, as many as its shared memory holds
  const int per_warp = warp_smem_bytes(lx + 1, ly);
  int warps = kSmemLimit / per_warp;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  if (warps > kWarpsPerBlock) warps = kWarpsPerBlock;
  const size_t smem = (size_t)warps * per_warp;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_fill_warp_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (B + warps - 1) / warps;
  sw_fill_warp_kernel<R><<<(unsigned)blocks, warps * 32, smem, stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)x_len,
      (const int32_t*)y_len, B, lx, ly, wm, wx, wi, wd, (uint8_t*)moves,
      (float*)best_sc, (int32_t*)best_d);
  return (int)cudaGetLastError();
}

}  // namespace

// route: 0 warp (lx <= 128), 1 block (lx + 1 <= 8192)
extern "C" int sw_fill_launch(const void* x, const void* y, const void* x_len,
                              const void* y_len, int64_t B, int64_t lx,
                              int64_t ly, float wm, float wx, float wi,
                              float wd, int route, void* moves, void* best_sc,
                              void* best_d, void* stream) {
  if (B <= 0) return 0;
  if (lx < 1 || ly < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int L = (int)lx + 1;
  if (route == 0) {
    if (lx > kWarpMaxRows) return (int)cudaErrorInvalidValue;
    const int R = ((int)lx + 31) / 32;
    const auto args = [&](auto fn) {
      return fn(x, y, x_len, y_len, B, (int)lx, (int)ly, wm, wx, wi, wd, moves,
                best_sc, best_d, s);
    };
    switch (R) {
      case 1: return args(launch_warp<1>);
      case 2: return args(launch_warp<2>);
      case 3: return args(launch_warp<3>);
      default: return args(launch_warp<4>);
    }
  }
  if (route != 1 || L > 1024 * kRowsPerThread) return (int)cudaErrorInvalidValue;
  int threads = ((L + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = (size_t)(3 * L) * sizeof(float) +
                      (size_t)(lx + ly) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_fill_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sw_fill_block_kernel<<<(unsigned)B, threads, smem, s>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)x_len,
      (const int32_t*)y_len, (int)lx, (int)ly, wm, wx, wi, wd,
      (uint8_t*)moves, (float*)best_sc, (int32_t*)best_d);
  return (int)cudaGetLastError();
}
