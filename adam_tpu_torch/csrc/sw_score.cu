// Score-only Smith-Waterman fill (the GCUPS path) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel adam_tpu/ops/smith_waterman.py:
// _sw_score_pallas (body _sw_score_kernel).  Per pair b it returns the
// best local-alignment score, f32[B].  Column j of the matrix is computed
// from column j-1 (row k holds matrix row k+1):
//   tmp[k] = max(max(H[k-1] + sub, H[k] + w_insert), 0)      (H[-1] = 0)
// then the same-row delete chain H[k] = max(tmp[k], H[k-1] + w_delete)
// is solved, as in the JAX package, by doubling steps s = 1, 2, 4, ... < lx:
//   h[k] = max(h[k], h[k-s] + decay_s)   (rows k < s: the pad never wins)
// with decay_s = float32(s) * float32(w_delete) for f32 (written as
// __fmul_rn so it is never fused into the add) and T(s * w_delete) for the
// integer types, then a clamp at 0 and the pair's row/column mask.  The
// running best starts at 0.  The order of the doubling steps is kept: in
// f32 the sequential chain rounds differently once w_delete is not a
// dyadic fraction.  Templated on the score type: f32, i32, and i16 for
// integral weights within the wrapper's overflow guard, and the JAX
// package's measurement-only bf16: every add, max and mask product is one
// __hadd / __hmax / __hmul on __nv_bfloat16 (one rounding each), the
// weights and decays rounded once from f32, the mask applied as the
// Pallas kernel's h * xmask * jok.  Every value is bit-equal to the plain
// version and to the JAX fills.
//
// Bound: operations.  Per cell 6 + 2*ceil(log2(lx)) + 3 operations (23 at
// lx = 127: the substitution's compare and select, two adds and two
// maxes, an add and a max per doubling step, then the clamp, the mask and
// the best's max) on inputs of ~2 bytes per pair row, at the card's
// instruction issue rate (one per lane per clock), not memory.
//
// Design: one warp per pair, no shared memory and no block barrier.  Lane
// t holds rows [R*t, R*t + R) in registers (R = the power of two >= lx/32,
// a template parameter, lx <= 1024): each row's H, its x code and mask,
// and the lane's running best.  The first row's H[k-1] comes from lane
// t-1 by one __shfl_up_sync.  A doubling step with s < R reads the lane's
// own registers and the last s rows of lane t-1 (shuffled by one lane); a
// step with s >= R shuffles every register up by s/R lanes.  Lanes whose
// source lies above row 0 keep their value: the pad (-inf, or -16384 for
// the integer types) plus a decay never beats H >= 0, so skipping it gives
// the same bits.  The y codes come 32 columns at a time into one register
// per lane and are broadcast by __shfl_sync, one per column.  Columns past
// y_len only leave H at 0 and the best as it is, so the loop ends there.
// The i16 route packs two pairs per warp into the 16-bit halves of each
// register and uses Hopper's DPX instructions: tmp is one
// __viaddmax_s16x2_relu(H[k-1], sub, H[k] + w_insert), each doubling step
// one __viaddmax_s16x2, exact within the wrapper's guard (-16384 plus the
// largest decay stays above -32768; the pad is never formed anyway).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxShifts = 10;  // s = 1 .. 512 < lx <= 1024

template <typename T>
__device__ __forceinline__ T cvt(float v) {
  return (T)v;
}
template <>
__device__ __forceinline__ bf16 cvt<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  return (float)v;
}
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T add(T a, T b) {
  return (T)(a + b);
}
template <>
__device__ __forceinline__ float add<float>(float a, float b) {
  return __fadd_rn(a, b);
}
template <>
__device__ __forceinline__ bf16 add<bf16>(bf16 a, bf16 b) {
  return __hadd(a, b);
}

template <typename T>
__device__ __forceinline__ T mx(T a, T b) {
  return a > b ? a : b;
}
template <>
__device__ __forceinline__ float mx<float>(float a, float b) {
  return fmaxf(a, b);
}
template <>
__device__ __forceinline__ bf16 mx<bf16>(bf16 a, bf16 b) {
  return __hmax(a, b);
}

// the pair's row mask (the column mask is 1 inside the loop): a select
// (v >= 0, so the JAX product h * xmask * jok gives the same), or for
// bf16 that product itself
template <typename T>
__device__ __forceinline__ T masked(T v, bool row_in) {
  return row_in ? v : cvt<T>(0.f);
}
template <>
__device__ __forceinline__ bf16 masked<bf16>(bf16 v, bool row_in) {
  return __hmul(__hmul(v, cvt<bf16>(row_in ? 1.f : 0.f)), cvt<bf16>(1.f));
}

template <typename T>
__device__ __forceinline__ T decay(int s, float w_delete) {
  return (T)((double)s * (double)w_delete);
}
template <>
__device__ __forceinline__ float decay<float>(int s, float w_delete) {
  return __fmul_rn((float)s, w_delete);
}
template <>
__device__ __forceinline__ bf16 decay<bf16>(int s, float w_delete) {
  return __float2bfloat16_rn(__fmul_rn((float)s, w_delete));
}

template <typename T>
__device__ __forceinline__ T shfl_up(T v, int delta) {
  return __shfl_up_sync(kFull, v, delta);
}
template <>
__device__ __forceinline__ bf16 shfl_up<bf16>(bf16 v, int delta) {
  return __ushort_as_bfloat16(
      (unsigned short)__shfl_up_sync(kFull, (unsigned)__bfloat16_as_ushort(v), delta));
}

// tag of the i16 route: two pairs in the 16-bit halves of a u32
struct I16x2 {};

// h[k] = max(h[k], h[k-s] + dec) for s = 1 << K, in place; rows whose
// source lies above row 0 keep their value.  Then the steps K+1, ... < lx.
template <typename V, int R, int K, typename Step>
__device__ __forceinline__ void doubling(V (&h)[R], const V (&dec)[kMaxShifts],
                                         int lx, int lane, Step step) {
  if constexpr ((1 << K) < 32 * R && K < kMaxShifts) {
    constexpr int s = 1 << K;
    // 16R < lx <= 32R for R > 1 (launch_rows), so only R = 1 stops early
    if constexpr (R == 1)
      if (s >= lx) return;
    if constexpr (s < R) {
      V nb[s];  // lane t-1's last s rows
#pragma unroll
      for (int q = 0; q < s; ++q) nb[q] = shfl_up(h[R - s + q], 1);
#pragma unroll
      for (int q = 0; q < R; ++q) {  // rows below r still hold step K-1
        const int r = R - 1 - q;
        if (r >= s)
          h[r] = step(h[r - s], dec[K], h[r]);
        else if (lane > 0)
          h[r] = step(nb[r], dec[K], h[r]);
      }
    } else {
      constexpr int delta = s / R;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const V v = shfl_up(h[r], delta);
        if (lane >= delta) h[r] = step(v, dec[K], h[r]);
      }
    }
    doubling<V, R, K + 1>(h, dec, lx, lane, step);
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    sw_score_warp(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                  const int32_t* __restrict__ x_len,
                  const int32_t* __restrict__ y_len, int64_t B, int lx, int ly,
                  float w_match, float w_mismatch, float w_insert,
                  float w_delete, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const int xl = x_len[b];
  const int yl = y_len[b];
  const T wm = cvt<T>(w_match), wx = cvt<T>(w_mismatch), wi = cvt<T>(w_insert);
  const T zero = cvt<T>(0.f);
  T dec[kMaxShifts];
#pragma unroll
  for (int k = 0; k < kMaxShifts; ++k)
    dec[k] = (1 << k) < lx ? decay<T>(1 << k, w_delete) : zero;
  int xr[R];
  bool in_x[R];
  T h[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = R * lane + r;
    xr[r] = k < lx ? x[b * lx + k] : -1;
    in_x[r] = k < lx && k + 1 <= xl;
    h[r] = zero;
  }
  T best = zero;
  const int ncols = yl < 0 ? 0 : (yl < ly ? yl : ly);
  const int32_t* yb = y + b * ly;
  int ynext = lane < ncols ? yb[lane] : -1;
  for (int j0 = 0; j0 < ncols; j0 += 32) {
    const int ychunk = ynext;
    if (j0 + 32 + lane < ncols) ynext = yb[j0 + 32 + lane];
    const int jn = ncols - j0 < 32 ? ncols - j0 : 32;
    for (int jj = 0; jj < jn; ++jj) {
      const int yj = __shfl_sync(kFull, ychunk, jj);
      const T top = shfl_up(h[R - 1], 1);
#pragma unroll
      for (int q = 0; q < R; ++q) {  // rows below r still hold column j-1
        const int r = R - 1 - q;
        const T hm1 = r ? h[r - 1] : (lane ? top : zero);
        const T sub = xr[r] == yj ? wm : wx;
        h[r] = mx(mx(add(hm1, sub), add(h[r], wi)), zero);
      }
      doubling<T, R, 0>(h, dec, lx, lane,
                        [](T src, T d, T v) { return mx(v, add(src, d)); });
#pragma unroll
      for (int r = 0; r < R; ++r) {
        h[r] = masked(mx(h[r], zero), in_x[r]);
        best = mx(best, h[r]);
      }
    }
  }
  float bf = to_f32(best);
  for (int o = 16; o > 0; o >>= 1)
    bf = fmaxf(bf, __shfl_down_sync(kFull, bf, o));
  if (lane == 0) out[b] = bf;
}

// i16, two pairs per warp (b0 in the low halves, b0 + 1 in the high)
template <int R>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    sw_score_i16x2(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                   const int32_t* __restrict__ x_len,
                   const int32_t* __restrict__ y_len, int64_t B, int lx,
                   int ly, float w_match, float w_mismatch, float w_insert,
                   float w_delete, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t b0 =
      2 * ((int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5));
  if (b0 >= B) return;  // the whole warp
  const bool has_hi = b0 + 1 < B;
  const int xl0 = x_len[b0], xl1 = has_hi ? x_len[b0 + 1] : 0;
  const int yl0 = y_len[b0], yl1 = has_hi ? y_len[b0 + 1] : 0;
  const auto pack = [](int lo, int hi) {
    return ((unsigned)lo & 0xffffu) | ((unsigned)hi << 16);
  };
  const auto half = [&](int v) { return pack(v, v); };
  const unsigned wm_lo = (unsigned)(int)w_match & 0xffffu,
                 wx_lo = (unsigned)(int)w_mismatch & 0xffffu;
  const unsigned wm_hi = wm_lo << 16, wx_hi = wx_lo << 16;
  const unsigned wi = half((int)w_insert);
  unsigned dec[kMaxShifts];
#pragma unroll
  for (int k = 0; k < kMaxShifts; ++k)
    dec[k] = (1 << k) < lx ? half(decay<int16_t>(1 << k, w_delete)) : 0u;
  int x0[R], x1[R];
  unsigned row_mask[R], h[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = R * lane + r;
    x0[r] = k < lx ? x[b0 * lx + k] : -1;
    x1[r] = k < lx && has_hi ? x[(b0 + 1) * lx + k] : -1;
    row_mask[r] = (k < lx && k + 1 <= xl0 ? 0xffffu : 0u) |
                  (k < lx && k + 1 <= xl1 ? 0xffff0000u : 0u);
    h[r] = 0u;
  }
  unsigned best = 0u;
  const int n0 = yl0 < 0 ? 0 : (yl0 < ly ? yl0 : ly);
  const int n1 = yl1 < 0 ? 0 : (yl1 < ly ? yl1 : ly);
  const int ncols = n0 > n1 ? n0 : n1;
  const int32_t* y0 = y + b0 * ly;
  const int32_t* y1 = has_hi ? y0 + ly : y0;
  int next0 = lane < ncols ? y0[lane] : -1;
  int next1 = lane < ncols ? y1[lane] : -1;
  for (int j0 = 0; j0 < ncols; j0 += 32) {
    const int c0 = next0, c1 = next1;
    if (j0 + 32 + lane < ncols) {
      next0 = y0[j0 + 32 + lane];
      next1 = y1[j0 + 32 + lane];
    }
    const int jn = ncols - j0 < 32 ? ncols - j0 : 32;
    for (int jj = 0; jj < jn; ++jj) {
      const int j = j0 + jj;
      const int ya = __shfl_sync(kFull, c0, jj);
      const int yb = __shfl_sync(kFull, c1, jj);
      // j < y_len of the pair in each half
      const unsigned col_mask = (j < n0 ? 0xffffu : 0u) | (j < n1 ? 0xffff0000u : 0u);
      const unsigned top = __shfl_up_sync(kFull, h[R - 1], 1);
#pragma unroll
      for (int q = 0; q < R; ++q) {  // rows below r still hold column j-1
        const int r = R - 1 - q;
        const unsigned hm1 = r ? h[r - 1] : (lane ? top : 0u);
        const unsigned sub = (x0[r] == ya ? wm_lo : wx_lo) | (x1[r] == yb ? wm_hi : wx_hi);
        h[r] = __viaddmax_s16x2_relu(hm1, sub, __vadd2(h[r], wi));
      }
      doubling<unsigned, R, 0>(h, dec, lx, lane, [](unsigned src, unsigned d,
                                                     unsigned v) {
        return __viaddmax_s16x2(src, d, v);
      });
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // H >= 0 already (the relu, then maxes), so the JAX clamp is exact
        h[r] &= row_mask[r] & col_mask;
        best = __vimax_s16x2_relu(best, h[r]);
      }
    }
  }
  int lo = (int16_t)(best & 0xffffu), hi = (int16_t)(best >> 16);
  for (int o = 16; o > 0; o >>= 1) {
    lo = max(lo, __shfl_down_sync(kFull, lo, o));
    hi = max(hi, __shfl_down_sync(kFull, hi, o));
  }
  if (lane == 0) {
    out[b0] = (float)lo;
    if (has_hi) out[b0 + 1] = (float)hi;
  }
}

template <typename T, int R>
int launch(const void* x, const void* y, const void* x_len, const void* y_len,
           int64_t B, int lx, int ly, float wm, float wx, float wi, float wd,
           void* out, cudaStream_t stream) {
  constexpr bool packed = std::is_same<T, I16x2>::value;
  const int64_t warps = packed ? (B + 1) / 2 : B;
  const unsigned blocks = (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int32_t *xi = (const int32_t*)x, *yi = (const int32_t*)y;
  const int32_t *xli = (const int32_t*)x_len, *yli = (const int32_t*)y_len;
  if constexpr (packed)
    sw_score_i16x2<R><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        xi, yi, xli, yli, B, lx, ly, wm, wx, wi, wd, (float*)out);
  else
    sw_score_warp<T, R><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        xi, yi, xli, yli, B, lx, ly, wm, wx, wi, wd, (float*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const void* x, const void* y, const void* x_len,
                const void* y_len, int64_t B, int lx, int ly, float wm,
                float wx, float wi, float wd, void* out, cudaStream_t s) {
  // R = the least power of two with 32 * R >= lx
  if (lx <= 32) return launch<T, 1>(x, y, x_len, y_len, B, lx, ly, wm, wx, wi, wd, out, s);
  if (lx <= 64) return launch<T, 2>(x, y, x_len, y_len, B, lx, ly, wm, wx, wi, wd, out, s);
  if (lx <= 128) return launch<T, 4>(x, y, x_len, y_len, B, lx, ly, wm, wx, wi, wd, out, s);
  if (lx <= 256) return launch<T, 8>(x, y, x_len, y_len, B, lx, ly, wm, wx, wi, wd, out, s);
  if (lx <= 512) return launch<T, 16>(x, y, x_len, y_len, B, lx, ly, wm, wx, wi, wd, out, s);
  return launch<T, 32>(x, y, x_len, y_len, B, lx, ly, wm, wx, wi, wd, out, s);
}

}  // namespace

// dtype: 0 f32, 1 i32, 2 i16 (two pairs a warp, DPX), 3 bf16
extern "C" int sw_score_launch(const void* x, const void* y,
                               const void* x_len, const void* y_len,
                               int64_t B, int64_t lx, int64_t ly, float wm,
                               float wx, float wi, float wd, int dtype,
                               void* out, void* stream) {
  if (B <= 0) return 0;
  if (lx < 1 || lx > 1024 || ly < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nx = (int)lx, ny = (int)ly;
  switch (dtype) {
    case 0:
      return launch_rows<float>(x, y, x_len, y_len, B, nx, ny, wm, wx, wi, wd, out, s);
    case 1:
      return launch_rows<int32_t>(x, y, x_len, y_len, B, nx, ny, wm, wx, wi, wd, out, s);
    case 2:
      return launch_rows<I16x2>(x, y, x_len, y_len, B, nx, ny, wm, wx, wi, wd, out, s);
    case 3:
      return launch_rows<bf16>(x, y, x_len, y_len, B, nx, ny, wm, wx, wi, wd, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
