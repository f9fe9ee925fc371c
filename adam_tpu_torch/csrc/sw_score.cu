// Score-only Smith-Waterman fill (the GCUPS path) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel adam_tpu/ops/smith_waterman.py:
// _sw_score_pallas (body _sw_score_kernel).  Per pair b it returns the
// best local-alignment score, f32[B].  Column j of the matrix is computed
// from column j-1 (lane t holds matrix row t+1):
//   tmp[t] = max(max(H[t-1] + sub, H[t] + w_insert), 0)      (H[-1] = 0)
// then the same-row delete chain H[t] = max(tmp[t], H[t-1] + w_delete)
// is solved, as in the JAX package, by doubling steps s = 1, 2, 4, ... < lx:
//   h[t] = max(h[t], h[t-s] + decay_s)   (rows t < s: the pad never wins)
// with decay_s = float32(s) * float32(w_delete) for f32 (written as
// __fmul_rn so it is never fused into the add) and T(s * w_delete) for the
// integer types, then a clamp at 0 and the pair's row/column mask.  The
// running best starts at 0.  Templated on the score type: f32, i32, and
// i16 for integral weights within the wrapper's overflow guard, and the
// JAX package's measurement-only bf16: every add, max and mask product is
// one __hadd / __hmax / __hmul on __nv_bfloat16 (one rounding each), the
// weights and decays rounded once from f32, the mask applied as the
// Pallas kernel's h * xmask * jok.  Every value is bit-equal to the plain
// version and to the JAX fills.
//
// Bound: operations.  Per cell 6 + 2*ceil(log2(lx)) + 3 integer/float
// operations (23 at lx = 127: the substitution's compare and select, two
// adds and two maxes, an add and a max per doubling step, then the clamp,
// the mask select and the best's max) on inputs of ~2 bytes per pair row,
// so the non-tensor operation rate, not memory, limits it.
//
// Design: one CTA per pair, one thread per matrix row (lx <= 1024).  Two
// ping-pong columns in shared memory carry the column-to-column state and
// every doubling step's shift; one barrier per step.  The y codes sit in
// shared memory, each row's x code in a register, the running best in a
// register, reduced over the block once at the end.  The Pallas kernel's
// transposed [L, TB] layout answered the TPU's sublane/lane tiling and has
// no counterpart here.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

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

// the pair's row/column mask: a select (v >= 0, so the JAX product
// h * xmask * jok gives the same), or for bf16 that product itself
template <typename T>
__device__ __forceinline__ T masked(T v, bool row_in, bool col_in) {
  return row_in && col_in ? v : cvt<T>(0.f);
}
template <>
__device__ __forceinline__ bf16 masked<bf16>(bf16 v, bool row_in, bool col_in) {
  return __hmul(__hmul(v, cvt<bf16>(row_in ? 1.f : 0.f)), cvt<bf16>(col_in ? 1.f : 0.f));
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
__global__ void sw_score_kernel(const int32_t* __restrict__ x,
                                const int32_t* __restrict__ y,
                                const int32_t* __restrict__ x_len,
                                const int32_t* __restrict__ y_len, int lx,
                                int ly, float w_match, float w_mismatch,
                                float w_insert, float w_delete,
                                float* __restrict__ out) {
  extern __shared__ int32_t smem_i[];
  __shared__ __align__(8) unsigned char dec_raw[32 * sizeof(T)];
  __shared__ float red[32];
  T* dec = reinterpret_cast<T*>(dec_raw);
  int32_t* ys = smem_i;                                   // ly
  T* h = reinterpret_cast<T*>(smem_i + ly);               // 2 * blockDim.x
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int xl = x_len[b];
  const int yl = y_len[b];
  const bool row_ok = t < lx;
  const bool in_x = row_ok && t + 1 <= xl;
  const int xc = row_ok ? x[b * lx + t] : 0;
  const T wm = cvt<T>(w_match), wx = cvt<T>(w_mismatch), wi = cvt<T>(w_insert);
  const T zero = cvt<T>(0.f);
  int n_shifts = 0;
  for (int s = 1; s < lx; s *= 2) ++n_shifts;
  for (int k = t; k < ly; k += nt) ys[k] = y[b * ly + k];
  if (t < n_shifts) dec[t] = decay<T>(1 << t, w_delete);
  h[t] = zero;
  __syncthreads();

  T best = zero;
  int cur = 0;
  for (int j = 0; j < ly; ++j) {
    T v = zero;
    if (row_ok) {
      const T hp_i = h[cur * nt + t];
      const T hp_im1 = t > 0 ? h[cur * nt + t - 1] : zero;
      const T sub = xc == ys[j] ? wm : wx;
      v = mx(mx(add(hp_im1, sub), add(hp_i, wi)), zero);
    }
    for (int k = 0; k < n_shifts; ++k) {
      cur ^= 1;
      h[cur * nt + t] = v;
      __syncthreads();
      const int s = 1 << k;
      if (row_ok && t >= s) v = mx(v, add(h[cur * nt + t - s], dec[k]));
    }
    v = masked(mx(v, zero), in_x, j + 1 <= yl);
    best = mx(best, v);
    cur ^= 1;
    h[cur * nt + t] = v;
    __syncthreads();
  }

  // block max of the per-row bests (exact: max of values, cast to f32)
  float bf = to_f32(best);
  for (int o = 16; o > 0; o >>= 1)
    bf = fmaxf(bf, __shfl_down_sync(0xffffffffu, bf, o));
  if ((t & 31) == 0) red[t >> 5] = bf;
  __syncthreads();
  if (t == 0) {
    float m = red[0];
    for (int w = 1; w < (nt + 31) / 32; ++w) m = fmaxf(m, red[w]);
    out[b] = m;
  }
}

template <typename T>
int launch(const void* x, const void* y, const void* x_len, const void* y_len,
           int64_t B, int64_t lx, int64_t ly, float wm, float wx, float wi,
           float wd, void* out, cudaStream_t stream) {
  const int threads = (int)(((lx + 31) / 32) * 32);
  const size_t smem = (size_t)ly * sizeof(int32_t) + 2 * (size_t)threads * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_score_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sw_score_kernel<T><<<(unsigned)B, threads, smem, stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)x_len,
      (const int32_t*)y_len, (int)lx, (int)ly, wm, wx, wi, wd, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 i32, 2 i16, 3 bf16
extern "C" int sw_score_launch(const void* x, const void* y,
                               const void* x_len, const void* y_len,
                               int64_t B, int64_t lx, int64_t ly, float wm,
                               float wx, float wi, float wd, int dtype,
                               void* out, void* stream) {
  if (B <= 0) return 0;
  if (lx < 1 || lx > 1024 || ly < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(x, y, x_len, y_len, B, lx, ly, wm, wx, wi, wd, out, s);
    case 1:
      return launch<int32_t>(x, y, x_len, y_len, B, lx, ly, wm, wx, wi, wd, out, s);
    case 2:
      return launch<int16_t>(x, y, x_len, y_len, B, lx, ly, wm, wx, wi, wd, out, s);
    case 3:
      return launch<bf16>(x, y, x_len, y_len, B, lx, ly, wm, wx, wi, wd, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
