// Smith-Waterman fill with moves, in diagonal layout, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel adam_tpu/ops/smith_waterman.py:
// _sw_fill_pallas (body _sw_kernel).  For every pair b, cell (i, j) of the
// (lx+1) x (ly+1) matrix lives at diagonal d = i + j, lane i:
//   moves[b, d, i]   u8 move code (0 T, 1 B, 2 J, 3 I)
// and for every matrix row i the running best over its diagonals:
//   best_sc[b, i]    f32 max score over the row's cells inside the pair's
//                    region (-inf when none), ties to the later diagonal
//   best_d[b, i]     i32 diagonal of that cell.
// The recurrence is the JAX one, in float32 and in the same order:
//   m = d2[i-1] + sub, dd = d1[i-1] + w_delete, inn = d1[i] + w_insert,
// take B if m >= dd && m >= inn && m > 0, else J if dd >= inn && dd > 0,
// else I if inn > 0, else terminate.  Only additions and comparisons, so
// (built without fast-math, adds written as __fadd_rn) every value is
// bit-equal to the plain version and to the XLA scan.
//
// Bound: the bytes written.  A pair's trackback can read only its
// (x_len+1) x (y_len+1) matrix cells, one move byte each; per interior
// cell the kernel does ~12 f32/int operations, so at 3.35 TB/s against
// the card's ~67 TFLOP/s of non-tensor f32 the move bytes bound it (the
// byte time is ~1.7x the operation time).  The kernel writes all
// B*D*(lx+1) move bytes, the cells outside the matrix (j < 0, j > y_len,
// i > x_len) and the bucket's padding included, which the trackback never
// reads; on the smithwaterman path's pairs that is about twice the bytes
// the data needs.
//
// Design: one CTA per pair, threads over matrix rows i in [0, lx] (each
// thread owns up to kRowsPerThread rows, strided by blockDim).  The
// Pallas kernel pre-gathers ydiag[b, d, i] = y[d-1-i] as i32 in XLA (4x
// the moves matrix); here both code rows sit in shared memory and are
// indexed directly.  The rolling diagonals d-1 and d-2 and the one being
// written rotate through three shared-memory buffers, so one barrier per
// diagonal suffices.  Each diagonal's move row is written by consecutive
// threads at consecutive bytes (coalesced).  The per-row best stays in
// registers.  The wrapper allocates every output; the kernel writes every
// element of each.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerThread = 8;
constexpr uint8_t kMoveT = 0, kMoveB = 1, kMoveJ = 2, kMoveI = 3;

__global__ void sw_fill_kernel(const int32_t* __restrict__ x,
                               const int32_t* __restrict__ y,
                               const int32_t* __restrict__ x_len,
                               const int32_t* __restrict__ y_len,
                               int lx, int ly, float wm, float wx, float wi,
                               float wd, uint8_t* __restrict__ moves,
                               float* __restrict__ best_sc,
                               int32_t* __restrict__ best_d) {
  extern __shared__ float smem[];
  const int L = lx + 1;
  float* diag = smem;                                          // 3 * L
  int32_t* ys = reinterpret_cast<int32_t*>(smem + 3 * L);      // ly
  int32_t* xs = ys + ly;                                       // lx
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
          const float m = __fadd_rn(d2[i - 1], sub);
          const float dd = __fadd_rn(d1[i - 1], wd);
          const float inn = __fadd_rn(d1[i], wi);
          if (m >= dd && m >= inn && m > 0.f) {
            score = m;
            mv = kMoveB;
          } else if (dd >= inn && dd > 0.f) {
            score = dd;
            mv = kMoveJ;
          } else if (inn > 0.f) {
            score = inn;
            mv = kMoveI;
          }
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

}  // namespace

extern "C" int sw_fill_launch(const void* x, const void* y, const void* x_len,
                              const void* y_len, int64_t B, int64_t lx,
                              int64_t ly, float wm, float wx, float wi,
                              float wd, void* moves, void* best_sc,
                              void* best_d, void* stream) {
  const int L = (int)lx + 1;
  if (B <= 0) return 0;
  if (L > 1024 * kRowsPerThread) return (int)cudaErrorInvalidValue;
  int threads = ((L + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = (size_t)(3 * L) * sizeof(float) +
                      (size_t)(lx + ly) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sw_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sw_fill_kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)x_len,
      (const int32_t*)y_len, (int)lx, (int)ly, wm, wx, wi, wd,
      (uint8_t*)moves, (float*)best_sc, (int32_t*)best_d);
  return (int)cudaGetLastError();
}
