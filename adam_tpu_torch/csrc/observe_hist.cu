// BQSR observe histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel adam_tpu/ops/pallas_observe.py:
// observe_hist_pallas (body _hist_block_kernel).  For every residue whose
// residue-ok bit and read_ok are set: total[key] += 1, and mism[key] += 1
// when its mismatch bit is set too.  Keys are the caller's precomputed
// i32 covariate keys (always in range); the two masks arrive bit-packed,
// big-endian within each byte (np.packbits layout), u8[n, lb].
//
// Bound: memory.  Per residue the kernel reads 4 key bytes plus two bits,
// and writes nothing but the histogram, so the least it can take is the
// input bytes (n*l*4 + 2*n*lb + n) plus one write of the two i32
// histograms, over the card's 3.35 TB/s.  The atomics are the practical
// limit: most residues fall in a few quality levels, so many threads hit
// the same few bins.
//
// Design: the TPU kernel keeps the whole histogram in VMEM and walks the
// rows in order; here that histogram (n_rg*94*(2l+1)*17 bins, 1.23 M at
// the main path's l = 128, 9.9 MB for the pair) is far above a block's
// 227 KB of shared memory, but it fits in the 50 MB L2, so the bins stay
// in global memory and every update is an i32 atomicAdd that resolves in
// L2.  One thread covers one packed mask byte (8 residues): it reads the
// row's read_ok and its two mask bytes, skips the byte at once when no
// residue in it counts, and otherwise reads the 8 keys and adds.  Integer
// atomics commute, so the result is bit-exact whatever the order.  The
// wrapper zeroes both outputs; nothing is allocated here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void observe_hist_kernel(const int32_t* __restrict__ keys,
                                    const uint8_t* __restrict__ res_bits,
                                    const uint8_t* __restrict__ mm_bits,
                                    const uint8_t* __restrict__ read_ok,
                                    int64_t n, int64_t l, int64_t lb,
                                    int32_t* __restrict__ total,
                                    int32_t* __restrict__ mism) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < n * lb; t += stride) {
    const int64_t row = t / lb;
    const int64_t byte = t - row * lb;
    if (!read_ok[row]) continue;
    const uint32_t rb = res_bits[t];
    if (rb == 0) continue;
    const uint32_t mb = mm_bits[t];
    const int64_t col0 = byte * 8;
    const int32_t* krow = keys + row * l;
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
      const int64_t col = col0 + bit;
      if (col >= l) break;
      const uint32_t shift = 7 - bit;
      if ((rb >> shift) & 1u) {
        const int32_t k = krow[col];
        atomicAdd(total + k, 1);
        if ((mb >> shift) & 1u) atomicAdd(mism + k, 1);
      }
    }
  }
}

}  // namespace

extern "C" int observe_hist_launch(const void* keys, const void* res_bits,
                                   const void* mm_bits, const void* read_ok,
                                   int64_t n, int64_t l, int64_t lb,
                                   void* total, void* mism, void* stream) {
  const int64_t work = n * lb;
  if (work > 0) {
    const int threads = 256;
    int64_t blocks = (work + threads - 1) / threads;
    if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
    observe_hist_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
        (const int32_t*)keys, (const uint8_t*)res_bits,
        (const uint8_t*)mm_bits, (const uint8_t*)read_ok, n, l, lb,
        (int32_t*)total, (int32_t*)mism);
  }
  return (int)cudaGetLastError();
}
