// Row-prefix pack for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel adam_tpu/ops/colpack.py:pack_rows_pallas
// (body _pack_block_kernel): row i's first lens[i] bytes of mat[i, :] go
// to the flat output at offs[i], the exclusive cumsum of lens, which the
// wrapper computes in i64 (as the XLA body colpack.pack_rows_body does;
// the Pallas twin's i32 offsets would overflow past 2 GiB of payload).
// Bytes past min(lens[i], w) are not written, and a position at or past
// `size` is dropped (the XLA scatter's mode="drop"); the wrapper hands in
// a zeroed output, so everything not written stays zero.
//
// Bound: memory.  The least it can take is reading the in-row bytes of
// mat plus the two i64 arrays and writing `size` output bytes, over the
// card's 3.35 TB/s.
//
// Design: one warp per row.  The TPU kernel walks row blocks in order
// and scatters into a payload held in VMEM; on Hopper rows are
// independent, so each warp reads its row's offset and length once and
// its 32 lanes copy the prefix with consecutive lanes on consecutive
// bytes: the loads of a row are coalesced and the stores land on one or
// two 128-byte lines per step.  No shared memory and no atomics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void pack_rows_kernel(const uint8_t* __restrict__ mat,
                                 const int64_t* __restrict__ lens,
                                 const int64_t* __restrict__ offs,
                                 int64_t n, int64_t w,
                                 uint8_t* __restrict__ out, int64_t size) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       row < n; row += warps) {
    int64_t len = lens[row];
    if (len > w) len = w;
    const int64_t off = offs[row];
    const uint8_t* src = mat + row * w;
    for (int64_t j = lane; j < len; j += 32) {
      const int64_t dst = off + j;
      if (dst >= 0 && dst < size) out[dst] = src[j];
    }
  }
}

}  // namespace

extern "C" int pack_rows_launch(const void* mat, const void* lens,
                                const void* offs, int64_t n, int64_t w,
                                void* out, int64_t size, void* stream) {
  if (n > 0 && w > 0 && size > 0) {
    int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
    pack_rows_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                       (cudaStream_t)stream>>>(
        (const uint8_t*)mat, (const int64_t*)lens, (const int64_t*)offs, n,
        w, (uint8_t*)out, size);
  }
  return (int)cudaGetLastError();
}
