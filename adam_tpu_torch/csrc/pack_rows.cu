// Row-prefix pack for Hopper (sm_90a), with the per-byte encode fused in.
//
// Replaces the Pallas TPU kernel adam_tpu/ops/colpack.py:pack_rows_pallas
// (body _pack_block_kernel): row i's first lens[i] bytes of mat[i, :],
// each passed through a 256-entry LUT (the SANGER encode or the base
// decode; none for a plain pack), go to the flat output at offs[i], the
// exclusive cumsum of lens in i64 (as the XLA body colpack.pack_rows_body
// computes it; the Pallas twin's i32 offsets would overflow past 2 GiB of
// payload).  Bytes of a row past w (lens[i] > w) are zeros, every byte
// past sum(lens) is zero, and a position at or past `size` is dropped
// (the XLA scatter's mode="drop").  The kernel writes every byte of
// [0, size) itself: the wrapper hands in an output from torch.empty.
//
// Bound: memory.  The least it can take is reading the in-row bytes of
// mat and the i64 lens and writing `size` output bytes, over the card's
// 3.35 TB/s.  The first design lost its time around that: a torch.cumsum
// and a torch.zeros of the whole output before the kernel, one byte per
// lane per load and store, and two more torch passes for the encode.
//
// Design: three kernels on the stream, one launch for the wrapper.
//   1. tile sums: a warp per tile of `rows` consecutive rows (about 16 KB
//      of mat) sums their lens (i64);
//   2. tile scan: one block turns the sums into each tile's first output
//      byte (and sum(lens) at the end);
//   3. pack: a tile of rows is one contiguous rows*w-byte span of mat,
//      and its output one contiguous span [offs[r0], offs[r0+rows]).  A
//      block walks tiles; each tile's rows, lens and first output byte
//      come into shared memory by cp.async copies, the next tile's in
//      flight while this one is packed.  One warp scans the tile's lens
//      into row offsets, a warp per row compacts the rows through the LUT
//      into a shared staging buffer that starts on the span's 16-byte
//      boundary, and the span is stored with 16-byte stores, with byte
//      stores only at its two unaligned ends, so no two blocks write the
//      same byte.  Then the blocks zero the tail [sum(lens), size) with
//      16-byte stores.
// A tile whose span does not fit the staging buffer (some lens > w) is
// written byte by byte from the shared copy, and rows too wide for the
// shared buffers (w above about 2,000) byte by byte from device memory.
// Tried and dropped, slower in a side-by-side run on the card: building
// each 16-byte output chunk straight from the shared rows (a row search
// per chunk), and tiles of 32 or 256 rows at w = 128.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int64_t kMaxStagedSmem = 96 * 1024;  // two blocks or more per SM

// the encode's 256-entry table, passed by value (kernel parameter space)
struct Lut {
  uint8_t b[256];
};

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 1. sums[t] = sum of lens over the rows of tile t
__global__ void tile_sums_kernel(const int64_t* __restrict__ lens, int64_t n,
                                 int64_t rows, int64_t n_tiles,
                                 int64_t* __restrict__ sums) {
  const int lane = threadIdx.x & 31;
  for (int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); t < n_tiles;
       t += (int64_t)gridDim.x * kWarps) {
    const int64_t r0 = t * rows;
    const int64_t r1 = r0 + rows < n ? r0 + rows : n;
    long long s = 0;
    for (int64_t r = r0 + lane; r < r1; r += 32) s += lens[r];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) sums[t] = s;
  }
}

// 2. in place: base[t] = sum of sums[< t], base[n_tiles] = the total
__global__ void tile_scan_kernel(int64_t* __restrict__ base, int64_t n_tiles) {
  __shared__ int64_t sa[kScanThreads];
  const int t = threadIdx.x;
  const int64_t per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int64_t i0 = t * per;
  const int64_t i1 = i0 + per < n_tiles ? i0 + per : n_tiles;
  int64_t a = 0;
  for (int64_t i = i0; i < i1; ++i) a += base[i];
  sa[t] = a;
  __syncthreads();
  for (int o = 1; o < kScanThreads; o <<= 1) {  // inclusive Hillis-Steele
    const int64_t v = t >= o ? sa[t - o] : 0;
    __syncthreads();
    sa[t] += v;
    __syncthreads();
  }
  a = sa[t] - a;
  for (int64_t i = i0; i < i1; ++i) {
    const int64_t v = base[i];
    base[i] = a;
    a += v;
  }
  if (t == kScanThreads - 1) base[n_tiles] = sa[t];
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ int64_t round16(int64_t v) { return (v + 15) & ~(int64_t)15; }

// 3. the pack.  Shared memory: the tile's row offsets (rows + 2 i64), two
// buffers of lens (2 x rows i64) and of the tile base (2 x 2 i64), the
// LUT (256) and, on the staged route, the staging buffer and two input
// buffers (3 x round16(rows*w) + 16 each).
__global__ void __launch_bounds__(kThreads, 4)  // <= 64 registers: 4 blocks an SM
pack_kernel(const uint8_t* __restrict__ mat, const int64_t* __restrict__ lens,
            const int64_t* __restrict__ base, int64_t n, int64_t w, int rows,
            int64_t n_tiles, const Lut lut, bool staged,
            uint8_t* __restrict__ out, int64_t size) {
  extern __shared__ __align__(16) uint8_t smem[];
  int64_t* off = reinterpret_cast<int64_t*>(smem);  // rows + 1
  int64_t* lenb = off + rows + 2;                    // 2 x rows
  int64_t* tb = lenb + 2 * rows;                     // 2 x 2
  uint8_t* slut = reinterpret_cast<uint8_t*>(tb + 4);
  const int64_t in_bytes = round16((int64_t)rows * w) + 16;  // the staging buffer's size
  uint8_t* stage = slut + 256;
  uint8_t* in0 = stage + in_bytes;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < 256; i += kThreads) slut[i] = lut.b[i];

  auto load = [&](int64_t t, int b) {  // tile t's rows, lens and base -> buffer b
    if (t < n_tiles) {
      const int64_t r0 = t * rows;
      const int64_t nr = (r0 + rows < n ? r0 + rows : n) - r0;
      const int64_t bytes = nr * w;
      const uint8_t* src = mat + r0 * w;
      uint8_t* dst = in0 + b * in_bytes;
      for (int64_t k = (int64_t)tid * 16; k < bytes; k += kThreads * 16)
        cp_async16(dst + k, src + k, bytes - k < 16 ? (int)(bytes - k) : 16);
      const uint8_t* lsrc = reinterpret_cast<const uint8_t*>(lens + r0);
      uint8_t* ldst = reinterpret_cast<uint8_t*>(lenb + b * rows);
      for (int64_t k = (int64_t)tid * 16; k < nr * 8; k += kThreads * 16)
        cp_async16(ldst + k, lsrc + k, nr * 8 - k < 16 ? (int)(nr * 8 - k) : 16);
      if (tid == 0) cp_async8(tb + 2 * b, base + t);
    }
    cp_async_commit();
  };

  int buf = 0;
  if (staged) load(blockIdx.x, 0);
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t r0 = t * rows;
    const int nr = (int)((r0 + rows < n ? r0 + rows : n) - r0);
    if (staged) {
      load(t + gridDim.x, buf ^ 1);
      cp_async_wait<1>();
    } else {
      for (int i = tid; i < nr; i += kThreads) lenb[i] = lens[r0 + i];
      if (tid == 0) tb[0] = base[t];
    }
    __syncthreads();
    const int64_t* ln = lenb + buf * rows;
    if (warp == 0) {  // row offsets of the tile: its base + exclusive scan
      long long run = tb[2 * buf];
      for (int i0 = 0; i0 < nr; i0 += 32) {
        const int i = i0 + lane;
        const long long v = i < nr ? ln[i] : 0;
        long long x = v;
        for (int o = 1; o < 32; o <<= 1) {
          const long long y = __shfl_up_sync(0xffffffffu, x, o);
          if (lane >= o) x += y;
        }
        if (i < nr) off[i] = run + x - v;
        run += __shfl_sync(0xffffffffu, x, 31);
      }
      if (lane == 0) off[nr] = run;
    }
    __syncthreads();

    const int64_t span0 = clamp64(off[0], 0, size);
    const int64_t span1 = clamp64(off[nr], 0, size);
    const int64_t a0 = span0 & ~(int64_t)15;
    if (staged && span1 >= span0 && span1 - a0 <= in_bytes) {
      const uint8_t* src = in0 + buf * in_bytes;
      for (int i = warp; i < nr; i += kWarps) {  // compact through the LUT
        const int64_t o = off[i];
        const int lw = (int)clamp64(ln[i], 0, w);
        const int j0 = (int)(span0 - o > 0 ? span0 - o : 0);
        const int j1 = (int)(ln[i] < span1 - o ? ln[i] : span1 - o);
        const uint8_t* srow = src + i * w;
        uint8_t* drow = stage + (o - a0);
        for (int j = j0 + lane; j < j1; j += 32) drow[j] = j < lw ? slut[srow[j]] : 0;
      }
      __syncthreads();
      const int64_t c0 = round16(span0) < span1 ? round16(span0) : span1;
      const int64_t c1 = (span1 & ~(int64_t)15) > c0 ? (span1 & ~(int64_t)15) : c0;
      for (int64_t p = span0 + tid; p < c0; p += kThreads) out[p] = stage[p - a0];
      for (int64_t p = c0 + (int64_t)tid * 16; p < c1; p += kThreads * 16)
        *reinterpret_cast<int4*>(out + p) = *reinterpret_cast<const int4*>(stage + (p - a0));
      for (int64_t p = c1 + tid; p < span1; p += kThreads) out[p] = stage[p - a0];
    } else {  // byte by byte, from the shared copy or from device memory
      const uint8_t* src = staged ? in0 + buf * in_bytes : mat + r0 * w;
      for (int i = warp; i < nr; i += kWarps) {
        const int64_t o = off[i];
        const int64_t lw = clamp64(ln[i], 0, w);
        const int64_t j0 = -o > 0 ? -o : 0;
        const int64_t j1 = ln[i] < size - o ? ln[i] : size - o;
        for (int64_t j = j0 + lane; j < j1; j += 32)
          out[o + j] = j < lw ? slut[src[i * w + j]] : 0;
      }
    }
    __syncthreads();
    if (staged) buf ^= 1;
  }
  if (staged) cp_async_wait<0>();

  // the tail past sum(lens): zeros
  const int64_t z0 = clamp64(base[n_tiles], 0, size);
  const int64_t zc0 = round16(z0) < size ? round16(z0) : size;
  const int64_t zc1 = (size & ~(int64_t)15) > zc0 ? (size & ~(int64_t)15) : zc0;
  if (blockIdx.x == 0) {
    for (int64_t p = z0 + tid; p < zc0; p += kThreads) out[p] = 0;
    for (int64_t p = zc1 + tid; p < size; p += kThreads) out[p] = 0;
  }
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int64_t p = zc0 + ((int64_t)blockIdx.x * kThreads + tid) * 16; p < zc1;
       p += (int64_t)gridDim.x * kThreads * 16)
    *reinterpret_cast<int4*>(out + p) = zero;
}

struct Launcher {
  bool ready = false;
  int sms = 0;
  size_t occ_smem = 0;
  int occ = 0;
};

}  // namespace

// mat u8[n, w] and lens i64[n] (both 16-byte aligned), lut u8[256] in
// host memory or null (no encode), base i64[ceil(n/rows) + 1] scratch,
// out u8[size] (16-byte aligned); rows is a multiple of 16 of at most 512.
extern "C" int pack_rows_launch(const void* mat, const void* lens, int64_t n,
                                int64_t w, int64_t rows, const void* lut,
                                void* base, void* out, int64_t size,
                                void* stream) {
  static Launcher launcher;
  if (rows < 16 || rows > 512 || rows % 16 || n < 0 || w < 0 ||
      (reinterpret_cast<uintptr_t>(mat) & 15) || (reinterpret_cast<uintptr_t>(lens) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  if (size <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (!launcher.ready) {
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&launcher.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxStagedSmem);
    if (e != cudaSuccess) return (int)e;
    launcher.ready = true;
  }
  const int sms = launcher.sms;
  Lut table;
  for (int i = 0; i < 256; ++i)
    table.b[i] = lut ? static_cast<const uint8_t*>(lut)[i] : (uint8_t)i;
  const int64_t n_tiles = (n + rows - 1) / rows;
  int64_t* b = (int64_t*)base;
  if (n_tiles > 0) {
    int64_t blocks = (n_tiles + kWarps - 1) / kWarps;
    if (blocks > 8 * sms) blocks = 8 * sms;
    tile_sums_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        (const int64_t*)lens, n, rows, n_tiles, b);
  }
  tile_scan_kernel<<<1, kScanThreads, 0, s>>>(b, n_tiles);

  const int64_t in_bytes = (rows * w + 15) / 16 * 16 + 16;
  const int64_t head = (3 * rows + 6) * 8 + 256;
  const int64_t staged_smem = head + 3 * in_bytes;
  const bool staged = staged_smem <= kMaxStagedSmem;
  const size_t smem = (size_t)(staged ? staged_smem : head);
  if (smem != launcher.occ_smem) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&launcher.occ, pack_kernel,
                                                      kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    launcher.occ_smem = smem;
  }
  int64_t blocks = (int64_t)sms * (launcher.occ > 0 ? launcher.occ : 1);
  if (n_tiles > 0 && blocks > n_tiles) blocks = n_tiles;
  pack_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
      (const uint8_t*)mat, (const int64_t*)lens, b, n, w, (int)rows, n_tiles,
      table, staged, (uint8_t*)out, size);
  return (int)cudaGetLastError();
}
