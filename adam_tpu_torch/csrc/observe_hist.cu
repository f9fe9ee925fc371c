// BQSR observe histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel adam_tpu/ops/pallas_observe.py:
// observe_hist_pallas (body _hist_block_kernel).  For every residue whose
// residue-ok bit and read_ok are set: total[key] += 1, and mism[key] += 1
// when its mismatch bit is set too.  Keys are the caller's precomputed
// i32 covariate keys (always in range); the two masks arrive bit-packed,
// big-endian within each byte (np.packbits layout), u8[n, lb].
//
// Bound: memory.  The least it can take is the keys of the residues that
// count, both masks, read_ok and one write of the two i32 histograms,
// over the card's 3.35 TB/s.  What held the first design back was the
// atomics: one i32 atomicAdd resolved in L2 per counted residue, most of
// them on the few bins of the common quality levels.  Timed apart on an
// NVIDIA H100 80GB HBM3 at 700 W at the main path's shapes
// (tools/observe_hist_split.py), that kernel took 0.378 ms, and the same
// loads with the atomics replaced by a register sum 0.081 ms.
//
// Design: a bin-partitioned histogram.  The table (n_rg*94 slabs of
// slab_w = (2l+1)*17 bins, 9.9 MB for the pair at l = 128) is far above a
// block's 227 KB of shared memory, but one (read group, quality) slab is
// not (35 KB for the pair at l = 128).  So the residues are first sorted
// by slab, then each slab is counted in shared memory:
//   1. count: each block counts its rows' residues per slab in shared
//      memory and adds the non-zero counts to a global per-slab count;
//   2. scan: one block turns the counts into each slab's segment of a
//      record buffer and cuts every slab into chunks of at most `chunk`
//      records, so that a hot quality level spreads over many blocks;
//   3. scatter: each block (kStage residue slots, 32 rows at l = 128)
//      gathers its residues in shared memory as records, (key mod slab_w)
//      | mismatch << 15 in u16 (u32 and << 31 where a slab has more than
//      32,768 bins), sorts them by slab there, reserves its run of each
//      slab's segment with one global atomic per non-zero slab, and
//      writes the runs out coalesced;
//   4. accumulate: a block per (chunk, bin part) reads its records with
//      16-byte loads into a shared copy of the slab (shared atomics),
//      then adds the non-zero bins to the outputs: one global atomic per
//      non-zero bin per block.  Where a slab's pair of i32 bins does not
//      fit in shared memory (l above about 750), its bins are split into
//      parts, one block each, every part reading the chunk's records.
// Loads are coalesced and several are in flight a warp: a warp takes four
// rows at once, 16 bytes (4 keys) a lane, the lane's 4 mask bits cut from
// the rows' packed bytes, and a lane whose 4 bits are all clear loads no
// key.  Integer adds commute, so the result is bit-exact whatever the
// order.  One cudaMemsetAsync zeroes the two outputs and the per-slab
// counts, which the wrapper allocates together; the record buffer and the
// scan's arrays are scratch the wrapper allocates.  Where there are more
// than kGroup slabs (n_rg above 43), steps 1-4 run once per group of
// kGroup slabs, each ignoring the residues of the other groups.
//
// tools/kernel_breakdown.py times the four steps apart: the scatter,
// its visit of the keys and its shared-memory sort, takes most of the
// time (PERF.md).  Tried and dropped, each slower in a side-by-side run
// on the card: ranking within a slab by warp match, writing each record
// straight to its global slot, and a single visit that leaves each
// block's sorted runs in place for the accumulate step to gather.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowBatch = 4;           // rows a warp loads at once
constexpr int kGroup = 4096;           // slabs per pass: 48 KB of shared arrays
constexpr int kStage = 4096;           // residue slots of one scatter block
constexpr int kMaxPartBins = 25600;    // bins of one accumulate block: 200 KB
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448 - 1024;  // dynamic, beside the static arrays

// exact k / d for 0 <= k < 2^31 and 1 <= d < 2^31: q = (k * magic) >> shift
// with shift = 31 + ceil(log2 d) and magic = floor(2^shift / d) + 1
struct Div {
  uint64_t magic;
  int shift;
};

Div make_div(uint32_t d) {
  int lg = 0;
  while ((1ull << lg) < d) ++lg;
  const int shift = 31 + lg;
  return Div{(1ull << shift) / d + 1, shift};
}

__device__ __forceinline__ uint32_t divide(uint32_t k, Div d) {
  return (uint32_t)(((uint64_t)k * d.magic) >> d.shift);  // < 2^63
}

struct Rows {
  const int32_t* keys;
  const uint8_t* res;
  const uint8_t* mm;
  const uint8_t* ok;
  int64_t n, l, lb;
  bool vec;  // 16-byte key loads (l % 4 == 0 and keys 16-byte aligned)
};

// f(key, counted, mismatch) for every residue slot of rows [r0, r1),
// called by the 32 lanes of a warp together.  A warp takes kRowBatch
// rows at once and lane `lane` columns 4*lane .. 4*lane+3 of each 128:
// the rows' read_ok and mask bytes are loaded together, then the keys of
// every lane with a counted residue (16 bytes a lane), so that each warp
// keeps several loads in flight.
template <class F>
__device__ __forceinline__ void visit(const Rows& a, int64_t r0, int64_t r1, F&& f) {
  const int lane = threadIdx.x & 31;
  for (int64_t rb = r0 + (int64_t)(threadIdx.x >> 5) * kRowBatch; rb < r1;
       rb += (int64_t)kWarps * kRowBatch) {
    for (int64_t c0 = 0; c0 < a.l; c0 += 128) {
      const int64_t c = c0 + lane * 4;
      const int sh = 4 - (int)(c & 4);  // high nibble for c % 8 == 0
      const int64_t left = a.l - c;
      const uint32_t keep = left >= 4 ? 0xFu : (left > 0 ? (0xF0u >> left) & 0xFu : 0u);
      uint32_t nib[kRowBatch], mnib[kRowBatch];  // bit 3 = column c
#pragma unroll
      for (int b = 0; b < kRowBatch; ++b) {
        const int64_t row = rb + b;
        nib[b] = 0;
        mnib[b] = 0;
        if (row < r1 && keep) {
          const uint32_t ok = a.ok[row];
          const uint32_t rbyte = a.res[row * a.lb + (c >> 3)];
          const uint32_t mbyte = a.mm[row * a.lb + (c >> 3)];
          nib[b] = ok ? (rbyte >> sh) & keep : 0u;
          mnib[b] = (mbyte >> sh) & nib[b];
        }
      }
      int32_t k[kRowBatch][4];
#pragma unroll
      for (int b = 0; b < kRowBatch; ++b) {
        const int32_t* p = a.keys + (rb + b) * a.l + c;
        if (nib[b] && a.vec) {
          const int4 v = *reinterpret_cast<const int4*>(p);
          k[b][0] = v.x; k[b][1] = v.y; k[b][2] = v.z; k[b][3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) k[b][j] = ((nib[b] >> (3 - j)) & 1u) ? p[j] : 0;
        }
      }
#pragma unroll
      for (int b = 0; b < kRowBatch; ++b)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          f(k[b][j], (nib[b] >> (3 - j)) & 1u, (mnib[b] >> (3 - j)) & 1u);
    }
  }
}

// exclusive scan of in[0, n) into out (in == out allowed) by the whole
// block -> the total; each thread scans a contiguous run
__device__ int32_t block_scan(const int32_t* in, int32_t* out, int n, int32_t* warp_tot) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int i0 = t * per < n ? t * per : n;
  const int i1 = i0 + per < n ? i0 + per : n;
  int32_t sum = 0;
  for (int i = i0; i < i1; ++i) sum += in[i];
  int32_t x = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int32_t before = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += warp_tot[w];
    total += warp_tot[w];
  }
  int32_t run = before + x - sum;
  for (int i = i0; i < i1; ++i) {
    const int32_t v = in[i];
    out[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

// 1. per-slab counts of the slabs [s0, s0 + gs)
__global__ void __launch_bounds__(kThreads)
count_kernel(Rows a, int64_t rows_per_block, Div div, uint32_t s0, uint32_t gs,
             int32_t* __restrict__ cnt) {
  extern __shared__ int32_t sc[];
  for (uint32_t i = threadIdx.x; i < gs; i += kThreads) sc[i] = 0;
  __syncthreads();
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < a.n ? r0 + rows_per_block : a.n;
  visit(a, r0, r1, [&](int32_t k, uint32_t counted, uint32_t) {
    const uint32_t s = divide((uint32_t)k, div) - s0;
    if (counted && s < gs) atomicAdd(&sc[s], 1);
  });
  __syncthreads();
  for (uint32_t i = threadIdx.x; i < gs; i += kThreads)
    if (sc[i]) atomicAdd(&cnt[i], sc[i]);
}

// 2. off = exclusive scan of cnt (off[gs] = total), cursor = off,
//    cstart = exclusive scan of ceil(cnt / chunk), n_items = chunks * parts
__global__ void scan_kernel(const int32_t* __restrict__ cnt, int gs, int chunk,
                            int parts, int32_t* __restrict__ off,
                            int32_t* __restrict__ cursor,
                            int32_t* __restrict__ cstart,
                            int32_t* __restrict__ n_items) {
  __shared__ int32_t sa[kScanThreads];
  __shared__ int32_t sb[kScanThreads];
  const int t = threadIdx.x;
  const int per = (gs + kScanThreads - 1) / kScanThreads;
  const int i0 = t * per;
  const int i1 = i0 + per < gs ? i0 + per : gs;
  int32_t a = 0, b = 0;
  for (int i = i0; i < i1; ++i) {
    a += cnt[i];
    b += (cnt[i] + chunk - 1) / chunk;
  }
  sa[t] = a;
  sb[t] = b;
  __syncthreads();
  for (int o = 1; o < kScanThreads; o <<= 1) {  // inclusive Hillis-Steele
    const int32_t va = t >= o ? sa[t - o] : 0;
    const int32_t vb = t >= o ? sb[t - o] : 0;
    __syncthreads();
    sa[t] += va;
    sb[t] += vb;
    __syncthreads();
  }
  a = sa[t] - a;
  b = sb[t] - b;
  for (int i = i0; i < i1; ++i) {
    off[i] = a;
    cursor[i] = a;
    cstart[i] = b;
    a += cnt[i];
    b += (cnt[i] + chunk - 1) / chunk;
  }
  if (t == kScanThreads - 1) {
    off[gs] = sa[t];
    cstart[gs] = sb[t];
    *n_items = sb[t] * parts;
  }
}

// 3. one record per counted residue in its slab's segment.  The block
// gathers its residues in shared memory (a ballot per warp step, one
// shared atomic per warp), sorts them by slab there, reserves each slab's
// run with one global atomic, and writes the runs out coalesced.
template <typename Rec>
__global__ void __launch_bounds__(kThreads, 6)  // <= 40 registers: 6 blocks an SM
scatter_kernel(Rows a, int64_t rows_per_block, int cap, Div div, uint32_t slab_w,
               uint32_t s0, uint32_t gs, int32_t* __restrict__ cursor,
               Rec* __restrict__ rec) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* sc = reinterpret_cast<int32_t*>(smem);  // gs: counts, then positions
  int32_t* loff = sc + gs;                          // gs: the block's slab runs
  int32_t* gbase = loff + gs;                       // gs: their first record
  Rec* rec_a = reinterpret_cast<Rec*>(gbase + gs);  // cap: arrival order
  Rec* rec_b = rec_a + cap;                         // cap: slab order
  uint16_t* slab_a = reinterpret_cast<uint16_t*>(rec_b + cap);  // cap
  uint16_t* slab_b = slab_a + cap;                              // cap
  __shared__ int32_t n_local;
  __shared__ int32_t warp_tot[kWarps];
  const int lane = threadIdx.x & 31;
  constexpr int kMmShift = sizeof(Rec) * 8 - 1;
  for (uint32_t i = threadIdx.x; i < gs; i += kThreads) sc[i] = 0;
  if (threadIdx.x == 0) n_local = 0;
  __syncthreads();
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < a.n ? r0 + rows_per_block : a.n;
  visit(a, r0, r1, [&](int32_t k, uint32_t counted, uint32_t m) {
    const uint32_t q = divide((uint32_t)k, div);
    const uint32_t s = q - s0;
    const bool in = counted && s < gs;
    const uint32_t ball = __ballot_sync(kFull, in);
    int32_t first = 0;
    if (lane == 0 && ball) first = atomicAdd(&n_local, __popc(ball));
    first = __shfl_sync(kFull, first, 0);
    if (in) {
      const int32_t p = first + __popc(ball & ((1u << lane) - 1u));
      rec_a[p] = (Rec)(((uint32_t)k - q * slab_w) | (m << kMmShift));
      slab_a[p] = (uint16_t)s;
      atomicAdd(&sc[s], 1);
    }
  });
  __syncthreads();
  block_scan(sc, loff, (int)gs, warp_tot);
  for (uint32_t i = threadIdx.x; i < gs; i += kThreads) {
    if (sc[i]) {
      gbase[i] = atomicAdd(&cursor[i], sc[i]);
      sc[i] = 0;
    }
  }
  __syncthreads();
  const int32_t nl = n_local;
  for (int32_t i = threadIdx.x; i < nl; i += kThreads) {
    const uint32_t s = slab_a[i];
    const int32_t p = loff[s] + atomicAdd(&sc[s], 1);
    rec_b[p] = rec_a[i];
    slab_b[p] = (uint16_t)s;
  }
  __syncthreads();
  for (int32_t i = threadIdx.x; i < nl; i += kThreads) {
    const uint32_t s = slab_b[i];
    rec[gbase[s] + (i - loff[s])] = rec_b[i];
  }
}

// 4. a block per (chunk, part): shared bins, then the non-zero ones out;
// the records come in 16-byte loads
template <typename Rec>
__global__ void __launch_bounds__(kThreads)
accum_kernel(const Rec* __restrict__ rec, const int32_t* __restrict__ off,
             const int32_t* __restrict__ cstart, const int32_t* __restrict__ n_items,
             int gs, int chunk, int parts, int part_bins, int64_t slab_w, int64_t s0,
             int32_t* __restrict__ total, int32_t* __restrict__ mism) {
  extern __shared__ int32_t sh[];
  int32_t* st = sh;              // part_bins
  int32_t* sm = sh + part_bins;  // part_bins
  __shared__ int s_slab;
  constexpr int kMmShift = sizeof(Rec) * 8 - 1;
  constexpr uint32_t kBinMask = (1u << kMmShift) - 1u;
  constexpr int kPer = 16 / sizeof(Rec);  // records per 16-byte load
  const int items = *n_items;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int ci = it / parts;
    const int part = it - ci * parts;
    if (threadIdx.x == 0) {  // the slab s with cstart[s] <= ci < cstart[s+1]
      int lo = 0, hi = gs - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (cstart[mid] <= ci) lo = mid; else hi = mid - 1;
      }
      s_slab = lo;
    }
    for (int i = threadIdx.x; i < part_bins; i += kThreads) {
      st[i] = 0;
      sm[i] = 0;
    }
    __syncthreads();
    const int s = s_slab;
    const int32_t begin = off[s] + (ci - cstart[s]) * chunk;
    const int32_t end = begin + chunk < off[s + 1] ? begin + chunk : off[s + 1];
    const int64_t lo = (int64_t)part * part_bins;
    const uint32_t width = (uint32_t)(slab_w - lo < part_bins ? slab_w - lo : part_bins);
    auto add = [&](uint32_t r) {
      const uint32_t b = (r & kBinMask) - (uint32_t)lo;
      if (b < width) {
        atomicAdd(&st[b], 1);
        if (r >> kMmShift) atomicAdd(&sm[b], 1);
      }
    };
    int32_t v0 = (begin + kPer - 1) / kPer * kPer;  // the 16-byte aligned middle
    int32_t v1 = end / kPer * kPer;
    if (v0 > v1) v0 = v1 = end;
    for (int32_t i = begin + threadIdx.x; i < v0; i += kThreads) add(rec[i]);
    for (int32_t i = v1 + threadIdx.x; i < end; i += kThreads) add(rec[i]);
    auto add4 = [&](uint4 x) {
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        if (sizeof(Rec) == 2) {
          add(w[h] & 0xFFFFu);
          add(w[h] >> 16);
        } else {
          add(w[h]);
        }
      }
    };
    const uint4* vrec = reinterpret_cast<const uint4*>(rec);
    for (int32_t i = v0 / kPer + threadIdx.x; i < v1 / kPer; i += 2 * kThreads) {
      const bool two = i + kThreads < v1 / kPer;  // two loads in flight
      const uint4 x = vrec[i];
      const uint4 y = two ? vrec[i + kThreads] : make_uint4(0, 0, 0, 0);
      add4(x);
      if (two) add4(y);
    }
    __syncthreads();
    const int64_t out0 = (s0 + s) * slab_w + lo;
    for (uint32_t b = threadIdx.x; b < width; b += kThreads) {
      if (st[b]) atomicAdd(total + out0 + b, st[b]);
      if (sm[b]) atomicAdd(mism + out0 + b, sm[b]);
    }
    __syncthreads();
  }
}

int64_t round16(int64_t v) { return (v + 15) / 16 * 16; }

template <typename Rec>
struct Launcher {
  bool ready = false;
  int sms = 0;
  size_t occ_smem = 0;
  int occ = 0;

  cudaError_t init() {
    if (ready) return cudaSuccess;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(scatter_kernel<Rec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(accum_kernel<Rec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    ready = e == cudaSuccess;
    return e;
  }

  int accum_blocks(size_t smem) {
    if (smem != occ_smem) {
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, accum_kernel<Rec>,
                                                        kThreads, smem) != cudaSuccess)
        occ = 1;
      occ_smem = smem;
    }
    return sms * (occ > 0 ? occ : 1);
  }
};

template <typename Rec>
int run(const Rows& a, int64_t size, int64_t slab_w, int32_t* hist,
        uint8_t* scratch, int64_t scratch_bytes, cudaStream_t stream) {
  static Launcher<Rec> launcher;
  const int64_t n_slabs = size / slab_w;
  const int64_t group = n_slabs < kGroup ? n_slabs : kGroup;
  const int64_t rec_bytes = round16(a.n * a.l * (int64_t)sizeof(Rec));
  if (scratch_bytes < rec_bytes + 4 * (3 * group + 4)) return (int)cudaErrorInvalidValue;
  Rec* rec = reinterpret_cast<Rec*>(scratch);
  int32_t* off = reinterpret_cast<int32_t*>(scratch + rec_bytes);  // group + 1
  int32_t* cursor = off + group + 1;                               // group
  int32_t* cstart = cursor + group;                                // group + 1
  int32_t* n_items = cstart + group + 1;                           // 1
  int32_t* total = hist;
  int32_t* mism = hist + size;
  int32_t* cnt = hist + 2 * size;  // n_slabs, zeroed with the outputs

  cudaError_t e = cudaMemsetAsync(hist, 0, (size_t)(2 * size + n_slabs) * 4, stream);
  if (e != cudaSuccess || a.n == 0 || a.l == 0) return (int)e;
  if ((e = launcher.init()) != cudaSuccess) return (int)e;
  const int sms = launcher.sms;
  const Div div = make_div((uint32_t)slab_w);
  // count: about four blocks per SM; scatter: kStage residue slots a block
  int64_t count_rows = (a.n + 4 * sms - 1) / (4 * sms);
  if (count_rows < kWarps * kRowBatch) count_rows = kWarps * kRowBatch;
  const int64_t scatter_rows = a.l < kStage ? kStage / a.l : 1;
  const int cap = (int)(scatter_rows * a.l);
  const int64_t count_blocks = (a.n + count_rows - 1) / count_rows;
  const int64_t scatter_blocks = (a.n + scatter_rows - 1) / scatter_rows;
  int64_t chunk = (a.n * a.l / 512 + 1023) / 1024 * 1024;
  chunk = chunk < 4096 ? 4096 : (chunk > 65536 ? 65536 : chunk);
  const int part_bins = (int)(slab_w < kMaxPartBins ? slab_w : kMaxPartBins);
  const int parts = (int)((slab_w + part_bins - 1) / part_bins);
  const size_t accum_smem = (size_t)part_bins * 8;
  const size_t scatter_smem = (size_t)12 * group + (size_t)cap * (2 * sizeof(Rec) + 4);
  if (scatter_smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int accum_blocks = launcher.accum_blocks(accum_smem);

  for (int64_t s0 = 0; s0 < n_slabs; s0 += group) {
    const int gs = (int)(n_slabs - s0 < group ? n_slabs - s0 : group);
    count_kernel<<<(unsigned)count_blocks, kThreads, gs * 4, stream>>>(
        a, count_rows, div, (uint32_t)s0, (uint32_t)gs, cnt + s0);
    scan_kernel<<<1, kScanThreads, 0, stream>>>(cnt + s0, gs, (int)chunk, parts,
                                                off, cursor, cstart, n_items);
    scatter_kernel<Rec><<<(unsigned)scatter_blocks, kThreads, scatter_smem, stream>>>(
        a, scatter_rows, cap, div, (uint32_t)slab_w, (uint32_t)s0, (uint32_t)gs,
        cursor, rec);
    accum_kernel<Rec><<<accum_blocks, kThreads, accum_smem, stream>>>(
        rec, off, cstart, n_items, gs, (int)chunk, parts, part_bins, slab_w, s0,
        total, mism);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// hist: i32[2*size + size/slab_w] -> total, mism, per-slab counts;
// scratch: the record buffer (n*l records, 16-byte rounded) followed by
// 3*min(size/slab_w, 4096) + 4 i32 of scan output.  l is at most 8192.
extern "C" int observe_hist_launch(const void* keys, const void* res_bits,
                                   const void* mm_bits, const void* read_ok,
                                   int64_t n, int64_t l, int64_t lb,
                                   int64_t size, int64_t slab_w, void* hist,
                                   void* scratch, int64_t scratch_bytes,
                                   void* stream) {
  if (slab_w < 1 || size < slab_w || size % slab_w || n * l >= (1ll << 31) ||
      size >= (1ll << 31) || l > 8192)
    return (int)cudaErrorInvalidValue;
  const Rows a{(const int32_t*)keys, (const uint8_t*)res_bits,
               (const uint8_t*)mm_bits, (const uint8_t*)read_ok, n, l, lb,
               l % 4 == 0 && (reinterpret_cast<uintptr_t>(keys) & 15) == 0};
  const cudaStream_t s = (cudaStream_t)stream;
  if (slab_w <= 32768)
    return run<uint16_t>(a, size, slab_w, (int32_t*)hist, (uint8_t*)scratch,
                         scratch_bytes, s);
  return run<uint32_t>(a, size, slab_w, (int32_t*)hist, (uint8_t*)scratch,
                       scratch_bytes, s);
}
