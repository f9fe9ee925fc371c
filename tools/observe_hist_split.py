"""Split the time of the first design of the ``observe_hist`` kernel (one
global atomic per counted residue) into loads and atomics on one GPU
(run: ``python3 tools/observe_hist_split.py``).

Builds four variants of the BQSR observe histogram from the source below
and times each at the main path's shapes (``chip_smoke.py``'s phase-3
inputs: g = 262,144 rows, gl = 128 lanes, n_rg = 3), by CUDA events, 3
warm-up launches and 20 timed:

* ``byte_atomic``: the first design (one thread per packed mask byte,
  eight scalar key loads, one global atomicAdd per counted residue and
  one more per mismatch);
* ``byte_regsum``: the same loads, the atomics replaced by a per-thread
  register sum and one store per block (the load cost alone);
* ``warp_atomic``: one warp per row, 16-byte key loads, global atomics;
* ``warp_regsum``: the same loads with the register sum.

It also times the wrapper's two ``torch.zeros`` of the histograms and,
for ``pack_rows``, the wrapper's ``torch.cumsum`` and ``torch.zeros`` of
the output.  Prints one JSON line; exits non-zero without a GPU.
"""

from __future__ import annotations

import ctypes as ct
import json
import os
import subprocess
import sys
import tempfile

SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>

template <bool ATOMIC>
__global__ void byte_kernel(const int32_t* __restrict__ keys,
                            const uint8_t* __restrict__ res_bits,
                            const uint8_t* __restrict__ mm_bits,
                            const uint8_t* __restrict__ read_ok,
                            int64_t n, int64_t l, int64_t lb,
                            int32_t* __restrict__ total,
                            int32_t* __restrict__ mism,
                            int32_t* __restrict__ sink) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int32_t acc = 0;
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
        if (ATOMIC) {
          atomicAdd(total + k, 1);
          if ((mb >> shift) & 1u) atomicAdd(mism + k, 1);
        } else {
          acc += k + (int32_t)((mb >> shift) & 1u);
        }
      }
    }
  }
  if (!ATOMIC) {
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if ((threadIdx.x & 31) == 0) atomicAdd(sink, acc);
  }
}

template <bool ATOMIC>
__global__ void warp_kernel(const int32_t* __restrict__ keys,
                            const uint8_t* __restrict__ res_bits,
                            const uint8_t* __restrict__ mm_bits,
                            const uint8_t* __restrict__ read_ok,
                            int64_t n, int64_t l, int64_t lb,
                            int32_t* __restrict__ total,
                            int32_t* __restrict__ mism,
                            int32_t* __restrict__ sink) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  int32_t acc = 0;
  for (int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       row < n; row += warps) {
    if (!read_ok[row]) continue;
    for (int64_t c = lane * 4; c < l; c += 128) {
      const int sh = 4 - (int)(c & 4);
      const uint32_t nib = (res_bits[row * lb + (c >> 3)] >> sh) & 0xFu;
      if (!nib) continue;
      const uint32_t mnib = (mm_bits[row * lb + (c >> 3)] >> sh) & 0xFu;
      const int4 k4 = *reinterpret_cast<const int4*>(keys + row * l + c);
      const int32_t kk[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((nib >> (3 - j)) & 1u) {
          if (ATOMIC) {
            atomicAdd(total + kk[j], 1);
            if ((mnib >> (3 - j)) & 1u) atomicAdd(mism + kk[j], 1);
          } else {
            acc += kk[j] + (int32_t)((mnib >> (3 - j)) & 1u);
          }
        }
      }
    }
  }
  if (!ATOMIC) {
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) atomicAdd(sink, acc);
  }
}

extern "C" int split_launch(int variant, const void* keys, const void* res,
                            const void* mm, const void* ok, int64_t n,
                            int64_t l, int64_t lb, void* total, void* mism,
                            void* sink, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  if (variant < 2) {
    int64_t blocks = (n * lb + threads - 1) / threads;
    if (blocks > 132 * 64) blocks = 132 * 64;
    auto k = variant == 0 ? byte_kernel<true> : byte_kernel<false>;
    k<<<(unsigned)blocks, threads, 0, s>>>(
        (const int32_t*)keys, (const uint8_t*)res, (const uint8_t*)mm,
        (const uint8_t*)ok, n, l, lb, (int32_t*)total, (int32_t*)mism,
        (int32_t*)sink);
  } else {
    int64_t blocks = (n + 7) / 8;
    if (blocks > 132 * 64) blocks = 132 * 64;
    auto k = variant == 2 ? warp_kernel<true> : warp_kernel<false>;
    k<<<(unsigned)blocks, threads, 0, s>>>(
        (const int32_t*)keys, (const uint8_t*)res, (const uint8_t*)mm,
        (const uint8_t*)ok, n, l, lb, (int32_t*)total, (int32_t*)mism,
        (int32_t*)sink);
  }
  return (int)cudaGetLastError();
}
"""

VARIANTS = ("byte_atomic", "byte_regsum", "warp_atomic", "warp_regsum")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("observe_hist_split: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    import chip_smoke
    from adam_tpu_torch.ops import kernels, observe
    from adam_tpu_torch.pipelines import bqsr

    work = tempfile.mkdtemp(prefix="observe_split_")
    src = os.path.join(work, "split.cu")
    so = os.path.join(work, "split.so")
    with open(src, "w") as fh:
        fh.write(SRC)
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", so, src], check=True)
    fn = ct.CDLL(so).split_launch
    P, I = ct.c_void_p, ct.c_int64
    fn.argtypes = [ct.c_int, P, P, P, P, I, I, I, P, P, P, P]
    fn.restype = ct.c_int

    dev = torch.device("cuda")
    t, g, gl = chip_smoke._kernel_inputs(dev)
    n_rg = 3
    size = n_rg * bqsr.N_QUAL * (2 * gl + 1) * bqsr.N_DINUC
    keys = bqsr.covariate_keys(t["bases"], t["quals"], t["lengths"], t["flags"],
                               t["rg"], n_rg, gl).contiguous()
    args = (keys, t["res_bits"], t["mm_bits"], t["read_ok"])
    want = observe.observe_hist_plain(*args, size)
    total = torch.zeros(size, dtype=torch.int32, device=dev)
    mism = torch.zeros(size, dtype=torch.int32, device=dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)

    def run(v):
        rc = fn(v, *(a.data_ptr() for a in args), g, gl, t["res_bits"].shape[1],
                total.data_ptr(), mism.data_ptr(), sink.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"variant {VARIANTS[v]} failed to launch ({rc})")

    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": chip_smoke._smi()}
    for v, name in enumerate(VARIANTS):
        if "atomic" in name:  # the atomic variants must give the histogram
            total.zero_()
            mism.zero_()
            run(v)
            torch.cuda.synchronize()
            if not (torch.equal(total, want[0]) and torch.equal(mism, want[1])):
                raise AssertionError(f"variant {name} disagrees with the plain version")
        out[f"{name}_ms"] = chip_smoke._time_ms(lambda v=v: run(v))
    out["hist_zeros_x2_ms"] = chip_smoke._time_ms(lambda: (
        torch.zeros(size, dtype=torch.int32, device=dev),
        torch.zeros(size, dtype=torch.int32, device=dev)))
    lens = t["lengths"].to(torch.int64)
    out["pack_cumsum_ms"] = chip_smoke._time_ms(lambda: torch.cumsum(lens, 0) - lens)
    out["pack_zeros_ms"] = chip_smoke._time_ms(
        lambda: torch.zeros(g * gl, dtype=torch.uint8, device=dev))
    out["residues_counted"] = int(want[0].sum())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
