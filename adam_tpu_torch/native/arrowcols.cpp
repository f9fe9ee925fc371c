// The Parquet load's base and quality matrices (the port's own source, not a
// copy of the JAX package's).
//
// from_arrow_alignments turns the `sequence` and `qual` string columns (each a
// flat byte buffer, offsets and validity) into the batch's dense [N, L]
// matrices.  Each row is written once, in its final form: its bases through
// the encode LUT and its qualities as `byte - offset` (u8 arithmetic, so bytes
// below the offset wrap), each padded to L.  No index arrays are built, and
// rows of any mix of lengths take the same loop.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// fn(lo, hi) over [0, N) on up to nthreads threads (serial below 4096 rows,
// where spawning a thread costs more than the rows)
template <class F>
void arrow_parallel_rows(int64_t N, int nthreads, F fn) {
  if (nthreads < 1) nthreads = 1;
  if (nthreads == 1 || N < 4096) {
    fn(int64_t(0), N);
    return;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; ++t)
    ts.emplace_back(fn, N * t / nthreads, N * (t + 1) / nthreads);
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Fill bases and quals (u8 [N, L]) and has_qual (u8 [N]) of N reads.
// lengths[i] (0 <= lengths[i] <= L) is read i's sequence length, 0 where the
// sequence is null; its bytes start at seq_buf + seq_off[i].  The quality
// string of read i is qual_buf[qual_off[i] : qual_off[i + 1]] where
// qual_valid[i], else absent.  The caller has checked every offset against
// its buffer.
//
//   bases[i, j] = lut[seq byte j] for j < lengths[i], else base_pad
//   has_qual[i] = the quality is present, not empty and not "*"
//   quals[i, j] = qual byte j - qual_offset for j < its length  (has_qual)
//               = 0 for j < lengths[i]                         (!has_qual)
//               = qual_pad everywhere else
void arrow_codes(const uint8_t* seq_buf, const int64_t* seq_off,
                 const int32_t* lengths, const uint8_t* qual_buf,
                 const int64_t* qual_off, const uint8_t* qual_valid,
                 int64_t N, int64_t L, const uint8_t* lut, uint8_t base_pad,
                 uint8_t qual_pad, uint8_t qual_offset, uint8_t* bases,
                 uint8_t* quals, uint8_t* has_qual, int nthreads) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t len = lengths[i];
      const uint8_t* s = seq_buf + seq_off[i];
      uint8_t* b = bases + i * L;
      for (int64_t j = 0; j < len; ++j) b[j] = lut[s[j]];
      std::memset(b + len, base_pad, size_t(L - len));

      int64_t qlen = qual_valid[i] ? qual_off[i + 1] - qual_off[i] : 0;
      const uint8_t* q = qual_buf + qual_off[i];
      bool hq = qlen > 0 && !(qlen == 1 && q[0] == '*');
      has_qual[i] = hq;
      uint8_t* o = quals + i * L;
      int64_t w = hq ? std::min(qlen, L) : len;
      if (hq)
        for (int64_t j = 0; j < w; ++j) o[j] = uint8_t(q[j] - qual_offset);
      else
        std::memset(o, 0, size_t(w));
      std::memset(o + w, qual_pad, size_t(L - w));
    }
  };
  arrow_parallel_rows(N, nthreads, work);
}

}  // extern "C"
