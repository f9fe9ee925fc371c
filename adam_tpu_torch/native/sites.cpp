// Known-site masking of the BQSR observe pass (the port's own source, not a
// copy of the JAX package's).
//
// The observe pass leaves out every residue aligned to a known SNP.  Sites
// are sparse (dbSNP holds about one per 40 bp, and most reads hold none), so
// instead of testing every residue's reference position against the site
// table, each read walks its CIGAR once and visits only the sites inside the
// reference span it aligns: one binary search at the read's start, then a
// pointer that moves forward across the read's ops.  The positions are those
// of ref_positions in adamtok.cpp (the same consumes-query / consumes-ref
// tables, `& 15` on the op, negative lengths as 0, at most C ops, query lanes
// at or past L ignored), so the mask is SnpTable.mask_positions over those
// positions, bit for bit.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// fn(lo, hi) over [0, N) on up to nthreads threads (serial below 4096 rows,
// where spawning a thread costs more than the rows)
template <class F>
void sites_parallel_rows(int64_t N, int nthreads, F fn) {
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

// Clear residue_ok[i, j] (u8/bool [N, L]) wherever query base j of read i is
// aligned (M, =, X) to a known site, and return the number of such residues.
// sites[offsets[c] : offsets[c + 1]] are contig c's sorted positions, c in
// the caller's contig-index space [0, n_contigs); duplicates are allowed and
// negative positions never match.  A read whose contig_idx lies outside that
// range masks nothing.
int64_t mask_known_sites(const uint8_t* ops, const int32_t* lens,
                         const int32_t* n_ops, const int64_t* start,
                         const int32_t* contig_idx, int64_t N, int64_t C,
                         int64_t L, const int64_t* sites,
                         const int64_t* offsets, int64_t n_contigs,
                         uint8_t* residue_ok, int nthreads) {
  // consumes-query / consumes-ref tables for op codes 0..15 (M I D N S H P = X)
  static const uint8_t kQ[16] = {1, 1, 0, 0, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0};
  static const uint8_t kR[16] = {1, 0, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0};
  std::atomic<int64_t> masked{0};
  auto work = [&](int64_t lo, int64_t hi) {
    int64_t n_masked = 0;
    for (int64_t i = lo; i < hi; ++i) {
      int64_t ci = contig_idx[i];
      if (ci < 0 || ci >= n_contigs) continue;
      const int64_t* end = sites + offsets[ci + 1];
      int64_t r = start[i];
      const int64_t* p = std::lower_bound(sites + offsets[ci], end,
                                          r < 0 ? int64_t(0) : r);
      if (p == end) continue;
      uint8_t* row = residue_ok + i * L;
      int64_t q = 0;
      int nc = n_ops[i];
      if (nc > C) nc = int(C);
      for (int k = 0; k < nc && q < L && p != end; ++k) {
        uint8_t op = ops[i * C + k] & 15;
        int64_t len = lens[i * C + k];
        if (len < 0) len = 0;
        bool cq = kQ[op], cr = kR[op];
        if (cq && cr) {
          int64_t stop = q + len;
          if (stop > L) stop = L;
          int64_t r_end = r + (stop - q);  // the aligned lanes' span [r, r_end)
          if (*p < r) p = std::lower_bound(p, end, r);
          while (p != end && *p < r_end) {
            int64_t s = *p;
            row[q + (s - r)] = 0;
            ++n_masked;
            do ++p; while (p != end && *p == s);
          }
        }
        if (cq) q += len;
        if (cr) r += len;
      }
    }
    masked.fetch_add(n_masked, std::memory_order_relaxed);
  };
  sites_parallel_rows(N, nthreads, work);
  return masked.load();
}

}  // extern "C"
