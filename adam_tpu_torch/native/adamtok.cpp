// Copied unchanged from adam_tpu/native/adamtok.cpp (the JAX package's SAM tokenizer and codecs).
// Native ingest kernels for adam_tpu: SAM tokenizer, BGZF decompressor,
// BAM record parser.
//
// The reference delegates this layer to JVM libraries (htsjdk record
// codecs, hadoop-bam splitting); here it is a small C++ library driven
// through ctypes that fills preallocated numpy arrays — the host-side
// analog of the reference's SAMRecordConverter
// (converters/SAMRecordConverter.scala:38-130) running at native speed so
// the TPU is never input-starved.
//
// Threading model: two-pass. A scan pass splits the input at record
// boundaries into per-thread chunks and sizes every output buffer; the
// fill pass writes disjoint ranges concurrently, then variable-width
// buffers (attrs/MD/OQ, which can shrink vs. their scan-pass capacity)
// are compacted serially.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <zlib.h>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr uint8_t BASE_N = 4;
constexpr uint8_t BASE_PAD = 5;
constexpr uint8_t CIGAR_PAD = 15;
constexpr uint8_t QUAL_PAD = 255;

struct Luts {
  uint8_t base[256];
  int8_t cigar[256];
  uint8_t bam_seq[16];  // BAM 4-bit "=ACMGRSVTWYHKDBN" -> code
  Luts() {
    memset(base, BASE_N, sizeof(base));
    base[uint8_t('A')] = 0; base[uint8_t('a')] = 0;
    base[uint8_t('C')] = 1; base[uint8_t('c')] = 1;
    base[uint8_t('G')] = 2; base[uint8_t('g')] = 2;
    base[uint8_t('T')] = 3; base[uint8_t('t')] = 3;
    base[uint8_t('*')] = BASE_PAD;
    memset(cigar, -1, sizeof(cigar));
    const char* ops = "MIDNSHP=X";
    for (int i = 0; ops[i]; ++i) cigar[uint8_t(ops[i])] = int8_t(i);
    const char* bs = "=ACMGRSVTWYHKDBN";
    for (int i = 0; i < 16; ++i) {
      switch (bs[i]) {
        case 'A': bam_seq[i] = 0; break;
        case 'C': bam_seq[i] = 1; break;
        case 'G': bam_seq[i] = 2; break;
        case 'T': bam_seq[i] = 3; break;
        default: bam_seq[i] = BASE_N;
      }
    }
  }
};
const Luts LUT;

// op consumes reference? (M,D,N,=,X)
inline bool consumes_ref(int op) {
  return op == 0 || op == 2 || op == 3 || op == 7 || op == 8;
}

inline int64_t parse_i64(const uint8_t* p, const uint8_t* end, bool* ok) {
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
  if (p >= end) { *ok = false; return 0; }
  int64_t v = 0;
  for (; p < end; ++p) {
    if (*p < '0' || *p > '9') { *ok = false; return 0; }
    v = v * 10 + (*p - '0');
  }
  *ok = true;
  return neg ? -v : v;
}

// shared row-range fan-out: fn(lo, hi) over [0, N) on up to nthreads
// threads (serial below 4096 rows, where thread spawn outweighs work)
template <class F>
void parallel_rows(int64_t N, int nthreads, F fn) {
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

using Dict = std::unordered_map<std::string, int32_t>;

Dict build_dict(const uint8_t* buf, const int64_t* off, int32_t n) {
  Dict d;
  d.reserve(size_t(n) * 2);
  for (int32_t i = 0; i < n; ++i) {
    d.emplace(std::string(reinterpret_cast<const char*>(buf) + off[i],
                          size_t(off[i + 1] - off[i])), i);
  }
  return d;
}

inline int32_t dict_lookup(const Dict& d, const uint8_t* p, size_t len) {
  auto it = d.find(std::string(reinterpret_cast<const char*>(p), len));
  return it == d.end() ? -1 : it->second;
}

// One-entry memo in front of dict_lookup: SAM rows repeat the same
// RNAME (coordinate- or name-grouped inputs) for long runs, so a byte
// compare against the previous field skips the hash+string round trip.
struct MemoLookup {
  const Dict* d;
  std::string last;
  int32_t last_val = -2;  // -2: empty memo (-1 is a legit miss value)
  explicit MemoLookup(const Dict& dict) : d(&dict) {}
  int32_t operator()(const uint8_t* p, size_t len) {
    if (last_val != -2 && len == last.size() &&
        memcmp(p, last.data(), len) == 0)
      return last_val;
    last.assign(reinterpret_cast<const char*>(p), len);
    last_val = dict_lookup(*d, p, len);
    return last_val;
  }
};

// Positions of the first ``want`` tabs in [ls, le) -> fe[]; returns the
// count found.  AVX2: compare 32 bytes at a time and walk the movemask
// bits (~0.1 byte-compares/byte vs the scalar walk's 1); loads never
// cross ``le`` so chunk ends are safe.
inline int line_tabs(const uint8_t* ls, const uint8_t* le,
                     const uint8_t** fe, int want) {
  int found = 0;
#if defined(__AVX2__)
  const uint8_t* p = ls;
  const __m256i vt = _mm256_set1_epi8('\t');
  while (p < le && found < want) {
    size_t blk = size_t(le - p) < 32 ? size_t(le - p) : 32;
    __m256i v;
    if (blk == 32) {
      v = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(p));
    } else {
      uint8_t tmp[32] = {0};
      memcpy(tmp, p, blk);
      v = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(tmp));
    }
    uint32_t m = uint32_t(_mm256_movemask_epi8(_mm256_cmpeq_epi8(v, vt)));
    if (blk < 32) m &= (uint32_t(1) << blk) - 1;
    while (m && found < want) {
      fe[found++] = p + __builtin_ctz(m);
      m &= m - 1;
    }
    p += blk;
  }
  return found;
#else
  for (const uint8_t* q = ls; q < le && found < want; ++q)
    if (*q == '\t') fe[found++] = q;
  return found;
#endif
}

// ASCII sequence -> base codes (A/C/G/T case-insensitive, '*' -> PAD,
// everything else -> N), the vector twin of LUT.base.
inline void encode_bases(const uint8_t* src, uint8_t* dst, int64_t L) {
  int64_t j = 0;
#if defined(__AVX2__)
  const __m256i up_mask = _mm256_set1_epi8(char(0xDF));
  const __m256i cA = _mm256_set1_epi8('A'), cC = _mm256_set1_epi8('C');
  const __m256i cG = _mm256_set1_epi8('G'), cT = _mm256_set1_epi8('T');
  const __m256i cStar = _mm256_set1_epi8('*');
  const __m256i v0 = _mm256_setzero_si256(), v1 = _mm256_set1_epi8(1);
  const __m256i v2 = _mm256_set1_epi8(2), v3 = _mm256_set1_epi8(3);
  const __m256i vN = _mm256_set1_epi8(char(BASE_N));
  const __m256i vPad = _mm256_set1_epi8(char(BASE_PAD));
  for (; j + 32 <= L; j += 32) {
    __m256i raw = _mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(src + j));
    __m256i up = _mm256_and_si256(raw, up_mask);
    __m256i r = vN;
    r = _mm256_blendv_epi8(r, v0, _mm256_cmpeq_epi8(up, cA));
    r = _mm256_blendv_epi8(r, v1, _mm256_cmpeq_epi8(up, cC));
    r = _mm256_blendv_epi8(r, v2, _mm256_cmpeq_epi8(up, cG));
    r = _mm256_blendv_epi8(r, v3, _mm256_cmpeq_epi8(up, cT));
    r = _mm256_blendv_epi8(r, vPad, _mm256_cmpeq_epi8(raw, cStar));
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(dst + j), r);
  }
#endif
  for (; j < L; ++j) dst[j] = LUT.base[src[j]];
}

// ---------------------------------------------------------------- SAM ----

struct SamDims {
  int64_t n_records = 0;
  int64_t name_bytes = 0;
  int64_t tag_bytes = 0;  // raw tag-region bytes (capacity for attrs/MD/OQ)
  int32_t lmax = 0;
  int32_t cmax = 0;
  bool malformed = false;
};

struct SamChunk {
  int64_t begin = 0, end = 0;     // byte range in buf
  SamDims dims;
  int64_t rec0 = 0;               // record index base
  int64_t name0 = 0;              // name buffer base (exact)
  int64_t tag0 = 0;               // attrs/md/oq capacity-region base
  int64_t attr_used = 0, md_used = 0, oq_used = 0;
};

struct SamHandle {
  const uint8_t* buf = nullptr;
  int64_t n = 0;
  std::vector<SamChunk> chunks;
  SamDims total;
};

void sam_scan_chunk(const uint8_t* buf, SamChunk* c) {
  const uint8_t* p = buf + c->begin;
  const uint8_t* end = buf + c->end;
  SamDims& d = c->dims;
  const uint8_t* tabs[11];
  while (p < end) {
    const uint8_t* nl = static_cast<const uint8_t*>(
        memchr(p, '\n', size_t(end - p)));
    const uint8_t* le = nl ? nl : end;
    const uint8_t* ls = p;
    p = nl ? nl + 1 : end;
    if (le > ls && le[-1] == '\r') --le;
    if (le == ls || *ls == '@') continue;
    ++d.n_records;
    // 11 mandatory fields need 10 tabs; an 11th tab opens the tag region
    int nt = line_tabs(ls, le, tabs, 11);
    if (nt < 10) { d.malformed = true; return; }
    d.name_bytes += tabs[0] - ls;
    if (nt == 11) d.tag_bytes += (le - (tabs[10] + 1)) + 1;
    const uint8_t* ss = tabs[8] + 1;
    const uint8_t* se = tabs[9];
    int32_t L = 0;
    if (!(se - ss == 1 && *ss == '*')) L = int32_t(se - ss);
    if (L > d.lmax) d.lmax = L;
    const uint8_t* cs = tabs[4] + 1;
    const uint8_t* ce = tabs[5];
    int32_t nc = 0;
    if (!(ce - cs == 1 && *cs == '*')) {
      for (const uint8_t* q = cs; q < ce; ++q)
        if (*q < '0' || *q > '9') ++nc;
    }
    if (nc > d.cmax) d.cmax = nc;
  }
}

struct SamOut {
  int32_t *flags, *contig_idx, *mapq, *mate_contig_idx, *tlen, *rg_idx,
      *lengths, *cigar_lens, *cigar_n;
  int64_t *start, *end, *mate_start;
  uint8_t *has_qual, *bases, *quals, *cigar_ops;
  int64_t lmax, cmax;
  uint8_t *name_buf, *attr_buf, *md_buf, *oq_buf;
  int64_t *name_off, *attr_off, *md_off, *oq_off;
  uint8_t *md_present, *oq_present;
};

bool sam_fill_chunk(const uint8_t* buf, SamChunk* c, const Dict& contigs,
                    const Dict& rgs, SamOut* o) {
  const uint8_t* p = buf + c->begin;
  const uint8_t* end = buf + c->end;
  int64_t r = c->rec0;
  int64_t npos = c->name0;
  int64_t apos = c->tag0, mpos = c->tag0, qpos = c->tag0;
  const int64_t acap = c->tag0 + c->dims.tag_bytes;
  MemoLookup contig_memo(contigs), rnext_memo(contigs), rg_memo(rgs);
  const uint8_t* tabs[11];
  while (p < end) {
    const uint8_t* nl = static_cast<const uint8_t*>(
        memchr(p, '\n', size_t(end - p)));
    const uint8_t* le = nl ? nl : end;
    const uint8_t* ls = p;
    p = nl ? nl + 1 : end;
    if (le > ls && le[-1] == '\r') --le;
    if (le == ls || *ls == '@') continue;
    // split first 11 fields off the SIMD tab index
    int nt = line_tabs(ls, le, tabs, 11);
    if (nt < 10) return false;
    const uint8_t* f[11];
    const uint8_t* fe[11];
    f[0] = ls;
    for (int k = 0; k < 10; ++k) {
      fe[k] = tabs[k];
      f[k + 1] = tabs[k] + 1;
    }
    fe[10] = nt == 11 ? tabs[10] : le;
    const uint8_t* tags = nt == 11 ? tabs[10] + 1 : le + 1;

    bool ok = true, allok = true;
    int64_t flag = parse_i64(f[1], fe[1], &ok); allok &= ok;
    int64_t pos1 = parse_i64(f[3], fe[3], &ok); allok &= ok;
    int64_t mapq = parse_i64(f[4], fe[4], &ok); allok &= ok;
    int64_t pnext = parse_i64(f[7], fe[7], &ok); allok &= ok;
    int64_t tl = parse_i64(f[8], fe[8], &ok); allok &= ok;
    if (!allok) return false;

    o->flags[r] = int32_t(flag);
    o->mapq[r] = int32_t(mapq);
    o->tlen[r] = int32_t(tl);

    bool rname_star = (fe[2] - f[2] == 1 && *f[2] == '*');
    int32_t ci = rname_star ? -1 : contig_memo(f[2], size_t(fe[2] - f[2]));
    o->contig_idx[r] = ci;
    int64_t start = (!rname_star && pos1 > 0) ? pos1 - 1 : -1;
    o->start[r] = start;

    bool rnext_star = (fe[6] - f[6] == 1 && *f[6] == '*');
    bool rnext_eq = (fe[6] - f[6] == 1 && *f[6] == '=');
    o->mate_contig_idx[r] =
        rnext_star ? -1
                   : (rnext_eq ? ci : rnext_memo(f[6], size_t(fe[6] - f[6])));
    o->mate_start[r] = pnext > 0 ? pnext - 1 : -1;

    // name
    size_t nlen = size_t(fe[0] - f[0]);
    memcpy(o->name_buf + npos, f[0], nlen);
    o->name_off[r] = npos;
    npos += nlen;

    // sequence + qualities
    uint8_t* brow = o->bases + r * o->lmax;
    uint8_t* qrow = o->quals + r * o->lmax;
    memset(brow, BASE_PAD, size_t(o->lmax));
    memset(qrow, QUAL_PAD, size_t(o->lmax));
    int32_t L = 0;
    if (!(fe[9] - f[9] == 1 && *f[9] == '*')) {
      L = int32_t(fe[9] - f[9]);
      encode_bases(f[9], brow, L);
    }
    o->lengths[r] = L;
    bool qual_star = (fe[10] - f[10] == 1 && *f[10] == '*');
    if (!qual_star) {
      int32_t QL = int32_t(fe[10] - f[10]);
      for (int32_t k = 0; k < QL && k < o->lmax; ++k)
        qrow[k] = uint8_t(f[10][k] - 33);
      o->has_qual[r] = 1;
    } else {
      o->has_qual[r] = 0;
      for (int32_t k = 0; k < L; ++k) qrow[k] = 0;
    }

    // cigar
    uint8_t* crow = o->cigar_ops + r * o->cmax;
    int32_t* clrow = o->cigar_lens + r * o->cmax;
    memset(crow, CIGAR_PAD, size_t(o->cmax));
    memset(clrow, 0, size_t(o->cmax) * 4);
    int32_t nc = 0;
    int64_t ref_span = 0;
    if (!(fe[5] - f[5] == 1 && *f[5] == '*')) {
      int64_t num = 0;
      for (const uint8_t* q = f[5]; q < fe[5]; ++q) {
        if (*q >= '0' && *q <= '9') {
          num = num * 10 + (*q - '0');
        } else {
          int8_t op = LUT.cigar[*q];
          if (op < 0 || nc >= o->cmax) return false;
          crow[nc] = uint8_t(op);
          clrow[nc] = int32_t(num);
          if (consumes_ref(op)) ref_span += num;
          num = 0;
          ++nc;
        }
      }
    }
    o->cigar_n[r] = nc;
    o->end[r] = start >= 0 ? start + ref_span : -1;

    // tags: extract MD/OQ/RG, everything else -> attrs
    o->attr_off[r] = apos;
    o->md_off[r] = mpos;
    o->oq_off[r] = qpos;
    o->md_present[r] = 0;
    o->oq_present[r] = 0;
    int32_t rg = -1;
    bool rg_seen = false;
    int64_t attr_start = apos;
    const uint8_t* t = tags;
    while (t <= le && t < le) {
      const uint8_t* te = static_cast<const uint8_t*>(
          memchr(t, '\t', size_t(le - t)));
      if (!te) te = le;
      size_t tlen_ = size_t(te - t);
      if (tlen_ >= 5 && t[2] == ':' && t[4] == ':') {
        if (t[0] == 'M' && t[1] == 'D' && t[3] == 'Z') {
          mpos = o->md_off[r];  // duplicate MD: last one wins (overwrite)
          memcpy(o->md_buf + mpos, t + 5, tlen_ - 5);
          mpos += tlen_ - 5;
          o->md_present[r] = 1;
          t = te + 1;
          continue;
        }
        if (t[0] == 'O' && t[1] == 'Q' && t[3] == 'Z') {
          qpos = o->oq_off[r];  // duplicate OQ: last one wins
          memcpy(o->oq_buf + qpos, t + 5, tlen_ - 5);
          qpos += tlen_ - 5;
          o->oq_present[r] = 1;
          t = te + 1;
          continue;
        }
        if (t[0] == 'R' && t[1] == 'G' && t[3] == 'Z' && !rg_seen) {
          // First RG tag becomes the column; an RG naming a group absent
          // from the header stays in attrs so round-trip preserves it.
          rg_seen = true;
          rg = rg_memo(t + 5, tlen_ - 5);
          if (rg >= 0) {
            t = te + 1;
            continue;
          }
        }
      }
      if (apos + int64_t(tlen_) + 1 > acap) return false;
      if (apos > attr_start) o->attr_buf[apos++] = '\t';
      memcpy(o->attr_buf + apos, t, tlen_);
      apos += tlen_;
      t = te + 1;
    }
    o->rg_idx[r] = rg;
    ++r;
  }
  // close the per-chunk offsets with sentinel end positions
  c->attr_used = apos - c->tag0;
  c->md_used = mpos - c->tag0;
  c->oq_used = qpos - c->tag0;
  return true;
}

// ---------------------------------------------------------------- BGZF ----

struct BgzfBlock {
  int64_t comp_off;   // offset of deflate payload
  int64_t comp_len;
  int64_t out_off;
  int64_t out_len;
  uint32_t crc;       // expected CRC32 of the decompressed payload
};

struct BgzfHandle {
  const uint8_t* buf;
  int64_t n;
  std::vector<BgzfBlock> blocks;
  int64_t out_bytes = 0;
  int64_t consumed = 0;
};

// returns header length and total block size via *bsize; -1 if not BGZF
// (bad magic / no BC subfield), -2 if the header is cut short by the end
// of the buffer (streaming windows need more bytes, not an error)
int64_t bgzf_block_header(const uint8_t* p, int64_t avail, int64_t* bsize) {
  if (avail >= 1 && p[0] != 0x1f) return -1;
  if (avail >= 2 && p[1] != 0x8b) return -1;
  if (avail >= 3 && p[2] != 8) return -1;
  if (avail >= 4 && !(p[3] & 4)) return -1;
  if (avail < 18) return -2;
  uint16_t xlen = uint16_t(p[10]) | (uint16_t(p[11]) << 8);
  if (avail < 12 + xlen) return -2;
  const uint8_t* x = p + 12;
  const uint8_t* xe = x + xlen;
  while (x + 4 <= xe) {
    uint8_t si1 = x[0], si2 = x[1];
    uint16_t slen = uint16_t(x[2]) | (uint16_t(x[3]) << 8);
    if (si1 == 66 && si2 == 67 && slen == 2) {
      *bsize = int64_t(uint16_t(x[4]) | (uint16_t(x[5]) << 8)) + 1;
      return 12 + xlen;
    }
    x += 4 + slen;
  }
  return -1;
}

// ---------------------------------------------------------------- BAM ----

struct BamHandle {
  const uint8_t* buf;     // decompressed BAM stream
  int64_t n;
  int64_t records_off;
  std::vector<int64_t> rec_off;  // offset of each record's block_size field
  int64_t name_bytes = 0;
  int64_t tag_bytes = 0;  // capacity estimate for stringified tags
  int64_t consumed = 0;
  int32_t lmax = 0, cmax = 0;
};

int bam_tags_to_text(const uint8_t* t, const uint8_t* te, char* out,
                     int64_t cap, int64_t* used, int32_t* rg,
                     const Dict& rgs, char* md, int64_t* md_len,
                     char* oq, int64_t* oq_len) {
  int64_t w = 0;
  *md_len = -1;
  *oq_len = -1;
  bool rg_seen = false;
  auto put = [&](const char* s, int64_t len) -> bool {
    if (w + len > cap) return false;
    memcpy(out + w, s, size_t(len));
    w += len;
    return true;
  };
  char tmp[64];
  while (t + 3 <= te) {
    char tag0 = char(t[0]), tag1 = char(t[1]), typ = char(t[2]);
    t += 3;
    if (typ == 'Z' || typ == 'H') {
      const uint8_t* z = static_cast<const uint8_t*>(
          memchr(t, 0, size_t(te - t)));
      if (!z) return -1;
      int64_t len = z - t;
      if (tag0 == 'M' && tag1 == 'D' && typ == 'Z') {
        memcpy(md, t, size_t(len)); *md_len = len;
      } else if (tag0 == 'O' && tag1 == 'Q' && typ == 'Z') {
        memcpy(oq, t, size_t(len)); *oq_len = len;
      } else if (tag0 == 'R' && tag1 == 'G' && typ == 'Z' && !rg_seen) {
        // First RG tag becomes the column; keep unresolvable RG in attrs.
        rg_seen = true;
        *rg = dict_lookup(rgs, t, size_t(len));
        if (*rg < 0) {
          if (w) { if (!put("\t", 1)) return -1; }
          if (!put("RG:Z:", 5) ||
              !put(reinterpret_cast<const char*>(t), len))
            return -1;
        }
      } else {
        if (w) { if (!put("\t", 1)) return -1; }
        int n = snprintf(tmp, sizeof(tmp), "%c%c:%c:", tag0, tag1, typ);
        if (!put(tmp, n) || !put(reinterpret_cast<const char*>(t), len))
          return -1;
      }
      t = z + 1;
      continue;
    }
    // fixed-width values: verify the bytes exist before reading them
    int64_t fixed = (typ == 'A' || typ == 'c' || typ == 'C') ? 1
                    : (typ == 's' || typ == 'S')             ? 2
                    : (typ == 'i' || typ == 'I' || typ == 'f') ? 4
                    : (typ == 'B')                            ? 5
                                                              : -1;
    if (fixed < 0 || t + fixed > te) return -1;
    if (w) { if (!put("\t", 1)) return -1; }
    int n;
    switch (typ) {
      case 'A':
        n = snprintf(tmp, sizeof(tmp), "%c%c:A:%c", tag0, tag1, char(*t));
        t += 1;
        if (!put(tmp, n)) return -1;
        break;
      case 'c': case 'C': case 's': case 'S': case 'i': case 'I': {
        int64_t v;
        if (typ == 'c') { v = int8_t(t[0]); t += 1; }
        else if (typ == 'C') { v = t[0]; t += 1; }
        else if (typ == 's') { v = int16_t(t[0] | (t[1] << 8)); t += 2; }
        else if (typ == 'S') { v = uint16_t(t[0] | (t[1] << 8)); t += 2; }
        else if (typ == 'i') {
          v = int32_t(uint32_t(t[0]) | (uint32_t(t[1]) << 8) |
                      (uint32_t(t[2]) << 16) | (uint32_t(t[3]) << 24));
          t += 4;
        } else {
          v = int64_t(uint32_t(t[0]) | (uint32_t(t[1]) << 8) |
                      (uint32_t(t[2]) << 16) | (uint32_t(t[3]) << 24));
          t += 4;
        }
        n = snprintf(tmp, sizeof(tmp), "%c%c:i:%lld", tag0, tag1,
                     static_cast<long long>(v));
        if (!put(tmp, n)) return -1;
        break;
      }
      case 'f': {
        float fv;
        memcpy(&fv, t, 4);
        t += 4;
        n = snprintf(tmp, sizeof(tmp), "%c%c:f:%g", tag0, tag1, double(fv));
        if (!put(tmp, n)) return -1;
        break;
      }
      case 'B': {
        char sub = char(*t);
        uint32_t cnt;
        memcpy(&cnt, t + 1, 4);
        t += 5;
        int size;
        switch (sub) {
          case 'c': case 'C': size = 1; break;
          case 's': case 'S': size = 2; break;
          case 'i': case 'I': case 'f': size = 4; break;
          default: return -1;  // unknown array subtype
        }
        if (t + int64_t(cnt) * size > te) return -1;  // corrupt count
        n = snprintf(tmp, sizeof(tmp), "%c%c:B:%c", tag0, tag1, sub);
        if (!put(tmp, n)) return -1;
        for (uint32_t k = 0; k < cnt; ++k) {
          const uint8_t* e = t + k * size;
          if (sub == 'f') {
            float fv; memcpy(&fv, e, 4);
            n = snprintf(tmp, sizeof(tmp), ",%g", double(fv));
          } else {
            int64_t v;
            switch (sub) {
              case 'c': v = int8_t(e[0]); break;
              case 'C': v = e[0]; break;
              case 's': v = int16_t(e[0] | (e[1] << 8)); break;
              case 'S': v = uint16_t(e[0] | (e[1] << 8)); break;
              case 'i': v = int32_t(uint32_t(e[0]) | (uint32_t(e[1]) << 8) |
                                    (uint32_t(e[2]) << 16) |
                                    (uint32_t(e[3]) << 24)); break;
              default:  v = int64_t(uint32_t(e[0]) | (uint32_t(e[1]) << 8) |
                                    (uint32_t(e[2]) << 16) |
                                    (uint32_t(e[3]) << 24)); break;
            }
            n = snprintf(tmp, sizeof(tmp), ",%lld",
                         static_cast<long long>(v));
          }
          if (!put(tmp, n)) return -1;
        }
        t += int64_t(cnt) * size;
        break;
      }
      default:
        return -1;
    }
  }
  *used = w;
  return 0;
}

}  // namespace

// ----------------------------------------------------- BAM encoding ----

namespace bamenc {  // NOLINT — internal helpers

// SAM text tag field ("NM:i:5") -> binary BAM tag bytes appended to out
// (nullptr = size-only pass).  Returns bytes produced, or -1 on a
// malformed field.
inline int64_t tag_to_bin(const uint8_t* f, const uint8_t* fe, uint8_t* out) {
  if (fe - f < 5 || f[2] != ':' || f[4] != ':') return -1;
  const uint8_t* val = f + 5;
  int64_t vlen = fe - val;
  char typ = char(f[3]);
  int64_t w = 0;
  // strtof needs a NUL terminator; the attrs buffer has none, so copy the
  // bounded [p, pe) field into a stack buffer before parsing (ADVICE r2)
  auto parse_f32 = [](const uint8_t* p, const uint8_t* pe) -> float {
    char buf[64];
    size_t n = size_t(pe - p);
    if (n >= sizeof(buf)) n = sizeof(buf) - 1;
    memcpy(buf, p, n);
    buf[n] = 0;
    return strtof(buf, nullptr);
  };
  auto put8 = [&](uint8_t v) { if (out) out[w] = v; ++w; };
  auto put_bytes = [&](const uint8_t* p, int64_t n) {
    if (out) memcpy(out + w, p, size_t(n));
    w += n;
  };
  auto parse_num = [&](const uint8_t* p, const uint8_t* pe, int64_t* ok_v,
                       bool* ok) {
    bool o = true;
    int64_t v = parse_i64(p, pe, &o);
    *ok = o;
    *ok_v = v;
  };
  put8(f[0]);
  put8(f[1]);
  switch (typ) {
    case 'A':
      if (vlen != 1) return -1;
      put8('A');
      put8(val[0]);
      break;
    case 'i': {
      bool ok;
      int64_t v;
      parse_num(val, fe, &v, &ok);
      if (!ok) return -1;
      int32_t v32 = int32_t(v);
      put8('i');
      put_bytes(reinterpret_cast<uint8_t*>(&v32), 4);
      break;
    }
    case 'f': {
      float fv = parse_f32(val, fe);
      put8('f');
      put_bytes(reinterpret_cast<uint8_t*>(&fv), 4);
      break;
    }
    case 'Z':
    case 'H':
      put8(uint8_t(typ));
      put_bytes(val, vlen);
      put8(0);
      break;
    case 'B': {
      if (vlen < 1) return -1;
      char sub = char(val[0]);
      put8('B');
      put8(uint8_t(sub));
      // count elements
      uint32_t cnt = 0;
      for (const uint8_t* p = val + 1; p < fe; ++p)
        if (*p == ',') ++cnt;
      put_bytes(reinterpret_cast<uint8_t*>(&cnt), 4);
      const uint8_t* p = val + 1;
      while (p < fe && *p == ',') {
        ++p;
        const uint8_t* q = p;
        while (q < fe && *q != ',') ++q;
        if (sub == 'f') {
          float fv = parse_f32(p, q);
          put_bytes(reinterpret_cast<uint8_t*>(&fv), 4);
        } else {
          bool ok;
          int64_t v;
          parse_num(p, q, &v, &ok);
          if (!ok) return -1;
          switch (sub) {
            case 'c': case 'C': {
              uint8_t b = uint8_t(v); put_bytes(&b, 1); break;
            }
            case 's': case 'S': {
              uint16_t s16 = uint16_t(v);
              put_bytes(reinterpret_cast<uint8_t*>(&s16), 2);
              break;
            }
            case 'i': case 'I': {
              uint32_t u32 = uint32_t(v);
              put_bytes(reinterpret_cast<uint8_t*>(&u32), 4);
              break;
            }
            default: return -1;
          }
        }
        p = q;
      }
      break;
    }
    default:
      return -1;
  }
  return w;
}

// All tags for one record (attrs text + MD/OQ/RG appended in the writer's
// order) -> binary; out == nullptr for the size pass.
inline int64_t tags_to_bin(
    const uint8_t* attr, int64_t attr_len,
    const uint8_t* md, int64_t md_len, bool has_md,
    const uint8_t* oq, int64_t oq_len, bool has_oq,
    const uint8_t* rg, int64_t rg_len, bool has_rg,
    uint8_t* out) {
  int64_t w = 0;
  const uint8_t* p = attr;
  const uint8_t* pe = attr + attr_len;
  while (p < pe) {
    const uint8_t* q = static_cast<const uint8_t*>(
        memchr(p, '\t', size_t(pe - p)));
    const uint8_t* fe = q ? q : pe;
    if (fe > p) {
      int64_t n = tag_to_bin(p, fe, out ? out + w : nullptr);
      if (n < 0) return -1;
      w += n;
    }
    p = q ? q + 1 : pe;
  }
  auto put_z = [&](char a, char b, const uint8_t* v, int64_t n) {
    if (out) {
      out[w] = uint8_t(a);
      out[w + 1] = uint8_t(b);
      out[w + 2] = 'Z';
      memcpy(out + w + 3, v, size_t(n));
      out[w + 3 + n] = 0;
    }
    w += n + 4;
  };
  if (has_md) put_z('M', 'D', md, md_len);
  if (has_oq) put_z('O', 'Q', oq, oq_len);
  if (has_rg) put_z('R', 'G', rg, rg_len);
  return w;
}

}  // namespace bamenc

extern "C" {

int adamtok_version() { return 5; }

// ------------------------------------------------------ BQSR observe ----

// Dense covariate histogram: the host twin of pipelines/bqsr.
// observe_kernel (scatter-add over (rg, qual, cycle, dinuc)), used on
// single-device topologies where there is no cross-chip psum to win;
// per-thread local histograms merged at the end keep it deterministic.
// residue_ok may be nullptr: the aligned-to-reference filter (M/=/X
// spans) plus q>0 / base<4 checks are then computed from the cigar
// columns in-loop — no [N, L] mask or position array ever materializes
// on the host (known-SNP masking passes an explicit mask instead).
// snp_keys (may be null): sorted (contig << 40 | ref_pos) known-SNP site
// keys; residues at those reference positions are skipped (the dbSNP
// masking of BaseQualityRecalibration) without any [N, L] host mask.
int64_t md_mismatch_offsets(const uint8_t* s, int64_t n, int64_t* out,
                            int64_t cap);  // realign.cpp

void bqsr_observe(
    const uint8_t* bases, const uint8_t* quals, const int32_t* lengths,
    const int32_t* flags, const int32_t* rg_idx,
    const uint8_t* cigar_ops, const int32_t* cigar_lens,
    const int32_t* cigar_n, int64_t cmax,
    const int32_t* contig_idx, const int64_t* start,
    const int64_t* snp_keys, int64_t n_snps,
    const uint8_t* residue_ok, const uint8_t* is_mm, const uint8_t* read_ok,
    const uint8_t* md_buf, const int64_t* md_off,
    int64_t N, int64_t lmax, int32_t n_rg, int64_t gl,
    int64_t* total, int64_t* mism, int nthreads) {
  static const uint8_t kComp[6] = {3, 2, 1, 0, 4, 5};
  constexpr int32_t kNQual = 94, kNDinuc = 17, kDinucNone = 16;
  const int64_t n_cyc = 2 * gl + 1;
  const int64_t size = int64_t(n_rg) * kNQual * n_cyc * kNDinuc;
  memset(total, 0, size_t(size) * 8);
  memset(mism, 0, size_t(size) * 8);
  if (nthreads < 1) nthreads = 1;
  int nt = (N < 4096) ? 1 : nthreads;
  // each thread owns a private histogram pair (16 bytes/cell); cap the
  // fan-out so the scratch stays under ~1 GB even for many read groups
  constexpr int64_t kScratchBudget = 1LL << 30;
  int64_t max_nt = kScratchBudget / (size * 16);
  if (max_nt < 1) max_nt = 1;
  if (nt > max_nt) nt = int(max_nt);
  std::vector<std::vector<int64_t>> loc_t(nt), loc_m(nt);
  auto work = [&](int t, int64_t lo, int64_t hi) {
    auto& lt = loc_t[t];
    auto& lm = loc_m[t];
    lt.assign(size_t(size), 0);
    lm.assign(size_t(size), 0);
    // per-thread scratch: aligned-span flags + reference positions +
    // inline-parsed MD mismatch offsets (is_mm == nullptr mode)
    std::vector<uint8_t> aligned(static_cast<size_t>(lmax), 0);
    std::vector<int64_t> refp(static_cast<size_t>(lmax), -1);
    std::vector<int64_t> mm_ro(static_cast<size_t>(4 * lmax + 8), 0);
    const bool mask_snps = snp_keys && n_snps > 0;
    for (int64_t i = lo; i < hi; ++i) {
      if (!read_ok[i]) continue;
      const uint8_t* bs = bases + i * lmax;
      const uint8_t* q = quals + i * lmax;
      const uint8_t* rok = residue_ok ? residue_ok + i * lmax : nullptr;
      const uint8_t* mm = is_mm ? is_mm + i * lmax : nullptr;
      int64_t n_mm = 0, mp = 0;
      if (!mm && md_buf && md_off) {
        n_mm = md_mismatch_offsets(md_buf + md_off[i],
                                   md_off[i + 1] - md_off[i], mm_ro.data(),
                                   int64_t(mm_ro.size()));
        // count == cap means the scratch may have truncated a
        // pathological MD tag; grow and re-parse rather than silently
        // dropping tail mismatches from the histogram
        while (n_mm == int64_t(mm_ro.size())) {
          mm_ro.resize(mm_ro.size() * 2);
          n_mm = md_mismatch_offsets(md_buf + md_off[i],
                                     md_off[i + 1] - md_off[i],
                                     mm_ro.data(), int64_t(mm_ro.size()));
        }
      }
      int64_t L = lengths[i];
      int32_t fl = flags[i];
      bool rev = fl & 0x10;
      bool second = (fl & 0x1) && (fl & 0x80);
      int64_t initial = rev ? (second ? -L : L) : (second ? -1 : 1);
      int64_t inc = rev ? (second ? 1 : -1) : (second ? -1 : 1);
      int32_t rg = rg_idx[i] >= 0 && rg_idx[i] < n_rg ? rg_idx[i] : n_rg - 1;
      // per-read SNP window: one binary search to the first site key at
      // or past this read's start, then a merge pointer over the
      // ascending refp walk — O(1) amortized per residue instead of a
      // log2(n_snps) search at every aligned base
      const int64_t* snp_it = nullptr;
      const int64_t* snp_end = nullptr;
      if (mask_snps && !rok) {
        int64_t key0 =
            (int64_t(contig_idx ? contig_idx[i] : 0) << 40) |
            (start ? start[i] : 0);
        snp_end = snp_keys + n_snps;
        snp_it = std::lower_bound(snp_keys, snp_end, key0);
      }
      if (!rok || !mm) {
        // mark query positions consumed by reference-aligned ops (M/=/X),
        // recording each one's reference position for SNP masking
        static const uint8_t kQ[16] = {1, 1, 0, 0, 1, 0, 0, 1, 1,
                                       0, 0, 0, 0, 0, 0, 0};
        memset(aligned.data(), 0, size_t(lmax));
        int64_t qp = 0;
        int64_t rp = start ? start[i] : 0;
        int nc = cigar_n[i] > cmax ? int(cmax) : cigar_n[i];
        for (int k = 0; k < nc && qp < lmax; ++k) {
          uint8_t op = cigar_ops[i * cmax + k] & 15;
          int64_t len = cigar_lens[i * cmax + k];
          if (len < 0) len = 0;
          bool cq = kQ[op];
          bool cr = consumes_ref(op);
          if (cq && cr) {
            int64_t stop = qp + len;
            if (stop > lmax) stop = lmax;
            for (int64_t j2 = qp; j2 < stop; ++j2) {
              aligned[size_t(j2)] = 1;
              refp[size_t(j2)] = rp + (j2 - qp);
            }
          }
          if (cq) qp += len;
          if (cr) rp += len;
        }
      }
      for (int64_t j = 0; j < L && j < lmax; ++j) {
        if (rok) {
          if (!rok[j]) continue;
        } else {
          if (!aligned[size_t(j)] || q[j] == 0 || q[j] >= QUAL_PAD ||
              bs[j] >= 4)
            continue;
          if (mask_snps) {
            int64_t key =
                (int64_t(contig_idx ? contig_idx[i] : 0) << 40) |
                refp[size_t(j)];
            while (snp_it != snp_end && *snp_it < key) ++snp_it;
            if (snp_it != snp_end && *snp_it == key) continue;
          }
        }
        int64_t cyc = initial + inc * j + gl;
        uint8_t cur = bs[j], prev;
        bool first_machine;
        if (rev) {
          cur = kComp[cur > 5 ? 5 : cur];
          uint8_t nb = (j + 1 < L) ? bs[j + 1] : 5;
          prev = kComp[nb > 5 ? 5 : nb];
          first_machine = (j == L - 1);
        } else {
          prev = j ? bs[j - 1] : 5;
          first_machine = (j == 0);
        }
        int32_t din = (!first_machine && cur < 4 && prev < 4)
                          ? int32_t(prev) * 4 + cur
                          : kDinucNone;
        int32_t qi = q[j] < kNQual ? q[j] : kNQual - 1;
        int64_t key =
            ((int64_t(rg) * kNQual + qi) * n_cyc + cyc) * kNDinuc + din;
        ++lt[size_t(key)];
        bool j_mm;
        if (mm) {
          j_mm = mm[j];
        } else {
          // merge inline-parsed MD mismatch offsets against the walk's
          // ascending reference positions (both relative to start[i])
          int64_t ro = refp[size_t(j)] - (start ? start[i] : 0);
          while (mp < n_mm && mm_ro[size_t(mp)] < ro) ++mp;
          j_mm = mp < n_mm && mm_ro[size_t(mp)] == ro;
        }
        if (j_mm) ++lm[size_t(key)];
      }
    }
  };
  if (nt == 1) {
    work(0, 0, N);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t)
      ts.emplace_back(work, t, N * t / nt, N * (t + 1) / nt);
    for (auto& t : ts) t.join();
  }
  for (int t = 0; t < nt; ++t) {
    for (int64_t k = 0; k < size; ++k) {
      total[k] += loc_t[size_t(t)][size_t(k)];
      mism[k] += loc_m[size_t(t)][size_t(k)];
    }
  }
}

// ----------------------------------------------------- CIGAR strings ----

// Columnar cigars -> concatenated run-length strings + offsets ('*' for
// cigar-less rows). Returns total bytes, -2 if cap too small.
int64_t cigar_strings(
    const uint8_t* ops, const int32_t* lens, const int32_t* n_ops,
    int64_t N, int64_t C, uint8_t* out, int64_t cap, int64_t* offsets,
    int nthreads) {
  std::vector<int64_t> sizes(size_t(N) + 1, 0);
  auto emit = [&](int64_t i, uint8_t* w) -> int64_t {
    int nc = n_ops[i] > C ? int(C) : n_ops[i];
    if (nc == 0) {
      if (w) *w = '*';
      return 1;
    }
    int64_t n_w = 0;
    for (int k = 0; k < nc; ++k) {
      char tmp[16];
      int n = snprintf(tmp, sizeof tmp, "%d", lens[i * C + k]);
      if (w) memcpy(w + n_w, tmp, size_t(n));
      n_w += n;
      if (w) w[n_w] = "MIDNSHP=X??????\?"[ops[i * C + k] & 0xF];
      ++n_w;
    }
    return n_w;
  };
  auto pass = [&](bool fill) {
    auto work = [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) {
        if (fill) emit(i, out + sizes[size_t(i)]);
        else sizes[size_t(i) + 1] = emit(i, nullptr);
      }
    };
    parallel_rows(N, nthreads, work);
  };
  pass(false);
  for (int64_t i = 0; i < N; ++i) sizes[size_t(i) + 1] += sizes[size_t(i)];
  if (sizes[size_t(N)] > cap) return -2;
  pass(true);
  memcpy(offsets, sizes.data(), size_t(N + 1) * 8);
  return sizes[size_t(N)];
}

// ------------------------------------------------------ FASTQ encode ----

// Format selected rows as FASTQ records (convertToFastq semantics:
// reverse-strand reads are reverse-complemented back to sequencer
// orientation, quals reversed; /1 /2 suffixes for paired reads when
// add_suffix). Two-pass like sam_encode. Returns bytes, -2 if cap small.
int64_t fastq_encode(
    const int32_t* flags, const int32_t* lengths,
    const uint8_t* select, const uint8_t* bases, const uint8_t* quals,
    int64_t lmax, const uint8_t* name_buf, const int64_t* name_off,
    int add_suffix, int64_t N, uint8_t* out, int64_t cap, int nthreads) {
  static const char kBase[6] = {'A', 'C', 'G', 'T', 'N', '.'};
  static const uint8_t kComp[6] = {3, 2, 1, 0, 4, 5};
  if (nthreads < 1) nthreads = 1;
  std::vector<int64_t> sizes(size_t(N) + 1, 0);

  auto emit = [&](int64_t i, uint8_t* w) -> int64_t {
    int64_t n_w = 0;
    auto putc_ = [&](char c) {
      if (w) w[n_w] = uint8_t(c);
      ++n_w;
    };
    int64_t L = lengths[i];
    if (L > lmax) L = lmax;
    int32_t fl = flags[i];
    bool rev = fl & 0x10;
    putc_('@');
    int64_t nm = name_off[i + 1] - name_off[i];
    if (w) memcpy(w + n_w, name_buf + name_off[i], size_t(nm));
    n_w += nm;
    if (add_suffix && (fl & 0x1)) {
      putc_('/');
      putc_((fl & 0x40) ? '1' : '2');
    }
    putc_('\n');
    const uint8_t* bs = bases + i * lmax;
    for (int64_t j = 0; j < L; ++j) {
      uint8_t c = rev ? bs[L - 1 - j] : bs[j];
      if (c > 5) c = 5;
      putc_(kBase[rev ? kComp[c] : c]);
    }
    putc_('\n');
    putc_('+');
    putc_('\n');
    const uint8_t* q = quals + i * lmax;
    for (int64_t j = 0; j < L; ++j)
      putc_(char(uint8_t(q[rev ? L - 1 - j : j] + 33)));
    putc_('\n');
    return n_w;
  };

  auto pass = [&](bool fill) {
    auto work = [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) {
        if (!select[i]) continue;
        if (fill) emit(i, out + sizes[size_t(i)]);
        else sizes[size_t(i) + 1] = emit(i, nullptr);
      }
    };
    parallel_rows(N, nthreads, work);
  };
  pass(false);
  for (int64_t i = 0; i < N; ++i) sizes[size_t(i) + 1] += sizes[size_t(i)];
  if (sizes[size_t(N)] > cap) return -2;
  pass(true);
  return sizes[size_t(N)];
}

// -------------------------------------------------------- BQSR apply ----

// Apply the recalibration phred table to every residue: the host twin of
// pipelines/bqsr.recalibrate_kernel's gather stage (cycle and dinuc
// covariates recomputed per residue, CycleCovariate.scala:31-49 /
// DinucCovariate.scala:24-50 semantics, Q5 floor + pad/valid masks).
void bqsr_apply(
    const uint8_t* bases, const uint8_t* quals, const int32_t* lengths,
    const int32_t* flags, const int32_t* rg_idx, const uint8_t* has_qual,
    const uint8_t* valid, int64_t N, int64_t lmax,
    const uint8_t* table, int32_t n_rg, int32_t n_cyc, int64_t gl,
    uint8_t* out, int nthreads) {
  static const uint8_t kComp[6] = {3, 2, 1, 0, 4, 5};  // A<->T C<->G
  constexpr int32_t kNQual = 94, kNDinuc = 17, kDinucNone = 16;
  constexpr uint8_t kQualPad = 255, kMinQ = 5;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* bs = bases + i * lmax;
      const uint8_t* q = quals + i * lmax;
      uint8_t* w = out + i * lmax;
      memcpy(w, q, size_t(lmax));
      if (!valid[i] || !has_qual[i]) continue;
      int64_t L = lengths[i];
      int32_t fl = flags[i];
      bool rev = fl & 0x10;
      bool second = (fl & 0x1) && (fl & 0x80);
      int64_t initial = rev ? (second ? -L : L) : (second ? -1 : 1);
      int64_t inc = rev ? (second ? 1 : -1) : (second ? -1 : 1);
      int32_t rg = rg_idx[i] >= 0 && rg_idx[i] < n_rg ? rg_idx[i] : n_rg - 1;
      const uint8_t* rg_table =
          table + size_t(rg) * kNQual * n_cyc * kNDinuc;
      for (int64_t j = 0; j < L && j < lmax; ++j) {
        uint8_t qv = q[j];
        if (qv < kMinQ || qv >= kQualPad) continue;
        int64_t cyc = initial + inc * j + gl;
        // machine-order previous base (reverse strand: complement of j+1)
        uint8_t cur = bs[j], prev;
        bool first_machine;
        if (rev) {
          cur = kComp[cur > 5 ? 5 : cur];
          uint8_t nb = (j + 1 < L) ? bs[j + 1] : 5;
          prev = kComp[nb > 5 ? 5 : nb];
          first_machine = (j == L - 1);
        } else {
          prev = j ? bs[j - 1] : 5;
          first_machine = (j == 0);
        }
        int32_t din = (!first_machine && cur < 4 && prev < 4)
                          ? int32_t(prev) * 4 + cur
                          : kDinucNone;
        int32_t qi = qv < kNQual ? qv : kNQual - 1;
        w[j] = rg_table[(int64_t(qi) * n_cyc + cyc) * kNDinuc + din];
      }
    }
  };
  parallel_rows(N, nthreads, work);
}

// -------------------------------------------------------- SAM encode ----

// Format valid rows as SAM text lines (the writer's format_sam_records
// semantics: 1-based positions with 0 for unplaced, '=' RNEXT
// shortening, MD/OQ/RG tags appended after the raw attrs).  Two passes
// like bam_encode.  Returns bytes written, -2 if cap too small.
int64_t sam_encode(
    const int32_t* flags, const int32_t* contig_idx, const int64_t* start,
    const int32_t* mapq, const int32_t* mate_contig_idx,
    const int64_t* mate_start, const int32_t* tlen, const int32_t* lengths,
    const uint8_t* has_qual, const uint8_t* valid,
    const uint8_t* bases, const uint8_t* quals, int64_t lmax,
    const uint8_t* cigar_ops, const int32_t* cigar_lens,
    const int32_t* cigar_n, int64_t cmax,
    const uint8_t* name_buf, const int64_t* name_off,
    const uint8_t* attr_buf, const int64_t* attr_off,
    const uint8_t* md_buf, const int64_t* md_off, const uint8_t* md_present,
    const uint8_t* oq_buf, const int64_t* oq_off, const uint8_t* oq_present,
    const int32_t* rg_idx, const uint8_t* rg_buf, const int64_t* rg_off,
    int32_t n_rgs,
    const uint8_t* ctg_buf, const int64_t* ctg_off, int32_t n_ctgs,
    int64_t N, uint8_t* out, int64_t cap, int nthreads) {
  static const char kBase[6] = {'A', 'C', 'G', 'T', 'N', '.'};
  if (nthreads < 1) nthreads = 1;
  std::vector<int64_t> sizes(size_t(N) + 1, 0);

  std::atomic<int> oob{0};
  auto emit = [&](int64_t i, uint8_t* w) -> int64_t {
    // w == nullptr: size-only.  Out-of-range contig/RG indices mark the
    // whole encode as failed (-1) so the caller's Python fallback can
    // surface the corruption loudly instead of writing a wrong file.
    if (contig_idx[i] >= n_ctgs || mate_contig_idx[i] >= n_ctgs ||
        rg_idx[i] >= n_rgs)
      oob.store(1);
    int64_t n_w = 0;
    auto put = [&](const uint8_t* p, int64_t n) {
      if (w) memcpy(w + n_w, p, size_t(n));
      n_w += n;
    };
    auto putc_ = [&](char c) {
      if (w) w[n_w] = uint8_t(c);
      ++n_w;
    };
    auto put_int = [&](int64_t v) {
      char tmp[24];
      int n = snprintf(tmp, sizeof tmp, "%lld", (long long)v);
      put(reinterpret_cast<uint8_t*>(tmp), n);
    };
    auto put_span = [&](const uint8_t* b2, const int64_t* off, int64_t k) {
      put(b2 + off[k], off[k + 1] - off[k]);
    };
    put_span(name_buf, name_off, i);
    putc_('\t');
    put_int(flags[i]);
    putc_('\t');
    int32_t c = contig_idx[i];
    if (c >= 0 && c < n_ctgs) put_span(ctg_buf, ctg_off, c);
    else putc_('*');
    putc_('\t');
    put_int(start[i] >= 0 ? start[i] + 1 : 0);
    putc_('\t');
    put_int(mapq[i] >= 0 ? mapq[i] : 0);
    putc_('\t');
    int32_t nc = cigar_n[i];
    if (nc == 0) {
      putc_('*');
    } else {
      for (int32_t k = 0; k < nc; ++k) {
        put_int(cigar_lens[i * cmax + k]);
        putc_("MIDNSHP=X??????\?"[cigar_ops[i * cmax + k] & 0xF]);
      }
    }
    putc_('\t');
    int32_t mc = mate_contig_idx[i];
    if (mc < 0) putc_('*');
    else if (mc == c && c >= 0) putc_('=');
    else if (mc < n_ctgs) put_span(ctg_buf, ctg_off, mc);
    else putc_('*');
    putc_('\t');
    put_int(mate_start[i] >= 0 ? mate_start[i] + 1 : 0);
    putc_('\t');
    put_int(tlen[i]);
    putc_('\t');
    int64_t L = lengths[i];
    if (L == 0) {
      putc_('*');
    } else {
      const uint8_t* bs = bases + i * lmax;
      for (int64_t j = 0; j < L; ++j)
        putc_(kBase[bs[j] > 5 ? 5 : bs[j]]);
    }
    putc_('\t');
    if (L == 0 || !has_qual[i]) {
      putc_('*');
    } else {
      const uint8_t* q = quals + i * lmax;
      for (int64_t j = 0; j < L; ++j)
        putc_(char(uint8_t(q[j] + 33)));
    }
    int64_t al = attr_off[i + 1] - attr_off[i];
    if (al) {
      putc_('\t');
      put(attr_buf + attr_off[i], al);
    }
    if (md_present[i]) {
      put(reinterpret_cast<const uint8_t*>("\tMD:Z:"), 6);
      put_span(md_buf, md_off, i);
    }
    if (oq_present[i]) {
      put(reinterpret_cast<const uint8_t*>("\tOQ:Z:"), 6);
      put_span(oq_buf, oq_off, i);
    }
    int32_t r = rg_idx[i];
    if (r >= 0 && r < n_rgs) {
      put(reinterpret_cast<const uint8_t*>("\tRG:Z:"), 6);
      put_span(rg_buf, rg_off, r);
    }
    putc_('\n');
    return n_w;
  };

  auto pass = [&](bool fill) {
    auto work = [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) {
        if (!valid[i]) continue;
        if (fill) emit(i, out + sizes[size_t(i)]);
        else sizes[size_t(i) + 1] = emit(i, nullptr);
      }
    };
    parallel_rows(N, nthreads, work);
  };
  pass(false);
  if (oob.load()) return -1;
  for (int64_t i = 0; i < N; ++i) sizes[size_t(i) + 1] += sizes[size_t(i)];
  if (sizes[size_t(N)] > cap) return -2;
  pass(true);
  return sizes[size_t(N)];
}

// -------------------------------------------------------- BAM encode ----

// Encode valid rows into a BAM record stream (the inverse of
// bamtok_fill; tags from the stringified attrs + MD/OQ/RG sidecars).
// Two passes: per-record sizes (threaded) -> exclusive offsets -> fill
// (threaded).  Returns bytes written, -1 on malformed tag text, -2 if
// ``cap`` is too small.
int64_t bam_encode(
    const int32_t* flags, const int32_t* contig_idx, const int64_t* start,
    const int32_t* mapq, const int32_t* mate_contig_idx,
    const int64_t* mate_start, const int32_t* tlen, const int32_t* lengths,
    const uint8_t* has_qual, const uint8_t* valid,
    const uint8_t* bases, const uint8_t* quals, int64_t lmax,
    const uint8_t* cigar_ops, const int32_t* cigar_lens,
    const int32_t* cigar_n, int64_t cmax,
    const uint8_t* name_buf, const int64_t* name_off,
    const uint8_t* attr_buf, const int64_t* attr_off,
    const uint8_t* md_buf, const int64_t* md_off, const uint8_t* md_present,
    const uint8_t* oq_buf, const int64_t* oq_off, const uint8_t* oq_present,
    const int32_t* rg_idx, const uint8_t* rg_buf, const int64_t* rg_off,
    int32_t n_rgs, int32_t n_refs, int64_t N, uint8_t* out, int64_t cap,
    int nthreads) {
  static const uint8_t kNib[6] = {1, 2, 4, 8, 15, 0};  // A C G T N PAD
  if (nthreads < 1) nthreads = 1;
  std::vector<int64_t> sizes(size_t(N) + 1, 0);
  std::atomic<int> bad{0};

  auto tag_parts = [&](int64_t i, const uint8_t** a, int64_t* al,
                       const uint8_t** md, int64_t* mdl, bool* hmd,
                       const uint8_t** oq, int64_t* oql, bool* hoq,
                       const uint8_t** rg, int64_t* rgl, bool* hrg) {
    *a = attr_buf + attr_off[i];
    *al = attr_off[i + 1] - attr_off[i];
    *hmd = md_present[i] != 0;
    *md = md_buf + md_off[i];
    *mdl = md_off[i + 1] - md_off[i];
    *hoq = oq_present[i] != 0;
    *oq = oq_buf + oq_off[i];
    *oql = oq_off[i + 1] - oq_off[i];
    int32_t r = rg_idx[i];
    *hrg = r >= 0 && r < n_rgs;
    if (*hrg) {
      *rg = rg_buf + rg_off[r];
      *rgl = rg_off[r + 1] - rg_off[r];
    } else {
      *rg = nullptr;
      *rgl = 0;
    }
  };

  auto size_one = [&](int64_t i) -> int64_t {
    if (!valid[i]) return 0;
    if (rg_idx[i] >= n_rgs) return -1;  // corrupt batch: fail loudly
    // an out-of-range refID would poison the BAM silently (sam_encode's
    // contig lookup fails loudly; mirror that here)
    if (contig_idx[i] >= n_refs || mate_contig_idx[i] >= n_refs) return -1;
    const uint8_t *a, *md, *oq, *rg;
    int64_t al, mdl, oql, rgl;
    bool hmd, hoq, hrg;
    tag_parts(i, &a, &al, &md, &mdl, &hmd, &oq, &oql, &hoq, &rg, &rgl, &hrg);
    int64_t tagsz = bamenc::tags_to_bin(a, al, md, mdl, hmd, oq, oql, hoq,
                                        rg, rgl, hrg, nullptr);
    if (tagsz < 0) return -1;
    int64_t L = lengths[i];
    int64_t nm = name_off[i + 1] - name_off[i];
    return 4 + 32 + nm + 1 + 4 * int64_t(cigar_n[i]) + (L + 1) / 2 + L +
           tagsz;
  };

  {
    auto work = [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) {
        int64_t s = size_one(i);
        if (s < 0) { bad.store(1); return; }
        sizes[size_t(i) + 1] = s;
      }
    };
    parallel_rows(N, nthreads, work);
  }
  if (bad.load()) return -1;
  for (int64_t i = 0; i < N; ++i) sizes[size_t(i) + 1] += sizes[size_t(i)];
  int64_t total = sizes[size_t(N)];
  if (total > cap) return -2;

  auto fill_one = [&](int64_t i) {
    if (!valid[i]) return;
    uint8_t* w = out + sizes[size_t(i)];
    int64_t block = sizes[size_t(i) + 1] - sizes[size_t(i)] - 4;
    int32_t bs32 = int32_t(block);
    memcpy(w, &bs32, 4); w += 4;
    int64_t nm = name_off[i + 1] - name_off[i];
    int64_t L = lengths[i];
    int32_t hdr[4];
    hdr[0] = contig_idx[i];
    hdr[1] = start[i] >= 0 ? int32_t(start[i]) : -1;
    memcpy(w, hdr, 8); w += 8;
    *w++ = uint8_t(nm + 1);
    *w++ = uint8_t(mapq[i] & 0xFF);
    uint16_t bin16 = 0;
    memcpy(w, &bin16, 2); w += 2;
    uint16_t nc16 = uint16_t(cigar_n[i]);
    memcpy(w, &nc16, 2); w += 2;
    uint16_t fl16 = uint16_t(flags[i] & 0xFFFF);
    memcpy(w, &fl16, 2); w += 2;
    int32_t l32 = int32_t(L);
    memcpy(w, &l32, 4); w += 4;
    int32_t mc = mate_contig_idx[i];
    memcpy(w, &mc, 4); w += 4;
    int32_t mp = mate_start[i] >= 0 ? int32_t(mate_start[i]) : -1;
    memcpy(w, &mp, 4); w += 4;
    int32_t tl32 = tlen[i];
    memcpy(w, &tl32, 4); w += 4;
    memcpy(w, name_buf + name_off[i], size_t(nm)); w += nm;
    *w++ = 0;
    for (int32_t k = 0; k < cigar_n[i]; ++k) {
      uint32_t c = (uint32_t(cigar_lens[i * cmax + k]) << 4) |
                   (cigar_ops[i * cmax + k] & 0xF);
      memcpy(w, &c, 4); w += 4;
    }
    const uint8_t* bs = bases + i * lmax;
    for (int64_t j = 0; j + 1 < L + 1; j += 2) {
      uint8_t hi = kNib[bs[j] > 5 ? 5 : bs[j]];
      uint8_t lo = (j + 1 < L) ? kNib[bs[j + 1] > 5 ? 5 : bs[j + 1]] : 0;
      *w++ = uint8_t((hi << 4) | lo);
    }
    const uint8_t* q = quals + i * lmax;
    if (has_qual[i]) {
      for (int64_t j = 0; j < L; ++j)
        *w++ = (q[j] == QUAL_PAD) ? 0xFF : q[j];
    } else {
      memset(w, 0xFF, size_t(L));
      w += L;
    }
    const uint8_t *a, *md, *oq, *rg;
    int64_t al, mdl, oql, rgl;
    bool hmd, hoq, hrg;
    tag_parts(i, &a, &al, &md, &mdl, &hmd, &oq, &oql, &hoq, &rg, &rgl, &hrg);
    bamenc::tags_to_bin(a, al, md, mdl, hmd, oq, oql, hoq, rg, rgl, hrg, w);
  };

  {
    auto work = [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) fill_one(i);
    };
    parallel_rows(N, nthreads, work);
  }
  return total;
}


// ------------------------------------------------------- CIGAR walks ----

// Parse CIGAR strings (flat byte buffer + row offsets, Arrow string
// layout) into columnar (ops u8[N, C], lens i32[N, C], n_ops i32[N]).
// '*' or empty rows get n_ops 0.  Returns -1 if any row has more than C
// ops (caller sized C from a host-side count) — never writes OOB.
int cigar_cols(const uint8_t* buf, const int64_t* offsets, int64_t N,
               int64_t C, uint8_t* ops, int32_t* lens, int32_t* n_ops,
               int nthreads) {
  static int8_t code[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; ++i) code[i] = -1;
    const char* cs = "MIDNSHP=X";
    for (int i = 0; cs[i]; ++i) code[uint8_t(cs[i])] = int8_t(i);
    init = true;
  }
  if (nthreads < 1) nthreads = 1;
  std::atomic<int> bad{0};
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      uint8_t* row_ops = ops + i * C;
      int32_t* row_lens = lens + i * C;
      for (int64_t k = 0; k < C; ++k) {
        row_ops[k] = 15;  // CIGAR_PAD
        row_lens[k] = 0;
      }
      int64_t s = offsets[i], e = offsets[i + 1];
      int n = 0;
      if (e - s == 1 && buf[s] == '*') {
        n_ops[i] = 0;
        continue;
      }
      int64_t num = 0;
      bool ok = true;
      for (int64_t p = s; p < e; ++p) {
        uint8_t ch = buf[p];
        if (ch >= '0' && ch <= '9') {
          num = num * 10 + (ch - '0');
          if (num > INT32_MAX) { ok = false; break; }
        } else {
          int8_t c = code[ch];
          if (c < 0 || n >= C) { ok = false; break; }
          row_ops[n] = uint8_t(c);
          row_lens[n] = int32_t(num);
          num = 0;
          ++n;
        }
      }
      if (!ok) { bad.store(1); n = 0; }
      n_ops[i] = n;
    }
  };
  parallel_rows(N, nthreads, work);
  return bad.load() ? -1 : 0;
}

// Per-base reference positions from columnar CIGARs: out[i, j] = reference
// position of query base j of read i, or -1 when the base is not aligned
// (insertion / soft clip / padding).  The host twin of the device kernel in
// ops/cigar.py (RichAlignmentRecord.referencePositions semantics,
// rich/RichAlignmentRecord.scala:200-229); a straight nested walk per read,
// threaded over rows.
void ref_positions(const uint8_t* ops, const int32_t* lens,
                   const int32_t* n_ops, const int64_t* start,
                   int64_t N, int64_t C, int64_t L, int64_t* out,
                   int nthreads) {
  // consumes-query / consumes-ref tables for op codes 0..15 (M I D N S H P = X)
  static const uint8_t kQ[16] = {1, 1, 0, 0, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0};
  static const uint8_t kR[16] = {1, 0, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0};
  if (nthreads < 1) nthreads = 1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t* row = out + i * L;
      for (int64_t j = 0; j < L; ++j) row[j] = -1;
      int64_t q = 0;
      int64_t r = start[i];
      int nc = n_ops[i];
      if (nc > C) nc = int(C);
      for (int k = 0; k < nc && q < L; ++k) {
        uint8_t op = ops[i * C + k] & 15;
        int64_t len = lens[i * C + k];
        if (len < 0) len = 0;
        bool cq = kQ[op], cr = kR[op];
        if (cq && cr) {
          int64_t stop = q + len;
          if (stop > L) stop = L;
          for (int64_t j = q; j < stop; ++j) row[j] = r + (j - q);
        }
        if (cq) q += len;
        if (cr) r += len;
      }
    }
  };
  parallel_rows(N, nthreads, work);
}

// ------------------------------------------------------------------ SAM --

void* samtok_scan(const uint8_t* buf, int64_t n, int64_t body_off,
                  int nthreads) {
  auto* h = new SamHandle;
  h->buf = buf;
  h->n = n;
  if (nthreads < 1) nthreads = 1;
  if (body_off < 0) body_off = 0;
  if (body_off > n) body_off = n;  // header-only file without trailing \n
  // chunk at line boundaries
  std::vector<int64_t> cuts{body_off};
  for (int i = 1; i < nthreads; ++i) {
    int64_t target = body_off + (n - body_off) * i / nthreads;
    const uint8_t* nl = static_cast<const uint8_t*>(
        memchr(buf + target, '\n', size_t(n - target)));
    int64_t cut = nl ? (nl - buf) + 1 : n;
    if (cut > cuts.back()) cuts.push_back(cut);
  }
  cuts.push_back(n);
  h->chunks.resize(cuts.size() - 1);
  std::vector<std::thread> ts;
  for (size_t i = 0; i < h->chunks.size(); ++i) {
    h->chunks[i].begin = cuts[i];
    h->chunks[i].end = cuts[i + 1];
    ts.emplace_back(sam_scan_chunk, buf, &h->chunks[i]);
  }
  for (auto& t : ts) t.join();
  int64_t rec = 0, nameb = 0, tagb = 0;
  for (auto& c : h->chunks) {
    if (c.dims.malformed) {
      delete h;
      return nullptr;
    }
    c.rec0 = rec;
    c.name0 = nameb;
    c.tag0 = tagb;
    rec += c.dims.n_records;
    nameb += c.dims.name_bytes;
    tagb += c.dims.tag_bytes;
    h->total.lmax = std::max(h->total.lmax, c.dims.lmax);
    h->total.cmax = std::max(h->total.cmax, c.dims.cmax);
  }
  h->total.n_records = rec;
  h->total.name_bytes = nameb;
  h->total.tag_bytes = tagb;
  return h;
}

void samtok_dims(void* vh, int64_t* n_records, int32_t* lmax, int32_t* cmax,
                 int64_t* name_bytes, int64_t* tag_bytes) {
  auto* h = static_cast<SamHandle*>(vh);
  *n_records = h->total.n_records;
  *lmax = h->total.lmax;
  *cmax = h->total.cmax;
  *name_bytes = h->total.name_bytes;
  *tag_bytes = h->total.tag_bytes;
}

int samtok_fill(
    void* vh, const uint8_t* contig_buf, const int64_t* contig_off,
    int32_t n_contigs, const uint8_t* rg_buf, const int64_t* rg_off,
    int32_t n_rgs, int32_t* flags, int32_t* contig_idx, int64_t* start,
    int64_t* end_, int32_t* mapq, int32_t* mate_contig_idx,
    int64_t* mate_start, int32_t* tlen, int32_t* rg_idx, int32_t* lengths,
    uint8_t* has_qual, uint8_t* bases, uint8_t* quals, int64_t lmax,
    uint8_t* cigar_ops, int32_t* cigar_lens, int32_t* cigar_n, int64_t cmax,
    uint8_t* name_buf, int64_t* name_off, uint8_t* attr_buf,
    int64_t* attr_off, uint8_t* md_buf, int64_t* md_off, uint8_t* md_present,
    uint8_t* oq_buf, int64_t* oq_off, uint8_t* oq_present,
    int64_t* attr_bytes, int64_t* md_bytes, int64_t* oq_bytes) {
  auto* h = static_cast<SamHandle*>(vh);
  Dict contigs = build_dict(contig_buf, contig_off, n_contigs);
  Dict rgs = build_dict(rg_buf, rg_off, n_rgs);
  SamOut o{flags, contig_idx, mapq, mate_contig_idx, tlen, rg_idx,
           lengths, cigar_lens, cigar_n, start, end_, mate_start,
           has_qual, bases, quals, cigar_ops, lmax, cmax,
           name_buf, attr_buf, md_buf, oq_buf,
           name_off, attr_off, md_off, oq_off, md_present, oq_present};
  std::vector<std::thread> ts;
  std::vector<uint8_t> oks(h->chunks.size(), 0);
  for (size_t i = 0; i < h->chunks.size(); ++i) {
    ts.emplace_back([&, i]() {
      oks[i] = sam_fill_chunk(h->buf, &h->chunks[i], contigs, rgs, &o) ? 1 : 0;
    });
  }
  for (auto& t : ts) t.join();
  for (auto ok : oks)
    if (!ok) return 1;
  // compact attrs/md/oq: slide each chunk's used region left
  int64_t aw = 0, mw = 0, qw = 0;
  for (auto& c : h->chunks) {
    int64_t n_rec = c.dims.n_records;
    if (c.attr_used && aw != c.tag0)
      memmove(attr_buf + aw, attr_buf + c.tag0, size_t(c.attr_used));
    if (c.md_used && mw != c.tag0)
      memmove(md_buf + mw, md_buf + c.tag0, size_t(c.md_used));
    if (c.oq_used && qw != c.tag0)
      memmove(oq_buf + qw, oq_buf + c.tag0, size_t(c.oq_used));
    int64_t da = aw - c.tag0, dm = mw - c.tag0, dq = qw - c.tag0;
    for (int64_t r = c.rec0; r < c.rec0 + n_rec; ++r) {
      attr_off[r] += da;
      md_off[r] += dm;
      oq_off[r] += dq;
    }
    aw += c.attr_used;
    mw += c.md_used;
    qw += c.oq_used;
  }
  int64_t nrec = h->total.n_records;
  attr_off[nrec] = aw;
  md_off[nrec] = mw;
  oq_off[nrec] = qw;
  name_off[nrec] = h->total.name_bytes;
  *attr_bytes = aw;
  *md_bytes = mw;
  *oq_bytes = qw;
  return 0;
}

void samtok_free(void* vh) { delete static_cast<SamHandle*>(vh); }

// ----------------------------------------------------------------- BGZF --

// partial_ok: a truncated final block (streaming window) ends the scan
// instead of failing; bgzf_consumed() then reports how many input bytes
// belong to complete blocks.
void* bgzf_scan2(const uint8_t* buf, int64_t n, int partial_ok) {
  auto* h = new BgzfHandle;
  h->buf = buf;
  h->n = n;
  int64_t off = 0, out = 0;
  while (off < n) {
    int64_t bsize = 0;
    int64_t hl = bgzf_block_header(buf + off, n - off, &bsize);
    if (hl < 0 || bsize < hl + 8 || off + bsize > n) {
      bool truncated = hl == -2 || (hl >= 0 && off + bsize > n);
      if (partial_ok && truncated) break;
      delete h;
      return nullptr;
    }
    uint32_t crc, isize;
    memcpy(&crc, buf + off + bsize - 8, 4);
    memcpy(&isize, buf + off + bsize - 4, 4);
    if (isize) {
      h->blocks.push_back(
          {off + hl, bsize - hl - 8, out, int64_t(isize), crc});
      out += isize;
    }
    off += bsize;
  }
  h->out_bytes = out;
  h->consumed = off;
  return h;
}

void* bgzf_scan(const uint8_t* buf, int64_t n) {
  return bgzf_scan2(buf, n, 0);
}

int64_t bgzf_consumed(void* vh) {
  return static_cast<BgzfHandle*>(vh)->consumed;
}

void bgzf_dims(void* vh, int64_t* n_blocks, int64_t* out_bytes) {
  auto* h = static_cast<BgzfHandle*>(vh);
  *n_blocks = int64_t(h->blocks.size());
  *out_bytes = h->out_bytes;
}

int bgzf_fill(void* vh, uint8_t* out, int nthreads) {
  auto* h = static_cast<BgzfHandle*>(vh);
  if (nthreads < 1) nthreads = 1;
  std::vector<uint8_t> oks(size_t(nthreads), 1);
  std::vector<std::thread> ts;
  int64_t nb = int64_t(h->blocks.size());
  for (int t = 0; t < nthreads; ++t) {
    ts.emplace_back([&, t]() {
      int64_t b0 = nb * t / nthreads, b1 = nb * (t + 1) / nthreads;
      for (int64_t b = b0; b < b1; ++b) {
        const BgzfBlock& blk = h->blocks[size_t(b)];
        z_stream zs;
        memset(&zs, 0, sizeof(zs));
        if (inflateInit2(&zs, -15) != Z_OK) { oks[size_t(t)] = 0; return; }
        zs.next_in = const_cast<uint8_t*>(h->buf + blk.comp_off);
        zs.avail_in = uInt(blk.comp_len);
        zs.next_out = out + blk.out_off;
        zs.avail_out = uInt(blk.out_len);
        int rc = inflate(&zs, Z_FINISH);
        inflateEnd(&zs);
        if (rc != Z_STREAM_END || zs.total_out != uLong(blk.out_len) ||
            uint32_t(crc32(0, out + blk.out_off, uInt(blk.out_len))) !=
                blk.crc) {
          oks[size_t(t)] = 0;
          return;
        }
      }
    });
  }
  for (auto& t : ts) t.join();
  for (auto ok : oks)
    if (!ok) return 1;
  return 0;
}

void bgzf_free(void* vh) { delete static_cast<BgzfHandle*>(vh); }

// BGZF compression: deflate independent blocks in parallel.
// Layout per block: 18-byte header (incl. BC extra field) + deflate
// payload + crc32 + isize.  Caller provides the worst-case output buffer.
int bgzf_compress(const uint8_t* in, int64_t n, int64_t block_size,
                  uint8_t* out, int64_t out_cap, int64_t* out_len,
                  int nthreads, int level) {
  if (block_size <= 0) block_size = 0xff00;
  int64_t n_blocks = n ? (n + block_size - 1) / block_size : 0;
  std::vector<int64_t> lens(size_t(n_blocks), 0);
  std::vector<std::vector<uint8_t>> payloads;
  payloads.resize(size_t(n_blocks));
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> ts;
  std::vector<uint8_t> oks(size_t(nthreads), 1);
  for (int t = 0; t < nthreads; ++t) {
    ts.emplace_back([&, t]() {
      for (int64_t b = n_blocks * t / nthreads;
           b < n_blocks * (t + 1) / nthreads; ++b) {
        int64_t off = b * block_size;
        int64_t len = std::min(block_size, n - off);
        auto& pl = payloads[size_t(b)];
        pl.resize(size_t(compressBound(uLong(len))) + 16);
        z_stream zs;
        memset(&zs, 0, sizeof(zs));
        if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                         Z_DEFAULT_STRATEGY) != Z_OK) {
          oks[size_t(t)] = 0;
          return;
        }
        zs.next_in = const_cast<uint8_t*>(in + off);
        zs.avail_in = uInt(len);
        zs.next_out = pl.data();
        zs.avail_out = uInt(pl.size());
        int rc = deflate(&zs, Z_FINISH);
        deflateEnd(&zs);
        if (rc != Z_STREAM_END) { oks[size_t(t)] = 0; return; }
        pl.resize(zs.total_out);
        lens[size_t(b)] = int64_t(zs.total_out);
      }
    });
  }
  for (auto& t : ts) t.join();
  for (auto ok : oks)
    if (!ok) return 1;
  int64_t w = 0;
  for (int64_t b = 0; b < n_blocks; ++b) {
    int64_t off = b * block_size;
    int64_t len = std::min(block_size, n - off);
    int64_t total = 18 + lens[size_t(b)] + 8;
    if (w + total > out_cap) return 1;
    uint8_t* p = out + w;
    const uint8_t hdr[12] = {0x1f, 0x8b, 8, 4, 0, 0, 0, 0, 0, 0xff, 6, 0};
    memcpy(p, hdr, 12);
    p[12] = 'B'; p[13] = 'C'; p[14] = 2; p[15] = 0;
    uint16_t bsize = uint16_t(total - 1);
    p[16] = uint8_t(bsize & 0xff);
    p[17] = uint8_t(bsize >> 8);
    memcpy(p + 18, payloads[size_t(b)].data(), size_t(lens[size_t(b)]));
    uint32_t crc = uint32_t(crc32(0, in + off, uInt(len)));
    uint32_t isz = uint32_t(len);
    memcpy(p + 18 + lens[size_t(b)], &crc, 4);
    memcpy(p + 18 + lens[size_t(b)] + 4, &isz, 4);
    w += total;
  }
  static const uint8_t EOF_BLOCK[28] = {
      0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff, 0x06, 0x00, 0x42,
      0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00, 0, 0, 0, 0, 0, 0, 0, 0};
  if (w + 28 > out_cap) return 1;
  memcpy(out + w, EOF_BLOCK, 28);
  w += 28;
  *out_len = w;
  return 0;
}

// ------------------------------------------------------------------ BAM --

// partial_ok: a record truncated by the end of a streaming window ends
// the scan (bamtok_consumed() reports the bytes covered by complete
// records); structurally malformed records still fail the scan.
void* bamtok_scan2(const uint8_t* buf, int64_t n, int64_t records_off,
                   int partial_ok) {
  auto* h = new BamHandle;
  h->buf = buf;
  h->n = n;
  h->records_off = records_off;
  int64_t off = records_off;
  while (off + 4 <= n) {
    int32_t bs;
    memcpy(&bs, buf + off, 4);
    if (bs < 32 || off + 4 + bs > n) {
      if (bs == 0) break;
      if (partial_ok && bs >= 32 && off + 4 + bs > n) break;
      delete h;
      return nullptr;
    }
    const uint8_t* rec = buf + off + 4;
    int32_t l_read_name = rec[8];
    uint16_t n_cigar;
    memcpy(&n_cigar, rec + 12, 2);
    int32_t l_seq;
    memcpy(&l_seq, rec + 16, 4);
    int64_t tag_bin =
        bs - 32 - l_read_name - 4 * int64_t(n_cigar) - (int64_t(l_seq) + 1) / 2 - l_seq;
    // Reject malformed records here so bamtok_fill never reads out of
    // bounds; the caller falls back to the pure-Python parser.
    if (l_read_name < 1 || l_seq < 0 || tag_bin < 0) {
      delete h;
      return nullptr;
    }
    h->rec_off.push_back(off);
    h->name_bytes += l_read_name - 1;
    if (l_seq > h->lmax) h->lmax = l_seq;
    if (n_cigar > h->cmax) h->cmax = n_cigar;
    h->tag_bytes += tag_bin * 6 + 48;
    off += 4 + bs;
  }
  h->consumed = off;
  return h;
}

void* bamtok_scan(const uint8_t* buf, int64_t n, int64_t records_off) {
  return bamtok_scan2(buf, n, records_off, 0);
}

int64_t bamtok_consumed(void* vh) {
  return static_cast<BamHandle*>(vh)->consumed;
}

void bamtok_dims(void* vh, int64_t* n_records, int32_t* lmax, int32_t* cmax,
                 int64_t* name_bytes, int64_t* tag_bytes) {
  auto* h = static_cast<BamHandle*>(vh);
  *n_records = int64_t(h->rec_off.size());
  *lmax = h->lmax;
  *cmax = h->cmax;
  *name_bytes = h->name_bytes;
  *tag_bytes = h->tag_bytes;
}

int bamtok_fill(
    void* vh, const uint8_t* rg_buf, const int64_t* rg_off, int32_t n_rgs,
    int32_t* flags, int32_t* contig_idx, int64_t* start, int64_t* end_,
    int32_t* mapq, int32_t* mate_contig_idx, int64_t* mate_start,
    int32_t* tlen, int32_t* rg_idx, int32_t* lengths, uint8_t* has_qual,
    uint8_t* bases, uint8_t* quals, int64_t lmax, uint8_t* cigar_ops,
    int32_t* cigar_lens, int32_t* cigar_n, int64_t cmax, uint8_t* name_buf,
    int64_t* name_off, uint8_t* attr_buf, int64_t* attr_off, uint8_t* md_buf,
    int64_t* md_off, uint8_t* md_present, uint8_t* oq_buf, int64_t* oq_off,
    uint8_t* oq_present, int64_t* attr_bytes, int64_t* md_bytes,
    int64_t* oq_bytes, int nthreads) {
  auto* h = static_cast<BamHandle*>(vh);
  Dict rgs = build_dict(rg_buf, rg_off, n_rgs);
  int64_t nrec = int64_t(h->rec_off.size());
  if (nthreads < 1) nthreads = 1;

  // per-thread record ranges with prefix-summed buffer bases
  std::vector<int64_t> r0(size_t(nthreads) + 1);
  for (int t = 0; t <= nthreads; ++t) r0[size_t(t)] = nrec * t / nthreads;
  // name bytes are exact; compute prefix per range serially (cheap)
  std::vector<int64_t> nbase(size_t(nthreads) + 1, 0),
      tbase(size_t(nthreads) + 1, 0);
  {
    int64_t nb = 0, tb = 0;
    int t = 0;
    for (int64_t r = 0; r <= nrec; ++r) {
      while (t <= nthreads && r == r0[size_t(t)]) {
        nbase[size_t(t)] = nb;
        tbase[size_t(t)] = tb;
        ++t;
      }
      if (r == nrec) break;
      const uint8_t* rec = h->buf + h->rec_off[size_t(r)] + 4;
      int32_t bs;
      memcpy(&bs, h->buf + h->rec_off[size_t(r)], 4);
      int32_t l_read_name = rec[8];
      uint16_t n_cigar;
      memcpy(&n_cigar, rec + 12, 2);
      int32_t l_seq;
      memcpy(&l_seq, rec + 16, 4);
      nb += l_read_name - 1;
      int64_t tag_bin = bs - 32 - l_read_name - 4 * int64_t(n_cigar) -
                        (int64_t(l_seq) + 1) / 2 - l_seq;
      tb += tag_bin * 6 + 48;
    }
  }

  std::vector<uint8_t> oks(size_t(nthreads), 1);
  std::vector<int64_t> used_a(size_t(nthreads), 0),
      used_m(size_t(nthreads), 0), used_q(size_t(nthreads), 0);
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; ++t) {
    ts.emplace_back([&, t]() {
      int64_t npos = nbase[size_t(t)];
      int64_t apos = tbase[size_t(t)], mpos = tbase[size_t(t)],
              qpos = tbase[size_t(t)];
      int64_t acap = tbase[size_t(t) + 1];
      for (int64_t r = r0[size_t(t)]; r < r0[size_t(t) + 1]; ++r) {
        int32_t bs;
        memcpy(&bs, h->buf + h->rec_off[size_t(r)], 4);
        const uint8_t* rec = h->buf + h->rec_off[size_t(r)] + 4;
        const uint8_t* rec_end = rec + bs;
        int32_t ref_id, pos, l_seq, next_ref, next_pos, tl;
        memcpy(&ref_id, rec, 4);
        memcpy(&pos, rec + 4, 4);
        int32_t l_read_name = rec[8];
        int32_t mq = rec[9];
        uint16_t n_cigar, flag;
        memcpy(&n_cigar, rec + 12, 2);
        memcpy(&flag, rec + 14, 2);
        memcpy(&l_seq, rec + 16, 4);
        memcpy(&next_ref, rec + 20, 4);
        memcpy(&next_pos, rec + 24, 4);
        memcpy(&tl, rec + 28, 4);
        flags[r] = flag;
        contig_idx[r] = ref_id;
        start[r] = ref_id >= 0 ? pos : -1;
        mapq[r] = mq;
        mate_contig_idx[r] = next_ref;
        mate_start[r] = next_ref >= 0 ? next_pos : -1;
        tlen[r] = tl;
        const uint8_t* p = rec + 32;
        memcpy(name_buf + npos, p, size_t(l_read_name - 1));
        name_off[r] = npos;
        npos += l_read_name - 1;
        p += l_read_name;
        uint8_t* crow = cigar_ops + r * cmax;
        int32_t* clrow = cigar_lens + r * cmax;
        memset(crow, CIGAR_PAD, size_t(cmax));
        memset(clrow, 0, size_t(cmax) * 4);
        int64_t ref_span = 0;
        for (int k = 0; k < n_cigar; ++k) {
          uint32_t c;
          memcpy(&c, p + 4 * k, 4);
          crow[k] = uint8_t(c & 0xf);
          clrow[k] = int32_t(c >> 4);
          if (consumes_ref(int(c & 0xf))) ref_span += c >> 4;
        }
        cigar_n[r] = n_cigar;
        end_[r] = start[r] >= 0 ? start[r] + ref_span : -1;
        p += 4 * int64_t(n_cigar);
        uint8_t* brow = bases + r * lmax;
        uint8_t* qrow = quals + r * lmax;
        memset(brow, BASE_PAD, size_t(lmax));
        memset(qrow, QUAL_PAD, size_t(lmax));
        for (int32_t k = 0; k < l_seq; ++k) {
          uint8_t nib = (k & 1) ? (p[k >> 1] & 0xf) : (p[k >> 1] >> 4);
          brow[k] = LUT.bam_seq[nib];
        }
        lengths[r] = l_seq;
        p += (int64_t(l_seq) + 1) / 2;
        bool all_ff = l_seq > 0;
        for (int32_t k = 0; k < l_seq; ++k)
          if (p[k] != 0xff) { all_ff = false; break; }
        if (l_seq && !all_ff) {
          memcpy(qrow, p, size_t(l_seq));
          has_qual[r] = 1;
        } else {
          has_qual[r] = 0;
          for (int32_t k = 0; k < l_seq; ++k) qrow[k] = 0;
        }
        p += l_seq;
        // tags
        int32_t rg = -1;
        int64_t aused = 0, mlen = -1, qlen = -1;
        attr_off[r] = apos;
        md_off[r] = mpos;
        oq_off[r] = qpos;
        if (bam_tags_to_text(p, rec_end,
                             reinterpret_cast<char*>(attr_buf) + apos,
                             acap - apos, &aused, &rg, rgs,
                             reinterpret_cast<char*>(md_buf) + mpos, &mlen,
                             reinterpret_cast<char*>(oq_buf) + qpos,
                             &qlen) != 0) {
          oks[size_t(t)] = 0;
          return;
        }
        apos += aused;
        md_present[r] = mlen >= 0 ? 1 : 0;
        if (mlen > 0) mpos += mlen;
        oq_present[r] = qlen >= 0 ? 1 : 0;
        if (qlen > 0) qpos += qlen;
        rg_idx[r] = rg;
      }
      used_a[size_t(t)] = apos - tbase[size_t(t)];
      used_m[size_t(t)] = mpos - tbase[size_t(t)];
      used_q[size_t(t)] = qpos - tbase[size_t(t)];
    });
  }
  for (auto& t : ts) t.join();
  for (auto ok : oks)
    if (!ok) return 1;
  // compact
  int64_t aw = 0, mw = 0, qw = 0;
  for (int t = 0; t < nthreads; ++t) {
    int64_t base = tbase[size_t(t)];
    if (used_a[size_t(t)] && aw != base)
      memmove(attr_buf + aw, attr_buf + base, size_t(used_a[size_t(t)]));
    if (used_m[size_t(t)] && mw != base)
      memmove(md_buf + mw, md_buf + base, size_t(used_m[size_t(t)]));
    if (used_q[size_t(t)] && qw != base)
      memmove(oq_buf + qw, oq_buf + base, size_t(used_q[size_t(t)]));
    int64_t da = aw - base, dm = mw - base, dq = qw - base;
    for (int64_t r = r0[size_t(t)]; r < r0[size_t(t) + 1]; ++r) {
      attr_off[r] += da;
      md_off[r] += dm;
      oq_off[r] += dq;
    }
    aw += used_a[size_t(t)];
    mw += used_m[size_t(t)];
    qw += used_q[size_t(t)];
  }
  attr_off[nrec] = aw;
  md_off[nrec] = mw;
  oq_off[nrec] = qw;
  name_off[nrec] = h->name_bytes;
  *attr_bytes = aw;
  *md_bytes = mw;
  *oq_bytes = qw;
  return 0;
}

void bamtok_free(void* vh) { delete static_cast<BamHandle*>(vh); }

// Gather variable-width byte spans [starts[i], starts[i]+lens[i]) from src
// into a packed destination — the StringColumn row-gather (take) kernel.
// One memcpy per row beats the numpy repeat/arange index machinery (three
// full-size int64 temporaries) on the single-core hosts this runs on.
void span_gather(const uint8_t* src, const int64_t* starts,
                 const int64_t* lens, int64_t n, uint8_t* out) {
  int64_t off = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t l = lens[i];
    if (l > 0) {
      memcpy(out + off, src + starts[i], size_t(l));
      off += l;
    }
  }
}

// Strided variant: row i's span lands at out + i*w (rows pre-zeroed by
// the caller) — the StringColumn.to_fixed_bytes layout for np.unique
// grouping, one memcpy per row instead of three fancy-index passes.
void span_gather_strided(const uint8_t* src, const int64_t* starts,
                         const int64_t* lens, int64_t n, int64_t w,
                         uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t l = lens[i];
    if (l > 0) memcpy(out + i * w, src + starts[i], size_t(l));
  }
}

// Padded byte matrix [N, W] -> LUT-mapped, length-compacted string
// buffer (row i's first lens[i] bytes land at out + off[i]).  One fused
// pass replacing the numpy LUT gather + mask-compress pair that
// dominated the Parquet part encode (sequence/qual columns: codes ->
// ASCII bases, quals -> clamped Sanger chars).  ``off`` is the caller's
// exclusive cumsum of lens (also the arrow offsets vector).
void lut_compact_rows(const uint8_t* mat, const int32_t* lens,
                      const int64_t* off, int64_t N, int64_t W,
                      const uint8_t* lut, uint8_t* out, int nthreads) {
  parallel_rows(N, nthreads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t l = lens[i];
      if (l <= 0) continue;
      if (l > W) l = W;
      const uint8_t* src = mat + i * W;
      uint8_t* dst = out + off[i];
      for (int64_t j = 0; j < l; ++j) dst[j] = lut[src[j]];
    }
  });
}

// Byte offset of every ``stride``-th line start in buf[begin:n], plus
// the end-of-last-line offset as the final entry.  Returns the number
// of offsets written (<= cap), or -1 if cap is too small.  Replaces the
// numpy whole-buffer newline scan (bool compare + flatnonzero over the
// input, ~0.5 s/GB) with one memchr walk, for the windowed SAM reader.
int64_t line_index_strided(const uint8_t* buf, int64_t n, int64_t begin,
                           int64_t stride, int64_t* out, int64_t cap) {
  if (stride < 1) stride = 1;
  int64_t written = 0;
  int64_t line = 0;
  int64_t pos = begin;
  while (pos < n) {
    if (line % stride == 0) {
      if (written >= cap) return -1;
      out[written++] = pos;
    }
    const void* nl = memchr(buf + pos, '\n', size_t(n - pos));
    pos = nl ? (static_cast<const uint8_t*>(nl) - buf) + 1 : n;
    ++line;
  }
  if (written >= cap) return -1;
  out[written++] = n;  // end offset (an unterminated final line included)
  return written;
}

}  // extern "C"
