// Copied unchanged from adam_tpu/native/realign.cpp: adamtok.cpp links against its md_mismatch_offsets.
// Native realignment prep + MD rewrite kernels.
//
// Host-side C++ port of the per-read string walks of GATK-style indel
// realignment: MD tag parse / getReference / moveAlignment / toString
// (adam_tpu/ops/mdtag.py, mirroring the reference util/MdTag.scala:47-532),
// left-normalization (pipelines/realign.py:77-183, reference
// NormalizationUtils.scala:35-153) and per-target reference rebuild +
// consensus generation (pipelines/realign.py phase 1, reference
// RealignIndels.scala:185-304, Consensus.scala:25-52).
//
// The device sweep and all accept/rewrite *decisions* stay in Python
// (numpy); this file only removes the per-read interpreter work that
// dominated the realign stage's host time.  Semantics must match the
// Python implementations bit-for-bit — the GATK golden parity tests
// (artificial.realigned.sam) run against both paths.
//
// Exposed via ctypes from adam_tpu/native/__init__.py; compiled into the
// same shared object as adamtok.cpp.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

namespace {

// ---- schema constants (formats/schema.py) -------------------------------
constexpr uint8_t CIG_M = 0, CIG_I = 1, CIG_D = 2, CIG_N = 3, CIG_S = 4,
                  CIG_H = 5, CIG_P = 6, CIG_EQ = 7, CIG_X = 8;
const char* CIGAR_CHARS = "MIDNSHP=X";
const char* BASE_DECODE = "ACGTN.";  // code -> char

inline uint8_t base_encode(char c) {
  // schema.BASE_ENCODE_LUT: ACGTN (either case) -> 0..4, '*' -> 5,
  // anything else (IUPAC ambiguity etc.) -> N (4)
  switch (c) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    case 'N': case 'n': return 4;
    case '*': return 5;
    default: return 4;
  }
}

inline bool is_md_base(char c) {
  // mdtag.py _BASES: full IUPAC ambiguity alphabet (uppercased input)
  switch (c) {
    case 'A': case 'G': case 'C': case 'T': case 'N': case 'U': case 'K':
    case 'M': case 'R': case 'S': case 'W': case 'B': case 'V': case 'H':
    case 'D': case 'X': case 'Y':
      return true;
    default:
      return false;
  }
}

struct CigEl {
  int32_t len;
  char op;
  bool operator==(const CigEl& o) const { return len == o.len && op == o.op; }
};
using Cigar = std::vector<CigEl>;

std::string cigar_to_string(const Cigar& c) {
  std::string s;
  char buf[16];
  for (const auto& e : c) {
    int n = snprintf(buf, sizeof buf, "%d%c", e.len, e.op);
    s.append(buf, n);
  }
  return s;
}

int64_t cigar_read_len(const Cigar& c) {  // ops in "MIS=X"
  int64_t n = 0;
  for (const auto& e : c)
    if (e.op == 'M' || e.op == 'I' || e.op == 'S' || e.op == '=' ||
        e.op == 'X')
      n += e.len;
  return n;
}

int64_t cigar_ref_len(const Cigar& c) {  // ops in "MDN=X"
  int64_t n = 0;
  for (const auto& e : c)
    if (e.op == 'M' || e.op == 'D' || e.op == 'N' || e.op == '=' ||
        e.op == 'X')
      n += e.len;
  return n;
}

int64_t cigar_total_len(const Cigar& c) {
  int64_t n = 0;
  for (const auto& e : c) n += e.len;
  return n;
}

int cigar_num_m_blocks(const Cigar& c) {
  int n = 0;
  for (const auto& e : c) n += e.op == 'M';
  return n;
}

// ---- MD tag --------------------------------------------------------------
struct Md {
  int64_t start = 0;
  // absolute reference positions, ascending by construction of parse
  std::vector<std::pair<int64_t, char>> mm;    // mismatches: pos -> ref base
  std::vector<std::pair<int64_t, char>> dels;  // deletions: pos -> ref base
  std::vector<std::pair<int64_t, int64_t>> matches;  // [start, end) ranges
};

// MdTag.parse (mdtag.py:53-94).  Returns false on malformed input.
// Input is uppercased on the fly (parse does `md.upper()`).
bool md_parse(const uint8_t* s, int64_t n, int64_t ref_start, Md& out) {
  out.start = ref_start;
  out.mm.clear();
  out.dels.clear();
  out.matches.clear();
  if (n == 0 || (n == 1 && s[0] == '0')) return true;
  int64_t off = 0;
  int64_t pos = ref_start;
  auto read_matches = [&]() -> bool {
    int64_t st = off;
    int64_t len = 0;
    while (off < n && s[off] >= '0' && s[off] <= '9') {
      len = len * 10 + (s[off] - '0');
      ++off;
    }
    if (off == st) return false;  // digits required
    if (len > 0) out.matches.emplace_back(pos, pos + len);
    pos += len;
    return true;
  };
  if (!read_matches()) return false;
  while (off < n) {
    if (s[off] == '^') {
      ++off;
      int64_t st = off;
      while (off < n) {
        char c = (char)toupper(s[off]);
        if (!is_md_base(c)) break;
        out.dels.emplace_back(pos, c);
        ++pos;
        ++off;
      }
      if (off == st) return false;
    } else {
      int64_t st = off;
      while (off < n) {
        char c = (char)toupper(s[off]);
        if (!is_md_base(c)) break;
        out.mm.emplace_back(pos, c);
        ++pos;
        ++off;
      }
      if (off == st) return false;
    }
    if (!read_matches()) return false;
  }
  return true;
}

// MdTag.get_reference (mdtag.py:205-256).  err: 0 ok, 2 IndexError
// (CIGAR overruns read), 3 ValueError (missing deleted base / bad op).
int md_get_reference(const Md& md, const std::string& seq, const Cigar& cig,
                     std::string& out) {
  int64_t ref_pos = md.start;
  int64_t read_pos = 0;
  out.clear();
  for (const auto& e : cig) {
    char op = e.op;
    int64_t length = e.len;
    if (op == 'M' || op == '=' || op == 'X') {
      if (read_pos + length > (int64_t)seq.size()) return 2;
      size_t seg0 = out.size();
      out.append(seq, read_pos, length);
      if (!md.mm.empty()) {
        auto lo = std::lower_bound(
            md.mm.begin(), md.mm.end(), std::make_pair(ref_pos, (char)0));
        for (auto it = lo; it != md.mm.end() && it->first < ref_pos + length;
             ++it)
          if (it->second) out[seg0 + (it->first - ref_pos)] = it->second;
      }
      read_pos += length;
      ref_pos += length;
    } else if (op == 'D') {
      for (int64_t k = 0; k < length; ++k) {
        auto it = std::lower_bound(md.dels.begin(), md.dels.end(),
                                   std::make_pair(ref_pos, (char)0));
        if (it == md.dels.end() || it->first != ref_pos) return 3;
        out.push_back(it->second);
        ++ref_pos;
      }
    } else if (op == 'I' || op == 'S') {
      read_pos += length;
    } else if (op == 'H' || op == 'P') {
      // no-op
    } else {
      return 3;
    }
  }
  return 0;
}

// MdTag.move_alignment (mdtag.py:134-186).  err: 0 ok, 2 IndexError,
// 3 ValueError (unhandled op).
int md_move_alignment(const char* reference, int64_t ref_len,
                      const std::string& seq, const Cigar& cig,
                      int64_t read_start, Md& out) {
  out.start = read_start;
  out.mm.clear();
  out.dels.clear();
  out.matches.clear();
  int64_t ref_pos = 0;
  int64_t read_pos = 0;
  for (const auto& e : cig) {
    char op = e.op;
    int64_t length = e.len;
    if (op == 'M') {
      if (ref_pos + length > ref_len || read_pos + length > (int64_t)seq.size())
        return 2;
      const char* r = reference + ref_pos;
      const char* s = seq.data() + read_pos;
      if (memcmp(r, s, length) == 0) {
        out.matches.emplace_back(ref_pos + read_start,
                                 ref_pos + length + read_start);
      } else {
        int64_t prev = -1;
        for (int64_t j = 0; j <= length; ++j) {
          bool diff = j < length && r[j] != s[j];
          if (diff) {
            out.mm.emplace_back(ref_pos + j + read_start, r[j]);
            if (j > prev + 1)
              out.matches.emplace_back(ref_pos + prev + 1 + read_start,
                                       ref_pos + j + read_start);
            prev = j;
          }
        }
        if (length > prev + 1)
          out.matches.emplace_back(ref_pos + prev + 1 + read_start,
                                   ref_pos + length + read_start);
      }
      read_pos += length;
      ref_pos += length;
    } else if (op == 'D') {
      if (ref_pos + length > ref_len) return 2;
      for (int64_t j = 0; j < length; ++j)
        out.dels.emplace_back(ref_pos + j + read_start,
                              reference[ref_pos + j]);
      ref_pos += length;
    } else if (op == 'I' || op == 'S') {
      read_pos += length;
    } else if (op == 'H' || op == 'P') {
      // no-op
    } else {
      return 3;
    }
  }
  return 0;
}

// MdTag.to_string (mdtag.py:259-287): canonical event-walk emission.
std::string md_to_string(const Md& md) {
  if (md.matches.empty() && md.mm.empty() && md.dels.empty()) return "0";
  int64_t end = md.start;  // largest covered position (inclusive)
  bool any = false;
  for (const auto& m : md.matches) {
    end = any ? std::max(end, m.second - 1) : m.second - 1;
    any = true;
  }
  for (const auto& p : md.mm) {
    end = any ? std::max(end, p.first) : p.first;
    any = true;
  }
  for (const auto& p : md.dels) {
    end = any ? std::max(end, p.first) : p.first;
    any = true;
  }
  // events sorted by (pos, is_del, base) — Python tuple ordering
  struct Ev {
    int64_t p;
    bool is_del;
    char base;
  };
  std::vector<Ev> events;
  events.reserve(md.mm.size() + md.dels.size());
  for (const auto& p : md.mm) events.push_back({p.first, false, p.second});
  for (const auto& p : md.dels) events.push_back({p.first, true, p.second});
  std::sort(events.begin(), events.end(), [](const Ev& a, const Ev& b) {
    if (a.p != b.p) return a.p < b.p;
    if (a.is_del != b.is_del) return !a.is_del;
    return a.base < b.base;
  });
  std::string out;
  char buf[24];
  int64_t prev_end = md.start;
  bool last_was_del = false;
  for (const auto& ev : events) {
    int64_t run = ev.p - prev_end;
    if (ev.is_del) {
      if (run > 0 || !last_was_del) {
        out.append(buf, snprintf(buf, sizeof buf, "%lld", (long long)run));
        out.push_back('^');
      }
      out.push_back(ev.base);
      last_was_del = true;
    } else {
      out.append(buf, snprintf(buf, sizeof buf, "%lld", (long long)run));
      out.push_back(ev.base);
      last_was_del = false;
    }
    prev_end = ev.p + 1;
  }
  out.append(buf,
             snprintf(buf, sizeof buf, "%lld", (long long)(end + 1 - prev_end)));
  return out;
}

// ---- left normalization (realign.py:77-183) ------------------------------

// RichCigar.moveLeft semantics (realign.py:77-101), including the
// reference's dropped-4th-element slicing quirk.
Cigar move_cigar_left(const Cigar& elems, int index) {
  if (index == 0 || elems.size() < 2) return elems;
  Cigar out(elems.begin(), elems.begin() + (index - 1));
  std::vector<CigEl> rest(elems.begin() + (index - 1), elems.end());
  const CigEl trim = rest[0];
  const CigEl* move = rest.size() > 1 ? &rest[1] : nullptr;
  const CigEl* pad = rest.size() > 2 ? &rest[2] : nullptr;
  if (trim.len > 1) out.push_back({trim.len - 1, trim.op});
  if (move) out.push_back(*move);
  if (pad)
    out.push_back({pad->len + 1, pad->op});
  else
    out.push_back({1, 'M'});
  if (rest.size() > 4)  // == 4 drops the 4th element (reference quirk)
    out.insert(out.end(), rest.begin() + 3, rest.end());
  return out;
}

// shift_indel (realign.py:104-136): pinned total/read/ref spans.
Cigar shift_indel(const Cigar& elems, int position, int64_t shifts) {
  Cigar cur = elems;
  const int64_t total = cigar_total_len(cur);
  const int64_t rlen = cigar_read_len(cur);
  const int64_t reflen = cigar_ref_len(cur);
  while (true) {
    Cigar nw = move_cigar_left(cur, position);
    if (shifts == 0 || cigar_total_len(nw) != total ||
        cigar_read_len(nw) != rlen || cigar_ref_len(nw) != reflen)
      return cur;
    cur = std::move(nw);
    --shifts;
  }
}

// positions_to_shift (realign.py:139-147): rotate-right compare walk.
int64_t positions_to_shift(const std::string& variant,
                           const std::string& preceding) {
  std::string v = variant, p = preceding;
  int64_t acc = 0;
  while (!p.empty() && !v.empty() && p.back() == v.back()) {
    // v = v[-1] + v[:-1]
    v.insert(v.begin(), v.back());
    v.pop_back();
    p.pop_back();
    ++acc;
  }
  return acc;
}

// left_align_indel (realign.py:150-183).  md may be null (absent).
// err out-param propagates get_reference failures.
Cigar left_align_indel(const std::string& seq, const Cigar& cigar,
                       const Md* md, int* err) {
  *err = 0;
  int indel_pos = -1;
  int64_t indel_len = 0;
  int64_t read_pos = 0, ref_pos = 0;
  bool is_insert = false;
  for (size_t i = 0; i < cigar.size(); ++i) {
    const auto& e = cigar[i];
    if (e.op == 'I') {
      if (indel_pos != -1) return cigar;
      indel_pos = (int)i;
      indel_len = e.len;
      is_insert = true;
    } else if (e.op == 'D') {
      if (indel_pos != -1) return cigar;
      indel_pos = (int)i;
      indel_len = e.len;
    } else if (indel_pos == -1) {
      char op = e.op;
      if (op == 'M' || op == 'I' || op == 'S' || op == '=' || op == 'X')
        read_pos += e.len;
      if (op == 'M' || op == 'D' || op == 'N' || op == '=' || op == 'X')
        ref_pos += e.len;
    }
  }
  if (indel_pos == -1) return cigar;
  std::string variant;
  if (is_insert) {
    variant = seq.substr(std::min((size_t)read_pos, seq.size()),
                         std::min((size_t)indel_len,
                                  seq.size() - std::min((size_t)read_pos,
                                                        seq.size())));
  } else {
    if (md == nullptr) return cigar;
    std::string ref;
    int rc = md_get_reference(*md, seq, cigar, ref);
    if (rc != 0) {
      *err = rc;
      return cigar;
    }
    variant = ref.substr(std::min((size_t)ref_pos, ref.size()),
                         std::min((size_t)indel_len,
                                  ref.size() - std::min((size_t)ref_pos,
                                                        ref.size())));
  }
  std::string preceding = seq.substr(0, std::min((size_t)read_pos, seq.size()));
  int64_t shift = positions_to_shift(variant, preceding);
  return shift_indel(cigar, indel_pos, shift);
}

// Consensus.generateAlternateConsensus (realign.py:623-641).
// Returns true when a consensus exists; fills (seq, index_start, index_end).
bool generate_alternate_consensus(const std::string& seq, int64_t start,
                                  const Cigar& cigar, std::string& cons,
                                  int64_t& idx_start, int64_t& idx_end) {
  int n_id = 0;
  for (const auto& e : cigar) n_id += (e.op == 'I' || e.op == 'D');
  if (n_id != 1) return false;
  int64_t read_pos = 0;
  int64_t ref_pos = start;
  for (const auto& e : cigar) {
    if (e.op == 'I') {
      cons = seq.substr(std::min((size_t)read_pos, seq.size()),
                        std::min((size_t)e.len,
                                 seq.size() - std::min((size_t)read_pos,
                                                       seq.size())));
      idx_start = ref_pos;
      idx_end = ref_pos + 1;
      return true;
    }
    if (e.op == 'D') {
      cons.clear();
      idx_start = ref_pos;
      idx_end = ref_pos + e.len + 1;
      return true;
    }
    if (e.op == 'M' || e.op == '=' || e.op == 'X') {
      read_pos += e.len;
      ref_pos += e.len;
    } else {
      return false;
    }
  }
  return false;
}

// ---- prep output ---------------------------------------------------------
struct PrepOut {
  // per group (G entries)
  std::vector<int32_t> t_status;  // 0 ok, 1 ref-gap skip, 2 no to_clean
  std::vector<std::string> t_ref;
  std::vector<int64_t> t_ref_start, t_ref_end;
  // per to_clean read, flattened in (group, to_clean order)
  std::vector<int32_t> r_group;
  std::vector<int64_t> r_row;
  std::vector<std::string> r_cigar;  // non-empty only when dirty
  std::vector<std::string> r_md;     // moved MD string when dirty+has md
  std::vector<uint8_t> r_md_set;     // r_md meaningful (may be "0")
  std::vector<uint8_t> r_dirty, r_pure;
  std::vector<int64_t> r_orig_qual;
  // per consensus candidate, flattened, deduped per group, order kept
  std::vector<int32_t> c_group;
  std::vector<std::string> c_seq;
  std::vector<int64_t> c_is, c_ie;
  int err = 0;        // 0 / 1 md-parse / 2 IndexError / 3 ValueError
  int64_t err_row = -1;
};

struct ReadState {
  int64_t row;
  std::string seq;
  Cigar cigar;
  Md md;
  bool has_md_eff;  // parsed md present (non-pure reads with MD)
  bool raw_has_md;  // the row has an MD string at all
  std::string ref;  // implied reference (empty+flag when absent)
  bool has_ref;
  bool pure;
  bool dirty;
  bool has_mm;  // any MD mismatch mapping inside an M/=/X op (in read)
  int64_t start;
  int64_t mm_qual;  // pure rows: MD-derived positional mismatch qual sum
};

// sumMismatchQualityIgnoreCigar (realign.py:526-536)
int64_t sum_mismatch_quality(const std::string& seq, const std::string& ref,
                             const uint8_t* quals, int64_t qlen) {
  int64_t n = std::min((int64_t)seq.size(), std::min((int64_t)ref.size(), qlen));
  int64_t acc = 0;
  for (int64_t i = 0; i < n; ++i)
    if (seq[i] != ref[i]) acc += quals[i];
  return acc;
}

}  // namespace

extern "C" {

// MD-tag mismatch reference offsets (relative to the alignment start),
// ascending.  Lenient: malformed MD yields however many offsets parsed
// before the error (the vectorized tokenizer's tolerance).  Returns the
// count written (capped at cap).  Shared with adamtok.cpp's BQSR
// observe walk so the host never materializes [N, L] mismatch masks.
int64_t md_mismatch_offsets(const uint8_t* s, int64_t n, int64_t* out,
                            int64_t cap) {
  // reusable parse scratch: this runs once per read inside the BQSR
  // observe hot loop, so the Md vectors must not reallocate per call
  thread_local Md md;
  md_parse(s, n, 0, md);  // partial results kept on malformed input
  int64_t k = 0;
  for (const auto& p : md.mm) {
    if (k >= cap) break;
    out[k++] = p.first;
  }
  return k;
}

// Phase-1 prep over candidate target groups.  See realign.py phase 1.
// Columns are the candidate batch's; groups are (grows flat rows, goff
// offsets).  gen_consensus=0 for the "knowns" model.
void* realign_prep(
    const uint8_t* bases, const uint8_t* quals, int64_t N, int64_t L,
    const int32_t* lengths, const int64_t* start,
    const uint8_t* cigar_ops, const int32_t* cigar_lens,
    const int32_t* cigar_n, int64_t C,
    const uint8_t* md_buf, const int64_t* md_off, const uint8_t* md_valid,
    const int64_t* grows, const int64_t* goff, int64_t G,
    int gen_consensus) {
  auto* out = new PrepOut();
  out->t_status.assign(G, 0);
  out->t_ref.resize(G);
  out->t_ref_start.assign(G, 0);
  out->t_ref_end.assign(G, 0);

  std::vector<ReadState> reads;
  // (ref string, start, end) for the pure-clean majority rows
  std::vector<std::pair<std::string, std::pair<int64_t, int64_t>>> extra;

  for (int64_t g = 0; g < G && out->err == 0; ++g) {
    reads.clear();
    extra.clear();
    bool any_to_clean = false;
    for (int64_t k = goff[g]; k < goff[g + 1]; ++k) {
      int64_t i = grows[k];
      int64_t len_i = lengths[i];
      int32_t nc = cigar_n[i];
      bool has_md_i = md_valid[i] != 0;
      bool pure = nc == 1 && cigar_ops[i * C] == CIG_M;

      // decode seq from codes
      std::string seq(len_i, 'N');
      for (int64_t p = 0; p < len_i; ++p)
        seq[p] = BASE_DECODE[std::min<uint8_t>(bases[i * L + p], 5)];

      Md md;
      bool md_parsed = false;
      if (has_md_i) {
        const uint8_t* ms = md_buf + md_off[i];
        int64_t mn = md_off[i + 1] - md_off[i];
        md_parsed = md_parse(ms, mn, start[i], md);
        if (!md_parsed && !pure) {
          // the Python path raises from MdTag.parse for non-pure rows;
          // pure rows go through the lenient vectorized tokenizer
          out->err = 1;
          out->err_row = i;
          break;
        }
      }

      Cigar cig(nc);
      for (int32_t k2 = 0; k2 < nc; ++k2)
        cig[k2] = {cigar_lens[i * C + k2],
                   CIGAR_CHARS[std::min<uint8_t>(cigar_ops[i * C + k2], 8)]};

      // row_has_mm + mm_qual: MD mismatches mapped through the cigar to
      // read positions inside M/=/X ops (ops/mdtag.py batch_md_arrays)
      bool has_mm = false;
      int64_t mm_qual = 0;
      std::string pure_ref;
      if (has_md_i && md_parsed && !md.mm.empty()) {
        int64_t read_pos = 0, ref_off = 0;
        size_t mi = 0;
        for (const auto& e : cig) {
          bool q = e.op == 'M' || e.op == 'I' || e.op == 'S' || e.op == '=' ||
                   e.op == 'X';
          bool r = e.op == 'M' || e.op == 'D' || e.op == 'N' || e.op == '=' ||
                   e.op == 'X';
          if (q && r) {
            while (mi < md.mm.size() &&
                   md.mm[mi].first - start[i] < ref_off + e.len) {
              int64_t ro = md.mm[mi].first - start[i];
              if (ro >= ref_off) {
                int64_t rp = read_pos + (ro - ref_off);
                if (rp >= 0 && rp < L) {
                  has_mm = true;
                  mm_qual += quals[i * L + rp];
                }
              }
              ++mi;
            }
          } else if (r) {
            while (mi < md.mm.size() &&
                   md.mm[mi].first - start[i] < ref_off + e.len)
              ++mi;  // mismatch recorded inside a non-query op: not in_m
          }
          if (q) read_pos += e.len;
          if (r) ref_off += e.len;
        }
      }

      if (pure && has_md_i) {
        // implied reference from codes: seq patched at mismatch read
        // positions with the *code-mapped* MD base (IUPAC -> N), exactly
        // as the vectorized ref_codes path produces it
        pure_ref = seq;
        for (const auto& p : md.mm) {
          int64_t rp = p.first - start[i];
          if (rp >= 0 && rp < len_i)
            pure_ref[rp] = BASE_DECODE[base_encode(p.second)];
        }
        if (!has_mm) {
          // pure clean majority: reference contribution only
          extra.push_back({std::move(pure_ref),
                           {start[i], start[i] + len_i}});
          continue;
        }
      }

      ReadState rs;
      rs.row = i;
      rs.seq = std::move(seq);
      rs.cigar = std::move(cig);
      rs.raw_has_md = has_md_i;
      rs.has_md_eff = has_md_i && !pure;  // pure rows skip MdTag.parse
      if (rs.has_md_eff) rs.md = std::move(md);
      rs.pure = pure;
      rs.dirty = false;
      rs.has_mm = has_mm;
      rs.start = start[i];
      rs.mm_qual = mm_qual;
      rs.has_ref = false;
      if (!has_md_i) {
        // ref stays absent
      } else if (pure) {
        rs.ref = std::move(pure_ref);
        rs.has_ref = true;
      } else {
        int rc = md_get_reference(rs.md, rs.seq, rs.cigar, rs.ref);
        if (rc != 0) {
          out->err = rc;
          out->err_row = i;
          break;
        }
        rs.has_ref = true;
      }
      if (!has_md_i || has_mm) any_to_clean = true;
      reads.push_back(std::move(rs));
    }
    if (out->err != 0) break;
    if (!any_to_clean) {
      out->t_status[g] = 2;
      continue;
    }

    // _get_reference_from_reads (realign.py:572-599): refs = extra_refs
    // then reads (row order), stable-sorted by start
    {
      std::vector<std::pair<int64_t, const std::string*>> refs;
      std::vector<int64_t> ref_ends;
      std::vector<std::pair<std::pair<int64_t, int64_t>, const std::string*>>
          spans;
      for (const auto& ex : extra)
        spans.push_back({{ex.second.first, ex.second.second}, &ex.first});
      for (const auto& r : reads)
        if (r.has_ref)
          spans.push_back(
              {{r.start, r.start + cigar_ref_len(r.cigar)}, &r.ref});
      if (spans.empty()) {
        out->t_status[g] = 1;  // "no reads with MD tags" ValueError -> skip
        continue;
      }
      std::stable_sort(spans.begin(), spans.end(),
                       [](const auto& a, const auto& b) {
                         return a.first.first < b.first.first;
                       });
      std::string ref;
      int64_t cur = spans[0].first.first;
      int64_t ref_start = cur;
      bool gap = false;
      for (const auto& sp : spans) {
        int64_t s0 = sp.first.first, e0 = sp.first.second;
        if (e0 < cur) continue;
        if (cur >= s0) {
          ref.append(*sp.second, cur - s0, std::string::npos);
          cur = e0;
        } else {
          gap = true;
          break;
        }
      }
      if (gap) {
        out->t_status[g] = 1;
        continue;
      }
      out->t_ref[g] = std::move(ref);
      out->t_ref_start[g] = ref_start;
      out->t_ref_end[g] = cur;
    }

    // preprocess + emit to_clean reads (left-normalize 2-M-block reads)
    size_t cons_seen_base = out->c_seq.size();
    {
      bool emitted_any = false;
      for (size_t ri = 0; ri < reads.size(); ++ri) {
        auto& r = reads[ri];
        // to_clean membership (realign.py:844-846): no MD, or any MD
        // mismatch mapping inside an M op
        if (r.raw_has_md && !r.has_mm) continue;  // clean: skip
        // left-normalize single-indel (2 M-block) reads
        if (cigar_num_m_blocks(r.cigar) == 2) {
          int lerr = 0;
          Cigar nw = left_align_indel(r.seq, r.cigar,
                                      r.has_md_eff ? &r.md : nullptr, &lerr);
          if (lerr != 0) {
            out->err = lerr;
            out->err_row = r.row;
            break;
          }
          if (!(nw == r.cigar)) {
            if (r.has_md_eff) {
              Md moved;
              int rc = md_move_alignment(r.ref.data(), r.ref.size(), r.seq,
                                         nw, r.start, moved);
              if (rc != 0) {
                out->err = rc;
                out->err_row = r.row;
                break;
              }
              r.md = std::move(moved);
            }
            r.cigar = std::move(nw);
            r.dirty = true;
          }
        }
        // orig_qual (realign.py:957-966 _orig_qual)
        int64_t oq;
        const uint8_t* q = quals + r.row * L;
        if (r.dirty && r.has_md_eff) {
          std::string ref2;
          int rc = md_get_reference(r.md, r.seq, r.cigar, ref2);
          if (rc != 0) {
            out->err = rc;
            out->err_row = r.row;
            break;
          }
          oq = sum_mismatch_quality(r.seq, ref2, q, lengths[r.row]);
        } else if (r.pure) {
          oq = r.mm_qual;
        } else {
          oq = sum_mismatch_quality(r.seq, r.has_ref ? r.ref : std::string(),
                                    q, lengths[r.row]);
        }

        out->r_group.push_back((int32_t)g);
        out->r_row.push_back(r.row);
        out->r_cigar.push_back(r.dirty ? cigar_to_string(r.cigar)
                                       : std::string());
        if (r.dirty && r.has_md_eff) {
          out->r_md.push_back(md_to_string(r.md));
          out->r_md_set.push_back(1);
        } else {
          out->r_md.push_back(std::string());
          out->r_md_set.push_back(0);
        }
        out->r_dirty.push_back(r.dirty ? 1 : 0);
        out->r_pure.push_back(r.pure ? 1 : 0);
        out->r_orig_qual.push_back(oq);
        emitted_any = true;

        // consensus generation (reads model), post-preprocess cigar
        if (gen_consensus && r.has_md_eff) {
          std::string cons;
          int64_t cis, cie;
          if (generate_alternate_consensus(r.seq, r.start, r.cigar, cons,
                                           cis, cie)) {
            bool dup = false;
            for (size_t ci = cons_seen_base; ci < out->c_seq.size(); ++ci)
              if (out->c_is[ci] == cis && out->c_ie[ci] == cie &&
                  out->c_seq[ci] == cons) {
                dup = true;
                break;
              }
            if (!dup) {
              out->c_group.push_back((int32_t)g);
              out->c_seq.push_back(std::move(cons));
              out->c_is.push_back(cis);
              out->c_ie.push_back(cie);
            }
          }
        }
      }
      if (out->err != 0) break;
      if (!emitted_any) out->t_status[g] = 2;
    }
  }
  return out;
}

void realign_prep_dims(void* vh, int64_t* n_reads, int64_t* cigar_bytes,
                       int64_t* md_bytes, int64_t* n_cons, int64_t* cons_bytes,
                       int64_t* ref_bytes, int64_t* err, int64_t* err_row) {
  auto* h = static_cast<PrepOut*>(vh);
  *n_reads = (int64_t)h->r_row.size();
  int64_t cb = 0, mb = 0, sb = 0, rb = 0;
  for (const auto& s : h->r_cigar) cb += s.size();
  for (const auto& s : h->r_md) mb += s.size();
  for (const auto& s : h->c_seq) sb += s.size();
  for (const auto& s : h->t_ref) rb += s.size();
  *cigar_bytes = cb;
  *md_bytes = mb;
  *n_cons = (int64_t)h->c_seq.size();
  *cons_bytes = sb;
  *ref_bytes = rb;
  *err = h->err;
  *err_row = h->err_row;
}

void realign_prep_fill(
    void* vh,
    // per group
    int32_t* t_status, uint8_t* t_ref_buf, int64_t* t_ref_off,
    int64_t* t_ref_start, int64_t* t_ref_end,
    // per read
    int32_t* r_group, int64_t* r_row, uint8_t* r_cigar_buf,
    int64_t* r_cigar_off, uint8_t* r_md_buf, int64_t* r_md_off,
    uint8_t* r_md_set, uint8_t* r_dirty, uint8_t* r_pure,
    int64_t* r_orig_qual,
    // per consensus
    int32_t* c_group, uint8_t* c_seq_buf, int64_t* c_seq_off, int64_t* c_is,
    int64_t* c_ie) {
  auto* h = static_cast<PrepOut*>(vh);
  const int64_t G = (int64_t)h->t_status.size();
  int64_t off = 0;
  for (int64_t g = 0; g < G; ++g) {
    t_status[g] = h->t_status[g];
    t_ref_off[g] = off;
    memcpy(t_ref_buf + off, h->t_ref[g].data(), h->t_ref[g].size());
    off += h->t_ref[g].size();
    t_ref_start[g] = h->t_ref_start[g];
    t_ref_end[g] = h->t_ref_end[g];
  }
  t_ref_off[G] = off;
  const int64_t R = (int64_t)h->r_row.size();
  int64_t coff = 0, moff = 0;
  for (int64_t i = 0; i < R; ++i) {
    r_group[i] = h->r_group[i];
    r_row[i] = h->r_row[i];
    r_cigar_off[i] = coff;
    memcpy(r_cigar_buf + coff, h->r_cigar[i].data(), h->r_cigar[i].size());
    coff += h->r_cigar[i].size();
    r_md_off[i] = moff;
    memcpy(r_md_buf + moff, h->r_md[i].data(), h->r_md[i].size());
    moff += h->r_md[i].size();
    r_md_set[i] = h->r_md_set[i];
    r_dirty[i] = h->r_dirty[i];
    r_pure[i] = h->r_pure[i];
    r_orig_qual[i] = h->r_orig_qual[i];
  }
  r_cigar_off[R] = coff;
  r_md_off[R] = moff;
  const int64_t CN = (int64_t)h->c_seq.size();
  int64_t soff = 0;
  for (int64_t i = 0; i < CN; ++i) {
    c_group[i] = h->c_group[i];
    c_seq_off[i] = soff;
    memcpy(c_seq_buf + soff, h->c_seq[i].data(), h->c_seq[i].size());
    soff += h->c_seq[i].size();
    c_is[i] = h->c_is[i];
    c_ie[i] = h->c_ie[i];
  }
  c_seq_off[CN] = soff;
}

void realign_prep_free(void* vh) { delete static_cast<PrepOut*>(vh); }

// Batched MdTag.move_alignment + to_string for the rewrite phase
// (realign.py:1032-1037).  Each record k realigns read rows[k] against
// ref[tloc[k]] shifted by offs[k], with a 1- or 3-element cigar
// (head M / mid I|D / end M; mid_op==0 -> single M of head_len).
// Returns bytes written, or -(needed) when out_cap is too small;
// *err/*err_row report the first failing record (err codes as above).
int64_t md_move_batch(
    const uint8_t* bases, int64_t N, int64_t L, const int32_t* lengths,
    const int64_t* rows, int64_t K,
    const uint8_t* ref_buf, const int64_t* ref_off,
    const int32_t* tloc, const int64_t* offs,
    const int32_t* head_len, const int32_t* mid_len, const uint8_t* mid_op,
    const int32_t* end_len, const int64_t* new_start,
    uint8_t* out_buf, int64_t out_cap, int64_t* out_off,
    int64_t* err, int64_t* err_row) {
  *err = 0;
  *err_row = -1;
  std::vector<std::string> results(K);
  int64_t total = 0;
  for (int64_t k = 0; k < K; ++k) {
    int64_t row = rows[k];
    int64_t len_i = lengths[row];
    std::string seq(len_i, 'N');
    for (int64_t p = 0; p < len_i; ++p)
      seq[p] = BASE_DECODE[std::min<uint8_t>(bases[row * L + p], 5)];
    Cigar cig;
    if (mid_op[k] == 0) {
      cig.push_back({head_len[k], 'M'});
    } else {
      cig.push_back({head_len[k], 'M'});
      cig.push_back({mid_len[k], (char)mid_op[k]});
      cig.push_back({end_len[k], 'M'});
    }
    const uint8_t* rb = ref_buf + ref_off[tloc[k]] + offs[k];
    int64_t rlen = ref_off[tloc[k] + 1] - ref_off[tloc[k]] - offs[k];
    Md moved;
    int rc = md_move_alignment((const char*)rb, rlen, seq, cig, new_start[k],
                               moved);
    if (rc != 0) {
      *err = rc;
      *err_row = row;
      return 0;
    }
    results[k] = md_to_string(moved);
    total += results[k].size();
  }
  if (total > out_cap) return -total;
  int64_t off = 0;
  for (int64_t k = 0; k < K; ++k) {
    out_off[k] = off;
    memcpy(out_buf + off, results[k].data(), results[k].size());
    off += results[k].size();
  }
  out_off[K] = off;
  return total;
}

}  // extern "C"
