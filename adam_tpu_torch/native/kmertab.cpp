// The k-mer table's {k-mer: count} dict, built in one pass over the sorted
// keys fetched from the device histogram (the port's own source, not a copy
// of the JAX package's).
//
// Each key packs k bases at 3 bits a base (A C G T N = 0..4), the most
// significant base first.  For every key the pass writes the k ASCII bytes
// straight into a new compact str, makes the value's int (int64 values) or
// float (float64 values) and inserts the pair into the dict, so the dict
// holds the keys in the order given.  It runs under the GIL (the library is
// loaded with ctypes.PyDLL) and returns a new reference, or NULL with the
// Python exception set.
//
// The inserts are random probes into an index table of hundreds of MB, and
// a cache miss each is most of the time.  So each str is made and hashed
// kAhead keys before its insert, and its first probe slot prefetched then.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int64_t kAhead = 16;

// The empty table.  CPython 3.12 caps _PyDict_NewPresized at 2**17 slots,
// so the table still doubles its way up to m entries; what the call buys
// is the general key layout, whose entries hold each key's hash, so a
// resize or a collision reads the hash there and not from the key's str.
// That layout is what makes it faster than PyDict_New's str-only layout.
PyObject* new_table(int64_t m) {
#if PY_VERSION_HEX < 0x030D0000
  return _PyDict_NewPresized(static_cast<Py_ssize_t>(m));
#else
  (void)m;
  return PyDict_New();
#endif
}

#if PY_VERSION_HEX >= 0x030C0000 && PY_VERSION_HEX < 0x030D0000 && \
    !defined(Py_GIL_DISABLED)
// The head of CPython 3.12's PyDictKeysObject, whose layout is private
// (Objects/dictobject.c); the index table follows it.  It is read only to
// aim a prefetch, which never faults: a wrong guess costs time, not a result.
struct KeysHead {
  Py_ssize_t refcnt;
  uint8_t log2_size;
  uint8_t log2_index_bytes;
  uint8_t kind;
  uint32_t version;
  Py_ssize_t usable;
  Py_ssize_t nentries;
};

// Prefetch the index slot where `hash` first probes `table`.
inline void prefetch_slot(PyObject* table, Py_hash_t hash) {
  const char* keys =
      reinterpret_cast<const char*>(reinterpret_cast<PyDictObject*>(table)->ma_keys);
  const unsigned log2 = reinterpret_cast<const KeysHead*>(keys)->log2_size & 63u;
  const size_t width = log2 < 8 ? 1 : log2 < 16 ? 2 : log2 < 32 ? 4 : 8;
  const size_t slot = static_cast<size_t>(hash) & ((size_t(1) << log2) - 1);
  __builtin_prefetch(keys + sizeof(KeysHead) + slot * width);
}
constexpr int kPrefetch = 1;
#else
inline void prefetch_slot(PyObject*, Py_hash_t) {}
constexpr int kPrefetch = 0;
#endif

// The k-mer's str, or NULL with the exception set.
PyObject* kmer_str(int64_t packed_key, int k) {
  static const char kChars[8] = {'A', 'C', 'G', 'T', 'N', 0, 0, 0};
  const uint64_t packed = static_cast<uint64_t>(packed_key);
  unsigned bad = 0;
  for (int j = 0; j < k; ++j) bad |= ((packed >> (3 * j)) & 7u) > 4;
  if (bad) {
    PyErr_Format(PyExc_ValueError, "kmer_table: key %lld holds a base code above 4 (N)",
                 static_cast<long long>(packed_key));
    return nullptr;
  }
  PyObject* s = PyUnicode_New(k, 127);
  if (s == nullptr) return nullptr;
  Py_UCS1* out = PyUnicode_1BYTE_DATA(s);
  for (int j = 0; j < k; ++j)
    out[j] = static_cast<Py_UCS1>(kChars[(packed >> (3 * (k - 1 - j))) & 7u]);
  return s;
}

}  // namespace

extern "C" {

// 1 where the build aims the prefetch (CPython 3.12's dict layout), else 0.
extern const int kmertab_prefetch;
const int kmertab_prefetch = kPrefetch;

// keys: i64[m], sorted; values: i64[m] (is_float == 0) or f64[m]; 1 <= k <= 21.
PyObject* kmer_table(const int64_t* keys, const void* values, int64_t m, int k,
                     int is_float) {
  PyObject* table = new_table(m);
  if (table == nullptr) return nullptr;
  const int64_t* ivals = static_cast<const int64_t*>(values);
  const double* fvals = static_cast<const double*>(values);
  PyObject* ahead[kAhead] = {};  // key i waits in ahead[i % kAhead] for its insert
  bool failed = false;
  for (int64_t i = 0; i < m + kAhead && !failed; ++i) {
    if (i >= kAhead) {
      const int64_t j = i - kAhead;
      PyObject* key = ahead[j % kAhead];
      ahead[j % kAhead] = nullptr;
      PyObject* value = is_float ? PyFloat_FromDouble(fvals[j]) : PyLong_FromLongLong(ivals[j]);
      failed = value == nullptr || PyDict_SetItem(table, key, value) < 0;
      Py_DECREF(key);
      Py_XDECREF(value);
    }
    if (i < m && !failed) {
      PyObject* key = kmer_str(keys[i], k);
      const Py_hash_t hash = key == nullptr ? -1 : PyObject_Hash(key);
      if (hash == -1) {
        Py_XDECREF(key);
        failed = true;
      } else {
        prefetch_slot(table, hash);
        ahead[i % kAhead] = key;
      }
    }
  }
  if (failed) {
    for (PyObject* key : ahead) Py_XDECREF(key);
    Py_DECREF(table);
    return nullptr;
  }
  return table;
}

}  // extern "C"
