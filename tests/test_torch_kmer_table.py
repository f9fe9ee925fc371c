"""The native k-mer table builder (``native.kmer_table``) against the numpy
decode ``dict(zip(_unpack_kmers(keys, k), values.tolist()))``: the same
items in the same order with the same value types, for k of 1, 2, 11 and
21 (N bases and the all-N k-mer among the keys), tables of 0, 1 and up to
100,000 entries, int64 counts past 2**31 and float64 values; and the
binding's checks of its arrays and of k; and which build of the
prefetch the library holds."""

import sys

import numpy as np
import pytest


def _sorted_keys(k: int, m: int, seed: int) -> np.ndarray:
    """``m`` distinct sorted packed k-mers (fewer where 5**k is smaller),
    the all-N k-mer always among them."""
    all_n = 0
    for _ in range(k):
        all_n = (all_n << 3) | 4
    if m == 0:
        return np.zeros(0, np.int64)
    rng = np.random.default_rng(seed)
    m = min(m, 5**k)
    keys = np.array([all_n], np.int64)
    while len(keys) < m:
        codes = rng.integers(0, 5, (m, k))
        packed = np.zeros(m, np.int64)
        for j in range(k):
            packed = (packed << 3) | codes[:, j]
        keys = np.unique(np.concatenate([keys, packed]))
    if len(keys) > m:  # keep the all-N k-mer, drop others at random
        rest = keys[keys != all_n]
        keys = np.sort(np.append(rng.choice(rest, m - 1, replace=False), all_n))
    return keys


def _values(kind: str, m: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 1)
    if kind == "int64":  # small counts (CPython's cached ints) and past 2**31
        v = rng.integers(1, 5, m).astype(np.int64)
        v[::3] = rng.integers(2**31, 2**40, len(v[::3]))
        return v
    return rng.random(m) * 10.0 ** rng.integers(-3, 4, m)


@pytest.mark.parametrize("kind", ["int64", "float64"])
@pytest.mark.parametrize("m", [0, 1, 100_000])
@pytest.mark.parametrize("k", [1, 2, 11, 21])
def test_table_equals_the_numpy_decode(k, m, kind):
    from adam_tpu_torch import native
    from adam_tpu_torch.ops.kmer import _unpack_kmers

    keys = _sorted_keys(k, m, seed=k * 7 + m)
    values = _values(kind, len(keys), seed=k + m)
    got = native.kmer_table(keys, values, k)
    want = dict(zip(_unpack_kmers(keys, k), values.tolist()))
    assert type(got) is dict
    assert list(got.items()) == list(want.items())  # same keys, order and values
    assert all(type(s) is str and len(s) == k for s in got)
    assert all(type(v) is (int if kind == "int64" else float) for v in got.values())
    if m:
        assert "N" * k in got
        assert sys.getrefcount(got) == 2  # the name and the call's argument
    if kind == "int64" and m > 1:
        assert max(got.values()) > 2**31


_KEYS = np.array([1, 2, 3], np.int64)
_BAD = {
    "non-contiguous keys": (np.arange(6, dtype=np.int64)[::2], _KEYS, 3),
    "non-contiguous values": (_KEYS, np.arange(6, dtype=np.int64)[::2], 3),
    "int32 keys": (_KEYS.astype(np.int32), _KEYS, 3),
    "int32 values": (_KEYS, _KEYS.astype(np.int32), 3),
    "float32 values": (_KEYS, _KEYS.astype(np.float32), 3),
    "2-D keys": (_KEYS.reshape(1, 3), _KEYS, 3),
    "a list": (_KEYS.tolist(), _KEYS, 3),
    "unequal lengths": (_KEYS, _KEYS[:2], 3),
    "k = 0": (_KEYS, _KEYS, 0),
    "k = 22": (_KEYS, _KEYS, 22),
    "a base code above N": (np.array([1, 5], np.int64), np.array([1, 1], np.int64), 2),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_bad_input_raises_value_error(case):
    from adam_tpu_torch import native

    keys, values, k = _BAD[case]
    with pytest.raises(ValueError, match="kmer_table"):
        native.kmer_table(keys, values, k)


def test_the_build_aims_the_prefetch_on_cpython_3_12():
    """The index-slot prefetch reads CPython 3.12's private dict layout and
    is compiled out elsewhere: the library says which build it is, so an
    interpreter or toolchain that loses it fails here, not only runs slower."""
    import ctypes as ct

    from adam_tpu_torch import native

    built = ct.c_int.in_dll(native._kmertab_lib(), "kmertab_prefetch").value
    assert built == int(sys.version_info[:2] == (3, 12))
