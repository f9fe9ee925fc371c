"""Fixed-depth DNA "prefix trie" over packed k-mer keys.

Copied from ``adam_tpu/ops/prefix_trie.py`` (host numpy, as there).

API parity with ``algorithms/prefixtrie/DNAPrefixTrie.scala:22-210``:
uniform-length ACGT keys mapping to values, with ``contains/get/
get_or_else/get_if_exists``, wildcard ``search`` ('N'/'*' match any
base), ``prefix_search`` and ``suffix_search``; keys containing
ambiguous bases are dropped at build, mixed key lengths and empty input
are errors.

Array-hardware recast: instead of a 4-ary pointer trie, keys live as a
**sorted 2-bit-packed integer array** plus a parallel value list —
lookups are binary searches, a prefix is a contiguous key range
(searchsorted pair), and wildcard/suffix queries are vectorized
mask-compare sweeps. Same asymptotics as trie walks for DNA alphabets,
but the whole structure is two flat arrays that can ship to device or
broadcast across a mesh.
"""

from __future__ import annotations

import numpy as np

_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
_BASE = "ACGT"


def _pack(key: str) -> int | None:
    """2 bits per base, first base most significant. None if ambiguous."""
    v = 0
    for ch in key:
        code = _CODE.get(ch)
        if code is None:
            if ch in ("N", "*"):
                return None
            raise ValueError(f"illegal character {ch!r} in key {key!r}")
        v = (v << 2) | code
    return v


class DNAPrefixTrie:
    def __init__(self, init: dict):
        # AssertionError, as the JAX package raises, but not an assert:
        # the check must survive ``python -O``
        if not init:
            raise AssertionError("Cannot build empty prefix trie.")
        lengths = {len(k) for k in init}
        if len(lengths) != 1:
            raise AssertionError("all keys must have equal length")
        self.depth = lengths.pop()
        if self.depth > 31:
            # 2 bits/base in a signed 64-bit key; 31 bases = 62 bits
            raise ValueError(
                f"key length {self.depth} exceeds the 31-base packed-key "
                f"limit"
            )
        keys, values = [], []
        for k, v in init.items():
            packed = _pack(k)  # raises on illegal chars
            if packed is None:
                continue  # ambiguous bases are silently dropped
            keys.append(packed)
            values.append(v)
        order = np.argsort(np.asarray(keys, np.int64), kind="stable")
        self._keys = np.asarray(keys, np.int64)[order] if keys else np.zeros(0, np.int64)
        self._values = [values[i] for i in order]

    # ------------------------------------------------------------ basics
    @property
    def size(self) -> int:
        return len(self._keys)

    def __len__(self) -> int:
        return self.size

    def _index_of(self, key: str) -> int:
        if len(key) != self.depth:
            return -1
        packed = _pack(key)
        if packed is None:
            return -1
        i = int(np.searchsorted(self._keys, packed))
        if i < len(self._keys) and self._keys[i] == packed:
            return i
        return -1

    def contains(self, key: str) -> bool:
        if any(c in ("N", "*") for c in key):
            return len(self.search(key)) > 0
        return self._index_of(key) >= 0

    def get(self, key: str):
        i = self._index_of(key)
        if i < 0:
            raise KeyError(key)
        return self._values[i]

    def get_or_else(self, key: str, default):
        i = self._index_of(key)
        return self._values[i] if i >= 0 else default

    def get_if_exists(self, key: str):
        i = self._index_of(key)
        return self._values[i] if i >= 0 else None

    def _unpack(self, packed: int) -> str:
        return "".join(
            _BASE[(packed >> (2 * (self.depth - 1 - i))) & 0x3]
            for i in range(self.depth)
        )

    # ----------------------------------------------------------- queries
    def search(self, key: str) -> dict:
        """Wildcard query: 'N'/'*' positions match any base
        (DNAPrefixTrie.search)."""
        if len(key) != self.depth:
            return {}
        mask = 0
        want = 0
        for ch in key:
            mask <<= 2
            want <<= 2
            if ch in ("N", "*"):
                continue
            code = _CODE.get(ch)
            if code is None:
                raise ValueError(f"illegal character {ch!r} in key {key!r}")
            mask |= 0x3
            want |= code
        hits = np.flatnonzero((self._keys & mask) == want)
        return {self._unpack(int(self._keys[i])): self._values[i] for i in hits}

    def find(self, key: str) -> dict:
        return self.search(key)

    def prefix_search(self, prefix: str) -> dict:
        """All keys beginning with ``prefix`` — one contiguous packed-key
        range (DNAPrefixTrie.prefixSearch)."""
        if len(prefix) > self.depth:
            return {}
        packed = _pack(prefix)
        if packed is None:
            # wildcards inside the prefix: pad with wildcards and search
            return self.search(prefix + "*" * (self.depth - len(prefix)))
        rest = self.depth - len(prefix)
        lo = packed << (2 * rest)
        hi = (packed + 1) << (2 * rest)
        i0 = int(np.searchsorted(self._keys, lo, "left"))
        i1 = int(np.searchsorted(self._keys, hi, "left"))
        return {
            self._unpack(int(self._keys[i])): self._values[i]
            for i in range(i0, i1)
        }

    def suffix_search(self, suffix: str) -> dict:
        """All keys ending with ``suffix`` — masked compare on the low
        bits (DNAPrefixTrie.suffixSearch)."""
        if len(suffix) > self.depth:
            return {}
        packed = _pack(suffix)
        if packed is None:
            return self.search("*" * (self.depth - len(suffix)) + suffix)
        mask = (1 << (2 * len(suffix))) - 1
        hits = np.flatnonzero((self._keys & mask) == packed)
        return {self._unpack(int(self._keys[i])): self._values[i] for i in hits}
