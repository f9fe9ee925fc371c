"""Columnar string storage for host-side sidecar fields (the subset of
``adam_tpu/formats/strings.py`` the port uses).

The reference carries read names / attribute strings / MD tags as fields
on per-read Avro objects.  Keeping a Python ``str`` per read makes every
whole-dataset operation O(N) interpreter work, so the sidecar's native
representation here is **one flat byte buffer + offsets** (the Arrow
string layout): list-like for compatibility (``col[i]`` -> str/None),
but convertible for free to numpy views and pyarrow arrays for
vectorized consumers.

``None``-ability (the reference's null fields, e.g. absent MD tags) is a
validity bitmask, as in Arrow.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Union

import numpy as np

StringLike = Union["StringColumn", Sequence[Optional[str]]]


class StringColumn:
    """Immutable column of optional strings as (buffer, offsets, validity)."""

    __slots__ = ("buf", "offsets", "valid")

    def __init__(self, buf: np.ndarray, offsets: np.ndarray,
                 valid: Optional[np.ndarray] = None):
        self.buf = np.asarray(buf, dtype=np.uint8)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        n = len(self.offsets) - 1
        self.valid = (
            np.ones(n, dtype=bool) if valid is None else np.asarray(valid, bool)
        )

    # ------------------------------------------------------------ builders
    @staticmethod
    def from_list(items: Iterable[Optional[str]]) -> "StringColumn":
        items = list(items)
        valid = np.array([s is not None for s in items], dtype=bool)
        bufs = [s.encode() if isinstance(s, str) else b"" for s in items]
        offsets = np.zeros(len(items) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in bufs], out=offsets[1:])
        buf = (
            np.frombuffer(b"".join(bufs), dtype=np.uint8)
            if offsets[-1]
            else np.zeros(0, np.uint8)
        )
        return StringColumn(buf, offsets, valid)

    @staticmethod
    def of(value: StringLike) -> "StringColumn":
        if isinstance(value, StringColumn):
            return value
        return StringColumn.from_list(value)

    @staticmethod
    def full(n: int, value: Optional[str] = None) -> "StringColumn":
        if value is None:
            return StringColumn(
                np.zeros(0, np.uint8), np.zeros(n + 1, np.int64),
                np.zeros(n, bool),
            )
        b = value.encode()
        offsets = np.arange(n + 1, dtype=np.int64) * len(b)
        return StringColumn(np.frombuffer(b * n, np.uint8).copy(), offsets)

    # ---------------------------------------------------------- list compat
    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            return self.take(np.arange(len(self))[i])
        i = int(i)
        if i < 0:
            i += len(self)
        if not self.valid[i]:
            return None
        return (
            self.buf[self.offsets[i]:self.offsets[i + 1]]
            .tobytes()
            .decode("utf-8", "replace")
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __eq__(self, other):
        if isinstance(other, (StringColumn, list, tuple)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other)
            )
        return NotImplemented

    def __repr__(self):
        head = ", ".join(repr(self[i]) for i in range(min(3, len(self))))
        return f"StringColumn([{head}{'...' if len(self) > 3 else ''}], n={len(self)})"

    def to_list(self) -> list:
        return list(self)

    # ------------------------------------------------------------- kernels
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def take(self, idx) -> "StringColumn":
        idx = np.asarray(idx, dtype=np.int64)
        lens = np.diff(self.offsets)[idx]
        new_off = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lens, out=new_off[1:])
        total = int(new_off[-1])
        if len(idx):
            starts = self.offsets[idx]
            from adam_tpu_torch import native

            out = native.span_gather(self.buf, starts, lens, total)
            if out is None:
                # fallback: flat index build (vectorized, no per-row Python)
                out = np.empty(total, dtype=np.uint8)
                out[:] = self.buf[_span_gather_indices(starts, lens)]
        else:
            out = np.empty(0, dtype=np.uint8)
        return StringColumn(out, new_off, self.valid[idx])

    @staticmethod
    def concat(cols: Sequence["StringColumn"]) -> "StringColumn":
        cols = [StringColumn.of(c) for c in cols]
        if not cols:
            return StringColumn.full(0)
        n = sum(len(c) for c in cols)
        offsets = np.zeros(n + 1, dtype=np.int64)
        lens = np.concatenate([c.lengths() for c in cols])
        np.cumsum(lens, out=offsets[1:])
        return StringColumn(
            np.concatenate([c.buf for c in cols]),
            offsets,
            np.concatenate([c.valid for c in cols]),
        )

    def to_fixed_bytes(self) -> np.ndarray:
        """-> S{maxlen} numpy array (for np.unique-style exact grouping)."""
        n = len(self)
        lens = self.lengths()
        w = max(1, int(lens.max()) if n else 1)
        if n and self.offsets[-1]:
            from adam_tpu_torch import native

            mat = native.span_gather_strided(
                self.buf, self.offsets[:-1], lens, w
            )
            if mat is not None:
                return mat.view(f"S{w}").ravel()
        mat = np.zeros((n, w), dtype=np.uint8)
        if n and self.offsets[-1]:
            flat = _span_gather_indices(self.offsets[:-1], lens)
            rows = np.repeat(np.arange(n), lens)
            pos = _span_local_positions(lens)
            mat[rows, pos] = self.buf[flat]
        return mat.view(f"S{w}").ravel()

    @staticmethod
    def where(cond: np.ndarray, a: "StringColumn",
              b: "StringColumn") -> "StringColumn":
        """Per-row select: rows with cond True from ``a``, else ``b``."""
        cond = np.asarray(cond, bool)
        la, lb = a.lengths(), b.lengths()
        lens = np.where(cond, la, lb)
        valid = np.where(cond, a.valid, b.valid)
        n = len(cond)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        out = np.empty(int(offsets[-1]), dtype=np.uint8)
        for col, rows in ((a, np.flatnonzero(cond)),
                          (b, np.flatnonzero(~cond))):
            if len(rows) == 0:
                continue
            rl = col.lengths()[rows]
            src = _span_gather_indices(col.offsets[rows], rl)
            dst = _span_gather_indices(offsets[rows], rl)
            out[dst] = col.buf[src]
        return StringColumn(out, offsets, valid)

    def to_arrow(self):
        """Zero-copy conversion to a pyarrow string array (py_buffer
        wraps the numpy memory and holds a reference — no tobytes copy,
        which cost a full buffer duplication per fat column)."""
        import pyarrow as pa

        n = len(self)
        if self.valid.all():
            validity = None
        else:
            validity = pa.array(self.valid).buffers()[1]
        return pa.Array.from_buffers(
            pa.large_string(),
            n,
            [
                validity,
                pa.py_buffer(np.ascontiguousarray(self.offsets)),
                pa.py_buffer(np.ascontiguousarray(self.buf)),
            ],
        )

    @staticmethod
    def from_arrow(arr) -> "StringColumn":
        """pyarrow string/large_string array (or chunked array) ->
        StringColumn."""
        import pyarrow as pa
        import pyarrow.compute as pc

        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        valid = np.asarray(pc.is_valid(arr))
        arr = pc.cast(arr, pa.large_string())
        if arr.offset != 0:
            arr = pa.concat_arrays([arr])  # re-materialize at offset 0
        buffers = arr.buffers()
        offsets = np.frombuffer(buffers[1], dtype=np.int64,
                                count=len(arr) + 1).copy()
        data = (
            np.frombuffer(buffers[2], dtype=np.uint8).copy()
            if buffers[2] is not None
            else np.zeros(0, np.uint8)
        )
        base = offsets[0]
        return StringColumn(data[base:offsets[-1]], offsets - base, valid)


def with_overrides(col: "StringColumn", overrides: dict) -> "StringColumn":
    """Replace a sparse set of rows ({row: str|None}) in one vectorized
    pass — the whole column is never materialized as python strings."""
    if not overrides:
        return col
    n = len(col)
    idx = np.fromiter(sorted(overrides), np.int64, len(overrides))
    vals = [overrides[int(i)] for i in idx]
    enc = [v.encode("utf-8") if v is not None else b"" for v in vals]
    lens = np.zeros(n, np.int64)
    lens[idx] = [len(e) for e in enc]
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    buf = np.frombuffer(b"".join(enc), np.uint8)
    valid = col.valid.copy()
    valid[idx] = [v is not None for v in vals]
    repl = StringColumn(buf, offsets, valid)
    mask = np.zeros(n, bool)
    mask[idx] = True
    return StringColumn.where(mask, repl, col)


def _span_gather_indices(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat source indices covering [starts[i], starts[i]+lens[i]) per row."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    nz = lens > 0
    u = np.unique(lens[nz])
    if len(u) == 1:
        # uniform span width (the common case for fixed-length reads):
        # one broadcasted add instead of repeat+cumsum index machinery
        w = int(u[0])
        return (
            starts[nz][:, None] + np.arange(w, dtype=np.int64)[None, :]
        ).ravel()
    # index = repeat(starts) + (arange within each span)
    out = np.repeat(starts, lens)
    out += _span_local_positions(lens)
    return out


def _span_local_positions(lens: np.ndarray) -> np.ndarray:
    """0,1,..,lens[0]-1, 0,1,..,lens[1]-1, ... as one flat array."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    flat_starts = np.concatenate([[0], np.cumsum(lens[:-1])])
    return np.arange(total, dtype=np.int64) - np.repeat(flat_starts, lens)
