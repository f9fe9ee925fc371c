"""Zero-copy Arrow columns over packed (offsets + data) buffers — the
port's copy of ``adam_tpu/io/arrow_pack.py``.

Pass C hands the writer each window's recalibrated qual column and its
base column already packed by the device (``ops/colpack.pack_rows``);
the Arrow columns are built directly over that memory.  Every builder is
byte-compatible with the column the JAX package writes (same Arrow type,
values and validity), which keeps the Parquet parts bit-identical.
pyarrow is imported only inside the builders.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from adam_tpu_torch.formats.strings import StringColumn, _span_gather_indices


@dataclass(frozen=True)
class PackedQuals:
    """A packed column payload: ``buf`` holds the concatenated in-read
    bytes of every row in row order and ``lens`` the per-row byte counts
    (0 for invalid / column-less rows)."""

    buf: np.ndarray   # u8[sum(lens)]
    lens: np.ndarray  # i64[N]

    def __post_init__(self):
        object.__setattr__(self, "buf", np.ascontiguousarray(self.buf, np.uint8))
        object.__setattr__(self, "lens", np.asarray(self.lens, np.int64))

    def offsets(self) -> np.ndarray:
        out = np.zeros(len(self.lens) + 1, np.int64)
        np.cumsum(self.lens, out=out[1:])
        return out

    def take(self, rows: np.ndarray) -> "PackedQuals":
        """Row subset (free when the dropped rows carry no bytes)."""
        rows = np.asarray(rows, np.int64)
        keep = np.zeros(len(self.lens), bool)
        keep[rows] = True
        in_order = bool((np.diff(rows) > 0).all()) if len(rows) > 1 else True
        if in_order and not self.lens[~keep].any():
            return PackedQuals(self.buf, self.lens[rows])
        starts = self.offsets()[:-1][rows]
        lens = self.lens[rows]
        return PackedQuals(self.buf[_span_gather_indices(starts, lens)], lens)


@dataclass(frozen=True)
class PackedColumns:
    """The pass-C payload pair of a window: the qual column and the base
    column, each a :class:`PackedQuals`."""

    quals: PackedQuals
    bases: PackedQuals

    def take(self, rows: np.ndarray) -> "PackedColumns":
        return PackedColumns(self.quals.take(rows), self.bases.take(rows))


def packed_qual_array(packed: PackedQuals, valid: np.ndarray):
    """Packed qual payload -> the Arrow ``large_string`` qual column
    (rows without a qual are nulls)."""
    return StringColumn(
        packed.buf, packed.offsets(), np.asarray(valid, bool)
    ).to_arrow()


def packed_base_array(packed: PackedQuals):
    """Packed base payload -> the Arrow ``sequence`` column (all valid)."""
    n = len(packed.lens)
    return StringColumn(packed.buf, packed.offsets(), np.ones(n, bool)).to_arrow()


def index_name_array(idx: np.ndarray, names: list[str]):
    """Dictionary-index column -> Arrow ``string`` array (nulls for
    idx < 0), assembled by gathering the dictionary's byte spans."""
    import pyarrow as pa

    idx = np.asarray(idx)
    n = len(idx)
    enc = [s.encode("utf-8") for s in names]
    dict_lens = np.array([len(b) for b in enc] + [0], np.int64)
    total_dict = int(dict_lens.sum())
    dict_buf = (
        np.frombuffer(b"".join(enc), np.uint8)
        if total_dict
        else np.zeros(0, np.uint8)
    )
    dict_off = np.zeros(len(enc) + 2, np.int64)
    np.cumsum(dict_lens, out=dict_off[1:])
    safe = np.where(idx >= 0, idx, len(enc)).astype(np.int64)
    lens = dict_lens[safe]
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    total = int(offsets[-1])
    if total > np.iinfo(np.int32).max:  # i32 offsets would overflow
        lut = np.array(names + [None], dtype=object)
        return pa.array(lut[safe], pa.string())
    buf = (
        dict_buf[_span_gather_indices(dict_off[safe], lens)]
        if total
        else np.zeros(0, np.uint8)
    )
    valid = idx >= 0
    validity = None if valid.all() else pa.array(valid).buffers()[1]
    return pa.Array.from_buffers(
        pa.string(),
        n,
        [
            validity,
            pa.py_buffer(np.ascontiguousarray(offsets.astype(np.int32))),
            pa.py_buffer(buf),
        ],
    )
