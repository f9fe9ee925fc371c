"""Columnar read batches — the port's counterpart of
``adam_tpu/formats/batch.py``.

A :class:`ReadBatch` is a plain dataclass of padded, masked arrays
``[N, Lmax]`` / ``[N]``: numpy arrays on the host (what ingest produces
and what the host-side codecs read), torch tensors after
:meth:`ReadBatch.to`.  :class:`ReadSidecar` holds the variable-length
host-only columns (names, tags, MD, OQ) as :class:`StringColumn`\\ s.

The grid helpers (:func:`grid_rows`, :func:`grid_cols`,
:func:`grid_cigar_cols`, :func:`pad_rows_np`) are kept exactly as in the
JAX package: they fix every kernel shape, so the port's per-window
kernels see the same ``[g, gl]`` grids as the reference's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from adam_tpu_torch.formats import schema

Array = Any  # np.ndarray (host) or torch.Tensor


def grid_rows(n: int, minimum: int = 1024) -> int:
    """Device-friendly row count: the next power of two, floored at
    ``minimum``.  Padding rows carry valid=False and are masked out by
    every kernel."""
    n = max(int(n), 1)
    g = max(minimum, 1 << (n - 1).bit_length())
    return g


def grid_cols(n: int, mult: int = 32) -> int:
    """Device-friendly lane count: next multiple of ``mult``."""
    return _round_up(max(int(n), 1), mult)


def grid_cigar_cols(width: int) -> int:
    """Cigar-op grid: multiples of 8 instead of :func:`grid_cols`'s 32."""
    return grid_cols(width, mult=8)


def pad_rows_np(arr, n: int, fill=0, cols: int | None = None):
    """Pad a numpy array's leading axis up to ``n`` rows (and, for 2-d
    arrays when ``cols`` is given, the second axis up to ``cols``) with
    ``fill``."""
    arr = np.asarray(arr)
    extra_rows = n - arr.shape[0]
    extra_cols = (cols - arr.shape[1]) if (cols is not None and arr.ndim > 1) else 0
    if extra_rows == 0 and extra_cols == 0:
        return arr
    pad_width = [(0, extra_rows), (0, extra_cols)] + [(0, 0)] * (arr.ndim - 2)
    return np.pad(arr, pad_width[: arr.ndim], constant_values=fill)


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "detach"):  # a torch tensor, on any device
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclass(frozen=True)
class ReadBatch:
    """Struct-of-arrays batch of (up to) N reads, padded to [N, L] / [N, C].

    Padding rows have ``valid == False``; padding lanes within a read have
    ``bases == BASE_PAD`` and ``quals == QUAL_PAD``.
    """

    bases: Array          # u8[N, L]   base codes (schema.BASE_*)
    quals: Array          # u8[N, L]   phred values, QUAL_PAD in padding
    lengths: Array        # i32[N]     true read length
    flags: Array          # i32[N]     packed SAM flags
    contig_idx: Array     # i32[N]     index into SequenceDictionary, -1 unmapped
    start: Array          # i64[N]     0-based inclusive, -1 if unmapped
    end: Array            # i64[N]     0-based exclusive (start + ref span)
    mapq: Array           # i32[N]     255 = unavailable
    cigar_ops: Array      # u8[N, C]   schema.CIGAR_* codes, CIGAR_PAD pad
    cigar_lens: Array     # i32[N, C]
    cigar_n: Array        # i32[N]     number of real cigar ops
    mate_contig_idx: Array  # i32[N]   -1 if mate unmapped/absent
    mate_start: Array     # i64[N]
    tlen: Array           # i32[N]    template length (SAM TLEN)
    read_group_idx: Array  # i32[N]   index into RecordGroupDictionary, -1 none
    has_qual: Array       # bool[N]   false when qual was '*'
    valid: Array          # bool[N]   row mask

    @property
    def n_rows(self) -> int:
        return int(self.bases.shape[0])

    @property
    def lmax(self) -> int:
        return int(self.bases.shape[1])

    @property
    def cmax(self) -> int:
        return int(self.cigar_ops.shape[1])

    def n_valid(self) -> int:
        return int(_to_numpy(self.valid).sum())

    def flag_set(self, bit: int) -> Array:
        """bool[N]: ``bit`` is set in the flags (host or tensor)."""
        return (self.flags & bit) != 0

    @property
    def is_mapped(self) -> Array:
        """bool[N]: the unmapped flag bit is clear (host or tensor)."""
        return (self.flags & schema.FLAG_UNMAPPED) == 0

    @property
    def is_primary(self) -> Array:
        """bool[N]: neither secondary nor supplementary (host or tensor)."""
        return (self.flags & (schema.FLAG_SECONDARY | schema.FLAG_SUPPLEMENTARY)) == 0

    def pad_rows(self, n: int) -> "ReadBatch":
        """A host batch padded to exactly ``n`` rows with invalid rows
        (``ValueError`` when it already has more)."""
        cur = self.n_rows
        if cur == n:
            return self
        if cur > n:
            raise ValueError(f"cannot pad {cur} rows down to {n}")
        fill = ReadBatch.empty(n - cur, self.lmax, self.cmax).arrays()
        return ReadBatch(**{
            k: np.concatenate([_to_numpy(v), fill[k]], axis=0)
            for k, v in self.arrays().items()
        })

    def arrays(self) -> dict:
        """Field name -> array, in declaration order."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def replace(self, **kw) -> "ReadBatch":
        return dataclasses.replace(self, **kw)

    def take(self, idx) -> "ReadBatch":
        """Row gather of a host batch."""
        idx = np.asarray(idx)
        return ReadBatch(**{k: np.asarray(v)[idx] for k, v in self.arrays().items()})

    @staticmethod
    def concat(batches) -> "ReadBatch":
        """Concatenate host batches along rows, widening L/C to the max."""
        batches = [b for b in batches if b.n_rows]
        if not batches:
            return ReadBatch.empty()
        lmax = max(b.lmax for b in batches)
        cmax = max(b.cmax for b in batches)
        batches = [b.to_numpy().widen(lmax, cmax) for b in batches]
        return ReadBatch(**{
            k: np.concatenate([b.arrays()[k] for b in batches], axis=0)
            for k in batches[0].arrays()
        })

    def widen(self, lmax: int, cmax: int) -> "ReadBatch":
        """Grow a host batch's per-read padding lanes to lmax/cmax."""
        if lmax == self.lmax and cmax == self.cmax:
            return self

        def padlane(x, width, fill):
            x = np.asarray(x)
            if x.shape[1] == width:
                return x
            return np.pad(x, [(0, 0), (0, width - x.shape[1])], constant_values=fill)

        return self.replace(
            bases=padlane(self.bases, lmax, schema.BASE_PAD),
            quals=padlane(self.quals, lmax, schema.QUAL_PAD),
            cigar_ops=padlane(self.cigar_ops, cmax, schema.CIGAR_PAD),
            cigar_lens=padlane(self.cigar_lens, cmax, 0),
        )

    def to_numpy(self) -> "ReadBatch":
        """Host copy (numpy arrays; a no-op for a host batch)."""
        return ReadBatch(**{k: _to_numpy(v) for k, v in self.arrays().items()})

    def to(self, device) -> "ReadBatch":
        """Every field as a torch tensor on ``device``."""
        import torch

        def move(x):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.ascontiguousarray(x))
            return x.to(device)

        return ReadBatch(**{k: move(v) for k, v in self.arrays().items()})

    def to_device(self, device="cuda") -> "ReadBatch":
        """Every field as a tensor on ``device`` (default: the card; JAX's
        ``to_device`` places on its default device)."""
        from adam_tpu_torch.device import resolve_device

        return self.to(resolve_device(device))

    @staticmethod
    def empty(n: int = 0, lmax: int = 0, cmax: int = 0) -> "ReadBatch":
        return ReadBatch(
            bases=np.full((n, lmax), schema.BASE_PAD, np.uint8),
            quals=np.full((n, lmax), schema.QUAL_PAD, np.uint8),
            lengths=np.zeros(n, np.int32),
            flags=np.full(n, schema.FLAG_UNMAPPED, np.int32),
            contig_idx=np.full(n, -1, np.int32),
            start=np.full(n, -1, np.int64),
            end=np.full(n, -1, np.int64),
            mapq=np.full(n, 255, np.int32),
            cigar_ops=np.full((n, cmax), schema.CIGAR_PAD, np.uint8),
            cigar_lens=np.zeros((n, cmax), np.int32),
            cigar_n=np.zeros(n, np.int32),
            mate_contig_idx=np.full(n, -1, np.int32),
            mate_start=np.full(n, -1, np.int64),
            tlen=np.zeros(n, np.int32),
            read_group_idx=np.full(n, -1, np.int32),
            has_qual=np.zeros(n, bool),
            valid=np.zeros(n, bool),
        )


@dataclass
class ReadSidecar:
    """Host-side variable-length columns, parallel to ReadBatch rows,
    stored columnar (:class:`StringColumn`: flat bytes + offsets)."""

    names: Any = field(default_factory=list)       # read names
    attrs: Any = field(default_factory=list)       # raw SAM tag strings
    md: Any = field(default_factory=list)          # MD tag string or None
    orig_quals: Any = field(default_factory=list)  # OQ or None
    trimmed_from_start: Any = None
    trimmed_from_end: Any = None

    def __post_init__(self):
        from adam_tpu_torch.formats.strings import StringColumn

        self.names = StringColumn.of(self.names)
        self.attrs = StringColumn.of(self.attrs)
        self.md = StringColumn.of(self.md)
        self.orig_quals = StringColumn.of(self.orig_quals)
        n = len(self.names)
        self.trimmed_from_start = (
            np.zeros(n, np.int32) if self.trimmed_from_start is None
            else np.asarray(self.trimmed_from_start, np.int32)
        )
        self.trimmed_from_end = (
            np.zeros(n, np.int32) if self.trimmed_from_end is None
            else np.asarray(self.trimmed_from_end, np.int32)
        )

    def take(self, idx) -> "ReadSidecar":
        idx = np.asarray(idx)
        return ReadSidecar(
            names=self.names.take(idx),
            attrs=self.attrs.take(idx),
            md=self.md.take(idx),
            orig_quals=self.orig_quals.take(idx),
            trimmed_from_start=self.trimmed_from_start[idx],
            trimmed_from_end=self.trimmed_from_end[idx],
        )

    @staticmethod
    def concat(sides) -> "ReadSidecar":
        from adam_tpu_torch.formats.strings import StringColumn

        if not sides:
            return ReadSidecar()
        return ReadSidecar(
            names=StringColumn.concat([s.names for s in sides]),
            attrs=StringColumn.concat([s.attrs for s in sides]),
            md=StringColumn.concat([s.md for s in sides]),
            orig_quals=StringColumn.concat([s.orig_quals for s in sides]),
            trimmed_from_start=np.concatenate(
                [np.asarray(s.trimmed_from_start, np.int32) for s in sides]
            ),
            trimmed_from_end=np.concatenate(
                [np.asarray(s.trimmed_from_end, np.int32) for s in sides]
            ),
        )

    def __len__(self) -> int:
        return len(self.names)


def pack_reads(
    records,
    lmax: int | None = None,
    cmax: int | None = None,
    round_rows_to: int = 1,
) -> tuple[ReadBatch, ReadSidecar]:
    """Build a host (ReadBatch, ReadSidecar) from parsed per-read dicts
    (copied from ``adam_tpu/formats/batch.pack_reads``).

    Each record dict carries: name, flags, contig_idx, start (0-based, -1
    unmapped), mapq, cigar (string), seq (string), qual (phred string or
    '*'), mate_contig_idx, mate_start, tlen, read_group_idx, attrs (raw tag
    string), md (or None).
    """
    n = len(records)
    if n == 0:
        return ReadBatch.empty(), ReadSidecar()
    if lmax is None:
        lmax = max((len(r["seq"]) if r["seq"] not in ("*", None) else 0) for r in records)
        lmax = max(lmax, 1)
    if cmax is None:
        cmax = 1
        for r in records:
            c = r.get("cigar") or "*"
            cmax = max(cmax, sum(1 for ch in c if not ch.isdigit()))
    nrows = _round_up(n, round_rows_to)

    b = ReadBatch.empty(nrows, lmax, cmax)
    s_names, s_attrs, s_md, s_oq, s_tfs, s_tfe = [], [], [], [], [], []

    for i, r in enumerate(records):
        seq = r["seq"] if r["seq"] not in ("*", None) else ""
        qual = r.get("qual")
        L = len(seq)
        if L:
            b.bases[i, :L] = schema.encode_bases(seq)
        if qual and qual != "*":
            b.quals[i, : len(qual)] = schema.encode_quals(qual)
            b.has_qual[i] = True
        elif L:
            b.quals[i, :L] = 0
        b.lengths[i] = L
        b.flags[i] = r["flags"]
        b.contig_idx[i] = r.get("contig_idx", -1)
        start = r.get("start", -1)
        b.start[i] = start
        b.mapq[i] = r.get("mapq", 255)
        cig = r.get("cigar") or "*"
        ops, lens, ncig = schema.encode_cigar(cig, cmax)
        b.cigar_ops[i] = ops
        b.cigar_lens[i] = lens
        b.cigar_n[i] = ncig
        _, rlen = schema.cigar_str_stats(cig) if cig != "*" else (0, 0)
        # end = start for mapped reads whose CIGAR consumes no reference
        # (e.g. fully soft-clipped); -1 is reserved for unplaced reads.
        b.end[i] = start + rlen if start >= 0 else -1
        b.mate_contig_idx[i] = r.get("mate_contig_idx", -1)
        b.mate_start[i] = r.get("mate_start", -1)
        b.tlen[i] = r.get("tlen", 0)
        b.read_group_idx[i] = r.get("read_group_idx", -1)
        b.valid[i] = True

        s_names.append(r.get("name", ""))
        s_attrs.append(r.get("attrs", ""))
        s_md.append(r.get("md"))
        s_oq.append(r.get("orig_qual"))
        s_tfs.append(r.get("trimmed_from_start", 0))
        s_tfe.append(r.get("trimmed_from_end", 0))

    # padding rows keep empty sidecar slots so columns stay row-parallel
    pad = nrows - n
    side = ReadSidecar(
        names=s_names + [""] * pad,
        attrs=s_attrs + [""] * pad,
        md=s_md + [None] * pad,
        orig_quals=s_oq + [None] * pad,
        trimmed_from_start=np.asarray(s_tfs + [0] * pad, np.int32),
        trimmed_from_end=np.asarray(s_tfe + [0] * pad, np.int32),
    )
    return b, side
