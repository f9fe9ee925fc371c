"""UCSC .2bit random-access reference reader.

Copied from ``adam_tpu/utils/two_bit.py`` (host code, no tensors).

Parity with ``util/TwoBitFile.scala:57-152`` + ``util/ReferenceFile.scala:33``:
magic/version header (either endianness), name index, per-sequence N
blocks and mask blocks, and ``extract(region)``.

Columnar recast: the packed 2-bit payload decodes with one vectorized
shift/mask over the byte slice (the reference walks byte-at-a-time per
base), and N blocks are *applied* (bases inside an N block decode as
``N``) — the reference leaves this as a TODO and emits phantom ACGT
there.  Soft-mask blocks are exposed but not lower-cased by default,
matching reference output.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

MAGIC = 0x1A412743
#: 2-bit code -> base, in .2bit bit order (T=0, C=1, A=2, G=3)
_CODE_TO_BASE = np.frombuffer(b"TCAG", np.uint8)


class ReferenceFile:
    """Anything that can hand back reference sequence for a region
    (util/ReferenceFile.scala:33)."""

    def extract(self, contig: str, start: int, end: int) -> str:
        raise NotImplementedError


@dataclass
class TwoBitRecord:
    dna_size: int
    n_blocks: list  # [(start, end), ...)  0-based half-open
    mask_blocks: list
    dna_offset: int  # byte offset of packed DNA


class TwoBitFile(ReferenceFile):
    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray)):
            data = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as fh:
                data = fh.read()
        self._data = data
        if struct.unpack_from("<I", data, 0)[0] == MAGIC:
            self._end = "<"
        elif struct.unpack_from(">I", data, 0)[0] == MAGIC:
            self._end = ">"
        else:
            raise ValueError("not a .2bit file (bad magic)")
        version, count, reserved = struct.unpack_from(
            self._end + "III", data, 4
        )
        if version != 0 or reserved != 0:
            raise ValueError("unsupported .2bit version/reserved fields")
        self.records: dict[str, TwoBitRecord] = {}
        off = 16
        offsets = []
        for _ in range(count):
            name_size = data[off]
            name = data[off + 1: off + 1 + name_size].decode()
            (seq_off,) = struct.unpack_from(
                self._end + "I", data, off + 1 + name_size
            )
            offsets.append((name, seq_off))
            off += 1 + name_size + 4
        for name, seq_off in offsets:
            self.records[name] = self._read_record(seq_off)
        self._name_order = [n for n, _ in offsets]

    @property
    def num_seq(self) -> int:
        return len(self.records)

    def seq_lengths(self) -> dict[str, int]:
        return {n: r.dna_size for n, r in self.records.items()}

    def _read_record(self, off: int) -> TwoBitRecord:
        u = lambda o: struct.unpack_from(self._end + "I", self._data, o)[0]
        dna_size = u(off)
        n_count = u(off + 4)
        p = off + 8
        n_starts = [u(p + 4 * i) for i in range(n_count)]
        n_sizes = [u(p + 4 * (n_count + i)) for i in range(n_count)]
        p += 8 * n_count
        m_count = u(p)
        p += 4
        m_starts = [u(p + 4 * i) for i in range(m_count)]
        m_sizes = [u(p + 4 * (m_count + i)) for i in range(m_count)]
        p += 8 * m_count
        p += 4  # reserved
        return TwoBitRecord(
            dna_size=dna_size,
            n_blocks=[(s, s + z) for s, z in zip(n_starts, n_sizes)],
            mask_blocks=[(s, s + z) for s, z in zip(m_starts, m_sizes)],
            dna_offset=p,
        )

    def extract(self, contig: str, start: int, end: int,
                apply_masks: bool = False) -> str:
        """Sequence for [start, end) on ``contig`` (0-based half-open,
        the extract of TwoBitFile.scala:120-146 + N-block application)."""
        rec = self.records[contig]
        if start < 0 or end > rec.dna_size or end < start:
            raise ValueError(
                f"region {contig}:{start}-{end} out of bounds "
                f"(size {rec.dna_size})"
            )
        if end == start:
            return ""
        first_byte = rec.dna_offset + start // 4
        last_byte = rec.dna_offset + (end - 1) // 4 + 1
        chunk = np.frombuffer(self._data[first_byte:last_byte], np.uint8)
        # each byte holds 4 bases, most significant pair first
        shifts = np.array([6, 4, 2, 0], np.uint8)
        codes = (chunk[:, None] >> shifts[None, :]) & 0x3
        codes = codes.reshape(-1)[start % 4: start % 4 + (end - start)]
        out = _CODE_TO_BASE[codes].copy()
        for bs, be in rec.n_blocks:
            lo, hi = max(bs, start), min(be, end)
            if lo < hi:
                out[lo - start: hi - start] = ord("N")
        seq = out.tobytes().decode()
        if apply_masks:
            arr = bytearray(seq.encode())
            for bs, be in rec.mask_blocks:
                lo, hi = max(bs, start), min(be, end)
                if lo < hi:
                    arr[lo - start: hi - start] = (
                        seq[lo - start: hi - start].lower().encode()
                    )
            seq = arr.decode()
        return seq


class FragmentReferenceFile(ReferenceFile):
    """ReferenceFile over an in-memory FragmentBatch (the framework's
    native reference representation)."""

    def __init__(self, fragments, seq_dict):
        self.fragments = fragments
        self.seq_dict = seq_dict

    def extract(self, contig: str, start: int, end: int) -> str:
        idx = self.seq_dict.names.index(contig)
        return self.fragments.extract_region(idx, start, end)
