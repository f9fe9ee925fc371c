"""GATK/Picard interval_list reader.

Copied from ``adam_tpu/utils/interval_list.py``, on the port's
``models/dictionaries`` and ``models/positions``.

Parity with ``util/IntervalListReader.scala``: the file carries a SAM
text header (@HD/@SQ lines) giving the sequence dictionary, followed by
tab-separated ``sequence start end strand name`` rows with **1-based
inclusive** coordinates. Iteration yields 0-based half-open
``(ReferenceRegion, name)`` pairs (the coordinate convention of this
framework; the reference forwards htsjdk's 1-based values unchanged).
"""

from __future__ import annotations

from adam_tpu_torch.models.dictionaries import SequenceDictionary, SequenceRecord
from adam_tpu_torch.models.positions import ReferenceRegion


class IntervalListReader:
    def __init__(self, path: str):
        self.path = path

    @property
    def sequence_dictionary(self) -> SequenceDictionary:
        records = []
        with open(self.path) as fh:
            for line in fh:
                if not line.startswith("@"):
                    break
                if line.startswith("@SQ"):
                    fields = dict(
                        f.split(":", 1)
                        for f in line.rstrip("\n").split("\t")[1:]
                        if ":" in f
                    )
                    records.append(
                        SequenceRecord(
                            fields["SN"], int(fields["LN"]),
                            md5=fields.get("M5"), url=fields.get("UR"),
                        )
                    )
        return SequenceDictionary(tuple(records))

    def __iter__(self):
        with open(self.path) as fh:
            for line in fh:
                if line.startswith("@") or not line.strip():
                    continue
                f = line.rstrip("\n").split("\t")
                seq, start, end = f[0], int(f[1]), int(f[2])
                name = f[4] if len(f) > 4 else ""
                yield ReferenceRegion(seq, start - 1, end), name

    def regions(self) -> list:
        return [r for r, _ in self]
