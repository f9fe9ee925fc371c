"""SAM ingest — the read path of ``adam_tpu/io/sam.py``.

Text SAM is tokenized window by window through the native C++ tokenizer
(:mod:`adam_tpu_torch.native`) into host :class:`ReadBatch` columns.
Positions: SAM text is 1-based; everything in the port is 0-based
end-exclusive, as in the JAX package.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

from adam_tpu_torch.formats.batch import ReadBatch, ReadSidecar
from adam_tpu_torch.models.dictionaries import (
    RecordGroupDictionary,
    SequenceDictionary,
)


@dataclass
class SamHeader:
    seq_dict: SequenceDictionary = field(default_factory=SequenceDictionary)
    read_groups: RecordGroupDictionary = field(default_factory=RecordGroupDictionary)
    hd_line: Optional[str] = None
    program_lines: list = field(default_factory=list)
    comment_lines: list = field(default_factory=list)

    @staticmethod
    def parse(lines: Iterable[str]) -> "SamHeader":
        hd = None
        sq, rg, pg, co = [], [], [], []
        for line in lines:
            if line.startswith("@HD"):
                hd = line.rstrip("\n")
            elif line.startswith("@SQ"):
                sq.append(line)
            elif line.startswith("@RG"):
                rg.append(line)
            elif line.startswith("@PG"):
                pg.append(line.rstrip("\n"))
            elif line.startswith("@CO"):
                co.append(line.rstrip("\n"))
        return SamHeader(
            seq_dict=SequenceDictionary.from_sam_header_lines(sq),
            read_groups=RecordGroupDictionary.from_sam_header_lines(rg),
            hd_line=hd,
            program_lines=pg,
            comment_lines=co,
        )


def _columns_to_batch(out: dict) -> tuple[ReadBatch, ReadSidecar]:
    """Native tokenizer columns -> (ReadBatch, ReadSidecar)."""
    from adam_tpu_torch.formats.strings import StringColumn

    n = out["n"]
    if n == 0:
        return ReadBatch.empty(), ReadSidecar()
    batch = ReadBatch(
        bases=out["bases"],
        quals=out["quals"],
        lengths=out["lengths"],
        flags=out["flags"],
        contig_idx=out["contig_idx"],
        start=out["start"],
        end=out["end"],
        mapq=out["mapq"],
        cigar_ops=out["cigar_ops"],
        cigar_lens=out["cigar_lens"],
        cigar_n=out["cigar_n"],
        mate_contig_idx=out["mate_contig_idx"],
        mate_start=out["mate_start"],
        tlen=out["tlen"],
        read_group_idx=out["rg_idx"],
        has_qual=out["has_qual"].astype(bool),
        valid=np.ones(n, dtype=bool),
    )
    side = ReadSidecar(
        names=StringColumn(out["name_buf"], out["name_off"]),
        attrs=StringColumn(out["attr_buf"], out["attr_off"]),
        md=StringColumn(
            out["md_buf"], out["md_off"], out["md_present"].astype(bool)
        ),
        orig_quals=StringColumn(
            out["oq_buf"], out["oq_off"], out["oq_present"].astype(bool)
        ),
    )
    return batch, side


def _split_header_lines(data: bytes) -> tuple[list[str], int]:
    """'@'-prefixed header lines + body offset of a SAM byte buffer."""
    body_off = 0
    header_lines = []
    while body_off < len(data) and data[body_off : body_off + 1] == b"@":
        nl = data.find(b"\n", body_off)
        end = nl if nl >= 0 else len(data)
        line = data[body_off:end]
        if line.endswith(b"\r"):
            line = line[:-1]
        header_lines.append(line.decode("utf-8", "replace"))
        body_off = end + 1
    return header_lines, body_off


def peek_sam_header(path: str) -> SamHeader:
    """Header-only SAM read: stream lines until the first record."""
    opener = gzip.open if str(path).endswith(".gz") else open
    lines = []
    with opener(path, "rt") as fh:
        for line in fh:
            if not line.startswith("@"):
                break
            lines.append(line.rstrip("\r\n"))
    return SamHeader.parse(lines)


def iter_sam_batches(path: str, batch_reads: int = 262_144):
    """Windowed SAM reader: yields (ReadBatch, ReadSidecar, SamHeader)
    chunks of ``batch_reads`` records each (line-exact windowing)."""
    from adam_tpu_torch import native

    if str(path).endswith(".gz"):
        with gzip.open(path, "rb") as fh:
            buf = np.frombuffer(fh.read(), np.uint8)
    elif os.path.getsize(path) == 0:
        yield ReadBatch.empty(), ReadSidecar(), SamHeader()
        return
    else:
        # file-backed mapping: the input's pages stay reclaimable while
        # the windows stream through
        buf = np.memmap(path, np.uint8, mode="r")
    hdr_probe = bytes(buf[: 1 << 20])
    header_lines, body_off = _split_header_lines(hdr_probe)
    if body_off >= len(hdr_probe) and len(buf) > len(hdr_probe):
        hdr_probe = bytes(buf)  # pathological >1MB header: full scan
        header_lines, body_off = _split_header_lines(hdr_probe)
    header = SamHeader.parse(header_lines)
    bounds = native.line_index_strided(buf, body_off, batch_reads)
    if len(bounds) < 2:
        yield ReadBatch.empty(), ReadSidecar(), header
        return
    for i in range(len(bounds) - 1):
        chunk = buf[bounds[i] : bounds[i + 1]]
        out = native.tokenize_sam(
            chunk, 0, header.seq_dict.names, header.read_groups.names
        )
        if out is None:
            raise ValueError(f"{path}: malformed SAM records in window")
        batch, side = _columns_to_batch(out)
        yield batch, side, header
