"""SAM and BAM ingest, and the SAM and BAM writers — copied from
``adam_tpu/io/sam.py`` on its native paths only.

Text SAM is tokenized window by window through the native C++ tokenizer
(:mod:`adam_tpu_torch.native`) into host :class:`ReadBatch` columns; a
BAM's BGZF blocks are inflated and its records tokenized by the same
library, window by window as well.  Where the JAX package falls back to
pure-Python codecs, the port has none: the native library is built or
the call raises.  :func:`iter_sam_records` is JAX's text-line parser
into :func:`pack_reads` records, for callers that build batches from a
few SAM lines.  Positions: SAM text is 1-based; everything in the port
is 0-based end-exclusive, as in the JAX package.
"""

from __future__ import annotations

import gzip
import io as _io
import os
import struct
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional

import numpy as np

from adam_tpu_torch.formats import schema
from adam_tpu_torch.formats.batch import ReadBatch, ReadSidecar
from adam_tpu_torch.models.dictionaries import (
    RecordGroupDictionary,
    SequenceDictionary,
    SequenceRecord,
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

    def to_lines(self, sort_order: Optional[str] = None) -> list[str]:
        hd = self.hd_line or "@HD\tVN:1.5"
        if sort_order is not None:
            fields = [f for f in hd.split("\t") if not f.startswith("SO:")]
            hd = "\t".join(fields + [f"SO:{sort_order}"])
        out = [hd]
        out += self.seq_dict.to_sam_header_lines()
        out += [g.to_sam_header_line() for g in self.read_groups]
        out += self.program_lines
        out += self.comment_lines
        return out


def _parse_tags(
    tag_fields: list[str],
) -> tuple[str, Optional[str], Optional[str], Optional[str]]:
    """Split raw SAM tag fields into (other_tags, md, orig_qual, rg).

    MD/OQ/RG move to dedicated columns (the reference's
    mismatchingPositions/origQual/recordGroup* record fields,
    converters/SAMRecordConverter.scala:103-130) and are re-emitted from
    those columns on export, so they are stripped from the attribute
    string here.
    """
    md = oq = rg = None
    rest = []
    for f in tag_fields:
        if f.startswith("MD:Z:"):
            md = f[5:]
        elif f.startswith("OQ:Z:"):
            oq = f[5:]
        elif f.startswith("RG:Z:") and rg is None:
            rg = f[5:]
        else:
            rest.append(f)
    return "\t".join(rest), md, oq, rg


def iter_sam_records(text_lines: Iterable[str], header: SamHeader) -> Iterator[dict]:
    """SAM body lines -> record dicts for :func:`pack_reads`."""
    sd, rgd = header.seq_dict, header.read_groups
    for line in text_lines:
        if not line or line.startswith("@"):
            continue
        f = line.rstrip("\n").split("\t")
        qname, flag, rname, pos, mapq, cigar, rnext, pnext, tlen, seq, qual = f[:11]
        flags = int(flag)
        attrs, md, oq, rg = _parse_tags(f[11:])
        rg_idx = rgd.index_or(rg) if rg is not None else -1
        if rg is not None and rg_idx < 0:
            # RG naming a group absent from the header: keep the tag in
            # attrs so round-trip preserves it (rg_idx stays -1).
            tag = f"RG:Z:{rg}"
            attrs = f"{attrs}\t{tag}" if attrs else tag
        contig_idx = sd.index_or(rname) if rname != "*" else -1
        if rnext == "=":
            mate_contig_idx = contig_idx
        elif rnext == "*":
            mate_contig_idx = -1
        else:
            mate_contig_idx = sd.index_or(rnext)
        yield dict(
            name=qname,
            flags=flags,
            contig_idx=contig_idx,
            start=int(pos) - 1 if rname != "*" and int(pos) > 0 else -1,
            mapq=int(mapq),
            cigar=cigar,
            seq=seq,
            qual=qual,
            mate_contig_idx=mate_contig_idx,
            mate_start=int(pnext) - 1 if int(pnext) > 0 else -1,
            tlen=int(tlen),
            read_group_idx=rg_idx,
            attrs=attrs,
            md=md,
            orig_qual=oq,
        )


def _columns_to_batch(out: dict, round_rows_to: int = 1
                      ) -> tuple[ReadBatch, ReadSidecar]:
    """Native tokenizer columns -> (ReadBatch, ReadSidecar), the rows
    padded (invalid, empty sidecar strings) up to a multiple of
    ``round_rows_to``."""
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
    nrows = ((n + round_rows_to - 1) // round_rows_to) * round_rows_to
    if nrows != n:
        batch = batch.pad_rows(nrows)
        pad = nrows - n
        side = ReadSidecar.concat(
            [side, ReadSidecar(names=[""] * pad, attrs=[""] * pad,
                               md=[None] * pad, orig_quals=[None] * pad)])
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


def read_sam(path: str, round_rows_to: int = 1
             ) -> tuple[ReadBatch, ReadSidecar, SamHeader]:
    """Whole-file SAM (or ``.sam.gz``) read through the native tokenizer;
    the rows pad up to a multiple of ``round_rows_to``."""
    from adam_tpu_torch import native

    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as fh:
        data = fh.read()
    header_lines, body_off = _split_header_lines(data)
    header = SamHeader.parse(header_lines)
    out = native.tokenize_sam(
        data, body_off, header.seq_dict.names, header.read_groups.names
    )
    if out is None:
        raise ValueError(f"{path}: malformed SAM records")
    batch, side = _columns_to_batch(out, round_rows_to)
    return batch, side, header


# --------------------------------------------------------------------------
# BAM (BGZF container + binary alignment records)
# --------------------------------------------------------------------------
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def bgzf_decompress(data: bytes) -> bytes:
    """Decode a BGZF container (the native block-parallel decoder)."""
    from adam_tpu_torch import native

    out = native.bgzf_decompress(data)
    if out is None:
        raise ValueError("not a BGZF container, or it ends in a truncated block")
    return out


def bgzf_compress(data: bytes, block_size: int = 0xFF00) -> bytes:
    """Encode bytes as BGZF blocks + EOF marker (the native block-parallel
    encoder).  BSIZE is a u16 (total block size - 1), so blocks never
    exceed 0xFF00 input bytes."""
    from adam_tpu_torch import native

    return native.bgzf_compress(data, block_size=min(max(1, block_size), 0xFF00))


def _parse_bam_header_blob(raw: bytes) -> tuple[SamHeader, int]:
    """Parse the BAM preamble (magic, header text, reference list) from a
    decompressed prefix -> (header, records offset).  Raises ValueError
    when ``raw`` is too short to contain the whole preamble."""
    if raw[:4] != b"BAM\x01":
        raise ValueError("not a BAM stream")
    if len(raw) < 8:
        raise ValueError("truncated BAM preamble")
    (l_text,) = struct.unpack_from("<i", raw, 4)
    if len(raw) < 8 + l_text + 4:
        raise ValueError("truncated BAM preamble")
    text = raw[8 : 8 + l_text].decode("utf-8", "replace").rstrip("\x00")
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", raw, off)
    off += 4
    recs = []
    for _ in range(n_ref):
        if len(raw) < off + 4:
            raise ValueError("truncated BAM reference list")
        (l_name,) = struct.unpack_from("<i", raw, off)
        if len(raw) < off + 4 + l_name + 4:
            raise ValueError("truncated BAM reference list")
        name = raw[off + 4 : off + 4 + l_name - 1].decode("ascii")
        (l_ref,) = struct.unpack_from("<i", raw, off + 4 + l_name)
        recs.append(SequenceRecord(name, l_ref))
        off += 4 + l_name + 4
    header = SamHeader.parse(text.splitlines())
    # the header text is authoritative; without @SQ lines the binary
    # reference list supplies the dictionary
    if len(header.seq_dict) == 0 and recs:
        header.seq_dict = SequenceDictionary(tuple(recs))
    return header, off


def iter_bam_batches(
    path: str,
    batch_reads: int = 500_000,
    window_bytes: int = 32 * 1024 * 1024,
):
    """Constant-memory streaming BAM reader: yields (ReadBatch,
    ReadSidecar, SamHeader).

    ``window_bytes`` of compressed input are read at a time; their
    *complete* BGZF blocks are inflated and their complete BAM records
    tokenized, and both the compressed and the decompressed tails carry
    into the next window.  Tokenized windows are yielded whole, together,
    once at least ``batch_reads`` reads are pending (and the rest at
    EOF), so a yielded batch usually holds more than ``batch_reads``
    reads: windows follow the bytes, as in the JAX package."""
    from adam_tpu_torch import native

    with open(path, "rb") as fh:
        comp_tail = b""
        raw_tail = b""
        header = None
        pending: list[dict] = []
        pending_reads = 0
        eof = False
        while not eof:
            chunk = fh.read(window_bytes)
            if not chunk:
                eof = True
            comp = comp_tail + chunk
            if comp:
                got = native.bgzf_decompress_partial(comp)
                if got is None:
                    raise ValueError(f"{path}: not a BGZF/BAM file")
                blob, consumed = got
                if eof and consumed < len(comp):
                    raise ValueError(f"{path}: truncated BGZF block at EOF")
                comp_tail = comp[consumed:]
                raw = raw_tail + blob
            else:
                raw = raw_tail
            if header is None:
                try:
                    header, records_off = _parse_bam_header_blob(raw)
                except ValueError:
                    if eof:
                        raise
                    raw_tail = raw
                    continue  # the preamble needs more data
                raw = raw[records_off:]
            out = native.tokenize_bam(raw, 0, header.read_groups.names, partial=True)
            if out is None:
                raise ValueError(f"{path}: malformed BAM records")
            consumed = out.pop("consumed")
            if eof and consumed < len(raw):
                raise ValueError(f"{path}: truncated BAM record at EOF")
            raw_tail = raw[consumed:]
            n = len(out["flags"])
            if n:
                pending.append(out)
                pending_reads += n
            while pending_reads >= batch_reads or (eof and pending):
                take, taken = [], 0
                while pending and taken < batch_reads:
                    take.append(pending.pop(0))
                    taken += len(take[-1]["flags"])
                batches = [_columns_to_batch(o) for o in take]
                if len(batches) == 1:
                    batch, side = batches[0]
                else:
                    batch = ReadBatch.concat([b for b, _ in batches])
                    side = ReadSidecar.concat([s for _, s in batches])
                pending_reads -= taken
                yield batch, side, header
                if not eof:
                    break


def read_bam(path: str, round_rows_to: int = 1
             ) -> tuple[ReadBatch, ReadSidecar, SamHeader]:
    """Whole-file BAM read: inflate, parse the preamble, tokenize; the
    rows pad up to a multiple of ``round_rows_to``."""
    from adam_tpu_torch import native

    with open(path, "rb") as fh:
        raw = bgzf_decompress(fh.read())
    header, off = _parse_bam_header_blob(raw)
    out = native.tokenize_bam(raw, off, header.read_groups.names)
    if out is None:
        raise ValueError(f"{path}: malformed BAM records")
    out.pop("consumed")
    batch, side = _columns_to_batch(out, round_rows_to)
    return batch, side, header


def format_sam_records(batch: ReadBatch, side: ReadSidecar,
                       header: SamHeader) -> Iterator[str]:
    """SAM text lines of the valid rows, one at a time, in plain Python
    (copied from the JAX package's ``format_sam_records``): the format
    :func:`write_sam`'s native encoder writes, kept as its oracle."""
    b = batch.to_numpy()
    names = header.seq_dict.names
    rg_names = header.read_groups.names
    for i in range(b.n_rows):
        if not b.valid[i]:
            continue
        L = int(b.lengths[i])
        contig = int(b.contig_idx[i])
        mate_contig = int(b.mate_contig_idx[i])
        rname = names[contig] if contig >= 0 else "*"
        if mate_contig < 0:
            rnext = "*"
        elif mate_contig == contig and rname != "*":
            rnext = "="
        else:
            rnext = names[mate_contig]
        seq = schema.decode_bases(b.bases[i], L) if L else "*"
        qual = schema.decode_quals(b.quals[i][:L]) if L and b.has_qual[i] else "*"
        cigar = schema.decode_cigar(b.cigar_ops[i], b.cigar_lens[i], int(b.cigar_n[i]))
        tags = []
        if side.attrs[i]:
            tags.append(side.attrs[i])
        if side.md[i] is not None:
            tags.append(f"MD:Z:{side.md[i]}")
        if side.orig_quals[i]:
            tags.append(f"OQ:Z:{side.orig_quals[i]}")
        rg = int(b.read_group_idx[i])
        if rg >= 0:
            tags.append(f"RG:Z:{rg_names[rg]}")
        fields = [
            side.names[i],
            str(int(b.flags[i])),
            rname,
            str(int(b.start[i]) + 1 if int(b.start[i]) >= 0 else 0),
            str(int(b.mapq[i]) if int(b.mapq[i]) >= 0 else 0),
            cigar,
            rnext,
            str(int(b.mate_start[i]) + 1 if int(b.mate_start[i]) >= 0 else 0),
            str(int(b.tlen[i])),
            seq,
            qual,
        ]
        yield "\t".join(fields + tags)


def write_sam(
    path: str,
    batch: ReadBatch,
    side: ReadSidecar,
    header: SamHeader,
    sort_order: Optional[str] = None,
) -> None:
    """Write a SAM file: the header lines, then the native encoder's
    records (``native.sam_encode``)."""
    from adam_tpu_torch import native

    body = native.sam_encode(batch, side, header.read_groups.names,
                             header.seq_dict.names)
    with open(path, "wb") as fh:
        for line in header.to_lines(sort_order=sort_order):
            fh.write(line.encode("utf-8") + b"\n")
        fh.write(body)


def write_bam(
    path: str,
    batch: ReadBatch,
    side: ReadSidecar,
    header: SamHeader,
    sort_order: Optional[str] = None,
) -> None:
    """Write a BAM: the preamble (header text and reference list), the
    native record encoder's stream, BGZF-compressed with the EOF block."""
    from adam_tpu_torch import native

    text = "\n".join(header.to_lines(sort_order=sort_order)) + "\n"
    body = _io.BytesIO()
    body.write(b"BAM\x01")
    tb = text.encode("utf-8")
    body.write(struct.pack("<i", len(tb)))
    body.write(tb)
    sd = header.seq_dict
    body.write(struct.pack("<i", len(sd)))
    for r in sd:
        nb = r.name.encode("ascii") + b"\x00"
        body.write(struct.pack("<i", len(nb)))
        body.write(nb)
        body.write(struct.pack("<i", r.length))
    body.write(native.bam_encode(batch, side, header.read_groups.names, len(sd)))
    with open(path, "wb") as fh:
        fh.write(bgzf_compress(body.getvalue()))
