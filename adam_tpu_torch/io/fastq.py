"""FASTQ ingest and export (the port's copy of ``adam_tpu/io/fastq.py``).

Paired, unpaired and interleaved semantics of the reference's
``FastqRecordConverter``, and the record-boundary rule of its Hadoop
input formats, multi-line records included: sequence lines run to the
``+`` separator, quality lines until their length matches the sequence.
Reading is host Python, line by line, as in the JAX package.

Export reverse-complements reverse-strand reads back to sequencer
orientation (quals reversed) and gives paired names ``/1`` and ``/2``.
A plain path goes through the native encoder; a ``.gz`` path through
:func:`format_fastq_record`, which writes the same bytes (the route is
chosen by the extension, as in the JAX package).
"""

from __future__ import annotations

import gzip
import logging
from typing import Iterator, Optional

import numpy as np

from adam_tpu_torch.formats import schema
from adam_tpu_torch.formats.batch import ReadBatch, ReadSidecar, pack_reads
from adam_tpu_torch.io.sam import SamHeader
from adam_tpu_torch.utils.validation import handle


def _open(path: str, mode="rt"):
    return gzip.open(path, mode) if str(path).endswith(".gz") else open(path, mode)


def _parse_one(lines: list[str], i: int) -> tuple[tuple[str, str, str], int]:
    """Parse one (possibly multi-line) record at line i -> (record, next_i)."""
    n = len(lines)
    line = lines[i].rstrip("\n")
    if not line.startswith("@"):
        raise ValueError(f"malformed FASTQ at line {i + 1}: {line[:50]!r}")
    name = line
    i += 1
    seq_parts = []
    while i < n and not lines[i].startswith("+"):
        if lines[i].startswith("@"):  # ran into the next name line: no '+'
            raise ValueError(f"FASTQ record {name!r} has no '+' separator")
        seq_parts.append(lines[i].rstrip("\n"))
        i += 1
    if i >= n:
        raise ValueError(f"FASTQ record {name!r} truncated before '+'")
    i += 1  # skip '+' line
    seq = "".join(seq_parts)
    qual_parts: list[str] = []
    qlen = 0
    while i < n and qlen < len(seq):
        q = lines[i].rstrip("\n")
        qual_parts.append(q)
        qlen += len(q)
        i += 1
    qual = "".join(qual_parts)
    if len(qual) != len(seq) or not seq:
        raise ValueError(
            f"FASTQ record {name!r}: qual length {len(qual)} != seq {len(seq)}"
        )
    return (name, seq, qual), i


def find_record_start(lines: list[str], interleaved: bool = False,
                      start: int = 0) -> int:
    """First line index where a well-formed record begins (for an
    interleaved file, a first-of-pair ``/1`` record), or ``len(lines)``:
    a split that opens mid-record resyncs here."""
    for i in range(start, len(lines)):
        if not lines[i].startswith("@"):
            continue
        try:
            (name, _, _), _ = _parse_one(lines, i)
        except ValueError:
            continue
        if interleaved and not name.rstrip("\n").endswith("/1"):
            continue
        return i
    return len(lines)


def split_fastq_records(lines: list[str], resync: bool = False,
                        interleaved: bool = False) -> Iterator[tuple[str, str, str]]:
    """Yield (name_line, seq, qual) records; with ``resync`` leading junk
    (a partial record) is skipped instead of raising."""
    i = find_record_start(lines, interleaved) if resync else 0
    n = len(lines)
    while i < n:
        if not lines[i].rstrip("\n"):
            i += 1
            continue
        rec, i = _parse_one(lines, i)
        yield rec


def _strip_pair_suffix(name: str) -> tuple[str, Optional[int]]:
    """'@read/1' -> ('read', 1); no suffix -> (name, None)."""
    name = name[1:] if name.startswith("@") else name
    if len(name) > 1 and name[-2] == "/" and name[-1] in "12":
        return name[:-2], int(name[-1])
    return name, None


def read_fastq(path: str, set_first_of_pair: bool = False,
               set_second_of_pair: bool = False,
               round_rows_to: int = 1) -> tuple[ReadBatch, ReadSidecar, SamHeader]:
    """Unpaired FASTQ -> unmapped reads; ``set_first/second_of_pair``
    flag the reads as one mate file of a pair."""
    with _open(path) as fh:
        lines = fh.read().splitlines()
    records = []
    for name_line, seq, qual in split_fastq_records(lines, resync=True):
        name, _ = _strip_pair_suffix(name_line)
        flags = schema.FLAG_UNMAPPED
        if set_first_of_pair or set_second_of_pair:
            flags |= schema.FLAG_PAIRED | schema.FLAG_MATE_UNMAPPED
            flags |= (schema.FLAG_FIRST_OF_PAIR if set_first_of_pair
                      else schema.FLAG_SECOND_OF_PAIR)
        records.append(dict(name=name, flags=flags, seq=seq, qual=qual, cigar="*",
                            contig_idx=-1, start=-1, mapq=255))
    batch, side = pack_reads(records, round_rows_to=round_rows_to)
    return batch, side, SamHeader()


def read_interleaved_fastq(path: str, round_rows_to: int = 1, stringency="strict"
                           ) -> tuple[ReadBatch, ReadSidecar, SamHeader]:
    """Interleaved paired FASTQ, records alternating mate 1 and mate 2.

    Pairing is checked by name (``/1`` ``/2`` stripped); ``stringency``
    turns a failure into a warning (LENIENT) or nothing (SILENT), and the
    pair is kept."""
    with _open(path) as fh:
        lines = fh.read().splitlines()
    recs = list(split_fastq_records(lines, resync=True, interleaved=True))
    if len(recs) % 2:
        handle(stringency, f"{path}: odd number of FASTQ records in interleaved file")
        recs = recs[:-1]
    records = []
    for k in range(0, len(recs), 2):
        (n1, s1, q1), (n2, s2, q2) = recs[k], recs[k + 1]
        name1, _ = _strip_pair_suffix(n1)
        name2, _ = _strip_pair_suffix(n2)
        if name1 != name2:
            handle(stringency,
                   f"interleaved FASTQ pair mismatch: {name1!r} vs {name2!r}")
        base = schema.FLAG_PAIRED | schema.FLAG_UNMAPPED | schema.FLAG_MATE_UNMAPPED
        records.append(dict(name=name1, flags=base | schema.FLAG_FIRST_OF_PAIR, seq=s1,
                            qual=q1, cigar="*", contig_idx=-1, start=-1, mapq=255))
        records.append(dict(name=name2, flags=base | schema.FLAG_SECOND_OF_PAIR, seq=s2,
                            qual=q2, cigar="*", contig_idx=-1, start=-1, mapq=255))
    batch, side = pack_reads(records, round_rows_to=round_rows_to)
    return batch, side, SamHeader()


def format_fastq_record(name: str, bases, quals, length: int, flags: int,
                        add_suffix: bool = True) -> str:
    """One record's text (no trailing newline)."""
    codes = np.asarray(bases)[:length]
    phred = np.asarray(quals)[:length]
    if flags & schema.FLAG_REVERSE:
        codes = schema.BASE_COMPLEMENT[codes][::-1]
        phred = phred[::-1]
    suffix = ""
    if add_suffix and (flags & schema.FLAG_PAIRED):
        suffix = "/1" if (flags & schema.FLAG_FIRST_OF_PAIR) else "/2"
    return (f"@{name}{suffix}\n"
            f"{schema.decode_bases(codes)}\n+\n{schema.decode_quals(phred)}")


def write_fastq(path: str, batch: ReadBatch, side: ReadSidecar, add_suffix: bool = True,
                predicate=None, row_mask=None) -> None:
    """Write the valid rows (narrowed by ``row_mask`` and by ``predicate``
    over each row's flags) as FASTQ."""
    from adam_tpu_torch import native

    b = batch.to_numpy()
    select = np.asarray(b.valid).copy()
    if row_mask is not None:
        select &= np.asarray(row_mask, bool)
    if predicate is not None:
        flags = np.asarray(b.flags)
        select &= np.fromiter((bool(predicate(int(f))) for f in flags), bool, len(flags))
    if not str(path).endswith(".gz"):
        data = native.fastq_encode(b, side, select, add_suffix)
        with open(path, "wb") as fh:
            fh.write(data)
        return
    with _open(path, "wt") as fh:
        for i in np.flatnonzero(select):
            fh.write(format_fastq_record(side.names[i], b.bases[i], b.quals[i],
                                         int(b.lengths[i]), int(b.flags[i]), add_suffix)
                     + "\n")


def write_paired_fastq(path1: str, path2: str, batch: ReadBatch, side: ReadSidecar,
                       stringency="lenient") -> None:
    """Split pairs into two files.  Read names must occur exactly twice
    (``/1`` ``/2`` stripped) and no read may carry both first- and
    second-of-pair: STRICT raises with the reference's "don't occur
    exactly twice" report, LENIENT logs it and writes only the properly
    paired records, SILENT only filters."""
    from adam_tpu_torch.formats.strings import StringColumn

    b = batch.to_numpy()
    flags = np.asarray(b.flags)
    valid = np.asarray(b.valid)
    fixed = StringColumn.of(side.names).to_fixed_bytes()
    # suffix-stripped grouping key
    keys = np.array([k[:-2] if k.endswith((b"/1", b"/2")) else k for k in fixed])
    keys = np.where(valid, keys, b"")
    _uniq, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
    n_per_read = counts[inv]
    bad = valid & (n_per_read != 2)
    if bad.any():
        bad_names = np.unique(keys[bad])[:100]
        handle(
            stringency,
            "Found %d read names that don't occur exactly twice\n\nSamples:\n\t%s"
            % (len(np.unique(keys[bad])),
               "\n\t".join(x.decode("utf-8", "replace") for x in bad_names)),
        )
    both = (valid & ((flags & schema.FLAG_FIRST_OF_PAIR) != 0)
            & ((flags & schema.FLAG_SECOND_OF_PAIR) != 0))
    if both.any():
        handle(stringency, "Read %s found with first- and second-of-pair set"
               % fixed[both.argmax()].decode("utf-8", "replace"))
    paired = valid & (n_per_read == 2) & ~both
    n_first = int((paired & ((flags & schema.FLAG_FIRST_OF_PAIR) != 0)).sum())
    n_second = int((paired & ((flags & schema.FLAG_SECOND_OF_PAIR) != 0)).sum())
    logging.getLogger("adam_tpu.io.fastq").info(
        "%d/%d records are properly paired: %d firsts, %d seconds",
        int(paired.sum()), int(valid.sum()), n_first, n_second,
    )
    write_fastq(path1, batch, side, predicate=lambda f: bool(f & schema.FLAG_FIRST_OF_PAIR),
                row_mask=paired)
    write_fastq(path2, batch, side, predicate=lambda f: bool(f & schema.FLAG_SECOND_OF_PAIR),
                row_mask=paired)
