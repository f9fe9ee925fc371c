"""FASTA ingest and export (the port's copy of ``adam_tpu/io/fasta.py``).

Description lines are parsed on the host, sequences cut into fixed-length
fragments: a :class:`FragmentBatch` and a :class:`SequenceDictionary`.
"""

from __future__ import annotations

import gzip
from typing import Optional

from adam_tpu_torch.formats import schema
from adam_tpu_torch.formats.fragments import FragmentBatch
from adam_tpu_torch.models.dictionaries import SequenceDictionary, SequenceRecord


def _open(path: str, mode="rt"):
    return gzip.open(path, mode) if str(path).endswith(".gz") else open(path, mode)


def parse_fasta(text: str) -> list[tuple[str, Optional[str], str]]:
    """-> [(name, description_or_None, sequence)]; blank lines and ``;``
    comments are skipped."""
    out = []
    name = desc = None
    seq_parts: list[str] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith(";"):
            continue
        if line.startswith(">"):
            if name is not None or seq_parts:
                out.append((name or "", desc, "".join(seq_parts)))
            headline = line[1:].strip()
            if " " in headline:
                name, desc = headline.split(" ", 1)
            else:
                name, desc = headline, None
            seq_parts = []
        else:
            seq_parts.append(line)
    if name is not None or seq_parts:
        out.append((name or "", desc, "".join(seq_parts)))
    return out


def read_fasta(path: str, fragment_length: int = 10_000
               ) -> tuple[FragmentBatch, SequenceDictionary, list[Optional[str]]]:
    with _open(path) as fh:
        entries = parse_fasta(fh.read())
    seq_dict = SequenceDictionary(tuple(SequenceRecord(n, len(s)) for n, _, s in entries))
    fragments = FragmentBatch.from_sequences(
        [(i, s) for i, (_, _, s) in enumerate(entries)], fragment_length)
    descriptions = [d for _, d, _ in entries]
    return fragments, seq_dict, descriptions


def write_fasta(path: str, fragments: FragmentBatch, seq_dict: SequenceDictionary,
                line_width: int = 60) -> None:
    b = fragments.to_numpy()
    with _open(path, "wt") as fh:
        for contig_idx, rec in enumerate(seq_dict):
            rows = [i for i in range(b.n_rows)
                    if b.valid[i] and int(b.contig_idx[i]) == contig_idx]
            rows.sort(key=lambda i: int(b.start[i]))
            seq = "".join(schema.decode_bases(b.bases[i][: int(b.lengths[i])])
                          for i in rows)
            fh.write(f">{rec.name}\n")
            for off in range(0, len(seq), line_width):
                fh.write(seq[off: off + line_width] + "\n")
