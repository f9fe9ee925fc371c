"""Columnar reference-fragment batches (the port's copy of
``adam_tpu/formats/fragments.py``).

A contig is chopped into fixed-length fragments (default 10 kbp) so a
genome is a dataset like any other: one row per fragment, padded to one
width.  :class:`FragmentBatch` holds numpy arrays on the host (what the
FASTA and Parquet loaders produce, and what the host functions here
read) and torch tensors after :meth:`FragmentBatch.to`.  Flanking each
fragment with the head of its genome-adjacent right neighbour makes
windows that span a fragment join count once (:func:`flank_fragments`).

:func:`count_contig_kmers` is the slice's device work: the flanked
fragments go to the card and through the shift-or k-mer histogram of
:mod:`adam_tpu_torch.ops.kmer`.  It runs on the card unless
``device="cpu"`` is asked for.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from adam_tpu_torch.formats import schema
from adam_tpu_torch.formats.batch import _to_numpy

Array = Any  # np.ndarray (host) or torch.Tensor


@dataclass(frozen=True)
class FragmentBatch:
    bases: Array        # u8[N, F] base codes, BASE_PAD beyond length
    lengths: Array      # i32[N]
    contig_idx: Array   # i32[N]
    start: Array        # i64[N]  fragment start on contig
    fragment_number: Array  # i32[N]
    num_fragments: Array    # i32[N] total fragments in contig
    valid: Array        # bool[N]

    @property
    def n_rows(self) -> int:
        return int(self.bases.shape[0])

    @property
    def fmax(self) -> int:
        return int(self.bases.shape[1])

    def arrays(self) -> dict:
        """Field name -> array, in declaration order."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def replace(self, **kw) -> "FragmentBatch":
        return dataclasses.replace(self, **kw)

    def take(self, idx) -> "FragmentBatch":
        """Row gather of a host batch."""
        idx = np.asarray(idx)
        return FragmentBatch(**{k: _to_numpy(v)[idx] for k, v in self.arrays().items()})

    def to_numpy(self) -> "FragmentBatch":
        """Host copy (numpy arrays; a no-op for a host batch)."""
        return FragmentBatch(**{k: _to_numpy(v) for k, v in self.arrays().items()})

    def to(self, device) -> "FragmentBatch":
        """Every field as a torch tensor on ``device``."""
        import torch

        def move(x):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.ascontiguousarray(x))
            return x.to(device)

        return FragmentBatch(**{k: move(v) for k, v in self.arrays().items()})

    @staticmethod
    def from_sequences(seqs: Sequence[tuple[int, str]],
                       fragment_length: int = 10_000) -> "FragmentBatch":
        """(contig_idx, sequence) pairs -> fragment rows."""
        rows = []
        for contig_idx, seq in seqs:
            nfrag = max(1, -(-len(seq) // fragment_length))
            for k in range(nfrag):
                chunk = seq[k * fragment_length: (k + 1) * fragment_length]
                rows.append((contig_idx, k * fragment_length, k, nfrag, chunk))
        n = len(rows)
        fmax = max((len(r[4]) for r in rows), default=1)
        out = FragmentBatch(
            bases=np.full((n, fmax), schema.BASE_PAD, np.uint8),
            lengths=np.zeros(n, np.int32),
            contig_idx=np.zeros(n, np.int32),
            start=np.zeros(n, np.int64),
            fragment_number=np.zeros(n, np.int32),
            num_fragments=np.zeros(n, np.int32),
            valid=np.ones(n, bool),
        )
        for i, (c, s, k, nf, chunk) in enumerate(rows):
            out.bases[i, : len(chunk)] = schema.encode_bases(chunk)
            out.lengths[i] = len(chunk)
            out.contig_idx[i] = c
            out.start[i] = s
            out.fragment_number[i] = k
            out.num_fragments[i] = nf
        return out

    def extract_region(self, contig_idx: int, start: int, end: int) -> str:
        """The sequence of [start, end) on a contig, from the fragments
        that cover it; a region not fully covered raises ``KeyError``."""
        b = self.to_numpy()
        pieces = []
        for i in np.argsort(np.asarray(b.start), kind="stable"):
            if not b.valid[i] or int(b.contig_idx[i]) != contig_idx:
                continue
            fs = int(b.start[i])
            fe = fs + int(b.lengths[i])
            lo, hi = max(fs, start), min(fe, end)
            if lo < hi:
                pieces.append(schema.decode_bases(b.bases[i][lo - fs: hi - fs]))
        got = "".join(pieces)
        if len(got) != end - start:
            raise KeyError(
                f"region {contig_idx}:{start}-{end} not fully covered by fragments"
            )
        return got


def flank_fragments(fragments: FragmentBatch, flank: int) -> FragmentBatch:
    """Extend each fragment with the first ``flank`` bases of its right
    neighbour on the same contig (host numpy).  Only genome-adjacent
    fragments exchange flanks: a coordinate gap (a subset batch) must not
    fabricate sequence across it."""
    b = fragments.to_numpy()
    n = b.n_rows
    order = np.lexsort((np.asarray(b.start), np.asarray(b.contig_idx), ~np.asarray(b.valid)))
    new_len = np.array(b.lengths)
    fmax = b.fmax
    ext = {}
    for j in range(n - 1):
        i, nxt = order[j], order[j + 1]
        if not (b.valid[i] and b.valid[nxt]):
            continue
        if int(b.contig_idx[i]) != int(b.contig_idx[nxt]):
            continue
        if int(b.start[nxt]) != int(b.start[i]) + int(b.lengths[i]):
            continue
        take = min(flank, int(b.lengths[nxt]))
        if take <= 0:
            continue
        ext[int(i)] = b.bases[nxt][:take]
        new_len[i] = int(b.lengths[i]) + take
    width = max(fmax, int(new_len.max(initial=1)))
    bases = np.full((n, width), schema.BASE_PAD, np.uint8)
    bases[:, :fmax] = b.bases
    for i, tail in ext.items():
        bases[i, int(b.lengths[i]): int(new_len[i])] = tail
    return b.replace(bases=bases, lengths=new_len)


def count_contig_kmers(fragments: FragmentBatch, k: int,
                       device: str = "cuda") -> dict[str, int]:
    """k-mer counts over contig fragments, windows across fragment joins
    included once: the fragments are flanked by ``k - 1`` bases on the
    host, then the shift-or histogram runs on ``device``."""
    from adam_tpu_torch.device import resolve_device
    from adam_tpu_torch.ops import kmer

    dev = resolve_device(device)
    flanked = flank_fragments(fragments, k - 1).to(dev)
    return kmer.histogram_to_dict(flanked.bases, flanked.lengths, flanked.valid, k)


def to_read_records(fragments: FragmentBatch, contig_names) -> list[dict]:
    """Merge adjacent fragments into synthetic read records: per contig,
    fragments sorted by start, each maximal run of adjacent fragments
    (next.start == prev.end) one read; non-adjacent fragments stay
    separate reads."""
    b = fragments.to_numpy()
    rows = np.flatnonzero(np.asarray(b.valid))
    if not len(rows):
        return []
    contig = np.asarray(b.contig_idx)[rows]
    start = np.asarray(b.start)[rows]
    lens = np.asarray(b.lengths)[rows].astype(np.int64)
    order = np.lexsort((start, contig))
    contig, start, lens, rows = contig[order], start[order], lens[order], rows[order]
    # run breaks: new contig, or a gap before this fragment
    prev_end = start + lens
    brk = np.ones(len(rows), bool)
    brk[1:] = (contig[1:] != contig[:-1]) | (start[1:] != prev_end[:-1])

    records: list[dict] = []
    heads = np.flatnonzero(brk)
    bounds = np.append(heads, len(rows))
    bases = np.asarray(b.bases)
    for r in range(len(heads)):
        lo, hi = bounds[r], bounds[r + 1]
        seq = "".join(schema.decode_bases(bases[rows[k]][: int(lens[k])])
                      for k in range(lo, hi))
        c = int(contig[lo])
        records.append(dict(
            name=contig_names[c] if 0 <= c < len(contig_names) else str(c),
            flags=0, contig_idx=c, start=int(start[lo]), mapq=255,
            cigar=f"{len(seq)}M", seq=seq, qual="*",
        ))
    return records
