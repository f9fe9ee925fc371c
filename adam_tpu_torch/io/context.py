"""Load dispatch by file extension (copied from ``adam_tpu/io/context.py``,
the read loaders).

``.sam``/``.sam.gz`` and ``.bam`` go through the SAM/BAM codecs; a
directory or glob of SAM/BAM files loads as one dataset with merged
header dictionaries; ``.ifq`` is interleaved FASTQ, ``.fq``/``.fastq``
unpaired FASTQ, ``.fa``/``.fasta`` FASTA contigs turned into unaligned
reads; anything else is read as Parquet (a part file or a part
directory), where a contig-fragment store (a file whose schema has
``fragmentSequence``) also becomes reads.  :func:`iter_alignment_batches`
is the windowed face of the same dispatch, for the out-of-core consumers.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Optional, Sequence

import numpy as np

from adam_tpu_torch.api.datasets import AlignmentDataset, GenotypeDataset
from adam_tpu_torch.formats.batch import ReadBatch, ReadSidecar, pack_reads
from adam_tpu_torch.io.sam import SamHeader


def load_bam(path: str, **kw) -> AlignmentDataset:
    from adam_tpu_torch.io import sam

    return AlignmentDataset(*sam.read_bam(path, **kw))


def load_sam(path: str, **kw) -> AlignmentDataset:
    from adam_tpu_torch.io import sam

    return AlignmentDataset(*sam.read_sam(path, **kw))


def load_fastq(path: str, **kw) -> AlignmentDataset:
    from adam_tpu_torch.io import fastq

    return AlignmentDataset(*fastq.read_fastq(path, **kw))


def load_interleaved_fastq(path: str, **kw) -> AlignmentDataset:
    from adam_tpu_torch.io import fastq

    return AlignmentDataset(*fastq.read_interleaved_fastq(path, **kw))


def load_paired_fastq(path1: str, path2: str) -> AlignmentDataset:
    """Two mate files as one dataset: the first file's reads flagged
    first of pair, then the second's flagged second of pair."""
    from adam_tpu_torch.io import fastq

    b1, s1, _ = fastq.read_fastq(path1, set_first_of_pair=True)
    b2, s2, _ = fastq.read_fastq(path2, set_second_of_pair=True)
    return AlignmentDataset(ReadBatch.concat([b1, b2]), ReadSidecar.concat([s1, s2]),
                            SamHeader())


def load_fasta(path: str, fragment_length: int = 10_000):
    """FASTA -> (FragmentBatch, SequenceDictionary, descriptions)."""
    from adam_tpu_torch.io import fasta

    return fasta.read_fasta(path, fragment_length)


def fragments_to_alignments(fragments, seq_dict) -> AlignmentDataset:
    """FragmentBatch -> a dataset of synthetic reads, one per run of
    adjacent fragments."""
    from adam_tpu_torch.formats.fragments import to_read_records

    batch, side = pack_reads(to_read_records(fragments, seq_dict.names))
    return AlignmentDataset(batch, side, SamHeader(seq_dict=seq_dict))


def load_fasta_reads(path: str, fragment_length: int = 10_000) -> AlignmentDataset:
    """FASTA contigs as synthetic reads."""
    fragments, seq_dict, _ = load_fasta(path, fragment_length=fragment_length)
    return fragments_to_alignments(fragments, seq_dict)


def load_parquet_alignments(
    path: str, projection: Optional[Sequence[str]] = None, predicate=None,
) -> AlignmentDataset:
    from adam_tpu_torch.io import parquet

    return AlignmentDataset(
        *parquet.load_alignments(path, projection=projection, predicate=predicate)
    )


def load_vcf(path: str, **kw):
    """VCF -> GenotypeDataset (loadVcf, rdd/ADAMContext.scala:311-335)."""
    return GenotypeDataset.load(path, **kw)


def load_genotypes(path: str, **kw):
    """Dispatcher over genotype sources (loadGenotypes): a VCF or a
    genotype Parquet store, by :meth:`GenotypeDataset.load`."""
    return load_vcf(path, **kw)


def load_header(path: str) -> SamHeader:
    """Header-only peek (sequence dictionary and read groups) without
    materializing the reads: SAM, BAM, directories and globs of them
    (headers merged), and Parquet parts (the schema metadata); other
    inputs are loaded to read their header."""
    p = str(path)
    multi = _expand_multi(p)
    if multi is not None and (len(multi) > 1 or multi[0] != p):
        return _merge_headers([load_header(f) for f in multi])
    base = p[:-3] if p.endswith(".gz") else p
    if base.endswith(".sam"):
        from adam_tpu_torch.io import sam

        return sam.peek_sam_header(p)
    if base.endswith(".bam"):
        from adam_tpu_torch.io import sam

        for _, _, header in sam.iter_bam_batches(p, batch_reads=1):
            return header
        return SamHeader()
    # Parquet stores carry the header in their schema metadata, read
    # without materializing any rows; FASTQ, FASTA and anything without
    # it load whole
    import pyarrow.parquet as pq

    from adam_tpu_torch.io.parquet import _header_from_meta

    try:
        parts = _parquet_parts(p)
        header = _header_from_meta(pq.read_schema(parts[0] if parts else p).metadata)
        if len(header.seq_dict.names) or len(header.read_groups):
            return header
    except (OSError, ValueError):  # not a Parquet file (pyarrow's ArrowInvalid)
        pass
    return load_alignments(path).header


def _merge_headers(headers) -> SamHeader:
    """Union of per-source headers: sequence and read-group dictionaries
    merge (conflicting contig lengths raise); no ``@HD`` line, since one
    source's sort order does not hold for the union."""
    sd = headers[0].seq_dict
    rgd = headers[0].read_groups
    for h in headers[1:]:
        sd = sd.merge(h.seq_dict)
        rgd = rgd.merge(h.read_groups)
    return SamHeader(seq_dict=sd, read_groups=rgd)


def _parquet_parts(path: str) -> list[str]:
    """Ordered part files of a part directory ([] when the path is not a
    directory)."""
    if not os.path.isdir(path):
        return []
    return sorted(
        _glob.glob(os.path.join(path, "part-*.parquet"))
        or _glob.glob(os.path.join(path, "part-*"))
    )


def _expand_multi(path: str) -> Optional[list[str]]:
    """Glob patterns and directories of SAM/BAM files -> ordered file
    list (None = a single-source path).  A directory of Parquet parts
    stays a single source."""
    p = str(path)
    if any(ch in p for ch in "*?["):
        hits = sorted(_glob.glob(p))
        return hits or None
    if os.path.isdir(p):
        entries = sorted(
            os.path.join(p, e) for e in os.listdir(p)
            if e.endswith((".sam", ".bam", ".sam.gz", ".bam.gz"))
        )
        return entries or None
    return None


def load_alignments_multi(paths: Sequence[str], **kw) -> AlignmentDataset:
    """Load several alignment files as one dataset: their headers merge
    and each batch's contig, mate-contig and read-group indices are
    re-indexed into the merged dictionaries."""
    parts = [load_alignments(p, **kw) for p in paths]
    merged = _merge_headers([part.header for part in parts])
    sd = merged.seq_dict
    rgd = merged.read_groups

    def remap(idx, m):
        idx = np.asarray(idx)
        if not len(m):
            return idx.astype(np.int32)
        return np.where(idx >= 0, m[np.clip(idx, 0, len(m) - 1)], idx).astype(np.int32)

    batches, sides = [], []
    for part in parts:
        b = part.batch.to_numpy()
        cmap = np.array([sd.index(nm) for nm in part.header.seq_dict.names], np.int32)
        gmap = np.array([rgd.index(nm) for nm in part.header.read_groups.names],
                        np.int32)
        batches.append(b.replace(
            contig_idx=remap(b.contig_idx, cmap),
            mate_contig_idx=remap(b.mate_contig_idx, cmap),
            read_group_idx=remap(b.read_group_idx, gmap),
        ))
        sides.append(part.sidecar)
    return AlignmentDataset(
        ReadBatch.concat(batches),
        ReadSidecar.concat(sides),
        SamHeader(seq_dict=sd, read_groups=rgd),
    )


def load_alignments(path: str, stringency: Optional[str] = None,
                    **kw) -> AlignmentDataset:
    """Load reads by extension: ``.sam[.gz]``, ``.bam``, a directory or
    glob of SAM/BAM files (one dataset, merged dictionaries), ``.ifq``,
    ``.fq``/``.fastq``, ``.fa``/``.fasta``, or Parquet (``projection=``
    and ``predicate=`` apply there).  ``stringency`` reaches the loader
    that validates pairing (interleaved FASTQ); the others ignore it.

    A Parquet *file* whose schema has ``fragmentSequence`` is a
    contig-fragment store and loads as synthetic reads; the sniff reads
    the path's own schema, as the JAX package does, so a directory is
    always read as alignment parts."""
    multi = _expand_multi(path)
    if multi is not None:
        if len(multi) == 1:
            return load_alignments(multi[0], stringency=stringency, **kw)
        if stringency is not None:
            kw["stringency"] = stringency
        return load_alignments_multi(multi, **kw)
    p = str(path)
    base = p[:-3] if p.endswith(".gz") else p
    if base.endswith(".sam"):
        return load_sam(path, **kw)
    if base.endswith(".bam"):
        return load_bam(path, **kw)
    if base.endswith(".ifq"):
        if stringency is not None:
            kw["stringency"] = stringency
        return load_interleaved_fastq(path, **kw)
    if base.endswith((".fq", ".fastq")):
        return load_fastq(path, **kw)
    if base.endswith((".fa", ".fasta")):
        return load_fasta_reads(path)
    import pyarrow.parquet as pq

    try:
        names = set(pq.read_schema(path).names)
    except (OSError, ValueError):  # a directory, or not a Parquet file (ArrowInvalid)
        names = set()
    if "fragmentSequence" in names:
        from adam_tpu_torch.io import parquet

        fragments, seq_dict, _ = parquet.load_fragments(path)
        return fragments_to_alignments(fragments, seq_dict)
    return load_parquet_alignments(path, **kw)


def iter_alignment_batches(path: str, batch_reads: int = 262_144, projection=None):
    """Windowed alignment reader: yields (ReadBatch, ReadSidecar,
    SamHeader) without holding the whole input, for the out-of-core
    consumers (``parallel/sharded_join``, ``parallel/host_shuffle``).

    SAM/BAM stream through the windowed tokenizers; a Parquet part
    directory yields one window per part (``projection`` pushed into the
    part reads); a directory or glob of SAM/BAM files that share one
    sequence dictionary streams file by file, each file's read groups
    remapped into the merged dictionary; files with differing
    dictionaries fall back, with a warning, to one resident merged load;
    a single Parquet file yields once."""
    from adam_tpu_torch.io import sam as sam_io

    p = str(path)
    base = p[:-3] if p.endswith(".gz") else p
    if base.endswith(".sam"):
        yield from sam_io.iter_sam_batches(p, batch_reads=batch_reads)
        return
    if base.endswith(".bam"):
        yield from sam_io.iter_bam_batches(p, batch_reads=batch_reads)
        return
    from adam_tpu_torch.io import parquet

    kw = {"projection": projection} if projection else {}
    parts = _parquet_parts(p)
    if parts:
        for part in parts:
            yield parquet.load_alignments(part, **kw)
        return
    multi = _expand_multi(p)
    if multi is not None:
        headers = [load_header(f) for f in multi]
        sq0 = headers[0].seq_dict.to_sam_header_lines()
        if all(h.seq_dict.to_sam_header_lines() == sq0 for h in headers[1:]):
            # one shared dictionary: contig ids already agree, so each
            # file streams, with its read groups remapped on the fly
            merged = _merge_headers(headers)
            rgd = merged.read_groups
            for f, h in zip(multi, headers):
                gmap = np.array([rgd.index(nm) for nm in h.read_groups.names], np.int32)
                identity = np.array_equal(gmap, np.arange(len(gmap), dtype=np.int32))
                for batch, side, _h in iter_alignment_batches(
                        f, batch_reads=batch_reads, projection=projection):
                    if len(gmap) and not identity:
                        rg = np.asarray(batch.read_group_idx)
                        rg = np.where(rg >= 0, gmap[np.clip(rg, 0, len(gmap) - 1)],
                                      rg).astype(np.int32)
                        batch = batch.replace(read_group_idx=rg)
                    yield batch, side, merged
            return
        import logging

        logging.getLogger(__name__).warning(
            "iter_alignment_batches(%s): %d sources with differing "
            "sequence dictionaries — falling back to a resident "
            "merged load (not out-of-core)", p, len(multi),
        )
        ds = load_alignments(p)
        yield ds.batch, ds.sidecar, ds.header
        return
    yield parquet.load_alignments(p, **kw)
