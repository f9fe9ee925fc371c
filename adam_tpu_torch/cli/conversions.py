"""The conversion verbs of the port's command line (the counterparts of
``adam_tpu/cli/conversions.py``): ``bam2adam``, ``vcf2adam``,
``anno2adam``, ``adam2vcf``, ``fasta2adam``, ``features2adam`` and
``wigfix2bed``.

Each takes the JAX verb's arguments and the shared flags of
``cli/main.py`` (``-parquet_compression_codec`` among them, and
``--device {cuda,cpu}``, default ``cuda``).  None of them does tensor
work: the device argument is checked (``cuda`` without a card raises) so
that every verb has the same face.  They write the JAX verbs' files byte
for byte and print the JAX verbs' standard output; the stage walls go to
standard error as one JSON line (``wigfix2bed`` prints none: it
streams)."""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from adam_tpu_torch.cli.main import Command


class Bam2Adam(Command):
    name = "bam2adam"
    description = ("Single-node BAM to ADAM converter (Note: the 'transform' "
                   "command can take SAM or BAM as input)")

    @classmethod
    def configure(cls, p):
        p.add_argument("bam", metavar="BAM")
        p.add_argument("adam", metavar="ADAM")
        p.add_argument("-samtools_validation", default="lenient", help="accepted for parity")
        p.add_argument("-num_threads", type=int, default=4)
        p.add_argument("-queue_size", type=int, default=10000, help="accepted for parity")

    @classmethod
    def run(cls, args):
        return bam2adam(args)


class Vcf2Adam(Command):
    name = "vcf2adam"
    description = "Convert a VCF file to the corresponding ADAM format"

    @classmethod
    def configure(cls, p):
        p.add_argument("vcf", metavar="VCF")
        p.add_argument("adam", metavar="ADAM")
        p.add_argument("-onlyvariants", action="store_true",
                       help="output only variants, not genotypes")

    @classmethod
    def run(cls, args):
        return vcf2adam(args)


class VcfAnnotation2Adam(Command):
    name = "anno2adam"
    description = "Convert a annotation file (in VCF format) to the corresponding ADAM format"

    @classmethod
    def configure(cls, p):
        p.add_argument("vcf", metavar="VCF")
        p.add_argument("adam", metavar="ADAM")
        p.add_argument("-current-db", dest="current_db", default=None,
                       help="existing annotation store to merge with")

    @classmethod
    def run(cls, args):
        return anno2adam(args)


class Adam2Vcf(Command):
    name = "adam2vcf"
    description = "Convert an ADAM variant to the VCF ADAM format"

    @classmethod
    def configure(cls, p):
        p.add_argument("adam", metavar="ADAM")
        p.add_argument("vcf", metavar="VCF")
        p.add_argument("-coalesce", type=int, default=-1, help="accepted for parity")
        p.add_argument("-sort_on_save", action="store_true")

    @classmethod
    def run(cls, args):
        return adam2vcf(args)


class Fasta2Adam(Command):
    name = "fasta2adam"
    description = ("Converts a text FASTA sequence file into an ADAMNucleotideContig "
                   "Parquet file which represents assembled sequences.")

    @classmethod
    def configure(cls, p):
        p.add_argument("fasta", metavar="FASTA")
        p.add_argument("adam", metavar="ADAM")
        p.add_argument("-fragment_length", type=int, default=10000)
        p.add_argument("-verbose", action="store_true")
        p.add_argument("-reads", default=None,
                       help="reads file for a sequence dictionary to use instead")

    @classmethod
    def run(cls, args):
        return fasta2adam(args)


class Features2Adam(Command):
    name = "features2adam"
    description = "Convert a file with sequence features into corresponding ADAM format"

    @classmethod
    def configure(cls, p):
        p.add_argument("features", metavar="FEATURES",
                       help="feature file (gtf/gff/bed/narrowpeak)")
        p.add_argument("adam", metavar="ADAM")

    @classmethod
    def run(cls, args):
        return features2adam(args)


class WigFix2Bed(Command):
    name = "wigfix2bed"
    description = "Locally convert a wigFix file to BED format"

    @classmethod
    def configure(cls, p):
        p.add_argument("wig", metavar="WIG", nargs="?", default=None,
                       help="input wigFix file (default: stdin)")
        p.add_argument("-o", dest="output", default=None,
                       help="output BED file (default: stdout)")

    @classmethod
    def run(cls, args):
        return wigfix2bed(args)


COMMANDS = [
    Bam2Adam,
    Vcf2Adam,
    VcfAnnotation2Adam,
    Adam2Vcf,
    Fasta2Adam,
    Features2Adam,
    WigFix2Bed,
]


def _walls(**kw) -> None:
    print(json.dumps(kw, sort_keys=True), file=sys.stderr)


def bam2adam(args) -> int:
    """SAM/BAM -> one Parquet file.  A BAM streams window by window into
    one ParquetWriter; an empty BAM (no window) falls through to the
    whole-file load, for its header."""
    from adam_tpu_torch.io import context, parquet
    from adam_tpu_torch.utils import instrumentation as ins

    t0 = time.monotonic()
    if str(args.bam).endswith(".bam"):
        import pyarrow.parquet as pq

        from adam_tpu_torch.io import sam as sam_io

        writer = None
        n = 0
        with ins.TIMERS.time(ins.SAVE_OUTPUT):
            for batch, side, header in sam_io.iter_bam_batches(args.bam):
                table = parquet.to_arrow_alignments(batch, side, header)
                if writer is None:
                    writer = pq.ParquetWriter(args.adam, table.schema,
                                              compression=args.parquet_compression_codec)
                writer.write_table(table)
                n += table.num_rows
            if writer is not None:
                writer.close()
        if writer is not None:
            print(f"bam2adam: streamed {n} reads")
            _walls(total_s=time.monotonic() - t0, n_reads=n, streamed=True)
            return 0
    with ins.TIMERS.time(ins.LOAD_ALIGNMENTS):
        ds = context.load_alignments(args.bam)
    t1 = time.monotonic()
    with ins.TIMERS.time(ins.SAVE_OUTPUT):
        parquet.save_alignments(args.adam, ds.batch, ds.sidecar, ds.header,
                                compression=args.parquet_compression_codec)
    _walls(load_s=t1 - t0, save_s=time.monotonic() - t1, n_reads=ds.batch.n_valid(),
           streamed=False)
    return 0


def vcf2adam(args) -> int:
    from adam_tpu_torch.io import parquet, vcf

    t0 = time.monotonic()
    variants, genotypes, seq_dict = vcf.read_vcf(args.vcf)
    if args.onlyvariants:
        genotypes = genotypes.take(np.zeros(0, np.int64))
    t1 = time.monotonic()
    parquet.save_genotypes(args.adam, variants, genotypes, seq_dict,
                           compression=args.parquet_compression_codec)
    _walls(load_s=t1 - t0, save_s=time.monotonic() - t1, n_variants=len(variants),
           n_genotypes=len(genotypes))
    return 0


def anno2adam(args) -> int:
    """A VCF annotation database -> the variant store (no genotypes).
    With ``-current-db`` the existing store's sites are merged in, the
    new VCF's rows superseding old ones of the same variant key."""
    from adam_tpu_torch.formats.variants import VariantBatch, VariantSidecar
    from adam_tpu_torch.io import parquet, vcf
    from adam_tpu_torch.models.dictionaries import SequenceDictionary, SequenceRecord

    t0 = time.monotonic()
    variants, genotypes, seq_dict = vcf.read_vcf(args.vcf)
    genotypes = genotypes.take(np.zeros(0, np.int64))
    if args.current_db:
        old_v, _og, old_sd = parquet.load_genotypes(args.current_db)
        names = [r.name for r in seq_dict.records]
        old_names = [r.name for r in old_sd.records]
        new_keys = set(variants.variant_keys(names))
        keep = np.array([i for i, k in enumerate(old_v.variant_keys(old_names))
                         if k not in new_keys], np.int64)
        old_v = old_v.take(keep)
        name_idx = {n: i for i, n in enumerate(names)}
        records = list(seq_dict.records)
        for r in old_sd.records:
            if r.name not in name_idx:
                name_idx[r.name] = len(records)
                records.append(SequenceRecord(r.name, r.length))
        seq_dict = SequenceDictionary(tuple(records))
        remap = np.array([name_idx[n] for n in old_names], np.int64)
        s_new, s_old = variants.sidecar, old_v.sidecar
        variants = VariantBatch(
            contig_idx=np.concatenate([variants.contig_idx,
                                       remap[old_v.contig_idx]]).astype(np.int32),
            start=np.concatenate([variants.start, old_v.start]),
            end=np.concatenate([variants.end, old_v.end]),
            ref_len=np.concatenate([variants.ref_len, old_v.ref_len]),
            alt_len=np.concatenate([variants.alt_len, old_v.alt_len]),
            qual=np.concatenate([variants.qual, old_v.qual]),
            filters_applied=np.concatenate([variants.filters_applied,
                                            old_v.filters_applied]),
            passing=np.concatenate([variants.passing, old_v.passing]),
            sidecar=VariantSidecar(
                ref_allele=s_new.ref_allele + s_old.ref_allele,
                alt_allele=s_new.alt_allele + s_old.alt_allele,
                names=s_new.names + s_old.names,
                filters=s_new.filters + s_old.filters,
                info=s_new.info + s_old.info,
            ),
        )
    t1 = time.monotonic()
    parquet.save_genotypes(args.adam, variants, genotypes, seq_dict,
                           compression=args.parquet_compression_codec)
    _walls(load_s=t1 - t0, save_s=time.monotonic() - t1, n_variants=len(variants))
    return 0


def adam2vcf(args) -> int:
    from adam_tpu_torch.io import parquet, vcf

    t0 = time.monotonic()
    variants, genotypes, seq_dict = parquet.load_genotypes(args.adam)
    t1 = time.monotonic()
    vcf.write_vcf(args.vcf, variants, genotypes, seq_dict, args.sort_on_save)
    _walls(load_s=t1 - t0, save_s=time.monotonic() - t1, n_variants=len(variants),
           n_genotypes=len(genotypes))
    return 0


def fasta2adam(args) -> int:
    """FASTA -> the contig-fragment store; ``-reads`` takes the sequence
    dictionary from a reads file instead (when it has one)."""
    from adam_tpu_torch.io import context, parquet

    t0 = time.monotonic()
    fragments, seq_dict, descriptions = context.load_fasta(args.fasta,
                                                           args.fragment_length)
    if args.reads:
        ds = context.load_alignments(args.reads)
        if len(ds.seq_dict.names) > 0:
            seq_dict = ds.seq_dict
    if args.verbose:
        print("Loaded dictionary:")
        for r in seq_dict.records:
            print(f"  {r.name}\t{r.length}")
    t1 = time.monotonic()
    parquet.save_fragments(args.adam, fragments, seq_dict, descriptions,
                           compression=args.parquet_compression_codec)
    _walls(load_s=t1 - t0, save_s=time.monotonic() - t1, n_fragments=fragments.n_rows,
           n_contigs=len(seq_dict.names))
    return 0


def features2adam(args) -> int:
    from adam_tpu_torch.io import features as fio
    from adam_tpu_torch.io import parquet

    t0 = time.monotonic()
    feats = fio.read_features(args.features)
    t1 = time.monotonic()
    parquet.save_features(args.adam, feats, compression=args.parquet_compression_codec)
    _walls(load_s=t1 - t0, save_s=time.monotonic() - t1, n_features=len(feats))
    return 0


def wigfix2bed(args) -> int:
    from adam_tpu_torch.io.features import wigfix_to_bed_lines

    fin = open(args.wig) if args.wig else sys.stdin
    fout = open(args.output, "w") if args.output else sys.stdout
    try:
        for row in wigfix_to_bed_lines(fin):
            fout.write(row + "\n")
    finally:
        if args.wig:
            fin.close()
        if args.output:
            fout.close()
    return 0
