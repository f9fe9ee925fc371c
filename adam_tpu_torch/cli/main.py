"""Command line of the port: ``python -m adam_tpu_torch`` with the verbs
``transform``, ``flagstat``, ``depth``, ``view``, ``count_kmers``,
``count_contig_kmers``, ``adam2fastq`` and the conversion verbs of
``cli/conversions.py`` (``bam2adam``, ``vcf2adam``, ``anno2adam``,
``adam2vcf``, ``fasta2adam``, ``features2adam``, ``wigfix2bed``).

Flag spellings, stage order, checkpoint fingerprints and refusal messages
follow the JAX package's CLI.  ``transform`` runs in one of three modes.

Without ``-streaming`` it is the dataset-level transform (ADAM's classic
``transform``): load the whole input by extension (``.sam[.gz]``,
``.bam``, ``.ifq``, ``.fq``/``.fastq``, ``.fa``/``.fasta``, Parquet; a
contig-fragment store loads as reads), run the stages over the whole
dataset, then save by the output's extension (``.sam``, ``.bam``,
``.fq``/``.fastq``, else one Parquet file)::

    python -m adam_tpu_torch transform IN OUT [-trimReads -trimFromStart N
        -trimFromEnd N [-trimReadGroup RG]] [-qualityBasedTrim
        [-qualityThreshold Q] [-trimBeforeBQSR]] [-mark_duplicate_reads]
        [-realign_indels [-known_indels I.vcf]] [-recalibrate_base_qualities
        [-known_snps K.vcf] [-dump_observations CSV]] [-sort_reads]
        [-checkpoint_dir DIR] [-force_load_bam | -force_load_fastq |
        -force_load_ifastq | -force_load_parquet] [-stringency S]
        [-sort_fastq_output] [--device cuda|cpu]

The stages run in the JAX order: trim, quality trim (here when
``-trimBeforeBQSR``), markdup, realign, BQSR, quality trim, sort.  With
``-checkpoint_dir`` each completed stage is saved there and a rerun of
the same command over the same input resumes after the deepest completed
stage (``pipelines/checkpoint.py``).  ``-stringency`` reaches the
interleaved-FASTQ loader (pairing by name); ``-sort_fastq_output`` sorts
a FASTQ output by read name.

With ``-streaming`` it is the streamed markdup + realign + BQSR pipeline
over a SAM or BAM file, written as Parquet parts::

    python -m adam_tpu_torch transform IN.{sam,sam.gz,bam} OUT.adam -streaming \\
        -mark_duplicate_reads -realign_indels -recalibrate_base_qualities \\
        [-known_snps K.vcf] [-known_indels I.vcf] \\
        [-known_recalibration_table T.npz] [-window_reads N] \\
        [-max_indel_size N] [-max_consensus_number N] \\
        [-log_odds_threshold X] [-max_target_size N] [--run-dir DIR [--resume]]
        [--fault-spec SPEC] [--device cuda|cpu]

``-realign_indels`` realigns with the ``reads`` consensus model, as the
JAX CLI does, or with ``knowns`` when ``-known_indels`` is given (the
``smithwaterman`` model is a library option).  The known-sites VCFs
(``.vcf`` or ``.vcf.gz``) load in the input header's contig index space.
``-known_recalibration_table`` (``-streaming`` only, as in the JAX CLI)
is an ``.npz`` with ``table`` (``[n_rg, 94, n_cyc, 17]``, cast to u8) and
``gl``, applied instead of the solved table; it arms the fused B->C tier
(``ADAM_TPU_FUSED_BC=0`` is the unfused leg).  A BAM's windows follow
its compressed bytes (32 MiB at a time), as in the JAX package.
``--run-dir DIR`` journals the run (``pipelines/checkpoint.RunJournal``)
and ``--resume`` resumes a killed one from it, byte-identical to an
uninterrupted run; ``--fault-spec`` (or ``ADAM_TPU_FAULTS``) arms the
fault points of ``utils/faults.py``, e.g. a SIGKILL at a chosen phase.
The refusals and their messages are the JAX CLI's.  In both
modes the run's stats (stage walls, read counts, kernel launches) are
printed to standard output as one JSON line.

``flagstat`` is the JAX CLI's samtools-style report::

    python -m adam_tpu_torch flagstat INPUT [--device cuda|cpu]

(a ``.adam`` or ``.parquet`` input is read with the flag columns
projected); the stage walls go to standard error as one JSON line.

With ``-shards N`` it is the sharded, out-of-core form of the same
stages (``parallel/sharded.py``): the SAM or BAM input is shuffled into N
genome-bin shards on disk, keyed by the 5'-clipped position, and each
pass runs one shard at a time around the global barriers; part ``i`` is
shard ``i`` and the realigned part comes last::

    python -m adam_tpu_torch transform IN.{sam,bam} OUT.adam -shards N \\
        -mark_duplicate_reads -realign_indels -recalibrate_base_qualities \\
        [-known_snps K.vcf] [-known_indels I.vcf] [-dump_observations CSV] \\
        [tuning flags] [--device cuda|cpu]

``depth`` is the JAX CLI's ``CalculateDepth``: the read depth at each
site of a VCF, by a broadcast region join on the device, or with
``-stream`` through a genome-bin interval spill one bin at a time::

    python -m adam_tpu_torch depth ADAM VCF [-cartesian] [-stream]
        [-bin_size N] [--device cuda|cpu]

``view`` is the JAX CLI's samtools-view clone (``-f/-F/-g/-G`` flag-bit
filters computed on the device, ``-c`` count, else SAM text or a file by
extension)::

    python -m adam_tpu_torch view INPUT [OUTPUT] [-f N] [-F N] [-g N] [-G N]
        [-c] [-o OUTPUT] [--device cuda|cpu]

``count_kmers`` is the JAX CLI's ``CountReadKmers``::

    python -m adam_tpu_torch count_kmers INPUT OUTPUT KMER_LENGTH \\
        [-countQmers] [-printHistogram] [-repartition N] [--device cuda|cpu]

INPUT is a ``.sam[.gz]``, a ``.bam``, a directory or glob of them, or a
Parquet part directory (read with the ``sequence`` and ``qual`` columns
projected when it ends in ``.adam`` or ``.parquet``).  OUTPUT gets one
``kmer, count`` line per k-mer, byte-identical to the JAX CLI's; with
``-printHistogram`` the histogram of counts goes to standard output, and
the stage walls go to standard error as one JSON line.

``count_contig_kmers`` is the JAX CLI's ``CountContigKmers``: the k-mers
of a FASTA (``.fa``/``.fasta``, ``.gz`` too) or a contig-fragment store,
windows across fragment joins counted once, the histogram on the card::

    python -m adam_tpu_torch count_contig_kmers INPUT OUTPUT KMER_LENGTH \\
        [-printHistogram] [--device cuda|cpu]

``adam2fastq`` writes reads as FASTQ (a ``.adam``/``.parquet`` input read
with ``readName``, ``sequence``, ``qual`` and ``flags`` projected unless
``-no-projection``); with OUTPUT2 the pairs split into two mate files
under ``-stringency``::

    python -m adam_tpu_torch adam2fastq INPUT OUTPUT [OUTPUT2] [-no-projection]
        [-stringency S] [--device cuda|cpu]

The output files of both are byte-identical to the JAX CLI's, and the
stage walls go to standard error as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

from adam_tpu_torch.cli import conversions


def _parser() -> argparse.ArgumentParser:
    """The parser; the verbs that check the device and then run carry
    their handler as ``args.handler``."""
    ap = argparse.ArgumentParser(prog="adam_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)
    # reference flags are single-dash long options: prefix matching would
    # make a typo silently match another flag
    p = sub.add_parser(
        "transform", allow_abbrev=False,
        help="load, run read pre-processing stages, save (or -streaming: the "
        "streamed markdup + realign + BQSR over a SAM or BAM file)",
    )
    p.add_argument("input", help="the SAM (.sam, .sam.gz), BAM, FASTQ (.fq, .fastq, "
                   ".ifq), FASTA or Parquet input")
    p.add_argument("output", help="where to write the result: .sam, .bam, .fq, else "
                   "Parquet (a part directory with -streaming)")
    p.add_argument("-streaming", action="store_true",
                   help="the streamed windowed pipeline over SAM/BAM input, "
                   "written as a Parquet part directory")
    p.add_argument("-sort_reads", action="store_true")
    p.add_argument("-mark_duplicate_reads", action="store_true")
    p.add_argument("-recalibrate_base_qualities", action="store_true")
    p.add_argument("-dump_observations", default=None,
                   help="local path to dump BQSR observations to (CSV)")
    p.add_argument("-known_snps", default=None,
                   help="VCF of known SNPs, masked out of the BQSR observations")
    p.add_argument("-known_recalibration_table", default=None,
                   help="npz with 'table' ([n_rg, 94, n_cyc, 17], cast to u8) and "
                   "'gl': applied instead of the table solved at barrier 2 "
                   "(-streaming only)")
    p.add_argument("-realign_indels", action="store_true")
    p.add_argument("-known_indels", default=None,
                   help="VCF of known INDELs; without it the consensus-from-reads "
                   "model is used")
    p.add_argument("-max_indel_size", type=int, default=500)
    p.add_argument("-max_consensus_number", type=int, default=30)
    p.add_argument("-log_odds_threshold", type=float, default=5.0)
    p.add_argument("-max_target_size", type=int, default=3000)
    p.add_argument("-trimReads", action="store_true")
    p.add_argument("-trimFromStart", type=int, default=0)
    p.add_argument("-trimFromEnd", type=int, default=0)
    p.add_argument("-trimReadGroup", default=None)
    p.add_argument("-qualityBasedTrim", action="store_true")
    p.add_argument("-qualityThreshold", type=int, default=20)
    p.add_argument("-trimBeforeBQSR", action="store_true")
    p.add_argument("-repartition", type=int, default=-1,
                   help="no-op: columnar batches have no partition count "
                   "(logged when set)")
    p.add_argument("-coalesce", type=int, default=-1,
                   help="no-op: columnar batches have no partition count "
                   "(logged when set)")
    p.add_argument("-checkpoint_dir", default=None,
                   help="save each completed stage here and resume after the "
                   "deepest completed stage on a rerun")
    p.add_argument("-window_reads", type=int, default=262_144,
                   help="ingest window size in reads for -streaming")
    p.add_argument("-shards", type=int, default=0,
                   help="run as the composed out-of-core sharded pipeline over N "
                   "genome-bin shards (parallel/sharded.py): windowed ingest "
                   "shuffles to 5'-clipped-position bins, per-shard passes with "
                   "global duplicate/target barriers, boundary-correct realign "
                   "tail; supports the markdup/BQSR/realign stage set on "
                   "SAM/BAM input")
    p.add_argument("--run-dir", dest="run_dir", default=None, metavar="DIR",
                   help="durable window-granular resume journal for -streaming: "
                   "each part is recorded after its durable publish, and the "
                   "observe histograms and the table persist as sidecars")
    p.add_argument("--resume", dest="resume", action="store_true",
                   help="resume a killed -streaming run from --run-dir's journal "
                   "(a journal of other input bytes, flags or window plan is "
                   "refused with a clean restart)")
    p.add_argument("--fault-spec", dest="fault_spec", default=None, metavar="SPEC",
                   help="arm fault injection at named points (testing only; e.g. "
                   "'proc.kill=kill,device=pass_c,after=2,times=1'; also "
                   "ADAM_TPU_FAULTS)")
    p.add_argument("-force_load_bam", action="store_true")
    p.add_argument("-force_load_fastq", action="store_true")
    p.add_argument("-force_load_ifastq", action="store_true")
    p.add_argument("-force_load_parquet", action="store_true")
    p.add_argument("-sort_fastq_output", action="store_true",
                   help="sort a .fq/.fastq output by read name")
    conversions.add_common(p)
    p = sub.add_parser(
        "flagstat", allow_abbrev=False,
        help="Print statistics on reads in an ADAM file (similar to samtools flagstat)",
    )
    p.add_argument("input", metavar="INPUT")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the tensor work runs (default: cuda)")
    p = sub.add_parser(
        "depth", allow_abbrev=False,
        help="Calculate the depth from a given ADAM file, at each variant in a VCF")
    p.add_argument("adam", metavar="ADAM", help="The read file to use to calculate depths")
    p.add_argument("vcf", metavar="VCF",
                   help="The VCF containing the sites at which to calculate depths")
    p.add_argument("-cartesian", action="store_true",
                   help="use a cartesian join, then filter")
    p.add_argument("-stream", action="store_true",
                   help="out-of-core: stream the reads through a genome-bin shard "
                   "spill and join one bin at a time (bounded memory on WGS-scale "
                   "input)")
    p.add_argument("-bin_size", type=int, default=1_000_000,
                   help="genome bin width for -stream (default 1Mbp)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the tensor work runs (default: cuda)")
    p = sub.add_parser("view", allow_abbrev=False,
                       help="View certain reads from an alignment-record file.")
    p.add_argument("input", metavar="INPUT")
    p.add_argument("output", metavar="OUTPUT", nargs="?", default=None)
    p.add_argument("-f", dest="match_all", type=int, default=0,
                   help="restrict to reads matching ALL bits in N")
    p.add_argument("-F", dest="mismatch_all", type=int, default=0,
                   help="restrict to reads matching NONE of the bits in N")
    p.add_argument("-g", dest="match_some", type=int, default=0,
                   help="restrict to reads matching ANY of the bits in N")
    p.add_argument("-G", dest="mismatch_some", type=int, default=0,
                   help="restrict to reads mismatching at least one bit in N")
    p.add_argument("-c", dest="print_count", action="store_true",
                   help="print count of matching records")
    p.add_argument("-o", dest="output_flag", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the tensor work runs (default: cuda)")
    p = sub.add_parser("count_kmers", help="Counts the k-mers/q-mers from a read dataset.")
    p.add_argument("input", metavar="INPUT")
    p.add_argument("output", metavar="OUTPUT", help="Location for storing k-mer counts")
    p.add_argument("kmer_length", metavar="KMER_LENGTH", type=int)
    p.add_argument("-countQmers", action="store_true",
                   help="counts q-mers instead of k-mers")
    p.add_argument("-printHistogram", action="store_true",
                   help="prints a histogram of counts")
    p.add_argument("-repartition", type=int, default=-1,
                   help="accepted for parity; batches need no repartition")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the tensor work runs (default: cuda)")
    p = sub.add_parser("count_contig_kmers", allow_abbrev=False,
                       help="Counts the k-mers/q-mers from a contig dataset.")
    p.add_argument("input", metavar="INPUT",
                   help="The ADAM or FASTA file to count kmers from")
    p.add_argument("output", metavar="OUTPUT")
    p.add_argument("kmer_length", metavar="KMER_LENGTH", type=int)
    p.add_argument("-printHistogram", action="store_true")
    conversions.add_common(p)
    p = sub.add_parser("adam2fastq", allow_abbrev=False, help="Convert BAM to FASTQ files")
    p.add_argument("input", metavar="INPUT")
    p.add_argument("output", metavar="OUTPUT")
    p.add_argument("output2", metavar="OUTPUT2", nargs="?", default=None,
                   help="all second-in-pair reads go here, if provided")
    p.add_argument("-no-projection", dest="no_projection", action="store_true")
    p.add_argument("-repartition", type=int, default=-1)
    conversions.add_common(p)
    p.set_defaults(handler=_adam2fastq)
    sub.choices["count_contig_kmers"].set_defaults(handler=_count_contig_kmers)
    conversions.configure(sub)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if getattr(args, "handler", None) is not None:
        from adam_tpu_torch.device import resolve_device

        resolve_device(args.device)
        return args.handler(args)
    if args.command == "count_kmers":
        return _count_kmers(args)
    if args.command == "flagstat":
        return _flagstat(args)
    if args.command == "depth":
        return _depth(args)
    if args.command == "view":
        return _view(args)
    if args.fault_spec:
        from adam_tpu_torch.utils import faults

        try:
            faults.install(args.fault_spec)
        except ValueError as e:
            print(f"--fault-spec: {e}", file=sys.stderr)
            return 2
    return _transform(args)


def _write_kmer_counts(counts: dict, output: str, print_histogram: bool) -> None:
    """'kmer, count' text output and the optional count histogram
    (copied from ``adam_tpu/cli/actions._write_kmer_counts``): k-mer
    counts stay ints, q-mer weights floats."""
    if print_histogram:
        hist: dict[int, int] = {}
        for v in counts.values():
            hist[int(v)] = hist.get(int(v), 0) + 1
        for k in sorted(hist):
            print((k, hist[k]))
    with open(output, "w") as fh:
        for kmer, v in counts.items():
            fh.write(f"{kmer}, {v}\n")


def _count_kmers(args) -> int:
    import time

    from adam_tpu_torch.io import context

    t0 = time.monotonic()
    kw = {}
    if str(args.input).endswith((".adam", ".parquet")):
        kw["projection"] = ["sequence", "qual"]
    ds = context.load_alignments(args.input, **kw)
    t1 = time.monotonic()
    if args.countQmers:
        counts = ds.count_qmers(args.kmer_length, device=args.device)
    else:
        counts = ds.count_kmers(args.kmer_length, device=args.device)
    t2 = time.monotonic()
    _write_kmer_counts(counts, args.output, args.printHistogram)
    stats = {"load_s": t1 - t0, "count_s": t2 - t1, "write_s": time.monotonic() - t2,
             "n_reads": ds.batch.n_valid(), "n_kmers": len(counts)}
    print(json.dumps(stats, sort_keys=True), file=sys.stderr)
    return 0


def _count_contig_kmers(args) -> int:
    import time

    from adam_tpu_torch.formats.fragments import count_contig_kmers
    from adam_tpu_torch.io import context, parquet

    t0 = time.monotonic()
    if str(args.input).endswith((".fa", ".fasta", ".fa.gz", ".fasta.gz")):
        fragments, _sd, _desc = context.load_fasta(args.input)
    else:
        fragments, _sd, _desc = parquet.load_fragments(args.input)
    t1 = time.monotonic()
    counts = count_contig_kmers(fragments, args.kmer_length, device=args.device)
    t2 = time.monotonic()
    _write_kmer_counts(counts, args.output, args.printHistogram)
    stats = {"load_s": t1 - t0, "count_s": t2 - t1, "write_s": time.monotonic() - t2,
             "n_fragments": fragments.n_rows, "n_kmers": len(counts)}
    print(json.dumps(stats, sort_keys=True), file=sys.stderr)
    return 0


def _adam2fastq(args) -> int:
    import time

    from adam_tpu_torch.io import context, fastq

    t0 = time.monotonic()
    kw = {}
    if not args.no_projection and str(args.input).endswith((".adam", ".parquet")):
        kw["projection"] = ["readName", "sequence", "qual", "flags"]
    ds = context.load_alignments(args.input, **kw)
    t1 = time.monotonic()
    if args.output2:
        ds.save_paired_fastq(args.output, args.output2, stringency=args.stringency)
    else:
        fastq.write_fastq(args.output, ds.batch, ds.sidecar)
    print(json.dumps({"load_s": t1 - t0, "write_s": time.monotonic() - t1,
                      "n_reads": ds.batch.n_valid()}, sort_keys=True), file=sys.stderr)
    return 0


def _flagstat(args) -> int:
    import time

    from adam_tpu_torch.io import context
    from adam_tpu_torch.ops.flagstat import flagstat, format_flagstat

    t0 = time.monotonic()
    kw = {}
    if str(args.input).endswith((".adam", ".parquet")):
        kw["projection"] = [
            "flags", "mapq", "readName", "sequence", "contig", "start",
            "mateContig", "mateAlignmentStart",
        ]
    ds = context.load_alignments(args.input, **kw)
    t1 = time.monotonic()
    failed, passed = flagstat(ds.batch, device=args.device)
    t2 = time.monotonic()
    print(format_flagstat(failed, passed))
    print(json.dumps({"load_s": t1 - t0, "flagstat_s": t2 - t1,
                      "n_reads": ds.batch.n_valid()}, sort_keys=True), file=sys.stderr)
    return 0


def _transform(args) -> int:
    if args.resume and not args.run_dir:
        print("transform: --resume needs the journal directory; pass "
              "--run-dir DIR (the same DIR the killed run journaled into)",
              file=sys.stderr)
        return 2
    if args.run_dir and not args.streaming:
        print("transform: --run-dir/--resume journal the -streaming "
              "pipeline only; use -checkpoint_dir for the composed "
              "stage pipeline", file=sys.stderr)
        return 2
    if args.shards and args.shards < 0:
        print(f"transform -shards must be positive (got {args.shards})",
              file=sys.stderr)
        return 2
    if args.window_reads < 1:
        print(f"transform -window_reads must be positive (got {args.window_reads})",
              file=sys.stderr)
        return 2
    if args.shards and args.streaming:
        print("transform -shards and -streaming are mutually exclusive "
              "execution modes; pass one or the other", file=sys.stderr)
        return 2
    if args.shards or args.streaming:
        mode = "-shards" if args.shards else "-streaming"
        base = args.input[:-3] if args.input.endswith(".gz") else args.input
        if (args.trimReads or args.qualityBasedTrim or args.sort_reads
                or not base.endswith((".sam", ".bam"))
                or args.force_load_fastq or args.force_load_ifastq
                or args.force_load_parquet):
            print(f"transform {mode} supports the markdup/BQSR/realign stage set "
                  "on windowed SAM/BAM input; drop it for trim/sort pipelines or "
                  "other formats", file=sys.stderr)
            return 2
        if args.shards:
            return _transform_sharded(args)
        return _transform_streamed(args)
    return _transform_dataset(args)


def _transform_dataset(args) -> int:
    """The non-streaming transform (the JAX CLI's stage composition):
    load, the stages over the whole dataset, save."""
    import logging
    import time

    from adam_tpu_torch.api.datasets import GenotypeDataset
    from adam_tpu_torch.device import resolve_device
    from adam_tpu_torch.io import context
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.pipelines.checkpoint import (
        compose_fingerprint,
        input_fingerprint,
        run_stages,
    )

    dev = resolve_device(args.device)
    launches0 = kernels.launches()
    stats: dict = {"device": str(dev), "stages_run": []}
    t_start = time.monotonic()
    if args.force_load_bam:
        ds = context.load_bam(args.input)
    elif args.force_load_fastq:
        ds = context.load_fastq(args.input)
    elif args.force_load_ifastq:
        ds = context.load_interleaved_fastq(args.input, stringency=args.stringency)
    elif args.force_load_parquet:
        ds = context.load_parquet_alignments(args.input)
    else:
        ds = context.load_alignments(args.input, stringency=args.stringency)
    stats["load_s"] = time.monotonic() - t_start
    stats["n_reads"] = ds.batch.n_valid()
    if args.repartition != -1 or args.coalesce != -1:
        logging.getLogger(__name__).warning(
            "-repartition/-coalesce are no-ops here: columnar batches "
            "have no RDD partition count"
        )

    def stage(name, fn):
        def run(ds):
            t0 = time.monotonic()
            out = fn(ds)
            stats[f"{name}_s"] = time.monotonic() - t0
            stats["stages_run"].append(name)
            return out
        return name, run

    def trim(ds):
        from adam_tpu_torch.pipelines import trim as trim_mod

        rg_idx = None
        if args.trimReadGroup is not None:
            rg_idx = ds.header.read_groups.names.index(args.trimReadGroup)
        return trim_mod.trim_reads(ds, args.trimFromStart, args.trimFromEnd,
                                   rg_idx=rg_idx)

    def quality_trim(ds):
        return ds.trim_low_quality_read_groups(args.qualityThreshold, device=dev)

    def realign(ds):
        kw = dict(max_indel_size=args.max_indel_size,
                  max_consensus_number=args.max_consensus_number,
                  lod_threshold=args.log_odds_threshold,
                  max_target_size=args.max_target_size, device=dev)
        if args.known_indels:
            gt = GenotypeDataset.load(args.known_indels, contig_names=ds.seq_dict.names)
            return ds.realign_indels(consensus_model="knowns",
                                     known_indels=gt.indel_table(), **kw)
        return ds.realign_indels(consensus_model="reads", **kw)

    def bqsr(ds):
        known = None
        if args.known_snps:
            known = GenotypeDataset.load(
                args.known_snps, contig_names=ds.seq_dict.names).snp_table()
        return ds.recalibrate_base_qualities(
            known_snps=known, dump_observation_table=args.dump_observations,
            device=dev, stats=stats)

    stages = []
    if args.trimReads:
        stages.append(stage("trim", trim))
    if args.qualityBasedTrim and args.trimBeforeBQSR:
        stages.append(stage("quality_trim", quality_trim))
    if args.mark_duplicate_reads:
        stages.append(stage("mark_duplicates", lambda ds: ds.mark_duplicates(device=dev)))
    if args.realign_indels:
        stages.append(stage("realign_indels", realign))
    if args.recalibrate_base_qualities:
        stages.append(stage("bqsr", bqsr))
    if args.qualityBasedTrim and not args.trimBeforeBQSR:
        stages.append(stage("quality_trim", quality_trim))
    if args.sort_reads:
        stages.append(stage("sort", lambda ds: ds.sort_by_reference_position()))

    fp = None
    if args.checkpoint_dir:
        # input content identity + every stage-affecting flag value: a
        # rerun over other bytes or retuned knobs invalidates the stores
        fp = compose_fingerprint({
            "input": input_fingerprint(args.input),
            "trimFromStart": args.trimFromStart,
            "trimFromEnd": args.trimFromEnd,
            "trimReadGroup": args.trimReadGroup,
            "qualityThreshold": args.qualityThreshold,
            # known-sites files fingerprint by content, not path
            "known_snps": (input_fingerprint(args.known_snps)
                           if args.known_snps else None),
            "known_indels": (input_fingerprint(args.known_indels)
                             if args.known_indels else None),
            "max_indel_size": args.max_indel_size,
            "max_consensus_number": args.max_consensus_number,
            "log_odds_threshold": args.log_odds_threshold,
            "max_target_size": args.max_target_size,
        })
    ds = run_stages(ds, stages, checkpoint_dir=args.checkpoint_dir, fingerprint=fp)
    t0 = time.monotonic()
    if args.sort_fastq_output and str(args.output).endswith((".fq", ".fastq")):
        # name-sorted FASTQ export
        import numpy as np

        from adam_tpu_torch.formats.strings import StringColumn

        names = StringColumn.of(ds.sidecar.names).to_fixed_bytes()
        ds = ds.take_rows(np.argsort(names, kind="stable"))
    ds.save(args.output, compression=args.parquet_compression_codec)
    stats["save_s"] = time.monotonic() - t0
    stats["n_rows_out"] = ds.batch.n_valid()
    stats["total_s"] = time.monotonic() - t_start
    stats["reads_per_s"] = stats["n_reads"] / stats["total_s"] if stats["total_s"] else 0.0
    now = kernels.launches()
    stats["kernel_launches"] = {k: now[k] - launches0[k] for k in now}
    print(json.dumps(stats, sort_keys=True))
    return 0


def _known_sites(args) -> tuple:
    """The ``-known_snps`` / ``-known_indels`` tables, in the input
    header's contig index space -> (SnpTable | None, IndelTable | None)."""
    from adam_tpu_torch.api.datasets import GenotypeDataset

    known = indels = None
    if args.known_snps or args.known_indels:
        from adam_tpu_torch.io.context import load_header

        names = load_header(args.input).seq_dict.names
        if args.known_snps:
            known = GenotypeDataset.load(args.known_snps, contig_names=names).snp_table()
        if args.known_indels:
            indels = GenotypeDataset.load(args.known_indels,
                                          contig_names=names).indel_table()
    return known, indels


def _transform_sharded(args) -> int:
    from adam_tpu_torch.parallel.sharded import transform_sharded

    known, indels = _known_sites(args)
    stats = transform_sharded(
        args.input, args.output, args.shards,
        mark_duplicates=args.mark_duplicate_reads,
        recalibrate=args.recalibrate_base_qualities,
        realign=args.realign_indels,
        known_snps=known,
        known_indels=indels,
        compression=args.parquet_compression_codec,
        max_indel_size=args.max_indel_size,
        max_consensus_number=args.max_consensus_number,
        lod_threshold=args.log_odds_threshold,
        max_target_size=args.max_target_size,
        dump_observations=args.dump_observations,
        device=args.device,
    )
    print(json.dumps(stats, sort_keys=True))
    return 0


def _depth(args) -> int:
    """Read depth at each VCF site (the JAX CLI's ``CalculateDepth``): the
    report on standard output, byte for byte the JAX CLI's; the walls on
    standard error as one JSON line."""
    import time

    import numpy as np
    import torch

    from adam_tpu_torch.api.datasets import GenotypeDataset
    from adam_tpu_torch.device import resolve_device
    from adam_tpu_torch.io import context
    from adam_tpu_torch.pipelines.region_join import IntervalArrays, broadcast_region_join

    dev = resolve_device(args.device)
    t0 = time.monotonic()
    proj = None
    if str(args.adam).endswith((".adam", ".parquet")):
        # the join reads only coordinates: the projection is pushed down
        proj = ["contig", "start", "end", "flags"]
    if args.stream:
        from adam_tpu_torch.parallel.sharded_join import streamed_depth

        header = context.load_header(args.adam)
        gt = GenotypeDataset.load(args.vcf, contig_names=header.seq_dict.names)
        v = gt.variants
        sites = IntervalArrays.of(v.contig_idx, v.start, np.asarray(v.start) + 1, device=dev)
        t1 = time.monotonic()
        depth = streamed_depth(context.iter_alignment_batches(args.adam, projection=proj),
                               sites, header.seq_dict, bin_size=args.bin_size)
    else:
        ds = context.load_alignments(args.adam, **({"projection": proj} if proj else {}))
        b = ds.batch.to_numpy()
        mapped = np.flatnonzero(np.asarray(b.is_mapped) & np.asarray(b.valid))
        reads = IntervalArrays.of(b.contig_idx[mapped], b.start[mapped], b.end[mapped],
                                  device=dev)
        gt = GenotypeDataset.load(args.vcf, contig_names=ds.seq_dict.names)
        v = gt.variants
        # the variant's position, as the reference keys it
        sites = IntervalArrays.of(v.contig_idx, v.start, np.asarray(v.start) + 1, device=dev)
        t1 = time.monotonic()
        si, _ri = broadcast_region_join(sites, reads)
        depth = torch.bincount(si, minlength=len(sites))
    depth = depth.cpu().numpy()
    t2 = time.monotonic()
    names = v.sidecar.names
    # the extended contig space: VCF-only contigs follow the read dictionary
    contig_names = gt.contig_names
    lines = ["location\tname\tdepth"]
    for i in np.lexsort((v.start, v.contig_idx)):
        loc = "%s:%d" % (contig_names[v.contig_idx[i]], int(v.start[i]))
        lines.append("%20s\t%15s\t% 5d" % (loc, names[i] or ".", int(depth[i])))
    print("\n".join(lines))
    print(json.dumps({"load_s": t1 - t0, "depth_s": t2 - t1, "n_sites": len(v),
                      "stream": bool(args.stream)}, sort_keys=True), file=sys.stderr)
    return 0


def _view_mask(flags, args):
    """The JAX CLI's ``View`` filter on a flags tensor -> bool tensor on
    its device: the twelve per-bit predicates (View.scala:103-127), where
    0x8 also requires the read to be paired (the reference's mate-mapped
    quirk), under ``-f`` (all), ``-F`` (none), ``-g`` (any) and ``-G``
    (at least one bit clear)."""
    import torch

    def pred(bit):
        if bit == 0x8:
            return ((flags & 0x1) != 0) & ((flags & 0x8) != 0)
        return (flags & bit) != 0

    bits = [1 << i for i in range(12)]
    keep = torch.ones(flags.shape, dtype=torch.bool, device=flags.device)
    for bit in bits:
        if args.match_all & bit:
            keep &= pred(bit)
        if args.mismatch_all & bit:
            keep &= ~pred(bit)
    for group, want in ((args.match_some, True), (args.mismatch_some, False)):
        if group:
            some = torch.zeros_like(keep)
            for bit in bits:
                if group & bit:
                    some |= pred(bit) == want
            keep &= some
    return keep


def _view(args) -> int:
    import numpy as np
    import torch

    from adam_tpu_torch.device import resolve_device
    from adam_tpu_torch.io import context, sam

    dev = resolve_device(args.device)
    output = args.output or args.output_flag
    ds = context.load_alignments(args.input)
    b = ds.batch.to_numpy()
    keep = _view_mask(torch.from_numpy(np.asarray(b.flags)).to(dev), args)
    keep &= torch.from_numpy(np.asarray(b.valid)).to(dev)
    ds = ds.take_rows(np.flatnonzero(keep.cpu().numpy()))
    if output:
        ds.save(output)
    elif args.print_count:
        print(len(ds))
    else:
        out = sys.stdout
        for line in sam.format_sam_records(ds.batch, ds.sidecar, ds.header):
            out.write(line + "\n")
    return 0


def _transform_streamed(args) -> int:
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    known, indels = _known_sites(args)
    table = None
    if args.known_recalibration_table:
        import numpy as np

        # cast to u8 by convert.table_from_numpy inside the transform
        with np.load(args.known_recalibration_table) as z:
            table = (np.asarray(z["table"]), int(z["gl"]))
    stats = transform_streamed(
        args.input, args.output,
        mark_duplicates=args.mark_duplicate_reads,
        recalibrate=args.recalibrate_base_qualities,
        realign=args.realign_indels,
        known_snps=known,
        known_indels=indels,
        known_table=table,
        window_reads=args.window_reads,
        compression=args.parquet_compression_codec,
        max_indel_size=args.max_indel_size,
        max_consensus_number=args.max_consensus_number,
        lod_threshold=args.log_odds_threshold,
        max_target_size=args.max_target_size,
        dump_observations=args.dump_observations,
        run_dir=args.run_dir,
        resume=args.resume,
        device=args.device,
    )
    print(json.dumps(stats, sort_keys=True))
    return 0
