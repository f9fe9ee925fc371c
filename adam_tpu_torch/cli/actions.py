"""The ADAM ACTIONS verbs of the port's command line (the counterparts
of ``adam_tpu/cli/actions.py``): ``depth``, ``count_kmers``,
``count_contig_kmers``, ``transform``, ``adam2fastq``, ``plugin`` and
``flatten``.

Flag spellings, stage order, checkpoint fingerprints and refusal messages
follow the JAX package's CLI.  ``transform`` runs in one of four modes.

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
The refusals and their messages are the JAX CLI's.  In these modes the
run's stats (stage walls, read counts, kernel launches) are printed to
standard output as one JSON line.

With ``-shards N`` it is the sharded, out-of-core form of the same
stages (``parallel/sharded.py``): the SAM or BAM input is shuffled into N
genome-bin shards on disk, keyed by the 5'-clipped position, and each
pass runs one shard at a time around the global barriers; part ``i`` is
shard ``i`` and the realigned part comes last::

    python -m adam_tpu_torch transform IN.{sam,bam} OUT.adam -shards N \\
        -mark_duplicate_reads -realign_indels -recalibrate_base_qualities \\
        [-known_snps K.vcf] [-known_indels I.vcf] [-dump_observations CSV] \\
        [tuning flags] [--device cuda|cpu]

With ``-backend spark`` the process is the Spark embedding executor
(``api/spark_executor.py``): the file paths are ignored (pass ``- -``),
one Arrow IPC stream of partitions comes in on standard input and one
batch per partition goes out on standard output, after markdup, realign
and BQSR as the stage flags ask (``-known_snps``, ``-known_indels``)::

    python -m adam_tpu_torch transform - - -backend spark [-mark_duplicate_reads]
        [-realign_indels [-known_indels I.vcf]] [-recalibrate_base_qualities
        [-known_snps K.vcf]] [--device cuda|cpu] < parts.arrows > out.arrows

Its stats (partitions, reads, walls, kernel launches) go to standard
error as one JSON line; standard output carries nothing but the stream.

``depth`` is the JAX CLI's ``CalculateDepth``: the read depth at each
site of a VCF, by a broadcast region join on the device, or with
``-stream`` through a genome-bin interval spill one bin at a time::

    python -m adam_tpu_torch depth ADAM VCF [-cartesian] [-stream]
        [-bin_size N] [--device cuda|cpu]

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

``plugin PLUGIN INPUT [-access_control AC] [-plugin_args "A B"]`` loads
the :class:`~adam_tpu_torch.plugins.AdamPlugin` named by a dotted path,
runs it over INPUT and prints each row it returns; ``flatten INPUT
OUTPUT`` writes a Parquet file with its nested columns flattened
(``utils/flattener.py``), byte for byte the JAX verb's file.
"""

from __future__ import annotations

import json
import sys

from adam_tpu_torch.cli.main import Command
from adam_tpu_torch.utils import instrumentation as ins


class CalculateDepth(Command):
    name = "depth"
    description = "Calculate the depth from a given ADAM file, at each variant in a VCF"

    @classmethod
    def configure(cls, p):
        p.add_argument("adam", metavar="ADAM",
                       help="The read file to use to calculate depths")
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

    @classmethod
    def run(cls, args):
        return _depth(args)


class CountReadKmers(Command):
    name = "count_kmers"
    description = "Counts the k-mers/q-mers from a read dataset."

    @classmethod
    def configure(cls, p):
        p.add_argument("input", metavar="INPUT")
        p.add_argument("output", metavar="OUTPUT", help="Location for storing k-mer counts")
        p.add_argument("kmer_length", metavar="KMER_LENGTH", type=int)
        p.add_argument("-countQmers", action="store_true",
                       help="counts q-mers instead of k-mers")
        p.add_argument("-printHistogram", action="store_true",
                       help="prints a histogram of counts")
        p.add_argument("-repartition", type=int, default=-1,
                       help="accepted for parity; batches need no repartition")

    @classmethod
    def run(cls, args):
        return _count_kmers(args)


class CountContigKmers(Command):
    name = "count_contig_kmers"
    description = "Counts the k-mers/q-mers from a contig dataset."

    @classmethod
    def configure(cls, p):
        p.add_argument("input", metavar="INPUT",
                       help="The ADAM or FASTA file to count kmers from")
        p.add_argument("output", metavar="OUTPUT")
        p.add_argument("kmer_length", metavar="KMER_LENGTH", type=int)
        p.add_argument("-printHistogram", action="store_true")

    @classmethod
    def run(cls, args):
        return _count_contig_kmers(args)


class Transform(Command):
    name = "transform"
    description = ("Convert SAM/BAM to ADAM format and optionally perform "
                   "read pre-processing transformations")

    @classmethod
    def configure(cls, p):
        p.add_argument("input", help="the SAM (.sam, .sam.gz), BAM, FASTQ (.fq, .fastq, "
                       ".ifq), FASTA or Parquet input (- with -backend spark)")
        p.add_argument("output", help="where to write the result: .sam, .bam, .fq, else "
                       "Parquet (a part directory with -streaming; - with -backend "
                       "spark)")
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
        p.add_argument("-sort_fastq_output", action="store_true",
                       help="sort a .fq/.fastq output by read name")
        p.add_argument("-checkpoint_dir", default=None,
                       help="save each completed stage here and resume after the "
                       "deepest completed stage on a rerun")
        p.add_argument("--report", dest="report", default=None, metavar="PATH",
                       help="write the analyzer run report (per-device busy/idle "
                       "attribution, barrier decomposition, critical path, latency "
                       "quantiles: the 'analyze' view of this run) to PATH on "
                       "completion; -streaming only")
        p.add_argument("-window_reads", type=int, default=262_144,
                       help="ingest window size in reads for -streaming")
        p.add_argument("--run-dir", dest="run_dir", default=None, metavar="DIR",
                       help="durable window-granular resume journal for -streaming: "
                       "each part is recorded after its durable publish, and the "
                       "observe histograms and the table persist as sidecars")
        p.add_argument("--resume", dest="resume", action="store_true",
                       help="resume a killed -streaming run from --run-dir's journal "
                       "(a journal of other input bytes, flags or window plan is "
                       "refused with a clean restart)")
        p.add_argument("-shards", type=int, default=0,
                       help="run as the composed out-of-core sharded pipeline over N "
                       "genome-bin shards (parallel/sharded.py): windowed ingest "
                       "shuffles to 5'-clipped-position bins, per-shard passes with "
                       "global duplicate/target barriers, boundary-correct realign "
                       "tail; supports the markdup/BQSR/realign stage set on "
                       "SAM/BAM input")
        p.add_argument("-backend", default="tpu", choices=["tpu", "spark"],
                       help="execution backend: 'tpu' runs the pipeline here; 'spark' "
                       "is the embedding mode, where this process is the "
                       "per-partition executor of an Arrow IPC stream on stdin/stdout "
                       "(pass - - for the paths)")
        p.add_argument("-force_load_bam", action="store_true")
        p.add_argument("-force_load_fastq", action="store_true")
        p.add_argument("-force_load_ifastq", action="store_true")
        p.add_argument("-force_load_parquet", action="store_true")

    @classmethod
    def run(cls, args):
        return _transform(args)


class Adam2Fastq(Command):
    name = "adam2fastq"
    description = "Convert BAM to FASTQ files"

    @classmethod
    def configure(cls, p):
        p.add_argument("input", metavar="INPUT")
        p.add_argument("output", metavar="OUTPUT")
        p.add_argument("output2", metavar="OUTPUT2", nargs="?", default=None,
                       help="all second-in-pair reads go here, if provided")
        p.add_argument("-no-projection", dest="no_projection", action="store_true")
        p.add_argument("-repartition", type=int, default=-1)

    @classmethod
    def run(cls, args):
        return _adam2fastq(args)


class PluginExecutor(Command):
    name = "plugin"
    description = "Executes an AdamPlugin"

    @classmethod
    def configure(cls, p):
        p.add_argument("plugin", metavar="PLUGIN",
                       help="dotted path of the AdamPlugin to run")
        p.add_argument("input", metavar="INPUT")
        p.add_argument("-access_control", default=None,
                       help="dotted path of an AccessControl class")
        p.add_argument("-plugin_args", default="",
                       help="string of args passed to the plugin, split on spaces")

    @classmethod
    def run(cls, args):
        from adam_tpu_torch import plugins

        plugin = plugins.load_plugin(args.plugin)
        ac = None
        if args.access_control:
            ac = plugins.load_plugin(args.access_control, base=plugins.AccessControl)
        out = plugins.execute_plugin(plugin, args.input, args.plugin_args.split(), ac,
                                     device=args.device)
        if out is not None:
            for row in out:
                print(row)
        return 0


class Flatten(Command):
    name = "flatten"
    description = ("Convert a ADAM format file to a version with a flattened "
                   "schema, suitable for querying with tools like Impala")

    @classmethod
    def configure(cls, p):
        p.add_argument("input", metavar="INPUT")
        p.add_argument("output", metavar="OUTPUT")

    @classmethod
    def run(cls, args):
        from adam_tpu_torch.utils.flattener import flatten_parquet

        flatten_parquet(args.input, args.output, compression=args.parquet_compression_codec)
        return 0


COMMANDS = [
    CalculateDepth,
    CountReadKmers,
    CountContigKmers,
    Transform,
    Adam2Fastq,
    PluginExecutor,
    Flatten,
]


def _transform_spark(args) -> int:
    """``transform -backend spark - -``: serve the Arrow IPC stream of
    partitions on stdin (``api/spark_executor.serve``), the stats line on
    stderr."""
    import time

    from adam_tpu_torch.api.datasets import GenotypeDataset
    from adam_tpu_torch.api.spark_executor import StageConfig, serve
    from adam_tpu_torch.ops import kernels

    cfg = StageConfig(
        mark_duplicates=bool(args.mark_duplicate_reads),
        recalibrate=bool(args.recalibrate_base_qualities),
        realign=bool(args.realign_indels),
        device=args.device,
    )
    if args.known_snps:
        cfg.known_snps = GenotypeDataset.load(args.known_snps).snp_table()
    if args.known_indels:
        cfg.known_indels = GenotypeDataset.load(args.known_indels).indel_table()
    launches0 = kernels.launches()
    stats: dict = {"device": args.device}
    t0 = time.monotonic()
    serve(cfg, stats=stats)
    stats["total_s"] = time.monotonic() - t0
    stats["reads_per_s"] = stats["n_reads"] / stats["total_s"] if stats["total_s"] else 0.0
    now = kernels.launches()
    stats["kernel_launches"] = {k: now[k] - launches0[k] for k in now}
    print(json.dumps(stats, sort_keys=True), file=sys.stderr)
    return 0


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
    with ins.TIMERS.time(ins.LOAD_ALIGNMENTS):
        kw = {}
        if str(args.input).endswith((".adam", ".parquet")):
            kw["projection"] = ["sequence", "qual"]
        ds = context.load_alignments(args.input, **kw)
    t1 = time.monotonic()
    with ins.TIMERS.time(ins.COUNT_KMERS):
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
    with ins.TIMERS.time(ins.COUNT_KMERS):
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


def _transform(args) -> int:
    if args.backend == "spark":
        return _transform_spark(args)
    # the observability sinks only the -streaming pipeline produces: warn
    # up front instead of exiting 0 with an artifact silently missing
    if args.report and not args.streaming:
        print("transform: --report is only produced by the -streaming "
              f"pipeline; {args.report} will not be written (use "
              "--metrics-json/--trace-out + 'python -m adam_tpu_torch analyze' for "
              "other modes)", file=sys.stderr)
    if args.progress and not args.streaming:
        print("transform: --progress heartbeat is emitted by the "
              "-streaming pipeline only; no lines will be written",
              file=sys.stderr)
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
    with ins.TIMERS.time(ins.LOAD_ALIGNMENTS):
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

    def stage(name, fn, timer=None):
        def run(ds):
            t0 = time.monotonic()
            if timer is None:
                out = fn(ds)
            else:
                with ins.TIMERS.time(timer):
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
    # the named timers of the JAX CLI's stages (quality trim has none)
    if args.trimReads:
        stages.append(stage("trim", trim, ins.TRIM_READS))
    if args.qualityBasedTrim and args.trimBeforeBQSR:
        stages.append(stage("quality_trim", quality_trim))
    if args.mark_duplicate_reads:
        stages.append(stage("mark_duplicates", lambda ds: ds.mark_duplicates(device=dev),
                            ins.MARK_DUPLICATES))
    if args.realign_indels:
        stages.append(stage("realign_indels", realign, ins.REALIGN_INDELS))
    if args.recalibrate_base_qualities:
        stages.append(stage("bqsr", bqsr, ins.BQSR))
    if args.qualityBasedTrim and not args.trimBeforeBQSR:
        stages.append(stage("quality_trim", quality_trim))
    if args.sort_reads:
        stages.append(stage("sort", lambda ds: ds.sort_by_reference_position(),
                            ins.SORT_READS))

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
    with ins.TIMERS.time(ins.SAVE_OUTPUT):
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


def _transform_streamed(args) -> int:
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    if args.report:
        # pre-flight the report path before the run: a mistyped directory
        # fails in milliseconds, not after the pipeline
        try:
            with open(args.report, "a"):
                pass
        except OSError as e:
            print(f"transform: cannot write --report {args.report}: {e}",
                  file=sys.stderr)
            return 2
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
        progress=args.progress,
        devices=args.devices,
        partitioner=args.partitioner,
        device=args.device,
    )
    print(json.dumps(stats, sort_keys=True))
    if args.report:
        # the analyzer view of this run, from the trace of the global
        # tracer (main() switched recording on for --report)
        from adam_tpu_torch.utils import analyzer
        from adam_tpu_torch.utils import telemetry as tele

        report = analyzer.analyze(tele.TRACE.to_chrome_trace())
        try:
            with open(args.report, "w") as fh:
                fh.write(analyzer.render_report(report) + "\n")
        except OSError as e:
            # the dataset is written and valid: a failed report write
            # must not turn the run into a failure
            print(f"transform: report write to {args.report} failed: {e}",
                  file=sys.stderr)
    return 0
