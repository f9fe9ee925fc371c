"""Command line of the port: ``python -m adam_tpu_torch transform ...``
and ``python -m adam_tpu_torch count_kmers ...``.

Flag spellings follow the JAX package's CLI.  ``transform`` runs the
streamed markdup + realign + BQSR transform over a SAM or BAM file::

    python -m adam_tpu_torch transform IN.{sam,sam.gz,bam} OUT.adam -streaming \\
        -mark_duplicate_reads -realign_indels -recalibrate_base_qualities \\
        [-known_snps K.vcf] [-known_indels I.vcf] \\
        [-known_recalibration_table T.npz] [-window_reads N] \\
        [-max_indel_size N] [-max_consensus_number N] \\
        [-log_odds_threshold X] [-max_target_size N] [--device cuda|cpu]

``-realign_indels`` realigns with the ``reads`` consensus model, as the
JAX CLI does, or with ``knowns`` when ``-known_indels`` is given (the
``smithwaterman`` model is a library option of ``transform_streamed``).
The known-sites VCFs (``.vcf`` or ``.vcf.gz``) load in the input
header's contig index space.  ``-known_recalibration_table`` is an
``.npz`` with ``table`` (``[n_rg, 94, n_cyc, 17]``, cast to u8) and
``gl``, applied instead of the solved table; it arms the fused B->C tier
(``ADAM_TPU_FUSED_BC=0`` is the unfused leg).  A BAM's windows follow
its compressed bytes (32 MiB at a time), as in the JAX package, so a
window usually holds more than ``-window_reads`` reads.  On success the
run's stats (stage walls, read counts, kernel launches) are printed to
standard output as one JSON line.

``count_kmers`` is the JAX CLI's ``CountReadKmers``::

    python -m adam_tpu_torch count_kmers INPUT OUTPUT KMER_LENGTH \\
        [-countQmers] [-printHistogram] [-repartition N] [--device cuda|cpu]

INPUT is a ``.sam[.gz]``, a ``.bam``, a directory or glob of them, or a
Parquet part directory (read with the ``sequence`` and ``qual`` columns
projected when it ends in ``.adam`` or ``.parquet``).  OUTPUT gets one
``kmer, count`` line per k-mer, byte-identical to the JAX CLI's; with
``-printHistogram`` the histogram of counts goes to standard output, and
the stage walls go to standard error as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="adam_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser(
        "transform",
        help="markdup + realign + BQSR over a SAM or BAM file -> Parquet parts",
    )
    p.add_argument("input", help="input SAM (.sam or .sam.gz) or BAM (.bam)")
    p.add_argument("output", help="output directory of Parquet parts")
    p.add_argument("-streaming", action="store_true",
                   help="the streamed windowed pipeline (the only mode ported)")
    p.add_argument("-mark_duplicate_reads", action="store_true")
    p.add_argument("-recalibrate_base_qualities", action="store_true")
    p.add_argument("-realign_indels", action="store_true")
    p.add_argument("-known_snps", default=None,
                   help="VCF of known SNPs, masked out of the BQSR observations")
    p.add_argument("-known_indels", default=None,
                   help="VCF of known INDELs; without it the consensus-from-reads "
                   "model is used")
    p.add_argument("-known_recalibration_table", default=None,
                   help="npz with 'table' ([n_rg, 94, n_cyc, 17], cast to u8) and "
                   "'gl': applied instead of the table solved at barrier 2")
    p.add_argument("-max_indel_size", type=int, default=500)
    p.add_argument("-max_consensus_number", type=int, default=30)
    p.add_argument("-log_odds_threshold", type=float, default=5.0)
    p.add_argument("-max_target_size", type=int, default=3000)
    p.add_argument("-dump_observations", default=None,
                   help="local path to dump BQSR observations to (CSV)")
    p.add_argument("-window_reads", type=int, default=262_144,
                   help="ingest window size in reads")
    p.add_argument("-parquet_compression_codec", default="zstd",
                   choices=["uncompressed", "snappy", "gzip", "zstd"])
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
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.command == "count_kmers":
        return _count_kmers(args)
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


def _transform(args) -> int:
    if not args.streaming:
        print("adam_tpu_torch transform runs only the -streaming pipeline; "
              "pass -streaming", file=sys.stderr)
        return 2
    if args.window_reads <= 0:
        print(f"-window_reads must be positive (got {args.window_reads})",
              file=sys.stderr)
        return 2
    base = args.input[:-3] if args.input.endswith(".gz") else args.input
    if not base.endswith((".sam", ".bam")):
        print("adam_tpu_torch transform -streaming reads windowed SAM/BAM input "
              f"(.sam, .sam.gz, .bam), not {args.input}", file=sys.stderr)
        return 2
    from adam_tpu_torch.api.datasets import GenotypeDataset
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    known = indels = table = None
    if args.known_snps or args.known_indels:
        from adam_tpu_torch.io.context import load_header

        names = load_header(args.input).seq_dict.names
        if args.known_snps:
            known = GenotypeDataset.load(args.known_snps, contig_names=names).snp_table()
        if args.known_indels:
            indels = GenotypeDataset.load(args.known_indels,
                                          contig_names=names).indel_table()
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
        device=args.device,
    )
    print(json.dumps(stats, sort_keys=True))
    return 0
