"""Command line of the port: ``python -m adam_tpu_torch transform ...``.

Flag spellings follow the JAX package's CLI.  The port runs the streamed
markdup + realign + BQSR transform::

    python -m adam_tpu_torch transform IN.sam OUT.adam -streaming \\
        -mark_duplicate_reads -realign_indels -recalibrate_base_qualities \\
        [-known_snps K.vcf] [-known_indels I.vcf] \\
        [-known_recalibration_table T.npz] [-window_reads N] \\
        [--device cuda|cpu]

``-realign_indels`` realigns with the ``reads`` consensus model, as the
JAX CLI does, or with ``knowns`` when ``-known_indels`` is given (the
``smithwaterman`` model is a library option of ``transform_streamed``).
The known-sites VCFs (``.vcf`` or ``.vcf.gz``) load in the SAM header's
contig index space.  ``-known_recalibration_table`` is an ``.npz`` with
``table`` (u8[n_rg, 94, 2*gl+1, 17]) and ``gl``, applied instead of the
solved table; it arms the fused B->C tier (``ADAM_TPU_FUSED_BC=0`` is
the unfused leg).

On success the run's stats (stage walls, read counts, kernel launches)
are printed to standard output as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="adam_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser(
        "transform", help="markdup + realign + BQSR over a SAM file -> Parquet parts"
    )
    p.add_argument("input", help="input SAM (.sam or .sam.gz)")
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
                   help="npz with 'table' (u8[n_rg, 94, 2*gl+1, 17]) and 'gl': "
                   "applied instead of the table solved at barrier 2")
    p.add_argument("-dump_observations", default=None,
                   help="local path to dump BQSR observations to (CSV)")
    p.add_argument("-window_reads", type=int, default=262_144,
                   help="ingest window size in reads")
    p.add_argument("-parquet_compression_codec", default="zstd",
                   choices=["uncompressed", "snappy", "gzip", "zstd"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the tensor work runs (default: cuda)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if not args.streaming:
        print("adam_tpu_torch transform runs only the -streaming pipeline; "
              "pass -streaming", file=sys.stderr)
        return 2
    if args.window_reads <= 0:
        print(f"-window_reads must be positive (got {args.window_reads})",
              file=sys.stderr)
        return 2
    from adam_tpu_torch.api.datasets import GenotypeDataset
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    known = indels = table = None
    if args.known_snps or args.known_indels:
        from adam_tpu_torch.io.sam import peek_sam_header

        names = peek_sam_header(args.input).seq_dict.names
        if args.known_snps:
            known = GenotypeDataset.load(args.known_snps, contig_names=names).snp_table()
        if args.known_indels:
            indels = GenotypeDataset.load(args.known_indels,
                                          contig_names=names).indel_table()
    if args.known_recalibration_table:
        import numpy as np

        # checked by convert.table_from_numpy inside the transform
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
        dump_observations=args.dump_observations,
        device=args.device,
    )
    print(json.dumps(stats, sort_keys=True))
    return 0
