"""The PRINT verbs of the port's command line (the counterparts of
``adam_tpu/cli/printers.py``): ``print``, ``print_genes``, ``flagstat``,
``print_tags``, ``listdict``, ``allelecount``, ``buildinfo``, ``view``
and ``analyze``.

Each prints what the JAX verb prints, byte for byte, on the same input:

    python -m adam_tpu_torch print FILE... [-o OUT] [-pretty] [-projection C1,C2]
    python -m adam_tpu_torch print_genes GTF
    python -m adam_tpu_torch flagstat INPUT [--device cuda|cpu]
    python -m adam_tpu_torch print_tags INPUT [-list N] [-count TAG1,TAG2]
    python -m adam_tpu_torch listdict INPUT
    python -m adam_tpu_torch allelecount {VCF,GENOTYPE_STORE} OUTPUT
    python -m adam_tpu_torch buildinfo
    python -m adam_tpu_torch view INPUT [OUTPUT] [-f N] [-F N] [-g N] [-G N]
        [-c] [-o OUTPUT] [--device cuda|cpu]
    python -m adam_tpu_torch analyze ARTIFACT [-json PATH] [--device-trace XPROF]

``flagstat`` is the samtools-style report (a ``.adam`` or ``.parquet``
input is read with the flag columns projected), its masked sums on the
device; its walls go to standard error as one JSON line.  ``view`` is the
samtools-view clone: the ``-f/-F/-g/-G`` flag-bit filters computed on the
device, ``-c`` the count, else SAM text or a file by extension.  The
others are host code, as in the JAX package.  ``buildinfo`` prints the
port's version, torch's, CUDA's, Python's and the device kind (the card's
name when there is one, else ``cpu``); it checks no device.  ``analyze``
renders the run report of a ``--metrics-json`` snapshot or a
``--trace-out`` Chrome trace of either package (``utils/analyzer.py``);
it checks no device either.  With ``--device-trace`` (this package's
option) it adds a section from the ``--xprof-dir`` trace of the same
run: the device's busy share over the run window and its ten longest
idle gaps, each named by the main-thread span that covers it.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from adam_tpu_torch.cli.main import Command
from adam_tpu_torch.formats import schema
from adam_tpu_torch.utils import instrumentation as ins


class PrintAdam(Command):
    name = "print"
    description = "Print an ADAM formatted file"

    @classmethod
    def configure(cls, p):
        p.add_argument("files", metavar="FILE(S)", nargs="+")
        p.add_argument("-o", dest="output", default=None, help="output to a (local) file")
        p.add_argument("-pretty", action="store_true",
                       help="display raw, pretty-formatted JSON")
        p.add_argument("-projection", default=None,
                       help="comma-separated column names to read (pushed down to "
                       "the Parquet scan)")

    @classmethod
    def run(cls, args):
        import pyarrow.parquet as pq

        cols = ([c.strip() for c in args.projection.split(",") if c.strip()]
                if args.projection else None)
        out = open(args.output, "w") if args.output else sys.stdout
        try:
            for path in args.files:
                for row in pq.read_table(path, columns=cols).to_pylist():
                    if args.pretty:
                        out.write(json.dumps(row, indent=2, default=str) + "\n")
                    else:
                        out.write(json.dumps(row, default=str) + "\n")
        finally:
            if args.output:
                out.close()
        return 0


class PrintGenes(Command):
    name = "print_genes"
    description = ("Load a GTF file containing gene annotations and print the "
                   "corresponding gene models")

    @classmethod
    def configure(cls, p):
        p.add_argument("gtf", metavar="GTF")

    @classmethod
    def run(cls, args):
        from adam_tpu_torch.io import features as fio
        from adam_tpu_torch.models.genes import as_genes

        for gene in as_genes(fio.read_features(args.gtf, fmt="gtf")):
            parts = ["Gene %s (%s)" % (gene.id, ",".join(gene.names))]
            for t in gene.transcripts:
                parts.append("\n\tTranscript %s %s:%d-%d:%s (%d exons)" % (
                    t.id, t.region.referenceName, t.region.start, t.region.end,
                    "+" if t.strand else "-", len(t.exons)))
            print("".join(parts))
        return 0


class FlagStat(Command):
    name = "flagstat"
    description = "Print statistics on reads in an ADAM file (similar to samtools flagstat)"

    @classmethod
    def configure(cls, p):
        p.add_argument("input", metavar="INPUT")

    @classmethod
    def run(cls, args):
        return _flagstat(args)


class PrintTags(Command):
    name = "print_tags"
    description = "Prints the values and counts of all tags in a set of records"

    @classmethod
    def configure(cls, p):
        p.add_argument("input", metavar="INPUT")
        p.add_argument("-list", dest="list_n", default=None,
                       help="also list the first N attribute fields")
        p.add_argument("-count", dest="count", default=None,
                       help="comma-separated tag names to print values/counts for")

    @classmethod
    def run(cls, args):
        from adam_tpu_torch.io import context

        ds = context.load_alignments(args.input)
        b = ds.batch.to_numpy()
        ok = np.asarray(b.valid) & ((np.asarray(b.flags) & schema.FLAG_FAILED_QC) == 0)
        rows = np.flatnonzero(ok)
        attrs = [ds.sidecar.attrs[i] for i in rows]
        if args.list_n is not None:
            for a in attrs[: int(args.list_n)]:
                print(a)
        to_count = set(args.count.split(",")) if args.count else set()
        tag_counts: dict[str, int] = {}
        value_counts: dict[str, dict] = {t: {} for t in to_count}
        for a in attrs:
            if not a:
                continue
            for tag_str in a.split("\t"):
                name = tag_str.split(":", 1)[0]
                tag_counts[name] = tag_counts.get(name, 0) + 1
                if name in to_count:
                    val = tag_str.split(":", 2)[-1]
                    value_counts[name][val] = value_counts[name].get(val, 0) + 1
        for tag, count in sorted(tag_counts.items()):
            print("%3s\t%d" % (tag, count))
            if tag in to_count:
                for value, vc in sorted(value_counts[tag].items()):
                    print("\t%10d\t%s" % (vc, value))
        print("Total: %d" % len(rows))
        return 0


class ListDict(Command):
    name = "listdict"
    description = "Print the contents of an ADAM sequence dictionary"

    @classmethod
    def configure(cls, p):
        p.add_argument("input", metavar="INPUT")

    @classmethod
    def run(cls, args):
        from adam_tpu_torch.io import context

        for rec in context.load_alignments(args.input).seq_dict.records:
            print("%s\t%d" % (rec.name, rec.length))
        return 0


class AlleleCount(Command):
    name = "allelecount"
    description = "Calculate Allele frequencies"

    @classmethod
    def configure(cls, p):
        p.add_argument("adam", metavar="ADAM", help="ADAM variant data or VCF")
        p.add_argument("output", metavar="Output")

    @classmethod
    def run(cls, args):
        from adam_tpu_torch.api.datasets import GenotypeDataset

        with open(args.output, "w") as fh:
            for chrom, pos, allele, count in GenotypeDataset.load(args.adam).allele_count():
                fh.write("%s\t%s\t%s\t%d\n" % (chrom, pos, allele, count))
        return 0


class BuildInformation(Command):
    name = "buildinfo"
    description = "Display build information (use this for bug reports)"
    checks_device = False  # it reports the device, whatever is there

    @classmethod
    def run(cls, args):
        import platform

        import torch

        import adam_tpu_torch

        kind = torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu"
        print("adam_tpu_torch version: %s" % adam_tpu_torch.__version__)
        print("torch version: %s" % torch.__version__)
        print("cuda: %s" % torch.version.cuda)
        print("python: %s" % platform.python_version())
        print("device: %s" % kind)
        return 0


class View(Command):
    name = "view"
    description = "View certain reads from an alignment-record file."

    @classmethod
    def configure(cls, p):
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

    @classmethod
    def run(cls, args):
        return _view(args)


class Analyze(Command):
    name = "analyze"
    description = ("Analyze a telemetry snapshot or Chrome trace into a "
                   "run report (device utilization, barrier stalls, "
                   "critical path, latency quantiles)")
    checks_device = False

    @classmethod
    def configure(cls, p):
        p.add_argument(
            "input", metavar="ARTIFACT",
            help="a --metrics-json snapshot or --trace-out Chrome trace "
            "(auto-detected; a trace additionally yields idle-gap "
            "analysis and the critical path)",
        )
        p.add_argument("-json", dest="json_out", default=None, metavar="PATH",
                       help="also write the analysis as machine-readable JSON")
        p.add_argument("--device-trace", dest="device_trace", default=None,
                       metavar="XPROF",
                       help="the --xprof-dir trace of the same run "
                       "(DIR/trace-<pid>.json): adds the device's busy share "
                       "over the run and its longest idle gaps, each named by "
                       "the main-thread span of the ARTIFACT (a --trace-out "
                       "file) that covers it")

    @classmethod
    def run(cls, args):
        from adam_tpu_torch.utils import analyzer

        try:
            # incident bundles, SLO_BUDGET.json and PERF_LEDGER.ndjson
            # beside the artifact fold into their report sections
            report = analyzer.analyze_path(args.input)
            if args.device_trace:
                report["device_trace"] = analyzer.device_trace_report(
                    analyzer.load_document(args.input),
                    analyzer.load_document(args.device_trace))
        except (OSError, ValueError) as e:
            print(f"analyze: {e}", file=sys.stderr)
            return 2
        print(analyzer.render_report(report))
        if "device_trace" in report:
            print()
            print(analyzer.render_device_trace(report["device_trace"]))
        if args.json_out:
            try:
                with open(args.json_out, "w") as fh:
                    json.dump(report, fh, indent=1, default=str)
            except OSError as e:
                print(f"analyze: cannot write {args.json_out}: {e}", file=sys.stderr)
                return 2
        return 0


class Top(Command):
    """Live dashboard over a streamed run's ``--progress`` heartbeat
    file (utils/top.py): the interactive half of the observability
    layer — tails the NDJSON stream, renders a refreshing one-screen
    view (progress bar, reads/s, tunnel bytes, HBM, per-device
    in-flight depth, retry/evict counters, ETA), and exits cleanly on
    the final ``done=true`` line.  Read-only: attach/detach freely
    while the run is live."""

    name = "top"
    checks_device = False
    description = ("Live terminal dashboard tailing a streamed run's "
                   "--progress heartbeat file, or a serve run-root "
                   "directory for the multi-job view (exits on done)")

    @classmethod
    def configure(cls, p):
        p.add_argument(
            "heartbeat", metavar="HEARTBEAT.ndjson|RUN_ROOT",
            nargs="?", default=None,
            help="the NDJSON file a streamed transform is writing via "
            "--progress PATH (or ADAM_TPU_PROGRESS=PATH); may not "
            "exist yet — top waits for the first line.  A DIRECTORY "
            "(a 'serve' run-root) switches to the multi-job "
            "view: every <job>/heartbeat.ndjson under it aggregates "
            "into one dashboard with per-job rows + pool totals, "
            "tolerating jobs appearing and finishing mid-watch",
        )
        p.add_argument(
            "--url", dest="url", default=None, metavar="URL",
            help="tail a REMOTE serve run-root through its HTTP "
            "gateway (http://host:port, from 'serve --listen'): "
            "the same multi-job dashboard, fed by the "
            "gateway's cursor-resumable NDJSON event streams instead "
            "of local files; exit codes keep the 0/1/2 contract",
        )
        p.add_argument(
            "-interval", type=float, default=0.5,
            help="refresh period in seconds (default 0.5)",
        )
        p.add_argument(
            "-once", "--once", dest="once", action="store_true",
            help="render a single frame from the newest line and exit "
            "(scripting/CI mode; exit 2 when the file has no lines) — "
            "the usual 0/1/2 codes, so CI legs and incident-bundle "
            "captures can gate on it",
        )
        p.add_argument(
            "-max_wait", type=float, default=None, metavar="S",
            help="give up (exit 2) when no done=true arrives within S "
            "seconds (default: follow forever)",
        )

    @classmethod
    def run(cls, args):
        import os

        from adam_tpu_torch.utils import top as top_mod

        if (args.heartbeat is None) == (args.url is None):
            print("top: give exactly one of HEARTBEAT.ndjson|RUN_ROOT "
                  "or --url", file=sys.stderr)
            return 2
        if args.url is not None:
            return top_mod.follow_url(
                args.url, interval=max(0.05, args.interval),
                once=args.once, max_wait_s=args.max_wait,
            )
        if os.path.isdir(args.heartbeat):
            return top_mod.follow_root(
                args.heartbeat, interval=max(0.05, args.interval),
                once=args.once, max_wait_s=args.max_wait,
            )
        return top_mod.follow(
            args.heartbeat, interval=max(0.05, args.interval),
            once=args.once, max_wait_s=args.max_wait,
        )


class Incidents(Command):
    """List the anomaly-triggered incident bundles a run (or serve
    run-root) recorded (utils/incidents.py): one row per bundle —
    trigger, device, window, trace id, reason — newest last.  Each
    bundle is a self-contained JSON file carrying the flight-recorder
    ring tail, a metrics snapshot, the health board, and the
    triggering job's Chrome trace; point ``adam-tpu analyze`` at a
    telemetry artifact beside them for the folded report view."""

    name = "incidents"
    checks_device = False
    description = ("List anomaly-triggered incident bundles under a "
                   "run dir or serve run-root (trigger, device, "
                   "window, trace id; bundles are self-contained JSON)")

    @classmethod
    def configure(cls, p):
        p.add_argument(
            "run_dir", metavar="RUN_DIR",
            help="a run dir or serve run-root (bundles live under its "
            "incidents/ subdirectory), or the incidents/ dir itself",
        )
        p.add_argument(
            "-json", dest="json_out", action="store_true",
            help="print the bundle summaries as JSON instead of a table",
        )

    @classmethod
    def run(cls, args):
        import json
        import time as time_mod

        from adam_tpu_torch.utils import incidents as incidents_mod

        rows = incidents_mod.list_bundles(args.run_dir)
        if args.json_out:
            print(json.dumps(
                {"schema": incidents_mod.INCIDENT_SCHEMA + "+list",
                 "incidents": rows}, indent=1,
            ))
            return 0
        if not rows:
            print(f"incidents: none under {args.run_dir}")
            return 0
        print(f"{'WHEN':<20} {'TRIGGER':<18} {'DEVICE':<14} "
              f"{'WINDOW':>6} {'TRACE':<17} REASON")
        for r in rows:
            ts = r.get("ts")
            when = (
                time_mod.strftime("%Y-%m-%d %H:%M:%S",
                                  time_mod.localtime(ts))
                if isinstance(ts, (int, float)) else "-"
            )
            window = r.get("window")
            print(
                f"{when:<20} {str(r.get('trigger') or '-'):<18} "
                f"{str(r.get('device') or '-'):<14} "
                f"{window if window is not None else '-':>6} "
                f"{str(r.get('trace_id') or '-'):<17} "
                f"{r.get('reason') or ''}"
            )
        return 0


COMMANDS = [
    PrintAdam,
    PrintGenes,
    FlagStat,
    PrintTags,
    ListDict,
    AlleleCount,
    BuildInformation,
    View,
    Analyze,
    Top,
    Incidents,
]


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
    with ins.TIMERS.time(ins.FLAGSTAT):
        failed, passed = flagstat(ds.batch, device=args.device)
    t2 = time.monotonic()
    print(format_flagstat(failed, passed))
    print(json.dumps({"load_s": t1 - t0, "flagstat_s": t2 - t1,
                      "n_reads": ds.batch.n_valid()}, sort_keys=True), file=sys.stderr)
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
