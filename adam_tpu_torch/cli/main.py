"""Command line of the port: ``python -m adam_tpu_torch COMMAND [args]``
(the counterpart of ``adam_tpu/cli/main.py``).

The registry has the JAX CLI's shape: one :class:`Command` per verb, in
JAX's groups and order (``cli/actions.py``, ``cli/conversions.py``,
``cli/printers.py``), one ``ArgumentParser(allow_abbrev=False)`` per verb
with :func:`add_common_args` and then the verb's own flags.  With no
verb, or ``-h``/``--help``, the usage goes to standard output and the
exit code is 0; an unknown verb prints ``unknown command: X`` and the
usage to standard error and exits 1.  A closed standard output (``view
in.sam | head -1``) ends the verb quietly with exit code 0.

Every verb takes JAX's shared flags.  ``-log_level`` sets up
``logging``; ``-stringency`` and ``-parquet_compression_codec`` reach the
verbs that read them; ``-parquet_block_size``, ``-parquet_page_size`` and
``-parquet_disable_dictionary`` are accepted for parity and read by no
verb, as in JAX; ``--fault-spec`` arms ``utils/faults.py`` before the
verb runs.  The port adds ``--device {cuda,cpu}`` (default ``cuda``,
which raises without a card).

The observability flags act as JAX's do (``utils/telemetry.py``,
``utils/instrumentation.py``): ``-print_metrics``, ``--metrics-json``,
``--trace-out`` and transform's ``--report`` switch recording on;
``-print_metrics`` prints the timer table and then the counters, gauges
and histograms; the JSON snapshot and the Chrome trace are written when
the verb ends, failed or not; ``--progress`` is the streamed transform's
heartbeat.  ``--xprof-dir DIR`` wraps the verb in a ``torch.profiler``
trace and writes it to DIR as a Chrome-trace JSON file (Perfetto opens
it), the port's counterpart of JAX's xprof trace.  The multi-device
flags act as JAX's do: ``--devices N`` caps the streamed transform's
device pool (at the cards attached, with a warning) and
``--partitioner {pool,mesh}`` picks its execution mode; other verbs
accept and ignore them, as in JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

from adam_tpu_torch.utils import instrumentation as ins
from adam_tpu_torch.utils import telemetry as tele

class Command:
    """One verb: subclasses set ``name`` and ``description`` and implement
    ``configure`` (its own flags) and ``run`` (-> exit code).  A verb
    whose ``checks_device`` is true has ``--device`` resolved before it
    runs, so ``cuda`` without a card raises even where no tensor work
    follows, as every entry point of the port does."""

    name: str = ""
    description: str = ""
    checks_device: bool = True

    @classmethod
    def configure(cls, parser: argparse.ArgumentParser) -> None:
        pass

    @classmethod
    def run(cls, args: argparse.Namespace) -> int | None:
        raise NotImplementedError


def add_common_args(parser: argparse.ArgumentParser) -> None:
    """The flags every verb shares: JAX's (``adam_tpu/cli/main.py``
    ``add_common_args``) and the port's ``--device``."""
    parser.add_argument(
        "-print_metrics", action="store_true",
        help="print metrics on completion (the timer table, then the "
        "telemetry counters, gauges and histograms recorded under it)",
    )
    parser.add_argument(
        "--metrics-json", dest="metrics_json", default=None, metavar="PATH",
        help="write the telemetry snapshot (spans, counters, gauges and the "
        "timer table as JSON) to PATH on completion",
    )
    parser.add_argument(
        "--trace-out", dest="trace_out", default=None, metavar="PATH",
        help="write the flight recorder as a Chrome-trace JSON file "
        "(chrome://tracing or Perfetto; per-thread tracks show the "
        "streamed tokenize/dispatch/encode/write overlap)",
    )
    parser.add_argument(
        "--progress", dest="progress", nargs="?", const="stderr",
        default=None, metavar="PATH",
        help="emit a live NDJSON progress heartbeat every few seconds "
        "(windows done/total, reads/s, bytes written, card memory, "
        "in-flight depth, fault counter, ETA) to stderr, or to PATH when "
        "given; also ADAM_TPU_PROGRESS, period ADAM_TPU_PROGRESS_INTERVAL_S "
        "(streamed transform only)",
    )
    parser.add_argument(
        "--devices", dest="devices", type=int, default=None, metavar="N",
        help="fan the streamed transform's device work out over N cards "
        "(windows round-robin over them; default: every card, or "
        "ADAM_TPU_DEVICES; N=1 forces the single-device path; requests "
        "beyond the attached count are capped)",
    )
    parser.add_argument(
        "--partitioner", dest="partitioner", default=None,
        choices=["pool", "mesh"],
        help="how the streamed transform places device work over the "
        "cards: 'pool' (default) round-robins whole windows; 'mesh' splits "
        "every window's rows over them, sums the BQSR observe histograms "
        "on the card (one table per grid width crosses at barrier 2) and "
        "degrades to the pool on a failure (also ADAM_TPU_PARTITIONER)",
    )
    parser.add_argument(
        "--fault-spec", dest="fault_spec", default=None, metavar="SPEC",
        help="arm fault injection at named points (testing only; e.g. "
        "'proc.kill=kill,device=pass_c,after=2,times=1'; also ADAM_TPU_FAULTS)",
    )
    parser.add_argument(
        "--xprof-dir", dest="xprof_dir", default=None, metavar="DIR",
        help="wrap the command in a torch.profiler trace (host calls and, "
        "on the card, the CUDA kernels) written to DIR as a Chrome-trace "
        "JSON file, loadable in Perfetto; a no-op if a trace is already "
        "active",
    )
    parser.add_argument(
        "-log_level", default="warning", choices=["debug", "info", "warning", "error"],
        help="logging verbosity",
    )
    parser.add_argument(
        "-stringency", default="lenient", choices=["strict", "lenient", "silent"],
        help="validation stringency for malformed input (the FASTQ pairing "
        "and export paths)",
    )
    parser.add_argument(
        "-parquet_compression_codec", default="zstd",
        choices=["uncompressed", "snappy", "gzip", "zstd"],
        help="parquet compression codec",
    )
    parser.add_argument("-parquet_block_size", type=int, default=128 * 1024 * 1024,
                        help="parquet block size (accepted for parity)")
    parser.add_argument("-parquet_page_size", type=int, default=1024 * 1024,
                        help="parquet page size (accepted for parity)")
    parser.add_argument("-parquet_disable_dictionary", action="store_true",
                        help="disable parquet dictionary encoding (accepted for parity)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the tensor work runs (default: cuda)")


def command_groups():
    """(group name, commands) in JAX's groups and order, for the verbs the
    port has."""
    from adam_tpu_torch.cli import actions, conversions, devtools, printers

    return [
        ("ADAM ACTIONS", actions.COMMANDS),
        ("CONVERSION OPERATIONS", conversions.COMMANDS),
        ("PRINT", printers.COMMANDS),
        ("DEVELOPMENT", devtools.COMMANDS),
    ]


def _usage() -> str:
    out = ["", "Usage: python -m adam_tpu_torch COMMAND", ""]
    for group, commands in command_groups():
        out.append(group)
        for cmd in commands:
            out.append(f"{cmd.name:>20} : {cmd.description}")
        out.append("")
    return "\n".join(out)


def _registry() -> dict:
    return {c.name: c for _, cmds in command_groups() for c in cmds}


def parser_for(name: str) -> argparse.ArgumentParser:
    """The argument parser of verb ``name`` (KeyError for an unknown one)."""
    cmd = _registry()[name]
    parser = argparse.ArgumentParser(
        prog=f"python -m adam_tpu_torch {name}", description=cmd.description,
        # reference flags are single-dash long options: prefix matching
        # would make a typo silently match another flag
        allow_abbrev=False,
    )
    add_common_args(parser)
    cmd.configure(parser)
    return parser


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0
    name, rest = argv[0], argv[1:]
    registry = _registry()
    if name not in registry:
        print(f"unknown command: {name}", file=sys.stderr)
        print(_usage(), file=sys.stderr)
        return 1
    cmd = registry[name]
    args = parser_for(name).parse_args(rest)
    import logging

    logging.basicConfig(
        level=getattr(logging, args.log_level.upper()),
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    # any observability sink switches recording on: the timer table, the
    # JSON snapshot, the Chrome trace and the analyzer report all read
    # the same run (--progress manages its own through the heartbeat)
    want_metrics = bool(
        args.print_metrics or args.metrics_json or args.trace_out
        or getattr(args, "report", None)
    )
    ins.TIMERS.recording = want_metrics
    tele.TRACE.recording = want_metrics
    if args.fault_spec:
        from adam_tpu_torch.utils import faults

        try:
            faults.install(args.fault_spec)
        except ValueError as e:
            print(f"--fault-spec: {e}", file=sys.stderr)
            return 2
    if cmd.checks_device:
        from adam_tpu_torch.device import resolve_device

        resolve_device(args.device)
    xprof = (
        ins.device_trace(args.xprof_dir) if args.xprof_dir
        else contextlib.nullcontext()
    )
    try:
        with xprof:
            rc = cmd.run(args)
    except BrokenPipeError:  # e.g. `view in.sam | head -1`
        # point stdout at /dev/null, so that the interpreter's last flush
        # of what is still buffered cannot fail at exit as well
        import os

        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        os.close(devnull)
        return 0
    finally:
        if args.print_metrics:
            try:
                print(ins.TIMERS.report())
                print(tele.TRACE.report())
            except BrokenPipeError:
                pass
        for path, dump in (
            (args.metrics_json, tele.TRACE.dump_json),
            (args.trace_out, tele.TRACE.dump_chrome_trace),
        ):
            if path:
                try:
                    dump(path)
                except OSError as e:
                    print(f"telemetry export to {path} failed: {e}",
                          file=sys.stderr)
    return int(rc or 0)


if __name__ == "__main__":
    sys.exit(main())
