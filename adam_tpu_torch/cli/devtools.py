"""Development and CI commands (the counterpart of
``adam_tpu/cli/devtools.py``): ``perf``, the perf ledger's trend table.
The static checker's ``check`` verb is still to be ported (ROADMAP queue
1 item 5)."""

from __future__ import annotations

import argparse

from adam_tpu_torch.cli.main import Command


class Perf(Command):
    """``adam-tpu perf`` — the perf-ledger trend table + regression
    sentinel (utils/perfledger.py, docs/OBSERVABILITY.md "The perf
    ledger").  Importable without jax: the ledger is plain NDJSON, so
    CI can gate on a run root no matter where it was produced."""

    name = "perf"
    checks_device = False
    description = ("Render a run root's PERF_LEDGER.ndjson trend and "
                   "flag regressions vs the rolling median baseline "
                   "(exit 1 when the newest run regressed)")

    @classmethod
    def configure(cls, parser: argparse.ArgumentParser) -> None:
        parser.add_argument(
            "root", metavar="RUN_ROOT",
            help="run root holding PERF_LEDGER.ndjson (or the ledger "
            "file itself)",
        )
        parser.add_argument(
            "--threshold", type=float, default=None, metavar="PCT",
            help="direction-aware regression threshold in percent "
            "(default ADAM_TPU_PERF_THRESHOLD, 25)",
        )
        parser.add_argument(
            "--baseline-n", dest="baseline_n", type=int, default=None,
            metavar="N",
            help="rolling-median baseline depth (default "
            "ADAM_TPU_PERF_BASELINE_N, 5)",
        )
        parser.add_argument(
            "--json", dest="json_out", action="store_true",
            help="emit the trend as one machine-readable JSON document "
            "(schema adam_tpu.perf_trend/1) instead of the table",
        )

    @classmethod
    def run(cls, args: argparse.Namespace) -> int:
        import json
        import sys
        import time

        from adam_tpu_torch.utils import perfledger

        entries = perfledger.read_ledger(args.root)
        if not entries:
            print(f"perf: no ledger entries under {args.root!r} "
                  f"({perfledger.LEDGER_FILENAME})", file=sys.stderr)
            return 2
        rows = perfledger.trend(
            entries, n=args.baseline_n, threshold_pct=args.threshold,
        )
        newest_regressions = rows[-1]["regressions"] if rows else []
        if args.json_out:
            print(json.dumps({
                "schema": "adam_tpu.perf_trend/1",
                "root": args.root,
                "n_entries": len(entries),
                "rows": rows,
                "regressions": newest_regressions,
                "ok": not newest_regressions,
            }, indent=1))
            return 1 if newest_regressions else 0
        print(f"{'#':>3}  {'when':19}  {'run':>12}  {'total_s':>9}"
              f"  {'keys':>5}  regressions")
        for r in rows:
            when = (time.strftime("%Y-%m-%d %H:%M:%S",
                                  time.localtime(r["ts"]))
                    if r.get("ts") else "-")
            run = str(r.get("run_id") or "-")[-12:]
            total = (f"{r['total_s']:9.3f}" if r.get("total_s")
                     is not None else f"{'-':>9}")
            mark = (", ".join(
                f"{x['key']} {x['delta_pct']:+.1f}%"
                for x in r["regressions"]) or
                ("(baseline)" if r["index"]
                 < perfledger.MIN_BASELINE_RUNS else "none"))
            print(f"{r['index']:>3}  {when:19}  {run:>12}  {total}"
                  f"  {r['n_keys']:>5}  {mark}")
        if newest_regressions:
            print(f"\nperf: newest run regressed "
                  f"{len(newest_regressions)} key(s) vs the rolling "
                  "median baseline", file=sys.stderr)
            return 1
        return 0


COMMANDS = [Perf]
