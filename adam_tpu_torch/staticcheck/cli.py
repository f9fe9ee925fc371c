"""Argument surface shared by ``python -m adam_tpu_torch check`` and
``python -m adam_tpu_torch.staticcheck`` (copied from
``adam_tpu/staticcheck/cli.py``)."""

from __future__ import annotations

import argparse
import json
import os
import sys

from adam_tpu_torch.staticcheck import core


def configure(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--root", default=None, metavar="DIR",
        help="repository root to check (default: the directory above "
        "the adam_tpu_torch package)",
    )
    parser.add_argument(
        "--rules", default=None, metavar="R1,R2",
        help="comma-separated rule subset (default: all registered); "
        "see --list-rules",
    )
    parser.add_argument(
        "--plugin", action="append", default=[], metavar="MODULE",
        help="import a plugin module registering extra rules (may "
        "repeat; also honored from ADAM_TPU_CHECK_PLUGINS)",
    )
    parser.add_argument(
        "--baseline", default=None, metavar="PATH",
        help="baseline file of triaged findings (default: "
        f"<root>/{core.DEFAULT_BASELINE})",
    )
    parser.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline from the current findings, "
        "preserving existing justifications; new entries still fail "
        "until a reason= is added by hand",
    )
    parser.add_argument(
        "--json", dest="json_out", default=None, metavar="PATH",
        help="write the machine-readable report (schema "
        f"{core.SCHEMA}) to PATH, '-' for stdout",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the registered rules and their contracts, then exit",
    )
    parser.add_argument(
        "--quiet", action="store_true",
        help="suppress the human-readable report (exit code / --json "
        "only)",
    )


def detect_root() -> str:
    """The repo root: the directory holding the ``adam_tpu_torch``
    package."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(here)


def run(args) -> int:
    if args.list_rules:
        env_plugins = [
            p for p in os.environ.get(
                "ADAM_TPU_CHECK_PLUGINS", ""
            ).split(":") if p
        ]
        try:
            core.load_plugins(list(args.plugin) + env_plugins)
        except ImportError as e:
            print(f"adam-tpu check: {e}", file=sys.stderr)
            return core.EXIT_ERROR
        for name, cls in sorted(core.all_rules().items()):
            print(f"{name}: {cls.summary}")
            if cls.contract:
                print(f"    contract: {cls.contract}")
        return core.EXIT_CLEAN
    root = os.path.abspath(args.root) if args.root else detect_root()
    rule_names = (
        [r.strip() for r in args.rules.split(",") if r.strip()]
        if args.rules else None
    )
    try:
        report = core.run_checks(
            root,
            rule_names=rule_names,
            plugins=args.plugin,
            baseline_path=args.baseline,
            update_baseline=args.update_baseline,
        )
    except (ValueError, ImportError, OSError) as e:
        print(f"adam-tpu check: {e}", file=sys.stderr)
        return core.EXIT_ERROR
    if args.json_out:
        doc = json.dumps(report.to_json(), indent=1, sort_keys=True)
        if args.json_out == "-":
            print(doc)
        else:
            with open(args.json_out, "w", encoding="utf-8") as fh:
                fh.write(doc + "\n")
    if not args.quiet and args.json_out != "-":
        print(report.render())
    return report.exit_code


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m adam_tpu_torch.staticcheck",
        description="AST-based contract checker of the port",
    )
    configure(parser)
    return run(parser.parse_args(argv))
