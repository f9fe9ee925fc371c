"""The controls of ``correct``, at a cell's own size: the plain
reference put in the program's place one step below what the
configuration states, compared by the run's own comparison.  Each must
come out not correct.

* transform cells: the realignment sweep's match sums in bfloat16 (what
  a bf16 ``torch.bmm`` returns) and the BQSR table solved in float32
  instead of float64 (the steps a faster sweep or a device-side solve
  would tempt);
* k-mer cells: a table keyed by a 32-bit hash of the k-mer instead of
  the exact 63-bit key (the step a hash table would tempt).

    python3 perfbench/controls.py --workload CELL --seeds 1,2,3 [--device cuda]

Prints one JSON line per seed with each compared number.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def control_checks(cell: dict, seed: int, device: str, params: dict | None = None) -> list:
    from perfbench.drivers.transform_cli import traffic_params
    from perfbench.reference import compare, kmers, transform
    from perfbench.traffic import wgs

    p = traffic_params(cell, params)
    reads = wgs.make_reads(p, seed)
    if cell["spec"]["driver"] == "kmers_count":
        k = int(cell["config"]["k"])
        return compare.compare_kmers(kmers.counts(reads, k, device=device),
                                     kmers.control_counts(reads, k, device=device))
    sites = "{known_snps}" in cell["spec"].get("extra_args", [])
    ref = transform.expected(reads, sites, device=device)
    ctl = transform.expected(reads, sites, device=device, control=True)
    return compare.compare_transform(ref, compare.as_published(ctl))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from perfbench.harness import core

    cell = core.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        checks = control_checks(cell, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "checks": {n: v for n, v, _ in checks},
                          "correct": all(v <= lim for _, v, lim in checks)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
