"""Time the streamed main path of two checkouts in turns on one GPU (run:
``python3 tools/compare_transform.py PARENT_DIR CHANGE_DIR``).

Generates one WGS-shaped SAM (``make_wgs(path, 1,048,576, 100,
seed=7)``, ``chip_smoke.py``'s main-path input), then runs each
checkout's CLI on it, ``python -m adam_tpu_torch transform
-streaming -mark_duplicate_reads -realign_indels
-recalibrate_base_qualities -window_reads 262144 --device cuda``, in
PARENT, CHANGE, CHANGE, PARENT order, twice over: eight runs, each its
own process (the first run in a process, as a user's).  Prints one JSON
line per run with the stats line's reads/s and stage times, then the
median reads/s of each side.  Exits non-zero without a GPU or when a
run fails.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

READS = 1_048_576
WINDOW_READS = 262_144
STAGES = ("total_s", "apply_s", "write_wait_s", "observe_s", "resolve_s",
          "ingest_pass_s", "realign_s")


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("compare_transform: no CUDA device", file=sys.stderr)
        return 1
    sides = {"parent": os.path.abspath(argv[0]), "change": os.path.abspath(argv[1])}
    sys.path.insert(0, os.path.join(sides["change"], "tools"))
    from make_wgs_sam import make_wgs

    work = tempfile.mkdtemp(prefix="compare_transform_")
    try:
        sam = os.path.join(work, "wgs.sam")
        make_wgs(sam, READS, 100, seed=7)
        rates = {"parent": [], "change": []}
        for side in ("parent", "change", "change", "parent") * 2:
            out = os.path.join(work, "out.adam")
            shutil.rmtree(out, ignore_errors=True)
            proc = subprocess.run(
                [sys.executable, "-m", "adam_tpu_torch", "transform", sam, out,
                 "-streaming", "-mark_duplicate_reads", "-realign_indels",
                 "-recalibrate_base_qualities", "-window_reads", str(WINDOW_READS),
                 "--device", "cuda"],
                cwd=sides[side], capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                return 1
            stats = json.loads(proc.stdout.strip().splitlines()[-1])
            rates[side].append(stats["reads_per_s"])
            print(json.dumps({"side": side, "reads_per_s": stats["reads_per_s"],
                              **{k: stats[k] for k in STAGES}}), flush=True)
        print(json.dumps({"median_reads_per_s": {
            side: statistics.median(r) for side, r in rates.items()}}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
