"""Time the kernel wrappers of two checkouts in turns on one GPU (run:
``python3 tools/compare_kernels.py PARENT_DIR CHANGE_DIR``).

Runs ``chip_smoke.check_kernels`` (phase 3's observe_hist and pack_rows
at the main path's shapes), ``chip_smoke.check_sw_score`` (sw_score f32,
i16 and bf16 at ``benchmark_gcups``' 8,192 x 127 x 127) and
``chip_smoke.check_sw_fill`` at the smithwaterman path's median launch
shape (SW_FILL_SHAPE), each checked against its plain version and timed
over the whole wrapper call by CUDA events, 3 warm-up and 20 timed
calls, in PARENT, CHANGE, CHANGE, PARENT order, each run in its own
process from its own checkout (so each builds and loads its own
kernels).  Each run also times the unfused SANGER pair,
``pack_rows(sanger_body(quals))``, which both versions accept.  Prints
one JSON line per run, then one line with each side's mean per name.
Exits non-zero without a GPU or when a run fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

#: (B, lx, ly) of the median sw_fill launch of the smithwaterman path on
#: chip_smoke.py's 1M-read input
SW_FILL_SHAPE = (4056, 128, 384)

SNIPPET = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke
from adam_tpu_torch.ops import colpack
dev = torch.device("cuda")
kern = chip_smoke.check_kernels(dev) + chip_smoke.check_sw_score(dev)
kern.append(chip_smoke.check_sw_fill(dev, SW_FILL_SHAPE, 0))
t, g, gl = chip_smoke._kernel_inputs(dev)
lens = t["lengths"].to(torch.int64)
pair = chip_smoke._time_ms(
    lambda: colpack.pack_rows(colpack.sanger_body(t["quals"]), lens, g * gl))
out = {k["name"]: k["ms"] for k in kern}
out["sanger_body_then_pack_rows"] = pair
print(json.dumps({"ms": out, "equal": all(k["equal"] for k in kern),
                  "nvidia_smi": chip_smoke._smi()}))
"""


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    sides = {"parent": os.path.abspath(argv[0]), "change": os.path.abspath(argv[1])}
    runs = {"parent": [], "change": []}
    for side in ("parent", "change", "change", "parent"):
        snippet = SNIPPET.replace("SW_FILL_SHAPE", repr(SW_FILL_SHAPE))
        proc = subprocess.run([sys.executable, "-c", snippet], cwd=sides[side],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        if not res["equal"]:
            print(f"{side}: a kernel disagrees with its plain version", file=sys.stderr)
            return 1
        runs[side].append(res["ms"])
        print(json.dumps({"side": side, **res}), flush=True)
    mean = {side: {name: sum(r[name] for r in rs) / len(rs) for name in rs[0]}
            for side, rs in runs.items()}
    print(json.dumps({"mean_ms": mean}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
