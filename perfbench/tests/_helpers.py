"""Shared by the benchmark's own tests: a tiny rehearsal of a cell on
the CPU, through the harness's test-only preset."""

from __future__ import annotations

import contextlib
import io
import json

TINY = {"reads": 6000, "contigs": 2, "contig_len": 40_000, "window_reads": 2048}


def rehearse(cell: str, seed: int = 3_000_000_017, trace: int = 0, seconds: float = 0.5,
             preset: dict | None = None) -> dict:
    """Run ``cell`` once at the tiny preset -> its result line."""
    from perfbench import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], rehearse=preset or TINY)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])
