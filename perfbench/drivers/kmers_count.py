"""Driver: the two calls the ``count_kmers`` verb makes on a ``.adam``:
``io.context.load_alignments(path, projection=["sequence", "qual"])``
and ``AlignmentDataset.count_kmers(k, device)``.

Set-up makes the seed's BAM, then the ``.adam`` with the port's own plain
``transform IN.bam OUT.adam`` (users load what the port writes), both
cached per seed and traffic, then runs one warm job.  The verb's text
write is left out: the window measures load and count.  The check
compares one job's table, drawn from the seed among the window's jobs,
with the reference's counts from the generated reads.
"""

from __future__ import annotations

import contextlib
import io
import time
from pathlib import Path

import numpy as np

from perfbench.drivers import transform_cli
from perfbench.harness import core
from perfbench.reference import kmers


class State:
    pass


def setup(cell: dict, seed: int, device: str, work_dir: Path, rehearse: dict | None):
    from adam_tpu_torch.cli.main import main as cli

    st = State()
    st.cell, st.seed, st.device, st.rehearse = cell, seed, device, rehearse
    st.k = int(cell["config"]["k"])
    t0 = time.perf_counter()
    st.input = transform_cli.make_input(transform_cli.traffic_params(cell, rehearse), seed)

    def make(d: Path) -> None:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli(["transform", st.input.bam, str(d / "reads.adam"), "--device", device])
        if rc != 0:
            raise RuntimeError(f"transform to .adam exited {rc}")

    st.adam = str(core.fill_once(st.input.dir / "adam", make) / "reads.adam")
    t1 = time.perf_counter()
    st.n_kmers = int(np.maximum(st.input.lengths.astype(np.int64) - st.k + 1, 0).sum())
    st.pick = np.random.default_rng(abs(seed) + 7)
    st.kept = None
    _job(st)
    st.setup_parts = {"input_and_adam_s": round(t1 - t0, 3),
                      "warm_job_s": round(time.perf_counter() - t1, 3)}
    return st


def _job(st) -> dict:
    from adam_tpu_torch.io import context

    t0 = time.monotonic_ns()
    ds = context.load_alignments(st.adam, projection=["sequence", "qual"])
    t1 = time.monotonic_ns()
    counts = ds.count_kmers(st.k, device=st.device)
    t2 = time.monotonic_ns()
    st.last_spans = [("kmers.load", t0, t1), ("kmers.count", t1, t2)]
    return {"load_s": (t1 - t0) / 1e9, "count_s": (t2 - t1) / 1e9, "wall_s": (t2 - t0) / 1e9,
            "kmers": st.n_kmers, "counts": counts}


def run_job(st, k: int) -> dict:
    """One job; its table is kept only where a reservoir of one, drawn
    from the seed, picks it, so at most one table outlives its job."""
    res = _job(st)
    counts = res.pop("counts")
    if st.pick.integers(0, k + 1) == 0:
        st.kept = counts
    return res


def spans(st) -> list:
    """The last job's two calls, timed by the driver (monotonic ns)."""
    return st.last_spans


def rate(st, jobs: list, window_s: float, metric: str) -> float:
    return sum(j["kmers"] for j in jobs) / window_s


def release(st) -> None:
    transform_cli.release(st)


def check(st, jobs: list, seed: int) -> list:
    """The kept job's table against the reference's counts from the
    generated reads; where its digest is the reference's answer's
    (cached per seed), every count of disagreements is 0."""
    from perfbench.reference import compare

    got = compare.kmer_arrays(st.kept, st.k)
    st.kept = None
    ref = None

    def compute():
        nonlocal ref
        ref = kmers.counts(st.input.reads(), st.k, device=st.device)
        return {"digest": compare.digest({"keys": ref[0], "counts": ref[1]})}

    ans = transform_cli.reference_digest(st.input, f"kmers.k{st.k}", compute)
    if ref is None and ans["digest"] == compare.digest({"keys": got[0], "counts": got[1]}):
        return [(name, 0, 0) for name in compare.KMER_CHECKS]
    if ref is None:
        compute()
    return compare.compare_kmers(ref, got)
