"""Driver: the streamed ``transform`` verb, in process, as a user runs it
with ``python -m adam_tpu_torch transform``.

Set-up makes the seed's BAM (and its known-sites VCF) once per seed and
traffic, into the checkout's input cache, then runs one whole warm job;
a repeated seed makes nothing.  Each job is
``adam_tpu_torch.cli.main.main(argv)`` into a directory of its own; its
stats line (the stage walls) is kept for the per-layer readers.  The
check reads back one job's parts, drawn from the seed, against
:mod:`perfbench.reference.transform` (run on reads made again from the
seed), and every other job's parts against that job's, byte for byte.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from perfbench.harness import core
from perfbench.traffic import bam, wgs

GEN_VERSION = 1
REF_VERSION = 2  # bump when the reference or the compared columns change


def traffic_params(cell: dict, rehearse: dict | None) -> dict:
    p = {**cell["config"]["traffic"], **cell["traffic"]}
    if rehearse:
        p.update(rehearse)
    return p


@dataclass
class Input:
    """The seed's input as a run needs it without the reads themselves:
    the files, and the sizes the rates and byte counts are made of."""

    dir: Path
    params: dict
    seed: int
    bam: str
    vcf: str
    n_reads: int
    read_len: int
    n_rg: int
    lengths: np.ndarray  # i32 per read

    @property
    def residues(self) -> int:
        return int(self.lengths.astype(np.int64).sum())

    def reads(self) -> wgs.Reads:
        """The generated reads again (only the check needs them)."""
        return wgs.make_reads(self.params, self.seed)


def make_input(params: dict, seed: int) -> Input:
    """The seed's BAM and known-sites VCF, made once per (seed, traffic)
    under ``perfbench/_cache/inputs``; a repeated seed makes nothing."""
    def make(d: Path) -> None:
        reads = wgs.make_reads(params, seed)
        bam.write_bam(str(d / "in.bam"), reads)
        wgs.write_vcf(str(d / "snps.vcf"), reads)
        np.save(d / "lengths.npy", reads.lengths)
        (d / "meta.json").write_text(json.dumps(
            {"n_reads": reads.n, "read_len": int(reads.bases.shape[1]),
             "n_rg": len(reads.read_groups)}))

    d = core.fill_once(core.cache_dir("inputs", GEN_VERSION, params, seed), make)
    meta = json.loads((d / "meta.json").read_text())
    return Input(dir=d, params=params, seed=seed, bam=str(d / "in.bam"),
                 vcf=str(d / "snps.vcf"), lengths=np.load(d / "lengths.npy"), **meta)


def reference_digest(inp: Input, tag: str, compute) -> dict:
    """The reference's answer for this input, as ``compute()`` gives it
    (a dict with its ``digest``), cached beside the input: a repeated
    seed does not run the reference again unless the answer it is
    compared with differs."""
    path = inp.dir / f"ref.{tag}.v{REF_VERSION}.json"
    if path.exists():
        return json.loads(path.read_text())
    ans = compute()
    part = path.with_name(f"{path.name}.part{os.getpid()}")
    part.write_text(json.dumps(ans))
    os.replace(part, path)
    return ans


class State:
    pass


def _argv(st, out: str) -> list[str]:
    sub = {"{input}": st.input.bam, "{output}": out, "{known_snps}": st.input.vcf,
           "{device}": st.device}
    args = [sub.get(a, a) for a in st.cell["config"]["command"]]
    args += [sub.get(a, a) for a in st.cell["spec"].get("extra_args", [])]
    if getattr(st, "traced", False):  # the program records its spans
        args += ["--trace-out", out + ".trace.json"]
    if st.rehearse and "window_reads" in st.rehearse:
        args[args.index("-window_reads") + 1] = str(st.rehearse["window_reads"])
    return args


def _reset_telemetry() -> None:
    from adam_tpu_torch.utils import instrumentation as ins
    from adam_tpu_torch.utils import telemetry as tele

    tele.TRACE.reset()
    ins.TIMERS.reset()


def setup(cell: dict, seed: int, device: str, work_dir: Path, rehearse: dict | None):
    st = State()
    st.cell, st.seed, st.device, st.work, st.rehearse = cell, seed, device, work_dir, rehearse
    st.sites = "{known_snps}" in cell["spec"].get("extra_args", [])
    t0 = time.perf_counter()
    st.input = make_input(traffic_params(cell, rehearse), seed)
    t1 = time.perf_counter()
    _job(st, str(work_dir / "warm"))
    st.setup_parts = {"input_s": round(t1 - t0, 3), "warm_job_s": round(time.perf_counter() - t1, 3)}
    return st


def _job(st, out: str) -> dict:
    from adam_tpu_torch.cli.main import main as cli

    _reset_telemetry()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli(_argv(st, out))
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"transform exited {rc}")
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    stats = json.loads(lines[-1])
    return {"wall_s": wall, "stats": stats, "output": out, "reads": st.input.n_reads}


def run_job(st, k: int) -> dict:
    return _job(st, str(st.work / f"job{k:03d}"))


def spans(st) -> list:
    """The last job's program spans: [(name, t0_ns, t1_ns)], monotonic."""
    from adam_tpu_torch.utils import telemetry as tele

    return [(e["name"], e["ts_ns"], e["ts_ns"] + e["dur_ns"]) for e in tele.TRACE.events()
            if "ts_ns" in e and "dur_ns" in e]


def rate(st, jobs: list, window_s: float, metric: str) -> float:
    return sum(j["reads"] for j in jobs) / window_s


def release(st) -> None:
    import gc

    import torch

    gc.collect()
    if st.device == "cuda":
        torch.cuda.empty_cache()


def _digest(out: str) -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(out)):
        h.update(name.encode())
        with open(os.path.join(out, name), "rb") as fh:
            h.update(hashlib.sha256(fh.read()).digest())
    return h.hexdigest()


def check(st, jobs: list, seed: int) -> list:
    """-> [(name, value, limit)]: the reference against one job drawn
    from the seed, and every job's parts against that job's.  Where the
    job's columns have the digest of the reference's answer (cached per
    seed), every count of disagreements is 0 without running it again."""
    from perfbench.reference import compare, transform

    pick = int(np.random.default_rng(abs(seed) + 7).integers(0, len(jobs)))
    chosen = jobs[pick]["output"]
    st.bytes_written = sum(os.path.getsize(os.path.join(j["output"], f))
                           for j in jobs for f in os.listdir(j["output"]))
    want = _digest(chosen)
    differ = sum(_digest(j["output"]) != want for j in jobs)
    got = compare.read_transform_output(chosen)
    ref = None

    def compute():
        nonlocal ref
        ref = transform.expected(st.input.reads(), known_sites=st.sites, device=st.device)
        return {"digest": compare.digest(compare.as_published(ref)), "observed": ref["observed"]}

    ans = reference_digest(st.input, "transform.sites" if st.sites else "transform.nosites",
                           compute)
    st.observed_residues = ans["observed"]
    if ref is None and ans["digest"] == compare.digest(got):
        checks = [(name, 0, 0) for name in compare.TRANSFORM_CHECKS]
    else:
        if ref is None:
            compute()
        checks = compare.compare_transform(ref, got)
    checks.append(("jobs_with_other_bytes", differ, 0))
    return checks
