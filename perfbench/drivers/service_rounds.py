"""Driver: the multi-tenant transform service, in process, through its
library seam ``adam_tpu_torch.api.transform_service.TransformService``,
as a lab embeds it.

One harness job is one round: the samples of one sequencing run (the
cell file's ``samples``: a job name, a tenant and its weight each),
submitted to the service at once, each a streamed flagship transform of
its own BAM with its own known-sites VCF.  A round ends when every
sample has published; the next round starts then.  The harness runs one
job at a time, so the round is the closed loop: the samples of a run
arrive together, and its clients wait for all of them before the next
run's arrive.  That is the only way four clients run within the
harness's loop.

Set-up makes each sample's BAM and VCF once per (seed, traffic) into the
checkout's input cache (sample ``i``'s seed is the run's seed plus
``i`` times the configuration's ``sample_seed_step``, so sample 0 is the
seed's flagship-shaped input), builds one service with the
configuration's ``max_jobs`` and batching under the run's work
directory, and runs one warm round.  Each round resets ``telemetry.TRACE``
once the previous round has settled (the service keeps recording on),
and keeps its snapshot of the service's spans and ``sched.batch.*``
counters for the service's readers.  For the flagship's stage readers a
round keeps ``stats``, each stage wall of its samples' stats lines summed
over the samples, and in a traced run writes ``TRACE``'s export beside
its outputs (``<output>.trace.json``, as ``--trace-out`` writes it), so
that the sums of the library's spans over the samples are read as a
flagship job's are.  A round holds the flagship job's 1,048,576 reads,
so its sums compare with a flagship job's walls.  The check is
:func:`perfbench.reference.service.check`.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

from perfbench.drivers.transform_cli import _reset_telemetry, make_input, traffic_params

#: The service's own spans a round keeps (names, not the program's
#: constants: a program without them reads nothing).
ROUND_SPANS = ("sched.batch.ticket_wait", "sched.pace.wait", "sched.batch.fused")

#: The longest a round may take before it counts as failed.
ROUND_TIMEOUT_S = 900.0


class State:
    pass


def sample_seeds(cell: dict, seed: int) -> list:
    step = int(cell["config"]["service"]["sample_seed_step"])
    return [seed + i * step for i in range(len(cell["spec"]["samples"]))]


def setup(cell: dict, seed: int, device: str, work_dir, rehearse: dict | None):
    from adam_tpu_torch.api.transform_service import TransformService

    st = State()
    st.cell, st.seed, st.device, st.work, st.rehearse = cell, seed, device, work_dir, rehearse
    st.sites = "{known_snps}" in cell["spec"].get("extra_args", [])
    st.samples = cell["spec"]["samples"]
    svc = cell["config"]["service"]
    st.window_reads = int((rehearse or {}).get("window_reads", svc["window_reads"]))
    t0 = time.perf_counter()
    params = traffic_params(cell, rehearse)
    st.inputs = [make_input(params, s) for s in sample_seeds(cell, seed)]
    t1 = time.perf_counter()
    st.root = str(work_dir / "service")
    st.service = TransformService(st.root, max_jobs=int(svc["max_jobs"]),
                                  batching=bool(svc["batching"]), device=device)
    _round(st, "warm")
    st.setup_parts = {"input_s": round(t1 - t0, 3), "warm_round_s": round(time.perf_counter() - t1, 3)}
    return st


def _round(st, tag: str) -> dict:
    from adam_tpu_torch.serve.job import Admitted, JobSpec
    from adam_tpu_torch.utils import telemetry as tele

    _reset_telemetry()
    ids, outputs = [], []
    t0 = time.perf_counter()
    for smp, inp in zip(st.samples, st.inputs):
        out = str(st.work / tag / f"{smp['job']}.adam")
        spec = JobSpec(job_id=f"{tag}.{smp['job']}", input=inp.bam, output=out,
                       tenant=smp["tenant"], weight=float(smp["weight"]),
                       known_snps=inp.vcf if st.sites else None, window_reads=st.window_reads)
        got = st.service.submit(spec)
        if not isinstance(got, Admitted):
            raise RuntimeError(f"{spec.job_id} was not admitted: {got}")
        ids.append(spec.job_id)
        outputs.append(out)
    if not st.service.wait(timeout=ROUND_TIMEOUT_S):
        raise RuntimeError(f"round {tag} did not settle within {ROUND_TIMEOUT_S:.0f} s")
    wall = time.perf_counter() - t0
    snap = tele.TRACE.snapshot()
    jobs = st.service.status()["jobs"]
    per_sample = _sample_stats(st, ids)
    rnd = {"wall_s": wall, "reads": sum(i.n_reads for i in st.inputs), "outputs": outputs,
           "output": str(st.work / tag), "states": {j: jobs[j]["state"] for j in ids},
           "stats": _summed(per_sample),
           "trace": {"spans": {n: snap["spans"][n] for n in ROUND_SPANS if n in snap["spans"]},
                     "counters": {k: v for k, v in snap["counters"].items()
                                  if k.startswith("sched.batch.")}}}
    if getattr(st, "traced", False):  # the library's spans, summed over the samples
        tele.TRACE.dump_chrome_trace(rnd["output"] + ".trace.json")
    walls = [round(s.get("total_s", 0.0), 3) for s in per_sample]
    stages = {k: round(v, 3) for k, v in rnd["stats"].items() if k.endswith("_s")}
    print(f"perfbench: round {tag}: wall {wall:.3f} s, samples' walls {walls}, "
          f"stages summed {json.dumps(stages)}, service {json.dumps(rnd['trace'])}",
          file=sys.stderr)
    return rnd


def _sample_stats(st, ids: list) -> list:
    """Each sample's stats line, as ``transform_streamed`` returned it to
    the scheduler, which keeps it on the job's record ({} where absent)."""
    records = st.service.scheduler._jobs
    return [getattr(records.get(j), "stats", None) or {} for j in ids]


def _summed(per_sample: list) -> dict:
    """The round's stage walls: each numeric key of every sample's stats
    line, summed over the samples."""
    keys = set.intersection(*(set(s) for s in per_sample)) if per_sample else set()
    return {k: sum(s[k] for s in per_sample) for k in sorted(keys)
            if all(type(s[k]) in (int, float) for s in per_sample)}


def run_job(st, k: int) -> dict:
    return _round(st, f"r{k}")


def spans(st) -> list:
    """The last round's program spans: [(name, t0_ns, t1_ns)], monotonic."""
    from adam_tpu_torch.utils import telemetry as tele

    return [(e["name"], e["ts_ns"], e["ts_ns"] + e["dur_ns"]) for e in tele.TRACE.events()
            if "ts_ns" in e and "dur_ns" in e]


def rate(st, jobs: list, window_s: float, metric: str) -> float:
    return sum(j["reads"] for j in jobs) / window_s


def release(st) -> None:
    import torch

    st.service.close()
    gc.collect()
    if st.device == "cuda":
        torch.cuda.empty_cache()


def check(st, jobs: list, seed: int) -> list:
    from perfbench.reference import service

    st.bytes_written = sum(os.path.getsize(os.path.join(o, f))
                           for j in jobs for o in j["outputs"] for f in os.listdir(o))
    checks, st.observed = service.check(jobs, st.inputs, seed, st.sites, st.device)
    return checks
