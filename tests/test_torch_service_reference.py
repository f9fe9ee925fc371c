"""The transform service against the plain reference, on the CPU at a tiny
size.

Four seeded samples of two weighted tenants (A:2, B:1), each with its own
known-sites VCF, go through ``TransformService(max_jobs=4)`` at once,
batched and unbatched.  Each sample's published columns must equal
``perfbench.reference.transform.expected`` for that sample alone: the
service's isolation and exactness.  The service's two waits are recorded
once per coalescer ticket and once per WFQ turn, and a band leak in the
fused observe is seen by the comparison.
"""

from __future__ import annotations

import pytest

from perfbench.reference import compare, transform
from perfbench.traffic import bam, wgs

SAMPLES = (("A1", "A", 2.0), ("A2", "A", 2.0), ("B1", "B", 1.0), ("B2", "B", 1.0))
PARAMS = dict(reads=1500, read_len=101, contigs=2, contig_len=15_000)
WINDOW = 512


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    d = tmp_path_factory.mktemp("service-ref")
    out = []
    for i, (job, tenant, weight) in enumerate(SAMPLES):
        reads = wgs.make_reads(PARAMS, 3_000_000_501 + i)
        bam.write_bam(str(d / f"{job}.bam"), reads)
        wgs.write_vcf(str(d / f"{job}.vcf"), reads)
        out.append({"job": job, "tenant": tenant, "weight": weight,
                    "bam": str(d / f"{job}.bam"), "vcf": str(d / f"{job}.vcf"),
                    "ref": transform.expected(reads, True)})
    return out


def _serve(root, samples, batching: bool) -> dict:
    """One round of the four samples through the service -> the jobs'
    states, the grants made, ``TRACE``'s snapshot and each sample's
    disagreements with its reference."""
    from adam_tpu_torch.api.transform_service import TransformService
    from adam_tpu_torch.serve import Admitted, JobSpec
    from adam_tpu_torch.utils import telemetry as tele

    tele.TRACE.reset()
    svc = TransformService(str(root / "root"), max_jobs=4, batching=batching, device="cpu")
    try:
        for s in samples:
            spec = JobSpec(job_id=s["job"], input=s["bam"], output=str(root / s["job"]),
                           tenant=s["tenant"], weight=s["weight"], known_snps=s["vcf"],
                           window_reads=WINDOW)
            assert isinstance(svc.submit(spec), Admitted)
        assert svc.wait(timeout=300)
        states = {j: v["state"] for j, v in svc.status()["jobs"].items()}
        grants = len(svc.scheduler.grant_times())
        snap = tele.TRACE.snapshot()
    finally:
        svc.close()
    counts = {s["job"]: {n: v for n, v, _ in compare.compare_transform(
        s["ref"], compare.read_transform_output(str(root / s["job"])))} for s in samples}
    return {"states": states, "grants": grants, "snap": snap, "counts": counts}


@pytest.mark.parametrize("batching", [False, True], ids=["unbatched", "batched"])
def test_each_sample_equals_the_reference_for_it_alone(tmp_path, samples, batching):
    r = _serve(tmp_path, samples, batching)
    assert set(r["states"].values()) == {"done"}, r["states"]
    for job, counts in r["counts"].items():
        assert all(v == 0 for v in counts.values()), (job, counts)
    c, spans = r["snap"]["counters"], r["snap"]["spans"]
    assert spans["sched.pace.wait"]["count"] == r["grants"] > 0  # once per turn
    if batching:
        assert c["sched.batch.windows"] > c["sched.batch.dispatches"]
        assert c.get("sched.batch.fallbacks", 0) == 0
        # once per ticket: every ticket rode a fused dispatch
        assert spans["sched.batch.ticket_wait"]["count"] == c["sched.batch.windows"]
    else:
        assert "sched.batch.ticket_wait" not in spans


def test_a_band_leak_between_jobs_is_seen(tmp_path, samples, monkeypatch):
    """Every ticket's read groups put into the first band of the fused
    table (one job's observations handed to another's): the samples no
    longer equal their references."""
    from adam_tpu_torch.serve import batching

    orig = batching._band_rg
    monkeypatch.setattr(batching, "_band_rg", lambda rg, base, n_rg_i: orig(rg, 0, n_rg_i))
    r = _serve(tmp_path, samples, True)
    assert set(r["states"].values()) == {"done"}
    assert r["snap"]["counters"].get("sched.batch.fallbacks", 0) == 0
    assert sum(sum(c.values()) for c in r["counts"].values()) > 0
