"""The per-layer readers of the program's own spans: a traced rehearsal
of each transform cell reads every one listed for the cell, and the
shared reader gives nothing where a job's ``--trace-out`` export is
missing."""

from __future__ import annotations

import json

import pytest

from perfbench.harness import core
from perfbench.tests._helpers import rehearse

SPAN_METRICS = {
    "transform.ingest_wait_s", "transform.observe_md_walk_s", "transform.observe_snp_mask_s",
    "transform.known_sites_s", "transform.realign_prep_s", "transform.realign_sweep_s",
    "transform.realign_decide_s", "transform.oq_stash_s", "transform.unattributed_s",
}


@pytest.mark.parametrize("cell", ["transform.chr20_30x_dbsnp", "transform.chr20_30x_nosites"])
def test_a_traced_rehearsal_reads_every_span_metric_of_its_cell(cell):
    listed = {m["name"] for m in core.cell(cell)["per_layer"]} & SPAN_METRICS
    sites = cell.endswith("dbsnp")
    assert ({"transform.observe_snp_mask_s", "transform.known_sites_s"} <= listed) == sites
    out = rehearse(cell, trace=1)
    assert out["correct"] is True, out["checks"]
    got = out["metrics"]
    assert listed <= set(got), sorted(listed - set(got))
    for name in listed:
        assert got[name]["unit"] == "s/job"
        assert got[name]["value"] >= 0.0, name
    assert got["transform.realign_sweep_s"]["value"] > 0.0


def _run(tmp_path, n_jobs, spans):
    jobs = []
    for k in range(n_jobs):
        out = tmp_path / f"job{k}"
        jobs.append({"output": str(out)})
        if spans is not None:
            hists = {name: {"count": 1, "sum": s * (k + 1)} for name, s in spans.items()}
            (tmp_path / f"job{k}.trace.json").write_text(json.dumps({"histograms": hists}))
    return {"jobs": jobs}


def test_the_span_reader_averages_per_job_and_needs_every_export(tmp_path):
    from perfbench.metrics._spans import mean_span_s

    run = _run(tmp_path, 3, {"realign.prep": 0.5})
    assert mean_span_s(run, "realign.prep") == pytest.approx((0.5 + 1.0 + 1.5) / 3)
    assert mean_span_s(run, "bqsr.observe.snp_mask") is None  # no job recorded it
    (tmp_path / "job1.trace.json").unlink()
    assert mean_span_s(run, "realign.prep") is None
    assert mean_span_s(_run(tmp_path / "none", 1, None), "realign.prep") is None
