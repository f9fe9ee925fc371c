"""The service cell on the CPU at a tiny size: a sound rehearsal is
correct, a traced one reads every span, counter and stage metric of the
cell, and a sample's parts written in another's place turn ``correct``
false."""

from __future__ import annotations

from perfbench.harness import core
from perfbench.reference.service import SERVICE_CHECKS
from perfbench.tests._helpers import rehearse

CELL = "service.four_samples"
#: The cell's readers of the program's spans and counters (the device
#: and roofline readers find nothing on the CPU).
SPAN_AND_COUNTER_METRICS = {"service.ticket_wait_s", "service.pace_wait_s",
                            "service.fused_dispatch_s", "service.windows_per_dispatch"}
#: The flagship's stage readers, over a round's samples summed.
STAGE_METRICS = {f"transform.{n}_s" for n in (
    "ingest_pass_a", "resolve", "observe", "realign", "barrier2", "apply", "write_wait",
    "ingest_wait", "observe_md_walk", "observe_snp_mask", "realign_prep", "realign_sweep",
    "realign_decide", "oq_stash", "unattributed")}
DEVICE_METRICS = {"device_idle_pct.transform", "service.observe_hist_roofline",
                  "service.pack_rows_roofline"}


def test_a_sound_rehearsal_of_the_service_is_correct():
    out = rehearse(CELL)
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == set(SERVICE_CHECKS)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"transform_reads_per_s", "setup_s"}


def test_a_traced_rehearsal_reads_every_span_and_counter_metric():
    listed = {m["name"] for m in core.cell(CELL)["per_layer"]}
    assert listed == SPAN_AND_COUNTER_METRICS | STAGE_METRICS | DEVICE_METRICS
    out = rehearse(CELL, trace=1)
    assert out["correct"] is True, out["checks"]
    got = out["metrics"]
    want = SPAN_AND_COUNTER_METRICS | STAGE_METRICS
    assert want <= set(got), sorted(want - set(got))
    assert got["service.windows_per_dispatch"]["value"] > 1
    for name in want - {"transform.unattributed_s"}:
        assert got[name]["value"] > 0, name
    assert got["transform.unattributed_s"]["value"] >= 0


def test_a_sample_written_in_anothers_place_is_not_correct(monkeypatch):
    from adam_tpu_torch.pipelines import streamed

    orig = streamed.transform_streamed
    swap = {"A1.adam": "A2.adam", "A2.adam": "A1.adam"}

    def swapped(path, out_path, **kw):
        head, _, name = out_path.rpartition("/")
        return orig(path, f"{head}/{swap.get(name, name)}", **kw)

    monkeypatch.setattr(streamed, "transform_streamed", swapped)
    out = rehearse(CELL)
    assert out["correct"] is False
    assert out["checks"]["bases_differ"]["value"] > 0  # another sample's reads
