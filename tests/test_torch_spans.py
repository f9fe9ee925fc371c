"""The port's own spans (``telemetry.PORT_ONLY_SPANS``): where a streamed
transform's host time goes below the stage spans, the stats line's
``unattributed_s``, the spans of ``count_kmers`` and ``load_alignments``,
and ``analyze --device-trace``, which puts the program's spans on a
``--xprof-dir`` trace's clock (its start marker: ``tests/test_torch_telemetry.py``).  Recording off, nothing new is recorded
and the parts are the same bytes."""

import contextlib
import io
import json
import os
import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

S = int(1e9)
WINDOW = 2048

#: The streamed run's new spans, and the two that only known sites record.
STREAMED = {"streamed.setup", "streamed.pass_a.wait", "streamed.finish",
            "bqsr.observe.md_walk", "realign.prep", "realign.sweep", "realign.decide",
            "bqsr.apply.oq_stash"}
SITES_ONLY = {"transform.known_sites.load", "bqsr.observe.snp_mask"}


def _cli(argv):
    from adam_tpu_torch.cli.main import main
    from adam_tpu_torch.utils import compile_ledger
    from adam_tpu_torch.utils import instrumentation as ins
    from adam_tpu_torch.utils import telemetry as tele

    compile_ledger.reset()
    tele.TRACE.reset()
    ins.TIMERS.reset()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv + ["--device", "cpu"])
    assert rc == 0, err.getvalue()
    spans_after = tele.TRACE.snapshot()["spans"]
    tele.TRACE.recording = ins.TIMERS.recording = False
    return json.loads(out.getvalue().splitlines()[0]), spans_after


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from make_wgs_sam import make_wgs

    d = tmp_path_factory.mktemp("spans")
    sam, snps = str(d / "in.sam"), str(d / "snps.vcf")
    make_wgs(sam, 4500, 100, n_contigs=2, contig_len=30_000, known_sites_out=snps)
    flags = ["-streaming", "-mark_duplicate_reads", "-realign_indels",
             "-recalibrate_base_qualities", "-window_reads", str(WINDOW)]
    out = {}
    for name, extra in (("sites", ["-known_snps", snps]), ("nosites", []), ("off", [])):
        rec = [] if name == "off" else ["--trace-out", str(d / f"{name}.trace.json"),
                                        "--metrics-json", str(d / f"{name}.metrics.json")]
        stats, spans = _cli(["transform", sam, str(d / f"{name}.adam"), *flags, *extra, *rec])
        run = {"stats": stats, "global_spans": spans}
        if rec:
            run["trace"] = json.loads((d / f"{name}.trace.json").read_text())
            run["metrics"] = json.loads((d / f"{name}.metrics.json").read_text())
        out[name] = run
    return d, out


@pytest.mark.parametrize("name", ["sites", "nosites"])
def test_a_traced_run_records_every_new_span(runs, name):
    from adam_tpu_torch.utils import telemetry as tele

    r = runs[1][name]
    hists = r["trace"]["histograms"]
    recorded = set(hists) & tele.PORT_ONLY_SPANS
    assert recorded == (STREAMED | SITES_ONLY if name == "sites" else STREAMED)
    # one wait per window, one set-up and one finish per run
    assert hists["streamed.pass_a.wait"]["count"] == r["stats"]["n_windows"] == 3
    assert hists["streamed.setup"]["count"] == hists["streamed.finish"]["count"] == 1
    # the realign tail's phases: three prep, two sweep, one decide
    assert [hists[f"realign.{p}"]["count"] for p in ("prep", "sweep", "decide")] == [3, 2, 1]
    assert set(r["metrics"]["spans"]) & tele.PORT_ONLY_SPANS == recorded


def test_one_snp_mask_a_sites_observe_and_its_counter(runs):
    """With known sites, one ``bqsr.observe.snp_mask`` span per observe
    (each window's and the realigned part's, as the MD walk's), and the
    ``bqsr.observe.snp_masked`` counter is JAX's mask summed over what the
    observes walk: every row of the input (a window walks its candidates
    too, masked out of its reads) and the realigned part.  Without known
    sites, neither."""
    from adam_tpu.io import load_alignments
    from adam_tpu.models.snp_table import SnpTable as JSnpTable
    from adam_tpu.ops.cigar import reference_positions_np as jref_pos

    d, r = runs
    hists = r["sites"]["trace"]["histograms"]
    assert hists["bqsr.observe.snp_mask"]["count"] == hists["bqsr.observe.md_walk"]["count"] == 4
    table = JSnpTable.from_file(str(d / "snps.vcf"))

    def jax_mask_sum(path):
        ds = load_alignments(path)
        b = ds.batch.to_numpy()
        return int(table.mask_positions(
            ds.seq_dict.names, b.contig_idx,
            jref_pos(b.cigar_ops, b.cigar_lens, b.cigar_n, b.start, b.lmax)).sum())

    realigned = d / "sites.adam" / f"part-r-{r['sites']['stats']['n_windows']:05d}.parquet"
    want = jax_mask_sum(str(d / "in.sam")) + jax_mask_sum(str(realigned))
    assert r["sites"]["metrics"]["counters"]["bqsr.observe.snp_masked"] == want > 100
    for name in ("nosites", "off"):
        assert "bqsr.observe.snp_mask" not in r[name]["global_spans"]
        assert r[name].get("metrics", {}).get("counters", {}).get(
            "bqsr.observe.snp_masked", 0) == 0


def test_the_realign_spans_nest_inside_the_tail_on_its_thread(runs):
    r = runs[1]["sites"]
    evs = [e for e in r["trace"]["traceEvents"] if e.get("ph") == "X"]
    tail = next(e for e in evs if e["name"] == "streamed.tail")
    phases = [e for e in evs if e["name"].startswith("realign.")]
    assert len(phases) == 6
    for e in phases:
        assert e["tid"] == tail["tid"]
        assert tail["ts"] <= e["ts"] and e["ts"] + e["dur"] <= tail["ts"] + tail["dur"] + 1e-3


def test_each_realign_timer_row_is_its_spans_measurement(runs):
    """The named-timer rows of the realign phases and their spans come
    from one measurement: each span's total is the sum of its rows."""
    from adam_tpu_torch.pipelines.realign import _PHASE_SPANS

    r = runs[1]["sites"]
    timers, spans = r["metrics"]["timers"], r["metrics"]["spans"]
    for span in set(_PHASE_SPANS.values()):
        rows = [label for label, s in _PHASE_SPANS.items() if s == span and label in timers]
        assert rows
        assert sum(timers[label]["total_s"] for label in rows) == pytest.approx(
            spans[span]["total_s"], rel=1e-12)
        assert sum(timers[label]["count"] for label in rows) == spans[span]["count"]


@pytest.mark.parametrize("name", ["sites", "nosites", "off"])
def test_unattributed_s_lies_between_zero_and_the_total(runs, name):
    from adam_tpu_torch.utils import telemetry as tele

    r = runs[1][name]
    stats = r["stats"]
    assert 0.0 <= stats["unattributed_s"] <= stats["total_s"]
    if name != "off":  # the view of the exported span totals
        assert stats["unattributed_s"] == tele.streamed_unattributed_s(r["metrics"])


def test_recording_off_records_nothing_and_writes_the_same_bytes(runs):
    d, r = runs
    assert r["off"]["global_spans"] == {}
    assert set(r["off"]["stats"]) == set(r["nosites"]["stats"])

    def parts(name):
        p = d / f"{name}.adam"
        return {f: (p / f).read_bytes() for f in sorted(os.listdir(p)) if f.startswith("part-")}

    assert len(parts("off")) == 4
    assert parts("off") == parts("nosites")


@pytest.mark.parametrize("recording", [True, False])
def test_load_alignments_and_count_kmers_record_their_spans(runs, recording):
    from adam_tpu_torch.io import context
    from adam_tpu_torch.utils import telemetry as tele

    d, _ = runs
    tele.TRACE.reset()
    tele.TRACE.recording = recording
    try:
        ds = context.load_alignments(str(d / "nosites.adam"), projection=["sequence", "qual"])
        counts = ds.count_kmers(11, device="cpu")
        spans = tele.TRACE.snapshot()["spans"]
    finally:
        tele.TRACE.recording = False
        tele.TRACE.reset()
    assert counts
    want = {"parquet.read_table", "parquet.from_arrow", "kmers.histogram", "kmers.decode"}
    if recording:
        assert {n: spans[n]["count"] for n in want} == dict.fromkeys(want, 1)
    else:
        assert spans == {}


# --------------------------------------------------------------------------
# analyze --device-trace
# --------------------------------------------------------------------------
def _pair(tmp_path, marker=True):
    """A program trace and a device trace of one 10 s run: the device is
    busy for 0-2 s and 5-10 s; 2-5 s lies under the main thread's
    ``bqsr.observe.snp_mask`` and, shorter, under a writer thread's span."""
    from adam_tpu_torch.utils import instrumentation as ins
    from adam_tpu_torch.utils import telemetry as tele

    t0 = tele._EPOCH_NS + 3 * S
    tr = tele.Tracer(recording=True)
    tr.add_span(tele.SPAN_TOTAL, t0, 10 * S, thread="MainThread")
    tr.add_span(tele.SPAN_OBSERVE, t0 + S, 5 * S, thread="MainThread")
    tr.add_span(tele.SPAN_OBSERVE_SNP_MASK, t0 + 2 * S, 3 * S, thread="MainThread")
    tr.add_span(tele.SPAN_PART_WRITE, t0 + 2 * S, 2 * S + S // 2, thread="writer-0")
    prog = tmp_path / "t.json"
    prog.write_text(json.dumps(tr.to_chrome_trace()))
    mark_us = 7_000_000.0  # the marker's ts, noted at the program's t0 - 1 s
    evs = [{"ph": "X", "cat": "user_annotation", "name": ins.DEVICE_TRACE_MARK,
            "ts": mark_us, "dur": 1.0}] if marker else []
    base = mark_us + 1e6  # t0 on the device trace's clock
    evs += [{"ph": "X", "cat": "kernel", "name": "k", "ts": base, "dur": 2e6},
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": base + 5e6,
             "dur": 5e6}]
    dev = {"traceEvents": evs, ins.DEVICE_TRACE_MARK_NS: t0 - S}
    (tmp_path / "xp").mkdir()
    (tmp_path / "xp" / "trace-1.json").write_text(json.dumps(dev))
    return prog, tmp_path / "xp" / "trace-1.json"


def _analyze(argv):
    from adam_tpu_torch.cli.main import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["analyze", *argv])
    return rc, out.getvalue(), err.getvalue()


def test_analyze_device_trace_names_a_gap_by_its_main_thread_span(tmp_path):
    from adam_tpu_torch.utils import analyzer

    prog, xp = _pair(tmp_path)
    dt = analyzer.device_trace_report(analyzer.load_document(str(prog)),
                                      analyzer.load_document(str(xp)))
    assert dt["window_of"] == "streamed.total"
    assert dt["window_s"] == pytest.approx(10.0)
    assert dt["busy_share"] == pytest.approx(0.7)
    longest = dt["idle_gaps"][0]
    assert longest["span"] == "bqsr.observe.snp_mask"
    assert longest["seconds"] == pytest.approx(3.0) and longest["at_s"] == pytest.approx(2.0)
    rc, out, _ = _analyze([str(prog), "--device-trace", str(xp), "-json",
                           str(tmp_path / "r.json")])
    assert rc == 0
    plain = _analyze([str(prog)])[1]
    assert out.startswith(plain.rstrip("\n"))  # the report as it was, then the section
    assert "Device trace" in out and "bqsr.observe.snp_mask" in out
    assert json.loads((tmp_path / "r.json").read_text())["device_trace"]["idle_gaps"][0][
        "span"] == "bqsr.observe.snp_mask"


def test_analyze_device_trace_refuses_a_trace_without_its_marker(tmp_path):
    prog, xp = _pair(tmp_path, marker=False)
    rc, _, err = _analyze([str(prog), "--device-trace", str(xp)])
    assert rc == 2 and "marker" in err
