"""The observability flags of the port's command line against the JAX
CLI's on the same input: each verb's ``-print_metrics`` tables (the timer
rows with their counts, the counters, the gauges and histogram names)
once the times are masked, the ``analyze`` verb on an artifact the JAX
CLI wrote, and transform's warnings for ``--report`` and ``--progress``
without ``-streaming``."""

import contextlib
import io
import json
import os
import pathlib
import re
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

#: Timer rows the JAX CLI prints and the port does not: the host work
#: JAX overlaps with the realign sweeps has no counterpart without the
#: sweep fan-out (ROADMAP queue 1 item 4).
JAX_ONLY_TIMERS: set = set()
#: Counters and gauges of JAX's device ledger and pool that the port does
#: not record: none since ROADMAP queue 1 item 4 (the device pool, the
#: transfer and compile ledgers, the resident windows).
JAX_ONLY_METRICS: set = set()
#: The device ledger's byte totals: the port places a table once per slot,
#: fetches packed columns at their exact size and sweeps unpadded chunks,
#: so the bytes differ by design (``tests/test_torch_telemetry.py``
#: ``LEDGER_BYTES`` holds them per pass); compared by name only.
LEDGER_ROWS = {"device.h2d.bytes", "device.d2h.bytes"}
#: Rows whose value follows the run's thread timing or the overlap
#: design rather than the data: compared by name only.
TIMING_ROWS = {"streamed.observe_overlap_hidden", "device.dispatch.in_flight",
               "parquet.pool.queue_depth", "parquet.pool.inflight_bound"}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from make_wgs_sam import make_wgs

    d = tmp_path_factory.mktemp("obs_cli")
    sam = d / "in.sam"
    make_wgs(str(sam), 4500, 100, n_contigs=2, contig_len=30_000)
    from adam_tpu_torch.io import sam as sam_io

    sam_io.write_bam(str(d / "in.bam"), *sam_io.read_sam(str(sam)))
    return d


def _run(package, argv):
    if package == "jax":
        from adam_tpu.cli.main import main
        from adam_tpu.utils import instrumentation as ins
        from adam_tpu.utils import telemetry as tele
    else:
        from adam_tpu_torch.cli.main import main
        from adam_tpu_torch.utils import instrumentation as ins
        from adam_tpu_torch.utils import telemetry as tele

        argv = argv + ["--device", "cpu"]
    from adam_tpu.utils import compile_ledger as jcl

    from adam_tpu_torch.utils import compile_ledger as tcl

    # each run's first launches are its own: forget what earlier tests in
    # this worker launched (both ledgers are process-wide)
    jcl.reset()
    tcl.reset()
    tele.TRACE.reset()
    ins.TIMERS.reset()
    old = {k: os.environ.get(k) for k in ("ADAM_TPU_BQSR_BACKEND", "ADAM_TPU_RESIDENT")}
    os.environ.update(ADAM_TPU_BQSR_BACKEND="device", ADAM_TPU_RESIDENT="1")
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tele.TRACE.recording = ins.TIMERS.recording = False
    return rc, out.getvalue(), err.getvalue()


def _tables(stdout: str) -> dict:
    """The ``-print_metrics`` tables of a verb's standard output ->
    {section: [masked row]}: the timer rows keep their name and count,
    counter rows their value, gauge and histogram rows their name."""
    text = stdout[stdout.index("Timings\n=======\n"):]
    out: dict = {}
    section = None
    for line in text.splitlines():
        if line in ("Timings", "Counters", "Gauges", "Histograms (seconds)"):
            section = line
            out[section] = []
            continue
        if not line.strip() or set(line) == {"="} or section is None:
            continue
        name = re.split(r"\s{2,}", line.strip())[0]
        if name in ("timer", "counter", "gauge", "histogram"):
            continue  # the header row (its width follows the names)
        fields = line[len(name):].split() if line.startswith(name) else line.split()[1:]
        if section == "Timings":
            out[section].append((name, fields[0]))
        elif section == "Counters" and name not in TIMING_ROWS | LEDGER_ROWS:
            out[section].append((name, fields[0]))
        else:
            out[section].append((name,))
    return {k: sorted(v) for k, v in out.items()}


def _drop(rows, names):
    return [r for r in rows if r[0] not in names]


VERBS = {
    "flagstat": ["flagstat", "{d}/in.sam"],
    "count_kmers": ["count_kmers", "{d}/in.sam", "{out}/k.txt", "11"],
    "bam2adam": ["bam2adam", "{d}/in.bam", "{out}/b.adam"],
    "transform": ["transform", "{d}/in.sam", "{out}/t.adam", "-mark_duplicate_reads",
                  "-recalibrate_base_qualities", "-sort_reads"],
    "transform_streamed": ["transform", "{d}/in.sam", "{out}/s.adam", "-streaming",
                           "-mark_duplicate_reads", "-realign_indels",
                           "-recalibrate_base_qualities", "-window_reads", "2048"],
}


@pytest.mark.parametrize("verb", sorted(VERBS))
def test_print_metrics_tables_equal_jax_with_times_masked(inputs, tmp_path, verb):
    tables = {}
    for package in ("jax", "torch"):
        out = tmp_path / package
        out.mkdir()
        argv = [a.format(d=inputs, out=out) for a in VERBS[verb]] + ["-print_metrics"]
        if package == "jax" and verb == "transform_streamed":
            argv += ["--devices", "1"]  # the single-chip path the port has
        rc, stdout, err = _run(package, argv)
        assert rc == 0, err
        tables[package] = _tables(stdout)
    jax = {k: _drop(v, JAX_ONLY_TIMERS | JAX_ONLY_METRICS)
           for k, v in tables["jax"].items()}
    jax = {k: v for k, v in jax.items() if v}  # a section of JAX-only rows
    assert tables["torch"] == jax
    assert len(jax["Timings"]) >= 2


def test_analyze_of_a_jax_artifact_prints_jax_text(inputs, tmp_path):
    argv = ["transform", str(inputs / "in.sam"), str(tmp_path / "s.adam"), "-streaming",
            "-mark_duplicate_reads", "-recalibrate_base_qualities", "-window_reads", "2048",
            "--devices", "1", "--trace-out", str(tmp_path / "t.json"),
            "--metrics-json", str(tmp_path / "m.json")]
    assert _run("jax", argv)[0] == 0
    for art in ("t.json", "m.json"):
        got, want = [_run(p, ["analyze", str(tmp_path / art), "-json",
                              str(tmp_path / f"{p}.{art}")]) for p in ("torch", "jax")]
        assert got[0] == want[0] == 0
        assert got[1] == want[1] and got[1].startswith("Run report")
        assert json.loads((tmp_path / f"torch.{art}").read_text()) == \
            json.loads((tmp_path / f"jax.{art}").read_text())
    rc, out, err = _run("torch", ["analyze", str(tmp_path / "missing.json")])
    assert rc == 2 and out == "" and err.startswith("analyze: ")


@pytest.mark.parametrize("flags", [["--report", "{out}/r.txt"], ["--progress"],
                                   ["--progress", "{out}/p.ndjson"]])
@pytest.mark.parametrize("mode", [[], ["-shards", "2"]])
def test_transform_warns_as_jax_without_streaming(inputs, tmp_path, flags, mode):
    errs = []
    for package in ("jax", "torch"):
        out = tmp_path / package
        out.mkdir()
        argv = ["transform", str(inputs / "in.sam"), str(out / "o.adam"), *mode,
                "-mark_duplicate_reads", *[f.format(out=tmp_path) for f in flags]]
        rc, _, err = _run(package, argv)
        assert rc == 0, err
        assert not (tmp_path / "r.txt").exists() and not (tmp_path / "p.ndjson").exists()
        errs.append([ln for ln in err.splitlines() if ln.startswith("transform: ")])
    want = [ln.replace("'adam-tpu analyze'", "'python -m adam_tpu_torch analyze'")
            for ln in errs[0]]
    assert errs[1] == want and len(want) == 1


def test_report_to_an_unwritable_path_exits_2_before_the_run(inputs, tmp_path):
    argv = ["transform", str(inputs / "in.sam"), str(tmp_path / "o.adam"), "-streaming",
            "--report", str(tmp_path / "no" / "such" / "r.txt")]
    rc, _, err = _run("torch", argv)
    assert rc == 2 and err.startswith("transform: cannot write --report ")
    assert not (tmp_path / "o.adam").exists()


def test_failed_export_prints_jax_message(inputs, tmp_path):
    bad = str(tmp_path / "no" / "m.json")
    results = [_run(p, ["flagstat", str(inputs / "in.sam"), "--metrics-json", bad])
               for p in ("jax", "torch")]
    for rc, _, err in results:
        assert rc == 0
        assert f"telemetry export to {bad} failed: " in err
