"""The port's command line has the JAX CLI's shape (``adam_tpu/cli/main.py``):
every verb takes JAX's shared flags, each observability flag acts, the
multi-device flags act (``--devices`` caps the streamed transform's pool,
``--partitioner`` picks its mode), usage and exit codes match, and a closed standard output ends a verb with
exit code 0 and no traceback.  Both packages' CLIs run on the same input."""

import argparse
import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

#: JAX's shared flags with a non-default value each (the same in both CLIs)
SHARED = ["-log_level", "info", "-stringency", "strict",
          "-parquet_compression_codec", "snappy", "-parquet_block_size", "1",
          "-parquet_page_size", "2", "-parquet_disable_dictionary",
          "--fault-spec", "proc.kill=kill,after=99"]
SHARED_DESTS = ("log_level", "stringency", "parquet_compression_codec",
                "parquet_block_size", "parquet_page_size",
                "parquet_disable_dictionary", "fault_spec")


@pytest.fixture(scope="module")
def sam(tmp_path_factory):
    from make_synth_sam import make_sam

    path = tmp_path_factory.mktemp("cli_common") / "in.sam"
    make_sam(str(path), 20_000, 100, seed=3)
    return path


def _positionals(parser) -> list:
    """One placeholder per required positional of ``parser``, then each
    required option with a placeholder (``submit --jobs``)."""
    return ["1" for a in parser._actions
            if not a.option_strings and a.nargs in (None, "+")] + [
        x for a in parser._actions if a.option_strings and a.required
        for x in (a.option_strings[0], "1")]


def _jax_parser(name):
    from adam_tpu.cli.main import add_common_args, command_groups

    cmd = {c.name: c for _, cmds in command_groups() for c in cmds}[name]
    p = argparse.ArgumentParser(allow_abbrev=False)
    add_common_args(p)
    cmd.configure(p)
    return p


def _port_verbs():
    from adam_tpu_torch.cli.main import command_groups

    return [c.name for _, cmds in command_groups() for c in cmds]


def test_groups_and_order_are_jax_for_the_ported_verbs():
    from adam_tpu.cli.main import command_groups as jax_groups

    from adam_tpu_torch.cli.main import command_groups

    jax = {g: [c.name for c in cmds] for g, cmds in jax_groups()}
    for group, cmds in command_groups():
        names = [c.name for c in cmds]
        assert names == [n for n in jax[group] if n in names], group
    jax_desc = {c.name: c.description for _, cmds in jax_groups() for c in cmds}
    assert all(c.description == jax_desc[c.name]
               for _, cmds in command_groups() for c in cmds)
    assert len(_port_verbs()) == 30


@pytest.mark.parametrize("verb", [
    "depth", "count_kmers", "count_contig_kmers", "transform", "adam2fastq", "plugin",
    "flatten", "bam2adam", "vcf2adam", "anno2adam", "adam2vcf", "fasta2adam",
    "features2adam", "wigfix2bed", "print", "print_genes", "flagstat", "print_tags",
    "listdict", "allelecount", "buildinfo", "view", "analyze", "serve", "submit",
    "status", "fetch", "cancel", "incidents", "perf"])
def test_every_verb_parses_the_shared_flags_as_jax(verb):
    from adam_tpu_torch.cli.main import parser_for

    port = parser_for(verb)
    jax = _jax_parser(verb)
    argv = _positionals(port) + SHARED
    assert _positionals(port) == _positionals(jax)
    got, want = port.parse_args(argv), jax.parse_args(argv)
    for dest in SHARED_DESTS:
        assert getattr(got, dest) == getattr(want, dest), dest
    # every flag of the JAX verb is there, with JAX's name and default
    got_all = vars(port.parse_args(_positionals(port)))
    want_all = vars(jax.parse_args(_positionals(jax)))
    assert {k: got_all.get(k, "missing") for k in want_all} == want_all
    assert got.device == "cuda"


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [
    ["flagstat", "{sam}", "-parquet_block_size", "1", "-log_level", "info"],
    ["flagstat", "{sam}", "-stringency", "silent", "--devices", "1"],
    ["view", "{sam}", "-c", "-F", "1024", "-parquet_compression_codec", "gzip"],
    ["view", "{sam}", "-c", "-f", "64", "-o", "{tmp}/v.sam", "-parquet_page_size", "9"],
    ["count_kmers", "{sam}", "{tmp}/k.txt", "5", "-stringency", "strict",
     "-parquet_disable_dictionary", "-printHistogram"],
])
def test_shared_flags_run_as_in_jax(sam, tmp_path, argv):
    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    argv = [a.format(sam=sam, tmp=tmp_path) for a in argv]
    jrc, jout, _ = _run(jax_main, argv)
    outputs = {}
    for f in tmp_path.iterdir():
        outputs[f.name] = f.read_bytes()
        f.unlink()
    rc, out, _ = _run(main, argv + ["--device", "cpu"])
    assert rc == jrc == 0
    assert out == jout
    for name, data in outputs.items():
        assert (tmp_path / name).read_bytes() == data, name


@pytest.mark.parametrize("flags,expect", [
    (["--devices", "2"], {"n_devices": 1, "partitioner": "pool"}),
    (["--partitioner", "mesh"], {"n_devices": 1, "partitioner": "mesh"}),
    (["--partitioner", "pool"], {"n_devices": 1, "partitioner": "pool"}),
])
def test_unported_flags_exit_2_naming_their_item(sam, tmp_path, flags, expect):
    """The multi-device flags act, as JAX's do: the
    streamed transform runs with them (``--devices 2`` on one CPU device is
    capped to one, with JAX's warning; ``--partitioner`` sets the mode the
    stats line reports) and writes the parts of the run without them; a
    verb that places no device work accepts and ignores them."""
    import logging

    from adam_tpu_torch.cli.main import main

    rc, out, _ = _run(main, ["flagstat", str(sam), *flags, "--device", "cpu"])
    rc0, out0, _ = _run(main, ["flagstat", str(sam), "--device", "cpu"])
    assert rc == rc0 == 0 and out == out0
    with_flags = tmp_path / "with"
    with_flags.mkdir()
    without = tmp_path / "without"
    without.mkdir()
    warnings = []

    class Grab(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    grab = Grab(logging.WARNING)
    logging.getLogger().addHandler(grab)
    try:
        rc, out, _ = _run(main, _streamed(sam, with_flags) + [*flags, "--device", "cpu"])
    finally:
        logging.getLogger().removeHandler(grab)
    assert rc == 0
    stats = json.loads(out.splitlines()[0])
    assert {k: stats[k] for k in expect} == expect
    if flags[0] == "--devices":
        assert any("--devices 2 requested but only 1 attached" in w for w in warnings)
    rc, _out, _ = _run(main, _streamed(sam, without) + ["--device", "cpu"])
    assert rc == 0

    def parts(d):
        return {f: (d / "o.adam" / f).read_bytes()
                for f in sorted(os.listdir(d / "o.adam")) if f.startswith("part-")}

    assert parts(with_flags) == parts(without) and parts(without)


def _streamed(sam, tmp_path):
    return ["transform", str(sam), str(tmp_path / "o.adam"), "-streaming",
            "-mark_duplicate_reads", "-recalibrate_base_qualities",
            "-window_reads", "8192"]


def _check_print_metrics(tmp_path, out, err):
    assert "Timings\n=======\n" in out and "Flag Stat" in out
    # then the tracer's table: the native tokenizer's span histogram
    assert "Histograms (seconds)\n" in out and "Tokenize Input (native)" in out


def _check_metrics_json(tmp_path, out, err):
    doc = json.loads((tmp_path / "m.json").read_text())
    assert doc["meta"]["schema"] == "adam_tpu.telemetry/1"
    assert doc["timers"]["Flag Stat"]["count"] == 1


def _check_trace_out(tmp_path, out, err):
    doc = json.loads((tmp_path / "t.json").read_text())
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert "streamed.total" in names and "streamed.tokenize" in names


def _beats(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith('{"schema"')]


def _check_progress_stderr(tmp_path, out, err):
    beats = _beats(err)
    assert beats and beats[-1]["done"] is True and beats[-1]["ok"] is True
    assert beats[-1]["reads_ingested"] == 20_000 and beats[-1]["parts_written"] == 3
    assert beats[-1]["hbm_bytes_in_use"] == {}  # the CPU reports no card memory


def _check_progress_path(tmp_path, out, err):
    assert _beats(err) == []
    beats = _beats((tmp_path / "p.ndjson").read_text())
    assert [b["seq"] for b in beats] == list(range(len(beats)))
    assert beats[-1]["done"] is True and beats[-1]["windows_total"] == 3


def _check_xprof(tmp_path, out, err):
    files = list((tmp_path / "xp").iterdir())
    assert len(files) == 1
    doc = json.loads(files[0].read_text())
    assert doc["traceEvents"]


def _check_report(tmp_path, out, err):
    text = (tmp_path / "r.txt").read_text()
    assert text.startswith("Run report (trace mode)")
    assert "Stage / barrier decomposition" in text and "pass_c_apply" in text


@pytest.mark.parametrize("case", [
    ("flagstat", ["-print_metrics"], _check_print_metrics),
    ("flagstat", ["--metrics-json", "{tmp}/m.json"], _check_metrics_json),
    ("streamed", ["--trace-out", "{tmp}/t.json"], _check_trace_out),
    ("streamed", ["--progress"], _check_progress_stderr),
    ("streamed", ["--progress", "{tmp}/p.ndjson"], _check_progress_path),
    ("flagstat", ["--xprof-dir", "{tmp}/xp"], _check_xprof),
    ("streamed", ["--report", "{tmp}/r.txt"], _check_report),
], ids=["print_metrics", "metrics_json", "trace_out", "progress_stderr",
        "progress_path", "xprof_dir", "report"])
def test_observability_flag_acts(sam, tmp_path, case):
    from adam_tpu_torch.cli.main import main
    from adam_tpu_torch.utils import instrumentation as ins
    from adam_tpu_torch.utils import telemetry as tele

    verb, flags, check = case
    argv = _streamed(sam, tmp_path) if verb == "streamed" else ["flagstat", str(sam)]
    tele.TRACE.reset()
    ins.TIMERS.reset()
    rc, out, err = _run(main, argv + [f.format(tmp=tmp_path) for f in flags]
                        + ["--device", "cpu"])
    tele.TRACE.recording = ins.TIMERS.recording = False
    assert rc == 0, err
    check(tmp_path, out, err)


@pytest.mark.parametrize("argv", [[], ["-h"], ["--help"]])
def test_usage_exits_0_in_both(argv):
    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    for fn in (main, jax_main):
        rc, out, err = _run(fn, argv)
        assert rc == 0 and err == ""
        assert out.startswith("\nUsage: ")
        assert "ADAM ACTIONS\n" in out and "PRINT\n" in out
    assert "           transform : " in _run(main, argv)[1]


@pytest.mark.parametrize("verb", ["bogus", "top", "Transform"])
def test_unknown_verb_exits_1_in_both(verb):
    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    rc, out, err = _run(main, [verb, "x"])
    assert rc == 1 and out == ""
    assert err.startswith(f"unknown command: {verb}\n\nUsage: ")
    if verb != "top":  # a JAX verb the port does not have yet
        jrc, _, jerr = _run(jax_main, [verb, "x"])
        assert jrc == 1 and jerr.startswith(f"unknown command: {verb}\n")


@pytest.mark.parametrize("package", ["adam_tpu_torch", "adam_tpu.cli.main"])
def test_view_into_a_closed_pipe_exits_0(sam, package):
    argv = [sys.executable, "-m", package, "view", str(sam)]
    if package == "adam_tpu_torch":
        argv += ["--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(argv, cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    first = proc.stdout.readline()
    proc.stdout.close()  # the reader is gone, as after `| head -1`
    try:
        rc = proc.wait(timeout=120)
    finally:
        err = proc.stderr.read().decode()
        proc.stderr.close()
    assert first.startswith(b"read")
    assert rc == 0, err
    assert "Traceback" not in err and "BrokenPipeError" not in err


def test_the_cli_resolves_the_device_before_the_verb(sam, tmp_path):
    import torch

    from adam_tpu_torch.cli.main import main

    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a card")
    for argv in (["listdict", str(sam)], ["flatten", "a", str(tmp_path / "b")],
                 ["print", "a"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    rc, out, _ = _run(main, ["buildinfo"])  # reports the device, checks none
    assert rc == 0 and out.splitlines()[-1] == "device: cpu"
