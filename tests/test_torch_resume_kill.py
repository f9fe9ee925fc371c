"""The SIGKILL-and-resume matrix of the port (``tests/test_streamed.py``'s
``test_streamed_sigkill_then_resume_bit_identical`` for
``adam_tpu_torch``): the streamed transform is run through the command
line in a subprocess armed with a ``proc.kill`` fault
(``adam_tpu_torch/utils/faults.py``), so it SIGKILLs itself at a chosen
phase; then ``--resume`` finishes the run.  At every phase the port arms
(``ingest``, ``pass_a``, ``pass_b``, ``fused_bc`` with a known table,
``barrier2`` at its entry and its exit, ``pass_c`` and ``write``) the
output is byte-identical to the uninterrupted run, which is the JAX
package's, and no staging residue is left.  The matrix has a file of its
own so that xdist's ``--dist loadfile`` gives it a worker."""

import contextlib
import io
import json
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

WINDOW = 256
N_READS = 2048
FLAGS = ["-streaming", "-mark_duplicate_reads", "-realign_indels",
         "-recalibrate_base_qualities", "-window_reads", str(WINDOW)]


def _parts(d) -> dict:
    return {f: (pathlib.Path(d) / f).read_bytes()
            for f in sorted(os.listdir(d)) if f.startswith("part-")}


def _cli(argv) -> dict:
    from adam_tpu_torch.cli.main import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def kill_input(tmp_path_factory):
    """The input, a known table (the discovered run's), and the
    uninterrupted runs of the port, with and without the table, each
    checked against the JAX package's run."""
    from make_wgs_sam import make_wgs

    from adam_tpu.pipelines.streamed import transform_streamed as jax_transform

    d = tmp_path_factory.mktemp("kill_resume")
    sam = d / "in.sam"
    make_wgs(str(sam), N_READS, 100, n_contigs=2, contig_len=20_000)
    _cli(["transform", str(sam), str(d / "clean.adam"), *FLAGS,
          "--run-dir", str(d / "rd"), "--device", "cpu"])
    table = d / "rd" / "table.npz"
    _cli(["transform", str(sam), str(d / "known.adam"), *FLAGS,
          "-known_recalibration_table", str(table), "--device", "cpu"])
    with np.load(str(table)) as z:
        known = (np.asarray(z["table"]), int(z["gl"]))
    mp = pytest.MonkeyPatch()
    mp.setenv("ADAM_TPU_BQSR_BACKEND", "device")
    mp.setenv("ADAM_TPU_RESIDENT", "1")
    try:
        jax_transform(str(sam), str(d / "clean.jax"), window_reads=WINDOW)
        jax_transform(str(sam), str(d / "known.jax"), window_reads=WINDOW,
                      known_table=known)
    finally:
        mp.undo()
    base = {"clean": _parts(d / "clean.adam"), "known": _parts(d / "known.adam")}
    assert base["clean"] == _parts(d / "clean.jax")
    assert base["known"] == _parts(d / "known.jax")
    assert len(base["clean"]) == N_READS // WINDOW + 1
    return d, table, base


#: (phase, arrivals skipped before the kill, what the kill leaves): one
#: SIGKILL at each phase the proc.kill point exposes; barrier2 arrives at
#: its entry (after=0: nothing journaled yet) and at its exit (after=1:
#: the table journaled)
_MATRIX = [
    ("ingest", 3), ("pass_a", 4), ("pass_b", 2), ("fused_bc", 1),
    ("barrier2", 0), ("barrier2", 1), ("pass_c", 2), ("write", 1),
]
_IDS = ["ingest", "pass_a", "pass_b", "fused_bc", "barrier2_entry",
        "barrier2_exit", "pass_c", "write"]


@pytest.mark.parametrize("phase,after", _MATRIX, ids=_IDS)
def test_sigkill_then_resume_is_byte_identical(kill_input, tmp_path, phase, after):
    d, table, base = kill_input
    out, rd = tmp_path / "out.adam", tmp_path / "rd"
    extra = ["-known_recalibration_table", str(table)] if phase == "fused_bc" else []
    argv = ["transform", str(d / "in.sam"), str(out), *FLAGS, *extra,
            "--run-dir", str(rd), "--device", "cpu"]
    spec = f"proc.kill=kill,device={phase},after={after},times=1"
    env = dict(os.environ, PYTHONPATH=str(REPO), ADAM_TPU_FUSED_BC="1")
    env.pop("ADAM_TPU_FAULTS", None)
    if phase == "pass_c":
        cmd = argv + ["--fault-spec", spec]  # the flag, and elsewhere the variable
    else:
        cmd = argv
        env["ADAM_TPU_FAULTS"] = spec
    res = subprocess.run([sys.executable, "-m", "adam_tpu_torch", *cmd], env=env,
                         cwd=str(REPO), capture_output=True, text=True, timeout=600)
    assert res.returncode == -signal.SIGKILL, (phase, res.returncode, res.stderr[-2000:])
    assert res.stdout == ""  # killed before its stats line
    journaled = (rd / "table.npz").is_file()
    assert journaled == (phase in ("pass_c", "write") or (phase, after) == ("barrier2", 1))

    s = _cli(argv + ["--resume"])
    want = base["known" if phase == "fused_bc" else "clean"]
    assert _parts(out) == want, phase
    assert s["resume.refused"] == 0
    assert s["windows_resumed"] + s["windows_fresh"] == len(want)
    if journaled:
        # the table was journaled: pass B's observe, the merge and the
        # solve are skipped
        assert s["resume.histograms_loaded"] == 0 and s["obs_merge_s"] == 0
    if phase == "write":
        # killed after its second publish, before that part's journal record
        assert s["windows_resumed"] >= 1
    if phase == "fused_bc":
        assert s["fused_bc"] and s["n_fused_windows"] > 0
    # crash consistency: no staging residue
    assert not [f for f in os.listdir(out) if f.endswith(".tmp")]
    assert not (out / "_temporary").exists()
    assert not [f for f in os.listdir(rd) if f.endswith(".tmp")]
