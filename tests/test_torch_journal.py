"""The streamed run journal of the port (``--run-dir`` / ``--resume``:
``adam_tpu_torch/pipelines/checkpoint.RunJournal`` and the hooks in
``adam_tpu_torch/pipelines/streamed.py``) against the JAX package's
(``adam_tpu/pipelines/checkpoint.RunJournal``, ``adam_tpu/pipelines/
streamed.py``), mirroring ``tests/test_streamed.py``'s resume tests: a
journaled run and its resume write the journal-free run's bytes (JAX's
bytes); deleted parts are rewritten, and only those; a changed input,
window plan, stage flag or known table, and a torn or foreign journal, is
refused with a clean restart; a ``-dump_observations`` resume observes
again and solves the journaled table's bytes; the fingerprint, the sidecars
and the table are JAX's; and a run directory that JAX journaled resumes
in the port to JAX's bytes."""

import contextlib
import io
import json
import os
import pathlib
import shutil
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

WINDOW = 256
N_READS = 2048


def _parts(d) -> dict:
    return {f: (pathlib.Path(d) / f).read_bytes()
            for f in sorted(os.listdir(d)) if f.startswith("part-")}


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _port(path, out, **kw):
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    kw.setdefault("window_reads", WINDOW)
    return transform_streamed(str(path), str(out), device="cpu", **kw)


def _jax(path, out, **kw):
    """The JAX streamed run in the environment the port's bytes match
    (device BQSR backend, resident windows)."""
    from adam_tpu.pipelines.streamed import transform_streamed

    kw.setdefault("window_reads", WINDOW)
    with _env(ADAM_TPU_BQSR_BACKEND="device", ADAM_TPU_RESIDENT="1"):
        return transform_streamed(str(path), str(out), **kw)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A WGS-shaped SAM with its known-SNP and known-indel VCFs, a second
    SAM (another seed), the journal-free runs of both packages, and a
    journaled port run that the tests copy."""
    from make_known_indels_vcf import make_known_indels_vcf
    from make_wgs_sam import make_wgs

    d = tmp_path_factory.mktemp("journal")
    sam, snps, indels = d / "in.sam", d / "snps.vcf", d / "indels.vcf"
    make_wgs(str(sam), N_READS, 100, n_contigs=2, contig_len=20_000,
             known_sites_out=str(snps))
    assert make_known_indels_vcf(str(sam), str(indels)) > 0
    make_wgs(str(d / "b.sam"), N_READS + 512, 100, seed=3, n_contigs=2,
             contig_len=20_000)
    _port(sam, d / "clean.torch")
    _jax(sam, d / "clean.jax")
    stats = _port(sam, d / "j.adam", run_dir=str(d / "rd"))
    return d, stats


def _copy_journaled(inputs, tmp_path):
    d, _ = inputs
    out, rd = tmp_path / "out.adam", tmp_path / "rd"
    shutil.copytree(d / "j.adam", out)
    shutil.copytree(d / "rd", rd)
    return out, rd


def test_journal_free_run_equals_jax(inputs):
    d, _ = inputs
    got, want = _parts(d / "clean.torch"), _parts(d / "clean.jax")
    assert len(want) == N_READS // WINDOW + 1
    assert got == want


def test_journaled_run_and_full_resume_write_the_same_bytes(inputs, tmp_path, monkeypatch):
    from adam_tpu_torch.pipelines import bqsr
    from adam_tpu_torch.pipelines import realign as ra

    d, s1 = inputs
    base = _parts(d / "clean.torch")
    assert s1["windows_resumed"] == 0 and s1["windows_fresh"] == len(base)
    assert s1["resume.refused"] == 0 and s1["resume.windows_skipped"] == 0
    assert _parts(d / "j.adam") == base
    doc = json.loads((d / "rd" / "JOURNAL.json").read_text())
    assert doc["schema"] == "adam_tpu.run_journal/1"
    assert doc["n_windows"] == s1["n_windows"] == len(base) - 1
    assert sorted(doc["windows"].values()) == sorted(base)
    # one sidecar per observed part (every window and the realigned part)
    assert sorted(os.listdir(d / "rd" / "obs")) == [
        f"window-{i:05d}.npz" for i in range(len(base))]
    assert (d / "rd" / "table.npz").is_file()

    # a full resume observes, merges, solves and realigns nothing
    calls = []
    for mod, name in ((bqsr, "observe_window"), (bqsr, "merge_observations"),
                      (ra, "realign_indels")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k:
                            (calls.append(_n), _r(*a, **k))[1])
    out, rd = _copy_journaled(inputs, tmp_path)
    s2 = _port(d / "in.sam", out, run_dir=str(rd), resume=True)
    assert s2["windows_fresh"] == 0 and s2["windows_resumed"] == len(base)
    assert s2["resume.windows_skipped"] == len(base) and s2["resume.refused"] == 0
    assert calls == []
    assert _parts(out) == base


def test_deleted_parts_are_rewritten_and_only_those(inputs, tmp_path):
    d, _ = inputs
    out, rd = _copy_journaled(inputs, tmp_path)
    before = {f: os.stat(out / f) for f in _parts(out)}
    gone = ["part-r-00001.parquet", "part-r-00004.parquet"]
    for f in gone:
        os.unlink(out / f)
    s = _port(d / "in.sam", out, run_dir=str(rd), resume=True)
    assert s["windows_fresh"] == 2 and s["windows_resumed"] == len(before) - 2
    assert _parts(out) == _parts(d / "clean.torch")
    for f, st in before.items():
        now = os.stat(out / f)
        same = (now.st_ino, now.st_mtime_ns) == (st.st_ino, st.st_mtime_ns)
        assert same == (f not in gone), f


def _known_table(inputs, bump=0):
    d, _ = inputs
    with np.load(str(d / "rd" / "table.npz")) as z:
        table, gl = np.asarray(z["table"], np.uint8), int(z["gl"])
    if bump:
        table = table.copy()
        table[0, 30, gl, 0] += bump
    return table, gl


@pytest.mark.parametrize("change", ["input", "window_plan", "stage_flag", "known_table"])
def test_changed_run_is_refused_and_restarts_clean(inputs, tmp_path, change):
    d, _ = inputs
    sam = d / "in.sam"
    first, kw = {}, {}
    if change == "input":
        sam = d / "b.sam"
    elif change == "window_plan":
        kw["window_reads"] = 512
    elif change == "stage_flag":
        kw["realign"] = False
    else:
        first["known_table"] = _known_table(inputs)
        kw["known_table"] = _known_table(inputs, bump=1)
    out, rd = tmp_path / "out.adam", tmp_path / "rd"
    if first:
        _port(d / "in.sam", out, run_dir=str(rd), **first)
    else:
        out, rd = _copy_journaled(inputs, tmp_path)
    s = _port(sam, out, run_dir=str(rd), resume=True, **kw)
    assert s["windows_resumed"] == 0 and s["resume.refused"] == 1
    clean = tmp_path / "clean.adam"
    _port(sam, clean, **kw)
    # the new configuration's bytes and nothing else: no stale part mixed in
    assert _parts(out) == _parts(clean)
    assert json.loads((rd / "JOURNAL.json").read_text())["n_windows"] == s["n_windows"]


_BROKEN = {
    "torn": '{"schema": "adam_tpu.run_journal/1", "windows": TORN',
    "not_an_object": "[1, 2, 3]",
    "other_schema": '{"schema": "adam_tpu.run_journal/0", "windows": {}}',
    "malformed_windows": None,  # the real journal with a bad window key
    "windows_a_list": None,
}


@pytest.mark.parametrize("kind", sorted(_BROKEN))
def test_broken_journal_is_refused_and_restarts_clean(inputs, tmp_path, kind):
    from adam_tpu_torch.pipelines.checkpoint import RunJournal

    d, _ = inputs
    out, rd = _copy_journaled(inputs, tmp_path)
    path = rd / "JOURNAL.json"
    if _BROKEN[kind] is not None:
        path.write_text(_BROKEN[kind])
    else:
        doc = json.loads(path.read_text())
        doc["windows"] = (dict(doc["windows"], x="part-r-00009.parquet")
                          if kind == "malformed_windows" else list(doc["windows"]))
        path.write_text(json.dumps(doc))
    assert (RunJournal.peek(str(rd)) is None) == (kind in ("torn", "not_an_object",
                                                          "other_schema"))
    s = _port(d / "in.sam", out, run_dir=str(rd), resume=True)
    assert s["windows_resumed"] == 0 and s["resume.refused"] == 1
    assert s["windows_fresh"] == len(_parts(d / "clean.torch"))
    assert _parts(out) == _parts(d / "clean.torch")
    assert RunJournal.peek(str(rd))["completed"] == s["windows_fresh"]


def test_resume_without_a_journal_starts_fresh(inputs, tmp_path):
    d, _ = inputs
    out = tmp_path / "out.adam"
    s = _port(d / "in.sam", out, run_dir=str(tmp_path / "rd"), resume=True)
    assert s["resume.refused"] == 1 and s["windows_resumed"] == 0
    assert _parts(out) == _parts(d / "clean.torch")


def test_dump_observations_resume_observes_again(inputs, tmp_path, monkeypatch):
    from adam_tpu_torch.pipelines import bqsr

    d, _ = inputs
    out, rd = tmp_path / "out.adam", tmp_path / "rd"
    csv1, csv2, csv_jax = tmp_path / "1.csv", tmp_path / "2.csv", tmp_path / "jax.csv"
    s1 = _port(d / "in.sam", out, run_dir=str(rd), dump_observations=str(csv1))
    with np.load(str(rd / "table.npz")) as z:
        table1 = {k: z[k] for k in z.files}
    # windows whose histograms are not journaled observe again on resume,
    # and the merge solves the journaled table's bytes again
    for f in ("window-00002.npz", "window-00005.npz"):
        os.unlink(rd / "obs" / f)
    for f in ("part-r-00002.parquet", "part-r-00005.parquet"):
        os.unlink(out / f)
    calls = []
    for name in ("observe_window", "apply_dispatch"):
        real = getattr(bqsr, name)
        monkeypatch.setattr(bqsr, name, lambda *a, _r=real, _n=name, **k:
                            (calls.append(_n), _r(*a, **k))[1])
    s2 = _port(d / "in.sam", out, run_dir=str(rd), resume=True,
               dump_observations=str(csv2))
    monkeypatch.undo()
    assert sorted(calls) == ["apply_dispatch"] * 2 + ["observe_window"] * 2
    assert "fused_bc" not in s1 and "fused_bc" not in s2
    with np.load(str(rd / "table.npz")) as z:
        assert sorted(z.files) == sorted(table1)
        for k in table1:
            np.testing.assert_array_equal(z[k], table1[k])
    assert s2["windows_fresh"] == 2
    assert s2["resume.histograms_loaded"] == len(_parts(out)) - 2
    assert _parts(out) == _parts(d / "clean.torch")
    _jax(d / "in.sam", tmp_path / "jax.adam", dump_observations=str(csv_jax))
    assert csv2.read_text() == csv1.read_text() == csv_jax.read_text()
    s3 = _port(d / "in.sam", out, run_dir=str(rd), resume=True,
               dump_observations=str(csv2))
    assert s3["windows_fresh"] == 0


def _known_sites(inputs, pkg):
    d, _ = inputs
    if pkg == "jax":
        from adam_tpu.api.datasets import GenotypeDataset
        from adam_tpu.io.sam import peek_sam_header
    else:
        from adam_tpu_torch.api.datasets import GenotypeDataset
        from adam_tpu_torch.io.sam import peek_sam_header
    names = peek_sam_header(str(d / "in.sam")).seq_dict.names
    return dict(
        known_snps=GenotypeDataset.load(str(d / "snps.vcf"), contig_names=names).snp_table(),
        known_indels=GenotypeDataset.load(str(d / "indels.vcf"),
                                          contig_names=names).indel_table(),
    )


@pytest.mark.parametrize("variant", ["plain", "known_sites", "known_table", "tuned"])
def test_journal_files_equal_jax(inputs, tmp_path, variant):
    d, _ = inputs
    kw_t, kw_j = {}, {}
    if variant == "known_sites":
        kw_t, kw_j = _known_sites(inputs, "torch"), _known_sites(inputs, "jax")
    elif variant == "known_table":
        table, gl = _known_table(inputs, bump=2)
        kw_t = {"known_table": (table.astype(np.int32), gl)}
        kw_j = {"known_table": (table.astype(np.int32), gl)}
    elif variant == "tuned":
        kw_t = kw_j = dict(realign=True, lod_threshold=3.0, max_target_size=2000,
                           max_indel_size=400, compression="snappy",
                           mark_duplicates=False, window_reads=512)
    _port(d / "in.sam", tmp_path / "t.adam", run_dir=str(tmp_path / "rt"), **kw_t)
    _jax(d / "in.sam", tmp_path / "j.adam", run_dir=str(tmp_path / "rj"), **kw_j)
    jt = json.loads((tmp_path / "rt" / "JOURNAL.json").read_text())
    jj = json.loads((tmp_path / "rj" / "JOURNAL.json").read_text())
    assert jt["fingerprint"] == jj["fingerprint"]
    assert jt == jj
    assert _parts(tmp_path / "t.adam") == _parts(tmp_path / "j.adam")
    obs = sorted(os.listdir(tmp_path / "rj" / "obs"))
    assert obs and sorted(os.listdir(tmp_path / "rt" / "obs")) == obs
    for f in obs + ["../table.npz"]:
        with np.load(str(tmp_path / "rt" / "obs" / f)) as a, \
                np.load(str(tmp_path / "rj" / "obs" / f)) as b:
            assert a.files == b.files
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (f, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f} {k}")


def test_port_resumes_a_run_that_jax_journaled(inputs, tmp_path):
    d, _ = inputs
    out, rd = tmp_path / "out.adam", tmp_path / "rd"
    _jax(d / "in.sam", out, run_dir=str(rd))
    for f in ("part-r-00000.parquet", "part-r-00006.parquet"):
        os.unlink(out / f)
    s = _port(d / "in.sam", out, run_dir=str(rd), resume=True)
    assert s["windows_fresh"] == 2 and s["resume.refused"] == 0
    assert _parts(out) == _parts(d / "clean.jax")


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [["--resume"], ["-streaming", "--resume"],
                                  ["--run-dir", "RD"], ["--run-dir", "RD", "--resume"]])
def test_cli_refuses_as_jax(inputs, tmp_path, argv):
    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    d, _ = inputs
    argv = ["transform", str(d / "in.sam"), str(tmp_path / "o.adam"),
            *[str(tmp_path / a) if a == "RD" else a for a in argv]]
    rc, _, err = _cli(main, argv + ["--device", "cpu"])
    jrc, _, jerr = _cli(jax_main, argv)
    assert rc == jrc == 2
    assert err.strip() == jerr.strip()
    assert "--resume" in err or "--run-dir" in err
    assert not (tmp_path / "o.adam").exists()


def test_cli_journals_and_resumes(inputs, tmp_path):
    from adam_tpu_torch.cli.main import main

    d, _ = inputs
    out, rd = str(tmp_path / "o.adam"), str(tmp_path / "rd")
    argv = ["transform", str(d / "in.sam"), out, "-streaming", "-mark_duplicate_reads",
            "-realign_indels", "-recalibrate_base_qualities", "-window_reads",
            str(WINDOW), "--run-dir", rd, "--device", "cpu"]
    rc, stdout, _ = _cli(main, argv)
    s1 = json.loads(stdout.strip().splitlines()[-1])
    assert rc == 0 and s1["windows_resumed"] == 0
    os.unlink(os.path.join(out, "part-r-00003.parquet"))
    rc, stdout, _ = _cli(main, argv + ["--resume"])
    s2 = json.loads(stdout.strip().splitlines()[-1])
    assert rc == 0 and s2["windows_fresh"] == 1
    for k in ("windows_resumed", "resume.refused", "resume.windows_skipped",
              "resume.histograms_loaded"):
        assert k in s2
    assert _parts(out) == _parts(d / "clean.torch")
