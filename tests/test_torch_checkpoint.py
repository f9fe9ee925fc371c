"""Stage checkpoint-restart and the durable-write helpers of the port,
against the JAX package on the CPU: the fingerprints and the manifest are
JAX's to the byte, a run stopped by a failing stage resumes after the
deepest completed stage and writes what an uninterrupted run writes, a
changed input byte or flag and a torn manifest each give a recompute, and
a failed durable write leaves the old file."""

import contextlib
import io
import json
import logging
import os
import pathlib
import shutil
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

N_READS = 4500
FULL = ["-mark_duplicate_reads", "-realign_indels", "-recalibrate_base_qualities",
        "-sort_reads"]
STAGES = ["mark_duplicates", "realign_indels", "bqsr", "sort"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A WGS-shaped SAM, and the output of an uninterrupted run of the
    full stage set without a checkpoint directory."""
    from make_wgs_sam import make_wgs

    d = tmp_path_factory.mktemp("checkpoint")
    make_wgs(str(d / "in.sam"), N_READS, 100, n_contigs=2, contig_len=30_000,
             known_sites_out=str(d / "snps.vcf"))
    rc, _ = _port(d / "in.sam", d / "plain.adam", FULL)
    assert rc == 0
    return d


def _port(src, out, flags, ck=None) -> tuple:
    """The port's CLI on the CPU -> (exit code, its stats line)."""
    from adam_tpu_torch.cli.main import main

    argv = ["transform", str(src), str(out), *flags, "--device", "cpu"]
    if ck is not None:
        argv += ["-checkpoint_dir", str(ck)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 else None)


# ------------------------------------------------------------ fingerprints


@pytest.mark.parametrize("kind", ["full", "edges", "dir"])
def test_input_fingerprint_equals_jax(inputs, tmp_path, monkeypatch, kind):
    """A small file (hashed whole), a file above the full-hash limit
    (size + head + tail; the limits shrunk alike in both packages), and a
    part directory (entry names and sizes)."""
    from adam_tpu.pipelines import checkpoint as jck

    from adam_tpu_torch.pipelines import checkpoint as ck

    path = inputs / "in.sam"
    if kind == "edges":
        for mod in (ck, jck):
            monkeypatch.setattr(mod, "_FULL_HASH_LIMIT", 1 << 16)
            monkeypatch.setattr(mod, "_EDGE_HASH_BYTES", 1 << 12)
    elif kind == "dir":
        path = tmp_path / "parts.adam"
        path.mkdir()
        for name, size in (("part-r-00000.parquet", 10), ("part-r-00001.parquet", 7),
                           ("_SUCCESS", 0), (".crc", 3)):
            (path / name).write_bytes(b"x" * size)
    got = ck.input_fingerprint(str(path))
    assert got == jck.input_fingerprint(str(path))
    if kind == "edges":
        # a byte in the middle is outside both windows; one at the end is not
        data = bytearray(path.read_bytes())
        moved = tmp_path / "edited.sam"
        data[len(data) // 2] ^= 1
        moved.write_bytes(bytes(data))
        assert ck.input_fingerprint(str(moved)) == got
        data[-2] ^= 1
        moved.write_bytes(bytes(data))
        assert ck.input_fingerprint(str(moved)) != got


def test_compose_fingerprint_equals_jax():
    from adam_tpu.pipelines import checkpoint as jck

    from adam_tpu_torch.pipelines import checkpoint as ck

    class Table:
        def __init__(self):
            self.keys = np.arange(6, dtype=np.int64).reshape(2, 3)
            self.name = "sites"

    fields = {
        "input": "ab" * 32, "trimFromStart": 2, "trimReadGroup": None,
        "log_odds_threshold": 5.0, "flags": (True, False), "np": np.int32(7),
        "table": np.linspace(0, 1, 5), "nested": {"b": [1, 2.5], "a": "x"},
        "object": Table(),
    }
    assert ck.compose_fingerprint(fields) == jck.compose_fingerprint(fields)
    assert ck._canon(fields) == jck._canon(fields)
    assert ck.compose_fingerprint({**fields, "trimFromStart": 3}) \
        != ck.compose_fingerprint(fields)


def test_manifest_and_stores_equal_jax(inputs, tmp_path):
    from adam_tpu.cli.main import main as jax_main

    argv = ["transform", str(inputs / "in.sam"), str(tmp_path / "j.adam"), *FULL,
            "-known_snps", str(inputs / "snps.vcf"), "-checkpoint_dir", str(tmp_path / "jck")]
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_main(argv) == 0
    rc, stats = _port(inputs / "in.sam", tmp_path / "t.adam",
                      FULL + ["-known_snps", str(inputs / "snps.vcf")], tmp_path / "tck")
    assert rc == 0 and stats["stages_run"] == STAGES
    manifest = (tmp_path / "tck" / "MANIFEST.json").read_bytes()
    assert manifest == (tmp_path / "jck" / "MANIFEST.json").read_bytes()
    doc = json.loads(manifest)
    assert doc["stages"] == doc["completed"] == STAGES and len(doc["fingerprint"]) == 64
    assert sorted(os.listdir(tmp_path / "tck")) == sorted(os.listdir(tmp_path / "jck"))
    for s in STAGES:
        assert ((tmp_path / "tck" / f"{s}.adam").read_bytes()
                == (tmp_path / "jck" / f"{s}.adam").read_bytes()), s


# ---------------------------------------------------------------- restarts


def test_failed_stage_resumes_after_the_deepest_completed(inputs, tmp_path, monkeypatch):
    """BQSR raises: markdup and realign are recorded; the rerun loads the
    realign store, runs only BQSR and sort, and writes the uninterrupted
    run's bytes."""
    from adam_tpu_torch.pipelines import bqsr

    real = bqsr.recalibrate_base_qualities

    def broken(*a, **k):
        raise OSError("device lost")

    monkeypatch.setattr(bqsr, "recalibrate_base_qualities", broken)
    with pytest.raises(OSError, match="device lost"):
        _port(inputs / "in.sam", tmp_path / "o.adam", FULL, tmp_path / "ck")
    doc = json.loads((tmp_path / "ck" / "MANIFEST.json").read_text())
    assert doc["completed"] == ["mark_duplicates", "realign_indels"]
    assert not (tmp_path / "o.adam").exists()
    monkeypatch.setattr(bqsr, "recalibrate_base_qualities", real)
    rc, stats = _port(inputs / "in.sam", tmp_path / "o.adam", FULL, tmp_path / "ck")
    assert rc == 0 and stats["stages_run"] == ["bqsr", "sort"]
    assert (tmp_path / "o.adam").read_bytes() == (inputs / "plain.adam").read_bytes()
    assert json.loads((tmp_path / "ck" / "MANIFEST.json").read_text())["completed"] == STAGES


def test_deleted_store_recomputes_from_there(inputs, tmp_path):
    """The chip smoke's restart: the bqsr store deleted and dropped from
    the manifest -> BQSR and sort run again, the output bytes are the
    same."""
    ck = tmp_path / "ck"
    assert _port(inputs / "in.sam", tmp_path / "a.adam", FULL, ck)[0] == 0
    os.unlink(ck / "bqsr.adam")
    doc = json.loads((ck / "MANIFEST.json").read_text())
    doc["completed"].remove("bqsr")
    (ck / "MANIFEST.json").write_text(json.dumps(doc))
    rc, stats = _port(inputs / "in.sam", tmp_path / "b.adam", FULL, ck)
    assert rc == 0 and stats["stages_run"] == ["bqsr", "sort"]
    assert (tmp_path / "b.adam").read_bytes() == (tmp_path / "a.adam").read_bytes()
    # a complete checkpoint: nothing runs, the last store is the result
    rc, stats = _port(inputs / "in.sam", tmp_path / "c.adam", FULL, ck)
    assert rc == 0 and stats["stages_run"] == []
    assert (tmp_path / "c.adam").read_bytes() == (tmp_path / "a.adam").read_bytes()


@pytest.mark.parametrize("change", ["input_byte", "flag", "stage_list", "torn_manifest",
                                    "not_an_object"])
def test_changes_give_a_recompute(inputs, tmp_path, caplog, change):
    src = tmp_path / "in.sam"
    shutil.copy(inputs / "in.sam", src)
    flags = list(FULL)
    ck = tmp_path / "ck"
    assert _port(src, tmp_path / "a.adam", flags, ck)[0] == 0
    if change == "input_byte":
        # one quality character of the last record
        lines = src.read_bytes().split(b"\n")
        fields = lines[-2].split(b"\t")
        fields[10] = (b"#" if fields[10][:1] != b"#" else b"I") + fields[10][1:]
        lines[-2] = b"\t".join(fields)
        src.write_bytes(b"\n".join(lines))
    elif change == "flag":
        flags += ["-max_consensus_number", "10"]
    elif change == "stage_list":
        flags.remove("-sort_reads")
    elif change == "torn_manifest":
        (ck / "MANIFEST.json").write_bytes((ck / "MANIFEST.json").read_bytes()[:-7])
    else:
        (ck / "MANIFEST.json").write_text("[1, 2]")
    with caplog.at_level(logging.WARNING):
        rc, stats = _port(src, tmp_path / "b.adam", flags, ck)
    assert rc == 0
    assert stats["stages_run"] == [s for s in STAGES if change != "stage_list" or s != "sort"]
    warned = " ".join(r.getMessage() for r in caplog.records)
    want = {"input_byte": "different input/flag fingerprint",
            "flag": "different input/flag fingerprint",
            "stage_list": "was built for stages",
            "torn_manifest": "is unreadable", "not_an_object": "is unreadable"}[change]
    assert want in warned
    doc = json.loads((ck / "MANIFEST.json").read_text())
    assert doc["completed"] == doc["stages"]


def test_mark_is_idempotent(tmp_path):
    from adam_tpu_torch.pipelines.checkpoint import StageCheckpointer

    ck = StageCheckpointer(str(tmp_path), ["a", "b"], fingerprint="f")
    for s in ("a", "a", "b"):
        (tmp_path / f"{s}.adam").write_bytes(b"")
        ck.mark(s)
    doc = json.loads((tmp_path / "MANIFEST.json").read_text())
    assert doc == {"stages": ["a", "b"], "completed": ["a", "b"], "fingerprint": "f"}
    assert StageCheckpointer(str(tmp_path), ["a", "b"], "f").last_completed() == "b"
    # a recorded stage whose store is gone does not count
    os.unlink(tmp_path / "a.adam")
    assert StageCheckpointer(str(tmp_path), ["a", "b"], "f").last_completed() is None


# -------------------------------------------------------------- durability


@pytest.mark.parametrize("fail_at", ["write", "replace", "none"])
def test_atomic_write_leaves_old_or_new(tmp_path, monkeypatch, fail_at):
    from adam_tpu_torch.utils import durability

    path = tmp_path / "m.json"
    durability.atomic_write_json(str(path), {"v": 1})
    if fail_at == "replace":
        def boom(*a):
            raise OSError("rename failed")
        monkeypatch.setattr(durability.os, "replace", boom)
    elif fail_at == "write":
        def boom(tmp):
            raise OSError("fsync failed")
        monkeypatch.setattr(durability, "fsync_file", boom)
    if fail_at == "none":
        durability.atomic_write_json(str(path), {"v": 2})
        assert json.loads(path.read_text()) == {"v": 2}
    else:
        with pytest.raises(OSError):
            durability.atomic_write_json(str(path), {"v": 2})
        assert json.loads(path.read_text()) == {"v": 1}
    assert sorted(os.listdir(tmp_path)) == ["m.json"]


def test_publish_and_fsync_helpers(tmp_path):
    from adam_tpu_torch.utils import durability

    tmp, dst = tmp_path / "x.tmp", tmp_path / "x"
    tmp.write_bytes(b"new")
    dst.write_bytes(b"old")
    durability.publish_file(str(tmp), str(dst))
    assert dst.read_bytes() == b"new" and not tmp.exists()
    durability.fsync_dir(str(tmp_path / "missing"))  # best effort: no raise
    with pytest.raises(OSError):
        durability.fsync_file(str(tmp_path / "missing"))


def test_part_writer_publishes_through_durability(tmp_path, monkeypatch):
    """``io/parquet.write_part`` publishes with ``publish_file``; a failed
    publish leaves no part and no staging file."""
    import pyarrow as pa

    from adam_tpu_torch.io import parquet
    from adam_tpu_torch.utils import durability

    table = pa.table({"x": [1, 2, 3]})
    seen = []
    real = durability.publish_file
    monkeypatch.setattr(durability, "publish_file",
                        lambda tmp, dst: (seen.append(dst), real(tmp, dst)))
    parquet.write_part(table, str(tmp_path / "p.parquet"), "zstd")
    assert seen == [str(tmp_path / "p.parquet")]

    def boom(tmp, dst):
        raise OSError("disk full")

    monkeypatch.setattr(durability, "publish_file", boom)
    with pytest.raises(OSError, match="disk full"):
        parquet.write_part(table, str(tmp_path / "q.parquet"), "zstd")
    assert not (tmp_path / "q.parquet").exists()
    assert os.listdir(tmp_path / parquet.TMP_DIR_NAME) == []
