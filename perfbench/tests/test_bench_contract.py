"""BENCHMARK.json against the benchmark contract, and the harness's
promise that every cell, configuration and metric is found by name."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from perfbench.harness import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = core.benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_spelled_from_the_allowed_characters(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key]), e[key]
        for key in e.get("reduced", []):
            assert NAME.match(key), key
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_entries_have_exactly_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_and_reports_what_it_must(cell):
    c = core.cell(cell)
    assert (core.BENCH / "drivers" / f"{c['spec']['driver']}.py").exists()
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert callable(core.metric_reader(m["name"]))
        assert m["moves"] in names
    cfg = c["config"]
    for key in ("source", "deployment", "reduced", "assumed", "traffic"):
        assert key in cfg


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        e2e = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            assert cell in e2e.get("workloads", [cell])


def test_files_under_paths_are_named_from_name_characters():
    for path in core.BENCH.rglob("*"):
        rel = path.relative_to(core.ROOT).as_posix()
        if "__pycache__" in rel or rel.startswith("perfbench/_cache"):
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_a_cell_added_from_new_files_alone_is_picked_up(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(core.BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "transform.chr20_30x_short", "config":
                               "adam_transform_na12878_chr20", "traffic": "chr20_short",
                               "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "transform.chr20_30x_dbsnp" in m.get("workloads", []):
            m["workloads"].append("transform.chr20_30x_short")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "perfbench" / "workloads" / "transform.chr20_30x_short.json").write_text(
        json.dumps({"config": "adam_transform_na12878_chr20", "driver": "transform_cli",
                    "extra_args": [], "traffic": {"reads": 524288}, "why": "a test cell"}))
    monkeypatch.setattr(core, "ROOT", root)
    monkeypatch.setattr(core, "BENCH", root / "perfbench")
    c = core.cell("transform.chr20_30x_short")
    assert c["traffic"] == {"reads": 524288}
    assert {m["name"] for m in c["per_layer"]} >= {"transform.observe_s"}


def test_the_real_command_fails_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is attached: the command would run")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "transform.chr20_30x_dbsnp", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=core.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_command_fails_in_a_checkout_without_the_program(tmp_path):
    shutil.copytree(core.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "transform.chr20_30x_dbsnp", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
