"""Finding a cell's files by name, and the run's fixed directories.

Everything that belongs to one configuration, one traffic mix, one
driver or one per-layer metric is a file of its own, found by the name
``BENCHMARK.json`` gives it:

* ``perfbench/configs/<config>.json``: the deployment (source, shapes,
  ``reduced``, ``assumed``, the command it runs);
* ``perfbench/workloads/<cell>.json``: the cell: its driver, what it
  adds to the configuration's command, and its traffic mix: under
  ``traffic``, the parameters the one generator
  (:mod:`perfbench.traffic.wgs`) reads on top of the configuration's;
* ``perfbench/drivers/<driver>.py``: the entry point the window drives;
* ``perfbench/metrics/<metric>.py``: one reader per per-layer metric.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
import os
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
CACHE = BENCH / "_cache"


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell ``name`` with its configuration, its metrics from
    ``BENCHMARK.json`` and its workload file merged in."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    spec = load_json(BENCH / "workloads" / f"{name}.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(ROOT / cfg_entry["file"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])
                 and any(e["name"] == m["moves"] for e in e2e)]
    return {"name": name, "entry": entry, "spec": spec, "config": config,
            "traffic": spec.get("traffic", {}),
            "end_to_end": e2e, "per_layer": per_layer}


def driver(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


def metric_reader(name: str):
    """``perfbench/metrics/<name>.py``'s ``read(run) -> float | None``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cache_dir(kind: str, *key) -> Path:
    """A fixed directory ``perfbench/_cache/<kind>/<digest of key>``: the
    same seed and parameters find it again.  Not created here."""
    digest = hashlib.sha256(json.dumps(key, sort_keys=True).encode()).hexdigest()[:20]
    return CACHE / kind / digest


def fill_once(path: Path, make) -> Path:
    """``path`` as ``make(staging_dir)`` fills it, made once: a run that
    finds it reuses it, and of two runs making it at once one wins."""
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    staging = path.with_name(f"{path.name}.part{os.getpid()}")
    shutil.rmtree(staging, ignore_errors=True)
    staging.mkdir()
    try:
        make(staging)
        os.rename(staging, path)
    except OSError:
        if not path.exists():
            raise
    finally:
        shutil.rmtree(staging, ignore_errors=True)
    return path


def pin_build_caches() -> None:
    """Every build or kernel cache at a fixed path inside the checkout."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
