"""Nothing the benchmark runs loads JAX or the JAX package, and the
plain reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from perfbench.harness import core

FORBIDDEN_REF = {"jax", "jaxlib", "flax", "adam_tpu", "adam_tpu_torch"}


def test_the_reference_imports_neither_jax_nor_either_package():
    for path in sorted((core.BENCH / "reference").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not tops & FORBIDDEN_REF, f"{path.name} imports {tops & FORBIDDEN_REF}"


def test_a_rehearsal_run_leaves_no_jax_module_loaded():
    code = (
        "import contextlib, io, json, sys\n"
        "from perfbench import run\n"
        "from perfbench.tests._helpers import TINY\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    rc = run.main(['--workload', 'transform.chr20_30x_dbsnp', '--seed', '5',\n"
        "                   '--seconds', '0.1', '--trace', '0'], rehearse=TINY)\n"
        "print(json.dumps({'rc': rc, 'found': run.forbidden_modules(),\n"
        "                  'mods': sorted({m.split('.')[0] for m in sys.modules})}))\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT, capture_output=True,
                       text=True, timeout=600)
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0 and out["found"] == []
    assert "adam_tpu_torch" in out["mods"]  # the port ran; compared whole, it is not adam_tpu
