"""The port stands alone: importing ``adam_tpu_torch`` loads neither JAX
nor any module of ``adam_tpu``, no source of the port (or
``chip_smoke.py``) imports them, and the device rule holds — the card
unless the caller asks for the CPU."""

import io
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_import_loads_no_jax_and_no_adam_tpu():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import adam_tpu_torch
        names = []
        for m in pkgutil.walk_packages(adam_tpu_torch.__path__, "adam_tpu_torch."):
            if m.name != "adam_tpu_torch.__main__":
                importlib.import_module(m.name)
                names.append(m.name)
        bad = sorted(n for n in sys.modules
                     if n == "jax" or n.startswith("jax.")
                     or n == "adam_tpu" or n.startswith("adam_tpu."))
        print(len(names), bad)
        assert len(names) >= 20, names
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+adam_tpu(?!_torch)\b"
    r"|from\s+adam_tpu(?!_torch)\b)",
    re.MULTILINE,
)


@pytest.mark.parametrize("module", ["adam_tpu_torch.serve", "adam_tpu_torch.gateway",
                                    "adam_tpu_torch.api.transform_service",
                                    "adam_tpu_torch.serve.batching"])
def test_service_modules_load_no_jax_and_no_adam_tpu(module):
    """The service, the gateway and the library seam stand alone too: each
    imported first, in a fresh interpreter."""
    code = textwrap.dedent(f"""
        import importlib, sys
        importlib.import_module({module!r})
        bad = sorted(n for n in sys.modules
                     if n == "jax" or n.startswith("jax.")
                     or n == "adam_tpu" or n.startswith("adam_tpu."))
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_import_no_jax_and_no_adam_tpu():
    files = sorted((REPO / "adam_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    hits = [
        f"{f.relative_to(REPO)}: {m.group(0).strip()}"
        for f in files for m in _FORBIDDEN.finditer(f.read_text())
    ]
    assert not hits, hits


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "import adam_tpu",
                 "from adam_tpu.io import sam", "    from adam_tpu import native"):
        assert _FORBIDDEN.search(line), line
    for line in ("import adam_tpu_torch", "from adam_tpu_torch.ops import kernels",
                 "# the JAX package adam_tpu is the reference"):
        assert not _FORBIDDEN.search(line), line


def test_default_device_is_cuda_and_never_falls_back():
    from adam_tpu_torch.device import DEFAULT_DEVICE, resolve_device

    assert DEFAULT_DEVICE == "cuda"
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_streamed_transform_defaults_to_the_card(tmp_path):
    import inspect

    from adam_tpu_torch.pipelines.streamed import transform_streamed

    assert inspect.signature(transform_streamed).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            transform_streamed(str(tmp_path / "missing.sam"), str(tmp_path / "out"))


def test_sharded_transform_defaults_to_the_card(tmp_path):
    import inspect

    from adam_tpu_torch.parallel import host_shuffle
    from adam_tpu_torch.parallel.sharded import transform_sharded

    for fn in (transform_sharded, host_shuffle.shuffle_alignments_to_shards,
               host_shuffle.shuffle_bam_to_shards):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            transform_sharded(str(tmp_path / "missing.sam"), str(tmp_path / "out"), 2)
        assert not (tmp_path / "out").exists()


def test_plugin_stage_config_and_transform_step_default_to_the_card(tmp_path):
    import inspect

    from adam_tpu_torch import plugins
    from adam_tpu_torch.api.spark_executor import StageConfig, serve
    from adam_tpu_torch.pipelines.transform_step import (
        synthetic_batch,
        synthetic_masks,
        transform_step,
    )

    assert StageConfig().device == "cuda"
    for fn in (plugins.execute_plugin, transform_step):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    b = synthetic_batch(8, 10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transform_step(b, *synthetic_masks(b), 2, 10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve(StageConfig(mark_duplicates=True), io.BytesIO(b""), io.BytesIO())

    class Rows(plugins.AdamPlugin):
        def run(self, ds, args):
            return []

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plugins.execute_plugin(Rows(), str(tmp_path / "missing.sam"))


def test_realign_names_the_next_slice():
    """Realignment with a known-indel table, once left to a later slice,
    runs: on an empty dataset it returns the dataset as it was."""
    from adam_tpu_torch.api.datasets import AlignmentDataset
    from adam_tpu_torch.formats.batch import ReadBatch, ReadSidecar
    from adam_tpu_torch.io.sam import SamHeader
    from adam_tpu_torch.models.snp_table import IndelTable
    from adam_tpu_torch.pipelines.realign import realign_indels

    ds = AlignmentDataset(ReadBatch.empty(), ReadSidecar(), SamHeader())
    table = IndelTable.from_variants([("chr1", 10, "A", "AT")])
    assert realign_indels(ds, consensus_model="knowns", known_indels=table,
                          device="cpu") is ds


@pytest.mark.parametrize("module", ["adam_tpu_torch.pipelines.realign",
                                    "adam_tpu_torch.ops.smith_waterman",
                                    "adam_tpu_torch.io.vcf",
                                    "adam_tpu_torch.models.snp_table",
                                    "adam_tpu_torch.models.positions",
                                    "adam_tpu_torch.formats.variants",
                                    "adam_tpu_torch.utils.retry",
                                    "adam_tpu_torch.api.datasets",
                                    "adam_tpu_torch.io.context",
                                    "adam_tpu_torch.io.sam",
                                    "adam_tpu_torch.io.parquet",
                                    "adam_tpu_torch.ops.kmer",
                                    "adam_tpu_torch.native",
                                    "adam_tpu_torch.cli.main",
                                    "adam_tpu_torch.ops.flagstat",
                                    "adam_tpu_torch.pipelines.checkpoint",
                                    "adam_tpu_torch.pipelines.sort",
                                    "adam_tpu_torch.pipelines.trim",
                                    "adam_tpu_torch.utils.durability",
                                    "adam_tpu_torch.utils.faults",
                                    "adam_tpu_torch.pipelines.streamed",
                                    "adam_tpu_torch.parallel.partitioner",
                                    "adam_tpu_torch.parallel.spill",
                                    "adam_tpu_torch.parallel.host_shuffle",
                                    "adam_tpu_torch.parallel.sharded",
                                    "adam_tpu_torch.parallel.sharded_join",
                                    "adam_tpu_torch.pipelines.region_join",
                                    "adam_tpu_torch.ops.intervals",
                                    "adam_tpu_torch.io.fastq",
                                    "adam_tpu_torch.io.fasta",
                                    "adam_tpu_torch.io.features",
                                    "adam_tpu_torch.formats.fragments",
                                    "adam_tpu_torch.formats.features",
                                    "adam_tpu_torch.formats.fields",
                                    "adam_tpu_torch.formats.annotations",
                                    "adam_tpu_torch.models.genes",
                                    "adam_tpu_torch.utils.validation",
                                    "adam_tpu_torch.cli.conversions",
                                    "adam_tpu_torch.cli.actions",
                                    "adam_tpu_torch.cli.printers",
                                    "adam_tpu_torch.api.spark_executor",
                                    "adam_tpu_torch.plugins",
                                    "adam_tpu_torch.pipelines.transform_step",
                                    "adam_tpu_torch.utils.two_bit",
                                    "adam_tpu_torch.utils.interval_list",
                                    "adam_tpu_torch.utils.attributes",
                                    "adam_tpu_torch.utils.flattener",
                                    "adam_tpu_torch.ops.prefix_trie",
                                    "adam_tpu_torch.ops.phred",
                                    "adam_tpu_torch.ops.cigar",
                                    "adam_tpu_torch.utils.telemetry",
                                    "adam_tpu_torch.utils.instrumentation",
                                    "adam_tpu_torch.utils.analyzer",
                                    "adam_tpu_torch.utils.perfledger",
                                    "adam_tpu_torch.utils.incidents",
                                    "adam_tpu_torch.utils.slo",
                                    "adam_tpu_torch.parallel.device_pool",
                                    "adam_tpu_torch.parallel.mesh",
                                    "adam_tpu_torch.parallel.dist",
                                    "adam_tpu_torch.utils.health",
                                    "adam_tpu_torch.utils.transfer",
                                    "adam_tpu_torch.utils.compile_ledger",
                                    "adam_tpu_torch.staticcheck",
                                    "adam_tpu_torch.utils.top",
                                    "adam_tpu_torch.utils.kernelbench",
                                    "adam_tpu_torch.cli.devtools"])
def test_realign_modules_load_no_jax(module):
    code = textwrap.dedent(f"""
        import sys
        import {module}
        bad = sorted(n for n in sys.modules
                     if n == "jax" or n.startswith("jax.")
                     or n == "adam_tpu" or n.startswith("adam_tpu."))
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_the_checker_imports_no_torch_and_no_numpy():
    """The static checker only parses source: it runs on the whole tree,
    and its CLI, in an interpreter that never loads torch or numpy (nor
    JAX or the JAX package)."""
    code = textwrap.dedent("""
        import sys
        from adam_tpu_torch.staticcheck import cli, core
        rep = core.run_checks(".")
        assert rep.ok, rep.new_findings
        assert cli.main(["--quiet", "--rules", "durability"]) == 0
        bad = sorted(n for n in sys.modules if n.split(".")[0] in
                     ("torch", "numpy", "jax", "adam_tpu"))
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_surface_entry_points_default_to_the_card():
    """The entry points that take JAX's call (a host table, a host batch,
    keys) default to the card and raise without one; importing the
    modules that hold them loads neither JAX nor the JAX package."""
    import inspect

    import numpy as np

    from adam_tpu_torch.api.datasets import AlignmentDataset
    from adam_tpu_torch.formats.batch import ReadBatch, ReadSidecar
    from adam_tpu_torch.io.sam import SamHeader
    from adam_tpu_torch.ops.flagstat import flagstat_device
    from adam_tpu_torch.parallel.device_pool import make_resident_window
    from adam_tpu_torch.parallel.dist import device_lexsort
    from adam_tpu_torch.pipelines.bqsr import apply_recalibration
    from adam_tpu_torch.pipelines.markdup import markdup_columns_device

    fns = (apply_recalibration, make_resident_window, flagstat_device, device_lexsort,
           markdup_columns_device, ReadBatch.to_device)
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        b = ReadBatch.empty(4, 8, 2)
        ds = AlignmentDataset(b, ReadSidecar(names=[""] * 4), SamHeader())
        table = np.zeros((1, 94, 17, 17), np.uint8)
        for call in (lambda: apply_recalibration(ds, table, 8),
                     lambda: make_resident_window(b, 0),
                     lambda: flagstat_device(b),
                     lambda: device_lexsort([np.arange(3)]),
                     lambda: markdup_columns_device(b),
                     lambda: b.to_device()):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    code = textwrap.dedent("""
        import sys
        import adam_tpu_torch.ops.flagstat, adam_tpu_torch.parallel.dist
        import adam_tpu_torch.parallel.device_pool, adam_tpu_torch.pipelines.bqsr
        import adam_tpu_torch.pipelines.markdup, adam_tpu_torch.utils.transfer
        bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "adam_tpu"))
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
