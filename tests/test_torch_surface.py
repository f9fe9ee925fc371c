"""The port's public surface holds the JAX package's.

Every module of ``adam_tpu`` and its counterpart in ``adam_tpu_torch``
are parsed with ``ast`` (neither package is imported) and compared:

* the public top-level names (functions, classes, module constants);
* the public methods of each class, plus ``__init__`` (a dataclass's or
  NamedTuple's fields when it has none), ``__add__`` and ``__call__``;
* the parameter names: every parameter of a JAX function or method must
  exist, by name, in the port's;
* the ``ADAM_TPU_*`` string literals each package reads.

Every difference is on :data:`ALLOWED`, keyed ``"module:name"``,
``"module:Class.method"``, ``"module:name(param)"``, ``"module:*"`` for a
module left out, or ``"env:ADAM_TPU_X"``, with its reason.  The list is
closed both ways: a difference not on it fails, and so does an entry
that matches no difference.  A reason that names the port's counterpart
writes it as ```module:name```, and that name must exist in the port.

The second half compares each CLI verb's options: the port's are JAX's
plus ``--device``.

Run: ``python -m pytest tests/test_torch_surface.py -q``.
"""

from __future__ import annotations

import argparse
import ast
import functools
import pathlib
import re
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_ROOT = REPO / "adam_tpu"
PORT_ROOT = REPO / "adam_tpu_torch"
DUNDERS = ("__init__", "__add__", "__call__")
ENV_RE = re.compile(r"^ADAM_TPU_[A-Z0-9_]+$")

_KERNEL = "a TPU-compile wrapper (jit, Pallas or XLA executable)"
_SLOT = ("the pool's entry is a slot, not a jax device (ROADMAP, Deliberate "
         "differences: Slots)")
_BACKEND = ("no kernel switch: a backend choice would put a plain version on the "
            "card path (ROADMAP, Deliberate differences: Kernel switches)")
_DONATE = "buffer donation is an XLA mechanism; torch frees by reference"
_PREWARM = ("a prewarm dummy of an XLA executable; the port prewarms with "
            "`parallel.device_pool:resident_dummy`")
_MESH = ("the MeshPartitioner's window methods became per-shard calls of the "
         "single-device bodies with mesh=: ")
_JAXRULE = "a static-checker helper that reads JAX idiom; the port's checker reads torch's"
_ONE_ROUTE = ("one route per pass (ROADMAP, Deliberate differences): the benchmark's "
              "cells all run the other route; the parts are the same bytes")

#: Every difference between the two surfaces, with its reason.
ALLOWED: dict[str, str] = {
    # ---- modules left out on purpose
    "ops.kernel_backend:*": _BACKEND,
    "ops.pallas_observe:*": ("the Pallas observe kernel; its counterpart is "
                             "`ops.observe:observe_hist` with csrc/observe_hist.cu"),
    # ---- api
    "api.datasets:AlignmentDataset.mark_duplicates(backend)": _BACKEND,
    "api.datasets:AlignmentDataset.recalibrate_base_qualities(backend)": _BACKEND,
    # ---- io
    "io.arrow_pack:pack_matrix_host": ("the host backend's pack; the plain torch "
                                       "counterpart is `ops.colpack:pack_rows_plain`"),
    # ---- native
    "native:available": ("the port has no fallback for it to choose: a failed "
                         "build raises (`native:lib`)"),
    "native:bqsr_observe": ("the host backend's C++ observe; the card runs "
                            "`ops.observe:observe_hist`"),
    "native:bqsr_apply": ("the host backend's C++ apply; the card runs "
                          "`pipelines.bqsr:apply_table_body`"),
    # ---- ops
    "ops.cigar:five_prime_position_np": ("a host-backend twin; the plain torch "
                                         "counterpart is `ops.cigar:five_prime_position`"),
    "ops.colpack:pack_rows_body": _KERNEL + "; the port's is `ops.colpack:pack_rows`",
    "ops.colpack:pack_rows_pallas": _KERNEL + "; the port's is `ops.colpack:pack_rows`",
    "ops.colpack:pack_rows_kernel": _KERNEL + "; the port's is `ops.colpack:pack_rows`",
    "ops.colpack:pack_rows_np": ("a host-backend twin; the plain torch counterpart "
                                 "is `ops.colpack:pack_rows_plain`"),
    "ops.colpack:unpack_mask_body": (_KERNEL + "; the port unpacks inside "
                                     "`pipelines.bqsr:covariate_keys`"),
    "ops.colpack:fetch_grid": ("buckets fetch-slice sizes so XLA compiles few slice "
                               "programs; a torch slice compiles nothing"),
    "ops.colpack:packed_columns_enabled": ("ADAM_TPU_PACKED_COLS=0 packs pass C on the "
                                           "host and takes kernel 2 off the card path"),
    "ops.mdtag:batch_md_arrays_reference": ("a host-backend twin; the port's one "
                                            "implementation is `ops.mdtag:batch_md_arrays`"),
    "ops.smith_waterman:sw_best_scores(backend)": _BACKEND,
    "ops.smith_waterman:benchmark_gcups(backend)": _BACKEND,
    # ---- parallel.device_pool
    "parallel.device_pool:span_attrs(device)": _SLOT,
    "parallel.device_pool:putter(device)": _SLOT,
    "parallel.device_pool:donation_ok": _DONATE,
    "parallel.device_pool:ResidentWindow.__init__(device)": _SLOT,
    "parallel.device_pool:ResidentWindow.__init__(arrays)": ("torch tensors, not jax "
                                                             "arrays: the field is `tensors`"),
    "parallel.device_pool:ResidentWindow.mark_consumed": _DONATE,
    "parallel.device_pool:DevicePool.__init__(devices)": (
        _SLOT + "; the pool takes slots from `parallel.device_pool:make_slots`"),
    "parallel.device_pool:DevicePool.__init__(limit)": (
        "the cap is `parallel.device_pool:make_pool`'s requested count"),
    "parallel.device_pool:DevicePool.evict(device)": _SLOT,
    "parallel.device_pool:DevicePool.put(tree)": "a tensor, not a pytree: the argument is `arr`",
    "parallel.device_pool:PoolLease.put(tree)": "a tensor, not a pytree: the argument is `arr`",
    "parallel.device_pool:PoolLease.evict(device)": _SLOT,
    "parallel.device_pool:dummy_like": _PREWARM,
    "parallel.device_pool:markdup_dummy_args": _PREWARM,
    "parallel.device_pool:observe_dummy_args": _PREWARM,
    "parallel.device_pool:apply_dummy_args": _PREWARM,
    "parallel.device_pool:fused_bc_dummy_args": _PREWARM,
    "parallel.device_pool:observe_packed_prewarm_entry": (
        "JAX's packed and unpacked observe are one kernel here: "
        "`parallel.device_pool:observe_prewarm_entry`"),
    "parallel.device_pool:streamed_prewarm_entries(packed_apply)": (
        "pass C always packs on the card (ADAM_TPU_PACKED_COLS is not read)"),
    "parallel.device_pool:streamed_prewarm_entries(resident)": (
        "every dispatch reads a placed window, so every entry warms one"),
    "parallel.device_pool:fused_bc_prewarm_entry": _ONE_ROUTE,
    "parallel.device_pool:streamed_prewarm_entries(fused_n_cyc)": _ONE_ROUTE,
    "parallel.device_pool:resident_windows_enabled": _ONE_ROUTE,
    "parallel.device_pool:apply_prewarm_entry(table_n_cyc)": (
        "a prewarm entry parameter, named `n_cyc` in the port"),
    "parallel.device_pool:apply_prewarm_entry(pack)": (
        "pass C always packs on the card: the entry warms `pipelines.bqsr:apply_pack2_body`"),
    "parallel.device_pool:apply_prewarm_entry(resident)": (
        "every dispatch reads a placed window, so every entry warms one"),
    "parallel.device_pool:probe_device_tflops(device)": _SLOT,
    "parallel.device_pool:sweep_weights(devices)": _SLOT,
    # ---- parallel.mesh: jax.sharding helpers
    "parallel.mesh:SHARD_AXIS": ("a jax.sharding axis name; the port's mesh is "
                                 "`parallel.mesh:LocalMesh` or `parallel.mesh:ProcessMesh`"),
    "parallel.mesh:BATCH_AXIS": "a jax.sharding axis name; see `parallel.mesh:LocalMesh`",
    "parallel.mesh:shard_map": ("jax's shard_map; the port's is "
                                "`parallel.partitioner:MeshPartitioner.shard_map`"),
    "parallel.mesh:genome_mesh": "a jax Mesh constructor; the port makes `parallel.mesh:LocalMesh`",
    "parallel.mesh:batch_mesh": "a jax Mesh constructor; the port makes `parallel.mesh:LocalMesh`",
    "parallel.mesh:batch_row_sharding": (
        "a NamedSharding; rows go out by `parallel.partitioner:MeshPartitioner.put_rows`"),
    "parallel.mesh:row_sharding": (
        "a NamedSharding; rows go out by `parallel.partitioner:MeshPartitioner.put_rows`"),
    "parallel.mesh:replicated": (
        "a NamedSharding; copies go out by "
        "`parallel.partitioner:MeshPartitioner.put_replicated`"),
    "parallel.mesh:initialize_distributed(coordinator_address)": (
        "jax's coordinator contract; torch.distributed's is init_method, world_size, rank"),
    "parallel.mesh:initialize_distributed(num_processes)": (
        "jax's coordinator contract; torch.distributed's is init_method, world_size, rank"),
    "parallel.mesh:initialize_distributed(process_id)": (
        "jax's coordinator contract; torch.distributed's is init_method, world_size, rank"),
    # ---- parallel.partitioner
    "parallel.partitioner:healthy_subset(devices)": _SLOT,
    "parallel.partitioner:MeshPartitioner.__init__(devices)": _SLOT,
    "parallel.partitioner:MeshPartitioner.observe_window": _MESH + "`pipelines.bqsr:observe_window`",
    "parallel.partitioner:MeshPartitioner.observe_window_resident": (
        _MESH + "`pipelines.bqsr:observe_window`"),
    "parallel.partitioner:MeshPartitioner.observe_packed_window": (
        _MESH + "`pipelines.bqsr:observe_window`"),
    "parallel.partitioner:MeshPartitioner.markdup_window": (
        _MESH + "`pipelines.markdup:markdup_columns`"),
    "parallel.partitioner:MeshPartitioner.markdup_window_resident": (
        _MESH + "`pipelines.markdup:markdup_columns`"),
    "parallel.partitioner:MeshPartitioner.apply_supports_donation": _DONATE,
    "parallel.partitioner:MeshPartitioner.apply_window": _MESH + "`pipelines.bqsr:apply_dispatch`",
    "parallel.partitioner:MeshPartitioner.apply_pack_window": (
        _MESH + "`pipelines.bqsr:apply_dispatch`"),
    "parallel.partitioner:MeshPartitioner.apply_window_resident": (
        _MESH + "`pipelines.bqsr:apply_dispatch`"),
    "parallel.partitioner:MeshPartitioner.apply_pack2_placed": (
        _MESH + "`pipelines.bqsr:apply_dispatch`"),
    "parallel.partitioner:MeshPartitioner.apply_pack2_window": (
        _MESH + "`pipelines.bqsr:apply_dispatch`"),
    "parallel.partitioner:MeshPartitioner.fused_bc_placed": _ONE_ROUTE,
    "parallel.partitioner:MeshPartitioner.fused_bc_window": _ONE_ROUTE,
    "parallel.partitioner:MeshPartitioner.packed_payload_slices": (
        "bucketed XLA fetch slices; the port fetches each shard's rows with "
        "`parallel.partitioner:MeshPartitioner.fetch_rows`"),
    "parallel.partitioner:mesh_fused_bc_prewarm_entry": _ONE_ROUTE,
    "parallel.partitioner:mesh_observe_packed_prewarm_entry": (
        "one observe kernel: `parallel.partitioner:mesh_observe_prewarm_entry`"),
    "parallel.partitioner:mesh_apply_prewarm_entry(pack)": (
        "pass C always packs both columns on the card"),
    "parallel.partitioner:mesh_apply_prewarm_entry(pack2)": (
        "pass C always packs both columns on the card"),
    # ---- pipelines.bqsr
    "pipelines.bqsr:BACKENDS": _BACKEND,
    "pipelines.bqsr:bqsr_backend": _BACKEND,
    "pipelines.bqsr:chip_present": _BACKEND + "; the card is `device:resolve_device`'s",
    "pipelines.bqsr:jit_variant": _KERNEL + " (with or without donation)",
    "pipelines.bqsr:compute_cycles_np": ("a host-backend twin; the plain torch "
                                         "counterpart is `pipelines.bqsr:compute_cycles`"),
    "pipelines.bqsr:compute_dinucs_np": ("a host-backend twin; the plain torch "
                                         "counterpart is `pipelines.bqsr:compute_dinucs`"),
    "pipelines.bqsr:observe_kernel_np": ("a host-backend twin; the plain torch "
                                         "counterpart is `pipelines.bqsr:observe_kernel`"),
    "pipelines.bqsr:apply_table_kernel": _KERNEL + "; the port's is `pipelines.bqsr:apply_table_body`",
    "pipelines.bqsr:apply_pack_body": (
        "the quals-only pack; pass C packs both columns: `pipelines.bqsr:apply_pack2_body`"),
    "pipelines.bqsr:apply_pack_kernel": _KERNEL + "; the port's is `pipelines.bqsr:apply_pack2_body`",
    "pipelines.bqsr:apply_pack2_kernel": _KERNEL + "; the port's is `pipelines.bqsr:apply_pack2_body`",
    "pipelines.bqsr:fused_bc_kernel": _ONE_ROUTE,
    "pipelines.bqsr:fused_bc_body": _ONE_ROUTE,
    "pipelines.bqsr:fused_bc_enabled": _ONE_ROUTE,
    "pipelines.bqsr:fused_bc_dispatch": _ONE_ROUTE,
    "pipelines.bqsr:recalibrate_base_qualities(backend)": _BACKEND,
    "pipelines.bqsr:apply_recalibration(backend)": _BACKEND,
    "pipelines.bqsr:apply_recalibration_dispatch": (
        "the placed-window dispatch is `pipelines.bqsr:apply_dispatch`"),
    "pipelines.bqsr:apply_recalibration_finish": (
        "the placed-window fetch is `pipelines.bqsr:apply_finish`"),
    "pipelines.bqsr:apply_recalibration_finish_packed": (
        "the placed-window fetch is `pipelines.bqsr:apply_finish` (always packed)"),
    # ---- pipelines.markdup
    "pipelines.markdup:get_columns_jit": _KERNEL + "; the port's is `pipelines.markdup:markdup_columns_local`",
    "pipelines.markdup:markdup_columns_dispatch": (
        "the placed-window dispatch is `pipelines.markdup:markdup_columns`"),
    "pipelines.markdup:mark_duplicates(backend)": _BACKEND,
    # ---- pipelines.realign
    "pipelines.realign:sweep_bucket_shape": ("pads sweeps to few XLA shapes; "
                                             "`pipelines.realign:sweep_gemm` needs none"),
    "pipelines.realign:sweep_gemm_kernel": _KERNEL + "; the port's is `pipelines.realign:sweep_gemm`",
    "pipelines.realign:warm_sweep_shapes": ("compiles the bucketed XLA sweep shapes "
                                            "ahead; torch compiles nothing"),
    # ---- pipelines.trim
    "pipelines.trim:quality_profile_kernel": (
        _KERNEL + "; the port's is `pipelines.trim:quality_histogram`"),
    # ---- serve.batching
    "serve.batching:fused_jit": (_KERNEL + "; the port's bodies are "
                                 "`serve.batching:fused_apply_body` and its siblings"),
    "serve.batching:CoalescerClient.submit_apply(pack)": (
        "the fused apply always packs both columns (ROADMAP, Deliberate differences)"),
    "serve.batching:WindowCoalescer.submit_apply(pack)": (
        "the fused apply always packs both columns (ROADMAP, Deliberate differences)"),
    "serve.batching:WindowCoalescer.warm_fused_executable": (
        "compiles the fused XLA executable ahead; torch compiles nothing"),
    # ---- staticcheck
    "staticcheck.core:SCAN_FILES": ("JAX's checker also scans bench.py; the port's "
                                    "scans `staticcheck.core:SCAN_ROOTS` only"),
    "staticcheck.rules._astutil:is_jit_decorated": _JAXRULE,
    "staticcheck.rules._astutil:collect_jit_callables": _JAXRULE,
    "staticcheck.rules._astutil:enclosing_function": (
        _JAXRULE + "; the port's rules take `staticcheck.rules._astutil:in_dispatchable`"),
    "staticcheck.rules.dispatch:MESH_WINDOW_METHODS": _JAXRULE,
    "staticcheck.rules.dispatch:PALLAS_HOST_SUFFIXES": (
        _JAXRULE + "; kernel containment replaces Pallas containment"),
    # ---- utils
    "utils.compile_ledger:active_backend": (
        _BACKEND + "; the key's route is `utils.compile_ledger:route_of`"),
    "utils.compile_ledger:device_cache_key(device)": _SLOT,
    "utils.compile_ledger:claim(device)": _SLOT,
    "utils.compile_ledger:track.__init__(device)": _SLOT,
    "utils.health:probe_known_answer(device)": _SLOT,
    # ---- environment variables
    "env:ADAM_TPU_BQSR_BACKEND": _BACKEND,
    "env:ADAM_TPU_KERNEL_BACKEND": _BACKEND,
    "env:ADAM_TPU_SW_BACKEND": _BACKEND,
    "env:ADAM_TPU_COMPILE_CACHE": "XLA's persistent compile cache",
    "env:ADAM_TPU_NO_COMPILE_CACHE": "XLA's persistent compile cache",
    "env:ADAM_TPU_NO_X64": "jax's x64 switch; torch types are explicit",
    "env:ADAM_TPU_REALIGN": ("=py picks the pure-Python realign path; the port has "
                             "no fallbacks"),
    "env:ADAM_TPU_PACKED_COLS": ("=0 packs pass C on the host and takes kernel 2 off "
                                 "the card path"),
    "env:ADAM_TPU_NATIVE_CACHE": ("the port builds its native code into its "
                                  "git-ignored _build/ directories"),
    "env:ADAM_TPU_FUSED_BC": _ONE_ROUTE,
    "env:ADAM_TPU_RESIDENT": _ONE_ROUTE,
    "env:ADAM_TPU_RESOLVE_SORT": _ONE_ROUTE,
    "env:ADAM_TPU_FETCH_THREADS": ("JAX sizes a pool of blocking chunk fetches with it; "
                                   "`utils.transfer:device_fetch` queues its chunks as "
                                   "asynchronous copies on one stream, so there is no pool "
                                   "to size and its `threads=` has no effect"),
}


# --------------------------------------------------------------------------
# The comparison
# --------------------------------------------------------------------------
def _params(fn) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]


def _last_name(node) -> str:
    node = node.func if isinstance(node, ast.Call) else node
    return node.attr if isinstance(node, ast.Attribute) else getattr(node, "id", "")


def _fields_init(cls: ast.ClassDef):
    """A dataclass's or NamedTuple's generated ``__init__`` parameters, or
    None for another class."""
    if not (any(_last_name(d) == "dataclass" for d in cls.decorator_list)
            or any(_last_name(b) == "NamedTuple" for b in cls.bases)):
        return None
    return ["self"] + [c.target.id for c in cls.body
                       if isinstance(c, ast.AnnAssign) and isinstance(c.target, ast.Name)]


def _statements(body):
    """Top-level statements, through ``if`` and ``try`` blocks."""
    for s in body:
        if isinstance(s, ast.If):
            yield from _statements(s.body)
            yield from _statements(s.orelse)
        elif isinstance(s, ast.Try):
            for block in (s.body, *(h.body for h in s.handlers), s.orelse, s.finalbody):
                yield from _statements(block)
        else:
            yield s


def surface(source: str) -> dict:
    """name -> ("func", params) | ("class", {method: params}) | ("const", None)."""
    out: dict = {}
    for s in _statements(ast.parse(source).body):
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not s.name.startswith("_"):
                out[s.name] = ("func", _params(s))
        elif isinstance(s, ast.ClassDef):
            if s.name.startswith("_"):
                continue
            methods = {c.name: _params(c) for c in s.body
                       if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef))
                       and (not c.name.startswith("_") or c.name in DUNDERS)}
            init = _fields_init(s)
            if "__init__" not in methods and init is not None:
                methods["__init__"] = init
            out[s.name] = ("class", methods)
        elif isinstance(s, (ast.Assign, ast.AnnAssign)):
            for t in (s.targets if isinstance(s, ast.Assign) else [s.target]):
                for n in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(n, ast.Name) and not n.id.startswith("_"):
                        out.setdefault(n.id, ("const", None))
    return out


def differences(module: str, jax_source: str, port_source: str) -> list:
    """Each JAX name, method or parameter the port lacks, as an
    :data:`ALLOWED` key."""
    jax, port = surface(jax_source), surface(port_source)
    found = []
    for name, (kind, info) in jax.items():
        if name not in port:
            found.append(f"{module}:{name}")
            continue
        pkind, pinfo = port[name]
        if kind == pkind == "func":
            found += [f"{module}:{name}({p})" for p in info if p not in pinfo]
        elif kind == pkind == "class":
            for meth, params in info.items():
                if meth not in pinfo:
                    found.append(f"{module}:{name}.{meth}")
                else:
                    found += [f"{module}:{name}.{meth}({p})" for p in params
                              if p not in pinfo[meth]]
    return found


def check(found, module: str, allowed: dict) -> tuple[list, list]:
    """-> (differences not on ``allowed``, entries of ``module`` that match
    no difference)."""
    listed = {k for k in allowed if k.split(":", 1)[0] == module}
    return sorted(set(found) - listed), sorted(listed - set(found))


def _module_name(rel: pathlib.Path) -> str:
    parts = rel.with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _jax_modules() -> dict:
    return {_module_name(f.relative_to(JAX_ROOT)): f.relative_to(JAX_ROOT)
            for f in sorted(JAX_ROOT.rglob("*.py"))}


def env_literals(root: pathlib.Path) -> set:
    return {n.value for f in root.rglob("*.py") for n in ast.walk(ast.parse(f.read_text()))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and ENV_RE.match(n.value)}


def _describe(unlisted, stale) -> str:
    return (f"not on the allow-list: {unlisted}; "
            f"on the allow-list but no longer a difference: {stale}")


@pytest.mark.parametrize("module", sorted(_jax_modules()))
def test_module_surface_holds_jax(module):
    rel = _jax_modules()[module]
    port_file = PORT_ROOT / rel
    if port_file.exists():
        found = differences(module, (JAX_ROOT / rel).read_text(), port_file.read_text())
    else:
        found = [f"{module}:*"]
    unlisted, stale = check(found, module, ALLOWED)
    assert not unlisted and not stale, _describe(unlisted, stale)


def test_environment_variables_hold_jax():
    found = [f"env:{v}" for v in env_literals(JAX_ROOT) - env_literals(PORT_ROOT)]
    unlisted, stale = check(found, "env", ALLOWED)
    assert not unlisted and not stale, _describe(unlisted, stale)


def test_allow_list_keys_name_jax_modules_and_give_reasons():
    modules = set(_jax_modules()) | {"env"}
    bad = [k for k in ALLOWED if k.split(":", 1)[0] not in modules]
    assert not bad, bad
    assert all(len(reason) > 20 for reason in ALLOWED.values())


def _port_has(ref: str) -> bool:
    module, name = ref.split(":", 1)
    path = PORT_ROOT.joinpath(*module.split("."))
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    if not path.exists():
        return False
    names = surface(path.read_text())
    top, _, meth = name.partition(".")
    if top not in names:
        return False
    return not meth or (names[top][0] == "class" and meth in names[top][1])


def test_counterparts_named_in_reasons_exist_in_the_port():
    refs = {m for reason in ALLOWED.values()
            for m in re.findall(r"`([a-z_.]+:[A-Za-z_][\w.]*)`", reason)}
    assert len(refs) > 30
    missing = sorted(r for r in refs if not _port_has(r))
    assert not missing, missing


def test_the_comparison_fails_on_a_new_name_a_dropped_parameter_and_a_stale_entry():
    jax_source = textwrap.dedent("""
        LIMIT = 3
        def kept(a, b, c=1): pass
        def added(x): pass
        class Box:
            def __add__(self, other): pass
            def open(self, mode): pass
        @dataclass
        class Row:
            name: str
            width: int
    """)
    port_source = textwrap.dedent("""
        LIMIT = 3
        def kept(a, c=1, device="cuda"): pass
        class Box:
            def open(self, mode): pass
        @dataclass
        class Row:
            name: str
    """)
    found = differences("demo", jax_source, port_source)
    assert sorted(found) == ["demo:Box.__add__", "demo:Row.__init__(width)",
                             "demo:added", "demo:kept(b)"]
    allowed = {"demo:added": "x" * 21, "demo:Box.__add__": "x" * 21,
               "demo:Row.__init__(width)": "x" * 21, "demo:gone": "x" * 21}
    unlisted, stale = check(found, "demo", allowed)
    assert unlisted == ["demo:kept(b)"]
    assert stale == ["demo:gone"]
    # the real list scoped to its own module ignores the demo
    assert check(found, "demo", ALLOWED) == (sorted(found), [])


# --------------------------------------------------------------------------
# The CLI: each verb's options are JAX's plus --device
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_commands() -> dict:
    from adam_tpu.cli.main import command_groups

    return {c.name: c for _, cmds in command_groups() for c in cmds}


def _options(parser: argparse.ArgumentParser) -> dict:
    """Each argument of ``parser`` (its flags, or its dest for a
    positional) -> what a caller sees of it."""
    return {(tuple(a.option_strings) or a.dest): (
        a.dest, a.nargs, repr(a.default), repr(a.const), repr(a.choices), a.required,
        type(a).__name__) for a in parser._actions}


_VERBS = ["depth", "count_kmers", "count_contig_kmers", "transform", "adam2fastq",
          "plugin", "flatten", "bam2adam", "vcf2adam", "anno2adam", "adam2vcf",
          "fasta2adam", "features2adam", "wigfix2bed", "print", "print_genes",
          "flagstat", "print_tags", "listdict", "allelecount", "buildinfo", "view",
          "analyze", "serve", "submit", "status", "fetch", "cancel", "incidents",
          "perf", "check", "top"]


def test_verb_list_is_jax_and_the_ports():
    from adam_tpu_torch.cli.main import command_groups

    port = sorted(c.name for _, cmds in command_groups() for c in cmds)
    assert sorted(_jax_commands()) == port == sorted(_VERBS)


#: Options only the port's verbs have, beside ``--device``.
PORT_ONLY_OPTIONS = {
    # the --xprof-dir trace of the run, read beside its --trace-out export
    "analyze": [("--device-trace",)],
}


@pytest.mark.parametrize("verb", _VERBS)
def test_verb_options_are_jax_and_device(verb):
    from adam_tpu.cli.main import add_common_args

    from adam_tpu_torch.cli.main import parser_for

    jax = argparse.ArgumentParser(allow_abbrev=False)
    add_common_args(jax)
    _jax_commands()[verb].configure(jax)
    want, got = _options(jax), _options(parser_for(verb))
    extra = {k: v for k, v in got.items() if k not in want}
    assert list(extra) == [("--device",)] + PORT_ONLY_OPTIONS.get(verb, []), extra
    assert extra[("--device",)][:3] == ("device", None, "'cuda'")
    assert {k: got.get(k) for k in want} == want
