"""Rule ``residency``: window bases/quals place host->device at ingest
only (the counterpart of ``adam_tpu/staticcheck/rules/residency.py``,
over the port's placers).

The device-resident-windows contract (docs/PERF.md "Device-resident
windows"): a streamed window's ``bases``/``quals`` matrices cross the
tunnel ONCE, when the window is tokenized
(``device_pool.make_resident_window`` / ``partitioner.
mesh_resident_window`` under ``pass_scope("ingest")``), and the
markdup/observe/apply passes dispatch against the
:class:`~adam_tpu_torch.parallel.device_pool.ResidentWindow` handle.  A new
``putter``/``DevicePool.put``/``put_rows`` placement of those matrices
inside a dispatch path silently re-ships the fattest arrays in the
pipeline every pass — exactly the regression this rule exists to stop
(the guardrail the ROADMAP's "Device-resident windows end-to-end" item
names).

Detection: inside the streamed dispatch surface
(``pipelines/{bqsr,markdup,streamed}.py``,
``parallel/{device_pool,partitioner}.py``), a call whose argument
expression reads a ``.bases`` or ``.quals`` attribute is flagged when
the call target is a placer (a name bound from ``putter(...)``,
``put``/``put_rows``/``put_replicated``/``device_put``; in torch's idiom
also ``.to(<device>)``/``.cuda()`` of a tensor built from them and a
``torch.*`` factory given ``device=``) **or a ``pad_rows_np`` grid pad** — padding the fat window matrices is what a
device ship looks like on this surface, whether the placement happens
in the same expression or via a tuple handed to a mesh collective.
Functions whose name (or any
enclosing function's name) matches ``*resident*``/``*ingest*`` — the
sanctioned placement sites — or the warm/prewarm/probe/bench patterns
are exempt.  The legacy non-resident fallbacks (residency off, a dead
handle, an eviction replay re-shipping from the host ingest copy) stay
in the code on purpose and carry ``noqa[residency]`` suppressions with
reasons, per the usual suppression contract."""

from __future__ import annotations

import ast
import fnmatch

from adam_tpu_torch.staticcheck.core import Rule, register
from adam_tpu_torch.staticcheck.rules._astutil import (
    WARMUP_FN_PATTERNS,
    dotted_name,
    terminal_name,
    to_device_call,
)

#: The streamed flagship's dispatch surface — the scope the residency
#: contract covers.  The non-streamed distributed paths (parallel/
#: dist.py, sharded.py) predate residency and stay out, like the
#: dispatch-ledger rule's baseline treatment of them.
SCOPE_FILES = (
    "adam_tpu_torch/pipelines/bqsr.py",
    "adam_tpu_torch/pipelines/markdup.py",
    "adam_tpu_torch/pipelines/streamed.py",
    "adam_tpu_torch/parallel/device_pool.py",
    "adam_tpu_torch/parallel/partitioner.py",
    # the cross-job coalescer dispatches fused grids built from
    # ResidentWindow slices; its non-resident re-ship fallbacks must
    # stay visibly fallbacks (serve/batching.py)
    "adam_tpu_torch/serve/batching.py",
)

#: Call targets that place host arrays on device — plus the grid pad
#: that precedes every such ship on this surface (the pad is flagged
#: even when the placement happens downstream via a tuple argument).
PLACER_NAMES = frozenset({
    "put", "put_rows", "put_replicated", "device_put", "pad_rows_np",
})

#: Function-name patterns exempt from the rule: the sanctioned ingest
#: placement builders, and warm/prewarm/probe/bench bodies (dummy
#: placements are the point there).
EXEMPT_FN_PATTERNS = ("*resident*", "*ingest*") + WARMUP_FN_PATTERNS

#: The window matrices the ingest-once contract covers.
_RESIDENT_ATTRS = frozenset({"bases", "quals"})


def _reads_resident_attr(node) -> str | None:
    """The first ``.bases``/``.quals`` attribute read inside ``node``
    (None when it reads neither)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _RESIDENT_ATTRS:
            return sub.attr
    return None


def _placed_expr(call, placers):
    """The host expression a call places on the device, or None: the
    first argument of a placer, the receiver of ``.to(<device>)`` /
    ``.cuda()``, or the data of a ``torch.*`` factory given ``device=``."""
    func = call.func
    if terminal_name(func) in placers and call.args:
        return call.args[0]
    if to_device_call(call):
        return func.value
    if (dotted_name(func).startswith("torch.") and call.args
            and any(kw.arg == "device" for kw in call.keywords)):
        return call.args[0]
    return None


def _fn_exempt(name: str) -> bool:
    return any(fnmatch.fnmatchcase(name, p) for p in EXEMPT_FN_PATTERNS)


@register
class ResidencyRule(Rule):
    name = "residency"
    summary = ("window bases/quals host->device placement outside the "
               "ingest-resident path (the passes must dispatch against "
               "the ResidentWindow handle)")
    contract = (
        "A streamed window's bases/quals matrices place on device once, "
        "at ingest (ResidentWindow under pass_scope('ingest')); markdup/"
        "observe/apply dispatch against the handle.  Re-placements in "
        "the dispatch paths are fallbacks and must carry a justified "
        "noqa[residency] (docs/PERF.md 'Device-resident windows')."
    )

    def visit(self, ctx):
        if ctx.relpath not in SCOPE_FILES:
            return
        # names bound from putter(...) are placers too (_put = putter(d))
        placers = set(PLACER_NAMES)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                if terminal_name(node.value.func) == "putter":
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            placers.add(t.id)
        yield from self._walk(ctx, ctx.tree.body, placers, exempt=False)

    def _walk(self, ctx, stmts, placers, exempt: bool):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._walk(
                    ctx, stmt.body, placers,
                    exempt or _fn_exempt(stmt.name),
                )
                continue
            if isinstance(stmt, ast.ClassDef):
                yield from self._walk(ctx, stmt.body, placers, exempt)
                continue
            if exempt:
                # exemption is lexical: everything under a sanctioned
                # function (nested defs included) is placement-side
                yield from self._walk_children(ctx, stmt, placers)
                continue
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Call):
                    continue
                placed = _placed_expr(sub, placers)
                if placed is None:
                    continue
                attr = _reads_resident_attr(placed)
                if attr is None:
                    continue
                yield ctx.finding(
                    self.name, sub,
                    f"host->device placement of window .{attr} outside "
                    "the ingest-resident path — dispatch against the "
                    "ResidentWindow handle, or justify the fallback "
                    "with noqa[residency] (docs/PERF.md "
                    "'Device-resident windows')",
                )

    def _walk_children(self, ctx, stmt, placers):
        """Recurse into defs nested under an exempt statement so their
        bodies inherit the exemption (nothing is flagged there)."""
        for sub in ast.iter_child_nodes(stmt):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                yield from self._walk(ctx, sub.body, placers, True)
            else:
                yield from self._walk_children(ctx, sub, placers)
