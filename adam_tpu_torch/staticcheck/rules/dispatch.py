"""Rule ``dispatch-ledger``: every dispatch of the streamed path is
``compile_ledger.track``-wrapped, its key has a prewarm registry entry,
and a hand kernel is reached only through ``ops/kernels.launch`` (the
counterpart of ``adam_tpu/staticcheck/rules/dispatch.py``).

The compile ledger makes "did the prewarm cover this shape?" a
first-class observable (``device.compile.in_window``), which the port
holds at zero on clean runs — but only if every dispatch site wraps
itself in :func:`compile_ledger.track` with a key the prewarm registry
also builds.

Three checks:

* **coverage** — a call that runs device work (a ``*_kernel`` or
  ``*_body`` function) in a streamed-path module must sit inside
  ``with compile_ledger.track(...)`` (or ``with ledger`` where ``ledger``
  is bound from one).  The port's idiom hands the work to a dispatch
  helper as a closure: ``bqsr._dispatch(key, rw, mesh, run)`` tracks and
  calls ``run``.  A call is covered when its enclosing nested function
  or lambda is referenced inside a tracked block of the same outer
  function, or is passed to a *tracked dispatcher* (a function of the
  package that calls a parameter under its own ``track``).  Calls inside
  a ``*_kernel``/``*_body`` function are part of the unit its caller
  launches (the counterpart of JAX's trace-time code).
* **prewarm cross-check** — every kernel name keying a ``track`` (the
  first element of the key tuple, a literal or a local name bound to
  literals; through a tracked dispatcher, its key argument) must appear
  in a prewarm entry key built in ``parallel/`` (the ``*entry*``/
  ``*prewarm*`` builders in ``device_pool.py``/``partitioner.py``).
* **kernel containment** — a hand kernel is reached only through
  ``ops/kernels.launch``, which counts the launch, puts it on its
  slot's stream and raises on a failed launch: a ``library(...)`` call
  or a ``<kernel>_launch`` attribute call anywhere else in the package
  is a finding (the counterpart of JAX's pallas containment)."""

from __future__ import annotations

import ast

from adam_tpu_torch.staticcheck.core import Finding, Rule, register
from adam_tpu_torch.staticcheck.rules._astutil import (
    dotted_name,
    enclosing_scope,
    in_dispatchable,
    in_warmup_function,
    is_dispatchable,
    terminal_name,
)

#: The streamed device path: the modules whose dispatches land inside
#: timed windows (the port's counterparts of JAX's list).
SCOPE_FILES = frozenset({
    "adam_tpu_torch/pipelines/markdup.py",
    "adam_tpu_torch/pipelines/bqsr.py",
    "adam_tpu_torch/pipelines/realign.py",
    "adam_tpu_torch/pipelines/streamed.py",
    "adam_tpu_torch/parallel/device_pool.py",
    "adam_tpu_torch/parallel/partitioner.py",
    "adam_tpu_torch/parallel/dist.py",
})

#: Where prewarm entry keys are built (the registry side of the
#: cross-check).
PREWARM_FILES = ("adam_tpu_torch/parallel/device_pool.py",
                 "adam_tpu_torch/parallel/partitioner.py")

#: The one module that may load a kernel library and call its entry.
KERNELS_MODULE = "adam_tpu_torch/ops/kernels.py"

_PACKAGE = "adam_tpu_torch/"


def _is_track_call(expr) -> bool:
    return (isinstance(expr, ast.Call)
            and terminal_name(expr.func) == "track")


def _literal_strings(expr) -> set:
    """String literals an expression evaluates to: a constant, or either
    branch of a conditional of constants."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return {expr.value}
    if isinstance(expr, ast.IfExp):
        return _literal_strings(expr.body) | _literal_strings(expr.orelse)
    return set()


def _key_kernels(key, scope) -> set:
    """Kernel names keying a ``(kernel, *dims)`` tuple: its first element
    as a literal, or a name bound to literals in ``scope``."""
    if not (isinstance(key, ast.Tuple) and key.elts):
        return set()
    first = key.elts[0]
    got = _literal_strings(first)
    if got or not isinstance(first, ast.Name) or scope is None:
        return got
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == first.id
            for t in node.targets
        ):
            got |= _literal_strings(node.value)
    return got


def _tracked_dispatcher(fn) -> int | None:
    """The index of the key parameter when ``fn`` keys a ``with
    compile_ledger.track(<param>, ...)`` (directly or through a name bound
    to such a track call) by one parameter and calls another (the work it
    was handed, possibly from a nested retry unit), else None."""
    params = [a.arg for a in fn.args.args]
    track_names: dict = {}  # local name -> track call
    called: set = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and _is_track_call(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    track_names[t.id] = node.value
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in params:
            called.add(node.func.id)
    for node in ast.walk(fn):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        for item in node.items:
            e = item.context_expr
            if isinstance(e, ast.Name):
                e = track_names.get(e.id)
            if not (_is_track_call(e) and e.args
                    and isinstance(e.args[0], ast.Name)):
                continue
            key = e.args[0].id
            if key in params and called - {key}:
                # a method's callers do not pass ``self``
                return params.index(key) - (params[0] in ("self", "cls"))
    return None


@register
class DispatchLedgerRule(Rule):
    name = "dispatch-ledger"
    summary = ("streamed dispatches not wrapped in compile_ledger.track, "
               "tracked kernels with no prewarm registry entry, or hand "
               "kernels reached outside ops/kernels.launch")
    contract = (
        "Every streamed-path dispatch wraps in compile_ledger.track "
        "keyed identically to a prewarm entry, so device.compile"
        ".in_window == 0 is a compile-time property, and every hand "
        "kernel launches through the counting ops/kernels.launch."
    )

    def __init__(self):
        self._tracked: dict[str, tuple] = {}  # kernel -> (path, line)
        self._prewarmed: set[str] = set()
        self._dispatchers: dict[str, int] = {}  # name -> key param index
        # (finding, dispatcher names its closure was handed to)
        self._pending: list = []
        self._calls: list = []  # (callee name, call, ctx): dispatcher keys

    def visit(self, ctx):
        if not ctx.relpath.startswith(_PACKAGE):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                idx = _tracked_dispatcher(node)
                if idx is not None:
                    self._dispatchers[node.name] = idx
            if not isinstance(node, ast.Call) or not node.args:
                continue
            if _is_track_call(node):
                for k in _key_kernels(node.args[0],
                                      enclosing_scope(ctx, node)):
                    self._tracked.setdefault(k, (ctx.relpath, node.lineno))
            else:
                self._calls.append((terminal_name(node.func), node, ctx))
        if ctx.relpath in PREWARM_FILES:
            self._collect_prewarm_kernels(ctx.tree)
        if ctx.relpath != KERNELS_MODULE:
            yield from self._check_containment(ctx)
        if ctx.relpath not in SCOPE_FILES:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = terminal_name(node.func)
            if not is_dispatchable(name):
                continue
            if in_dispatchable(ctx, node):
                continue  # inside a launched unit: part of its dispatch
            if in_warmup_function(ctx, node):
                # prewarm entry thunks run under the pool/mesh prewarm's
                # own track; probe/bench dispatches are deliberately
                # outside any window
                continue
            covered, handed_to = self._covered(ctx, node)
            if covered:
                continue
            finding = ctx.finding(
                self.name, node,
                f"dispatch '{name}' outside compile_ledger.track — "
                "the compile ledger (and the in_window == 0 invariant) "
                "cannot see this site",
            )
            self._pending.append((finding, handed_to))

    def _check_containment(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if terminal_name(func) == "library" and (
                isinstance(func, ast.Name)
                or dotted_name(func).endswith("kernels.library")
            ):
                what = "library()"
            elif (isinstance(func, ast.Attribute)
                  and func.attr.endswith("_launch")
                  and func.attr[:-len("_launch")].strip("_")
                  and not (isinstance(func.value, ast.Name)
                           and func.value.id in ("self", "cls"))):
                what = f"{func.attr}()"
            else:
                continue
            yield ctx.finding(
                self.name, node,
                f"{what} outside ops/kernels.py — a hand kernel launches "
                "only through ops/kernels.launch, which counts the launch, "
                "runs it on its slot's stream and raises on a failed "
                "launch",
            )

    # ---- coverage -------------------------------------------------------
    def _covered(self, ctx, call):
        """-> (covered, names of the calls its enclosing closures were
        handed to): those are judged in :meth:`finalize`, once every
        tracked dispatcher of the package is known."""
        for anc in ctx.ancestors(call):
            if isinstance(anc, (ast.With, ast.AsyncWith)):
                if any(self._is_tracking(ctx, anc, i.context_expr)
                       for i in anc.items):
                    return True, set()
        handed_to: set = set()
        fn = enclosing_scope(ctx, call)
        while fn is not None:
            outer = enclosing_scope(ctx, fn)
            if outer is None:
                break
            if self._referenced_under_track(ctx, outer, fn):
                return True, set()
            handed_to |= self._handed_to(ctx, outer, fn)
            fn = outer
        return False, handed_to

    def _is_tracking(self, ctx, with_node, expr) -> bool:
        if _is_track_call(expr):
            return True
        if not isinstance(expr, ast.Name):
            return False
        fn = enclosing_scope(ctx, with_node)
        if fn is None:
            return False
        return any(
            isinstance(n, ast.Assign) and _is_track_call(n.value)
            and any(isinstance(t, ast.Name) and t.id == expr.id
                    for t in n.targets)
            for n in ast.walk(fn)
        )

    def _referenced_under_track(self, ctx, outer_fn, fn) -> bool:
        for node in ast.walk(outer_fn):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if not any(self._is_tracking(ctx, node, i.context_expr)
                       for i in node.items):
                continue
            for sub in ast.walk(node):
                if sub is fn or (
                    isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and isinstance(sub, ast.Name) and sub.id == fn.name
                    and isinstance(sub.ctx, ast.Load)
                ):
                    return True
        return False

    @staticmethod
    def _handed_to(ctx, outer_fn, fn) -> set:
        """Names of the calls in ``outer_fn`` that take ``fn`` (a nested
        def by name, or the lambda itself) as an argument."""
        out = set()
        for node in ast.walk(outer_fn):
            if not isinstance(node, ast.Call):
                continue
            for a in list(node.args) + [k.value for k in node.keywords]:
                if a is fn or (
                    isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and isinstance(a, ast.Name) and a.id == fn.name
                ):
                    out.add(terminal_name(node.func))
        return out

    # ---- prewarm registry side ------------------------------------------
    def _collect_prewarm_kernels(self, tree) -> None:
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            fname = node.name.lower()
            if "entry" not in fname and "prewarm" not in fname:
                continue
            for sub in ast.walk(node):
                first = None
                if isinstance(sub, ast.Tuple) and sub.elts:
                    first = sub.elts[0]
                elif (isinstance(sub, ast.Call) and sub.args
                      and "entry" in terminal_name(sub.func)):
                    # _mesh_entry("mesh.observe_packed", ...)
                    first = sub.args[0]
                if isinstance(first, ast.Constant) and isinstance(
                    first.value, str
                ) and "." in first.value:
                    self._prewarmed.add(first.value)

    def finalize(self, project):
        for finding, handed_to in self._pending:
            if not handed_to & set(self._dispatchers):
                yield finding
        for callee, call, ctx in self._calls:
            idx = self._dispatchers.get(callee)
            if idx is None or idx >= len(call.args):
                continue
            for k in _key_kernels(call.args[idx], enclosing_scope(ctx, call)):
                self._tracked.setdefault(k, (ctx.relpath, call.lineno))
        for kernel, (path, line) in sorted(self._tracked.items()):
            if kernel not in self._prewarmed:
                yield Finding(
                    self.name, path, line, 0,
                    f"kernel '{kernel}' is ledger-tracked but no "
                    "prewarm registry entry builds this key "
                    "(parallel/device_pool.py / partitioner.py) — its "
                    "first dispatch cold-compiles inside a timed "
                    "window",
                    "",
                )
