"""Rule ``host-sync``: hot-path device->host synchronization must route
through ``utils/transfer.device_fetch`` (the counterpart of
``adam_tpu/staticcheck/rules/hostsync.py``, in torch's idiom).

The device ledger (``device.d2h.bytes`` and the per-pass ``transfers``
attribution) is complete only **by convention**: every fetch of a tensor
on the card crosses in ``transfer.device_fetch``, which also carries the
fetch deadline watchdog, the transient retry and the ``device.fetch``
fault point (docs/ROBUSTNESS.md).  A stray ``t.cpu()`` in the hot path is
an unledgered, unwatched, unretryable d2h copy — exactly the drift this
rule kills.

Detection is a per-function forward taint pass.  Values are
*device-tainted* when they come from a call that runs device work (the
JAX package's device call patterns, ``*_kernel``/``*_body`` functions,
the wrappers in ``ops/`` that launch a hand kernel through
``ops/kernels.launch``), from a placer (a name bound from
``putter(...)``, ``move_to``, ``put_rows``, a local function that
returns a tainted value), from ``.to(<device>)`` or ``.cuda()``, from a
``torch.*`` factory given ``device=``, or from a ``torch.*`` call on a
tainted value; taint follows assignment, tuple unpacking, indexing,
attribute access and method calls; ``device_fetch`` launders it.
Applying ``np.asarray`` / ``np.array`` / ``np.ascontiguousarray`` /
``float`` / ``int`` / ``bool`` / ``.item()`` / ``.tolist()`` /
``.numpy()`` to a tainted value — or calling ``.cpu()`` or
``torch.cuda.synchronize()`` at all, the torch spellings of JAX's
``jax.device_get`` and ``block_until_ready`` — inside ``pipelines/``,
``parallel/``, ``ops/``, ``serve/`` or ``gateway/`` is a finding.  An
``isinstance(x, np.ndarray)`` test narrows ``x`` to host inside the
guarded branch (the standard host-short-circuit idiom).  Warm, prewarm,
probe and bench functions are exempt."""

from __future__ import annotations

import ast
import fnmatch
import os

from adam_tpu_torch.staticcheck.core import Rule, register
from adam_tpu_torch.staticcheck.rules._astutil import (
    dotted_name,
    is_dispatchable,
    is_warmup_name,
    terminal_name,
    to_device_call,
)

SCOPE_PREFIXES = ("adam_tpu_torch/pipelines/", "adam_tpu_torch/parallel/",
                  "adam_tpu_torch/ops/", "adam_tpu_torch/serve/",
                  "adam_tpu_torch/gateway/")

#: Where the hand-kernel wrappers live: a function there whose body calls
#: ``kernels.launch`` returns tensors on the card.
KERNEL_WRAPPER_DIR = "adam_tpu_torch/ops"

#: Callable-name patterns whose results are device-resident (or may
#: be): the JAX package's list (its mesh per-window collectives and
#: placement names keep their meaning), plus the port's ``move_to``
#: (a tensor handed across slots) and ``put_rows`` (the mesh's row
#: blocks).  fnmatch'd against the call's terminal name.
DEVICE_CALL_PATTERNS = (
    "*_kernel",
    "*_jit",
    "_observe_device",
    "observe_window",
    "apply_window",
    "markdup_window",
    "device_lexsort",
    "*_columns_dispatch",
    "device_put",
    "put_replicated",
    "move_to",
    "put_rows",
)

#: Calls that launder taint: the result is host-resident numpy.
SANITIZERS = ("device_fetch",)

_NP_SINKS = {
    "np.asarray", "numpy.asarray",
    "np.array", "numpy.array",
    "np.ascontiguousarray", "numpy.ascontiguousarray",
}
_BUILTIN_SINKS = {"float", "int", "bool"}
_METHOD_SINKS = {"item", "tolist", "numpy"}

#: Methods whose result is on the host (the sinks themselves).
_HOST_METHODS = _METHOD_SINKS | {"cpu"}

#: Builtins whose result is a host value whatever they are given.
_HOST_BUILTINS = {"len", "isinstance", "hasattr", "type", "id", "str",
                  "repr", "print", "range", "callable"}


def _matches_device_call(name: str) -> bool:
    return is_dispatchable(name) or any(
        fnmatch.fnmatchcase(name, p) for p in DEVICE_CALL_PATTERNS
    )


def _device_kwarg(call: ast.Call) -> bool:
    """A ``torch.*`` factory given ``device=`` other than ``"cpu"``."""
    for kw in call.keywords:
        if kw.arg == "device":
            v = kw.value
            return not (isinstance(v, ast.Constant) and v.value == "cpu")
    return False


def _launching_functions(tree) -> set:
    """Functions of a module whose body calls ``kernels.launch``."""
    out = set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and dotted_name(sub.func).endswith(
                "kernels.launch"
            ):
                out.add(node.name)
                break
    return out


@register
class HostSyncRule(Rule):
    name = "host-sync"
    summary = ("hot-path d2h sync (.cpu()/.item()/.tolist()/.numpy()/"
               "np.asarray/float()/torch.cuda.synchronize on device "
               "values) outside transfer.device_fetch")
    contract = (
        "Every device->host fetch in pipelines/, parallel/, ops/, serve/ "
        "and gateway/ routes through utils/transfer.device_fetch so the "
        "d2h ledger, fetch watchdog, retry and fault point stay complete "
        "by construction (docs/ROBUSTNESS.md)."
    )

    def __init__(self):
        self._wrappers: set | None = None

    def _kernel_wrappers(self, root: str) -> set:
        """The hand-kernel wrappers of ``ops/`` (``observe_hist``,
        ``pack_rows``, ``sw_fill``...), read from the tree under check."""
        if self._wrappers is None:
            self._wrappers = set()
            top = os.path.join(root, KERNEL_WRAPPER_DIR)
            try:
                names = sorted(os.listdir(top))
            except OSError:
                names = []
            for fn in names:
                if not fn.endswith(".py") or fn == "kernels.py":
                    continue
                try:
                    with open(os.path.join(top, fn), encoding="utf-8") as fh:
                        tree = ast.parse(fh.read())
                except (OSError, SyntaxError, UnicodeDecodeError):
                    continue
                self._wrappers |= _launching_functions(tree)
        return self._wrappers

    def visit(self, ctx):
        if not ctx.relpath.startswith(SCOPE_PREFIXES):
            return
        self._device_fns = set(self._kernel_wrappers(ctx.root))
        # names bound from putter(...) place arrays on device
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                if terminal_name(node.value.func) in ("putter",):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self._device_fns.add(t.id)

        findings: list = []
        # one walk from the module body: _walk_block recurses into every
        # function/class it encounters exactly once (including defs nested
        # in module-level if/try), skipping warm/probe/bench functions
        self._walk_block(ctx, ctx.tree.body, set(), findings, set())
        yield from findings

    # ---- helpers --------------------------------------------------------
    def _is_device_call(self, call: ast.Call, tainted, local_fns) -> bool:
        func = call.func
        name = terminal_name(func)
        if name in SANITIZERS or (isinstance(func, ast.Name)
                                  and name in _HOST_BUILTINS):
            return False
        if name in self._device_fns or (isinstance(func, ast.Name)
                                        and name in local_fns):
            return True
        if _matches_device_call(name):
            return True
        if to_device_call(call):
            return True
        d = dotted_name(func)
        if d.startswith("torch.") and (
            _device_kwarg(call)
            or any(self._tainted(a, tainted, local_fns) for a in call.args)
        ):
            return True
        # method on a tainted value stays tainted (t.to(torch.int64),
        # t.sum()), but a copy home is host (and flagged where it is made)
        if isinstance(func, ast.Attribute) and func.attr in _HOST_METHODS:
            return False
        if isinstance(func, ast.Attribute) and self._tainted(
            func.value, tainted, local_fns
        ):
            return True
        return False

    def _tainted(self, expr, tainted, local_fns) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in tainted
        if isinstance(expr, ast.Call):
            if terminal_name(expr.func) in SANITIZERS:
                return False
            return self._is_device_call(expr, tainted, local_fns)
        if isinstance(expr, ast.Attribute):
            # tensor metadata is host-resident even on device tensors
            if expr.attr in ("shape", "ndim", "dtype", "device",
                             "is_cuda"):
                return False
            return self._tainted(expr.value, tainted, local_fns)
        if isinstance(expr, (ast.Subscript, ast.Starred)):
            return self._tainted(expr.value, tainted, local_fns)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return any(self._tainted(e, tainted, local_fns)
                       for e in expr.elts)
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self._tainted(expr.elt, tainted, local_fns)
        if isinstance(expr, ast.BinOp):
            return (self._tainted(expr.left, tainted, local_fns)
                    or self._tainted(expr.right, tainted, local_fns))
        if isinstance(expr, ast.UnaryOp):
            return self._tainted(expr.operand, tainted, local_fns)
        if isinstance(expr, ast.Compare):
            return (self._tainted(expr.left, tainted, local_fns)
                    or any(self._tainted(c, tainted, local_fns)
                           for c in expr.comparators))
        if isinstance(expr, ast.IfExp):
            return (self._tainted(expr.body, tainted, local_fns)
                    or self._tainted(expr.orelse, tainted, local_fns))
        if isinstance(expr, ast.NamedExpr):
            return self._tainted(expr.value, tainted, local_fns)
        return False

    def _assign_names(self, target, value_tainted: bool, tainted) -> None:
        if isinstance(target, ast.Name):
            if value_tainted:
                tainted.add(target.id)
            else:
                tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._assign_names(elt, value_tainted, tainted)
        elif isinstance(target, ast.Starred):
            self._assign_names(target.value, value_tainted, tainted)

    def _check_exprs(self, ctx, node, tainted, findings, local_fns) -> None:
        """Scan every Call inside ``node`` for sink applications, and
        record NamedExpr bindings."""
        for sub in ast.walk(node):
            if isinstance(sub, ast.NamedExpr) and isinstance(
                sub.target, ast.Name
            ):
                self._assign_names(
                    sub.target,
                    self._tainted(sub.value, tainted, local_fns), tainted,
                )
            if not isinstance(sub, ast.Call):
                continue
            func = sub.func
            d = dotted_name(func)
            args_tainted = any(
                self._tainted(a, tainted, local_fns) for a in sub.args
            )
            if d in _NP_SINKS and args_tainted:
                findings.append(ctx.finding(
                    self.name, sub,
                    f"{d}() on a device value — route the fetch "
                    "through transfer.device_fetch (ledger + watchdog "
                    "+ retry)",
                ))
            elif (isinstance(func, ast.Name)
                  and func.id in _BUILTIN_SINKS
                  and len(sub.args) == 1 and args_tainted):
                findings.append(ctx.finding(
                    self.name, sub,
                    f"{func.id}() on a device value forces a blocking "
                    "d2h sync — fetch through transfer.device_fetch "
                    "first",
                ))
            elif (isinstance(func, ast.Attribute)
                  and func.attr in _METHOD_SINKS
                  and self._tainted(func.value, tainted, local_fns)):
                findings.append(ctx.finding(
                    self.name, sub,
                    f".{func.attr}() on a device value forces a "
                    "blocking d2h sync — fetch through "
                    "transfer.device_fetch first",
                ))
            elif (isinstance(func, ast.Attribute) and func.attr == "cpu"
                  and not sub.args):
                findings.append(ctx.finding(
                    self.name, sub,
                    ".cpu() bypasses transfer.device_fetch "
                    "(unledgered, unwatched d2h)",
                ))
            elif d == "torch.cuda.synchronize":
                findings.append(ctx.finding(
                    self.name, sub,
                    "torch.cuda.synchronize in the hot path stalls the "
                    "dispatch pipeline — fetch through "
                    "transfer.device_fetch or keep the value lazy",
                ))

    def _returns_tainted(self, fn, tainted, local_fns) -> bool:
        """A local function whose return value is device-tainted: a
        placer such as ``def put(x): return torch.from_numpy(x).to(dev)``."""
        inner = set(tainted)
        self._walk_block(None, fn.body, inner, None, set(local_fns))
        return any(
            isinstance(n, ast.Return) and n.value is not None
            and self._tainted(n.value, inner, local_fns)
            for n in ast.walk(fn)
        )

    def _walk_block(self, ctx, stmts, tainted, findings, local_fns) -> None:
        """Forward walk over a statement block, threading the tainted
        name set through assignments and branch structure.  With
        ``findings`` None it only threads the taint (no sink checks)."""
        def check(node):
            if findings is not None:
                self._check_exprs(ctx, node, tainted, findings, local_fns)

        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if is_warmup_name(stmt.name):
                    continue
                if findings is not None:
                    # closure sees the taint state at its definition point
                    self._walk_block(ctx, stmt.body, set(tainted), findings,
                                     set(local_fns))
                if self._returns_tainted(stmt, tainted, local_fns):
                    local_fns.add(stmt.name)
                continue
            if isinstance(stmt, ast.ClassDef):
                if findings is None:
                    continue
                for item in stmt.body:
                    if isinstance(
                        item, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ) and not is_warmup_name(item.name):
                        self._walk_block(ctx, item.body, set(), findings,
                                         set())
                continue
            if isinstance(stmt, ast.Assign):
                check(stmt.value)
                vt = self._tainted(stmt.value, tainted, local_fns)
                for t in stmt.targets:
                    self._assign_names(t, vt, tainted)
                continue
            if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                check(stmt.value)
                self._assign_names(
                    stmt.target,
                    self._tainted(stmt.value, tainted, local_fns), tainted,
                )
                continue
            if isinstance(stmt, ast.AugAssign):
                check(stmt.value)
                if self._tainted(stmt.value, tainted, local_fns):
                    self._assign_names(stmt.target, True, tainted)
                continue
            if isinstance(stmt, ast.If):
                check(stmt.test)
                narrowed = set(tainted)
                for n in _isinstance_ndarray_names(stmt.test):
                    narrowed.discard(n)
                else_taint = set(tainted)
                self._walk_block(ctx, stmt.body, narrowed, findings,
                                 local_fns)
                self._walk_block(ctx, stmt.orelse, else_taint, findings,
                                 local_fns)
                # conservative join: anything tainted in either branch
                tainted |= narrowed | else_taint
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                check(stmt.iter)
                self._assign_names(
                    stmt.target,
                    self._tainted(stmt.iter, tainted, local_fns), tainted,
                )
                self._walk_block(ctx, stmt.body, tainted, findings,
                                 local_fns)
                self._walk_block(ctx, stmt.orelse, tainted, findings,
                                 local_fns)
                continue
            if isinstance(stmt, ast.While):
                check(stmt.test)
                self._walk_block(ctx, stmt.body, tainted, findings,
                                 local_fns)
                self._walk_block(ctx, stmt.orelse, tainted, findings,
                                 local_fns)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    check(item.context_expr)
                    if item.optional_vars is not None:
                        self._assign_names(
                            item.optional_vars,
                            self._tainted(item.context_expr, tainted,
                                          local_fns),
                            tainted,
                        )
                self._walk_block(ctx, stmt.body, tainted, findings,
                                 local_fns)
                continue
            if isinstance(stmt, ast.Try):
                self._walk_block(ctx, stmt.body, tainted, findings,
                                 local_fns)
                for h in stmt.handlers:
                    self._walk_block(ctx, h.body, set(tainted), findings,
                                     local_fns)
                self._walk_block(ctx, stmt.orelse, tainted, findings,
                                 local_fns)
                self._walk_block(ctx, stmt.finalbody, tainted, findings,
                                 local_fns)
                continue
            # leaf statements: Expr, Return, Raise, Assert, Delete...
            check(stmt)


def _isinstance_ndarray_names(test) -> set:
    """Names proven host-resident by an ``isinstance(x, np.ndarray)``
    test (possibly inside an ``and``)."""
    names: set[str] = set()
    nodes = [test]
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        nodes = list(test.values)
    for n in nodes:
        if (isinstance(n, ast.Call)
                and terminal_name(n.func) == "isinstance"
                and len(n.args) == 2
                and isinstance(n.args[0], ast.Name)
                and dotted_name(n.args[1]) in
                ("np.ndarray", "numpy.ndarray")):
            names.add(n.args[0].id)
    return names
