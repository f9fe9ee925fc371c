"""Shared AST helpers for the built-in rules (the counterpart of
``adam_tpu/staticcheck/rules/_astutil.py``: the port has no jit, so the
"dispatchable" of a rule is a call that launches work on the card)."""

from __future__ import annotations

import ast
import fnmatch

#: Call names that run device work of the port: the pass kernels
#: (``observe_kernel``, ``recalibrate_kernel``, the realign sweep's
#: ``sweep_kernel_gather``...) and the bodies that launch the hand kernels
#: or the plain PyTorch ops on their tensors' device
#: (``observe_packed_body``, ``apply_pack2_body``...).
#: The counterpart of the JAX package's jit-compiled callables.
DISPATCH_PATTERNS = ("*_kernel", "*_kernel_gather", "*_body")

#: Function-name patterns whose bodies are compile-forcing by design:
#: prewarm entry thunks (executed under DevicePool.prewarm /
#: MeshPartitioner.prewarm's own compile_ledger.track), TFLOP/s probes
#: and micro-benchmarks.  Synchronising and direct kernel calls there
#: are the POINT, not hot-path drift.
WARMUP_FN_PATTERNS = ("warm*", "*prewarm*", "*probe*", "*bench*")

_FUNCTIONS = (ast.FunctionDef, ast.AsyncFunctionDef)
_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def terminal_name(func) -> str:
    """The rightmost name of a call target: ``f`` for ``f(...)``,
    ``track`` for ``compile_ledger.track(...)``."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ""


def dotted_name(node) -> str:
    """Best-effort dotted path (``torch.cuda.synchronize`` /
    ``np.asarray``); empty for dynamic expressions."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


_TORCH_DTYPES = {
    "bool", "uint8", "int8", "int16", "int32", "int64", "float16",
    "bfloat16", "float32", "float64", "float", "double", "half", "int",
    "long", "short",
}


def to_device_call(call: ast.Call) -> bool:
    """``x.to(<device>)`` / ``x.to(device=...)`` / ``x.cuda()``: a
    placement, where ``x.to(torch.int64)`` (a dtype) is not."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return False
    if func.attr == "cuda":
        return True
    if func.attr != "to":
        return False
    if any(kw.arg == "device" for kw in call.keywords):
        return True
    if not call.args:
        return False
    a = call.args[0]
    if isinstance(a, ast.Constant):
        return isinstance(a.value, str) and a.value != "cpu"
    d = dotted_name(a)
    if d.startswith("torch.") and d.split(".", 1)[1] in _TORCH_DTYPES:
        return False
    if isinstance(a, ast.Attribute) and a.attr == "dtype":
        return False
    return True


def is_dispatchable(name: str) -> bool:
    return any(fnmatch.fnmatchcase(name, p) for p in DISPATCH_PATTERNS)


def is_warmup_name(name: str) -> bool:
    return any(fnmatch.fnmatchcase(name, p) for p in WARMUP_FN_PATTERNS)


def in_warmup_function(ctx, node) -> bool:
    """``node`` sits inside a function whose (or whose ancestor's) name
    marks it as warm/probe/bench code."""
    return any(isinstance(anc, _FUNCTIONS) and is_warmup_name(anc.name)
               for anc in ctx.ancestors(node))


def in_dispatchable(ctx, node) -> bool:
    """``node`` sits inside a ``*_kernel``/``*_body`` function: part of
    the unit a dispatch site launches, not a dispatch of its own (the
    counterpart of JAX's trace-time code inside a jit)."""
    return any(isinstance(anc, _FUNCTIONS) and is_dispatchable(anc.name)
               for anc in ctx.ancestors(node))


def enclosing_scope(ctx, node):
    """The nearest enclosing FunctionDef or lambda (None at module
    level)."""
    for anc in ctx.ancestors(node):
        if isinstance(anc, _SCOPES):
            return anc
    return None


def in_with_matching(ctx, node, match) -> bool:
    """True when ``node`` sits lexically inside a ``with`` statement one
    of whose context expressions satisfies ``match(expr)``."""
    for anc in ctx.ancestors(node):
        if isinstance(anc, (ast.With, ast.AsyncWith)):
            for item in anc.items:
                if match(item.context_expr):
                    return True
    return False


def name_contains_lock(node) -> bool:
    """A ``with`` context expression that looks like a lock: a name or
    attribute whose terminal name contains ``lock`` (``_LOCK``,
    ``self._lock``, ``_PREWARM_LOCK``...), or a call on one
    (``lk.acquire_timeout(...)`` style)."""
    if isinstance(node, ast.Call):
        node = node.func
    term = ""
    if isinstance(node, ast.Name):
        term = node.id
    elif isinstance(node, ast.Attribute):
        term = node.attr
    return "lock" in term.lower()
