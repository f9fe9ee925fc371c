"""Rule ``lock-discipline``: shared mutable state stays behind its
lock (copied from ``adam_tpu/staticcheck/rules/locks.py``, over the
port's package).

The streamed pipeline spawns threads in half a dozen modules (writer
pool, heartbeat, fetch chunks, prewarm workers, deadline watchdogs);
their shared state is guarded by convention — ``TimerRegistry`` takes
``self._lock`` around every ``Timer`` read-modify-write precisely
because codec timers fire from the ingest thread and the writer pool
concurrently.  Two checks encode that convention:

* **module globals** — in a module that spawns threads
  (``threading.Thread`` / ``ThreadPoolExecutor`` textually present),
  rebinding a ``global``-declared name or mutating a module-level
  container (``.add``/``.append``/``.update``/``[...]=``/``del``)
  outside a ``with <lock>`` block is a finding.  Lock recognition is
  by name: any context manager whose terminal name contains ``lock``.
* **locked classes** — in ANY class that owns a lock attribute
  (``self._lock = threading.Lock()`` or a dataclass
  ``field(default_factory=threading.Lock)``), methods that mutate the
  instance's container attributes outside ``with self.<lock>`` are
  findings.  The ``*_locked`` naming convention is honored both ways:
  a method named ``*_locked`` asserts "caller holds the lock" and is
  exempt inside, but *calling* one outside a ``with``-lock block is a
  finding — the convention is only as good as its call sites."""

from __future__ import annotations

import ast

from adam_tpu_torch.staticcheck.core import Rule, register
from adam_tpu_torch.staticcheck.rules._astutil import (
    dotted_name,
    in_with_matching,
    name_contains_lock,
    terminal_name,
)

_MUTATORS = frozenset({
    "add", "append", "appendleft", "extend", "update", "clear",
    "discard", "remove", "pop", "popleft", "insert", "setdefault",
})

_THREAD_SPAWNERS = ("threading.Thread", "Thread", "ThreadPoolExecutor",
                    "concurrent.futures.ThreadPoolExecutor")

_CONTAINER_FACTORIES = ("dict", "list", "set", "deque", "defaultdict",
                        "OrderedDict", "Counter")


def _spawns_threads(tree) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            if dotted_name(node.func) in _THREAD_SPAWNERS:
                return True
    return False


def _module_containers(tree) -> set:
    """Module-level names bound to container literals/constructors."""
    out: set[str] = set()
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign):
            continue
        v = stmt.value
        is_container = isinstance(v, (ast.Dict, ast.List, ast.Set)) or (
            isinstance(v, ast.Call)
            and terminal_name(v.func) in _CONTAINER_FACTORIES
        )
        if is_container:
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def _under_lock(ctx, node) -> bool:
    return in_with_matching(ctx, node, name_contains_lock)


@register
class LockDisciplineRule(Rule):
    name = "lock-discipline"
    summary = ("shared-state mutation outside its lock in "
               "thread-spawning modules and lock-owning classes")
    contract = (
        "Module globals in thread-spawning modules and container "
        "attributes of lock-owning classes (TimerRegistry, Tracer, "
        "the prewarm/compile-ledger seen-sets) mutate only under "
        "their lock; *_locked methods are callable only under it."
    )

    def visit(self, ctx):
        if not ctx.relpath.startswith("adam_tpu_torch/"):
            return
        if _spawns_threads(ctx.tree):
            yield from self._check_module_globals(ctx)
        yield from self._check_locked_classes(ctx)

    # ---- module-global discipline --------------------------------------
    def _check_module_globals(self, ctx):
        containers = _module_containers(ctx.tree)
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            declared: set[str] = set()
            for stmt in fn.body:
                if isinstance(stmt, ast.Global):
                    declared.update(stmt.names)
            for node in ast.walk(fn):
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = (
                        node.targets if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    for t in targets:
                        if (isinstance(t, ast.Name) and t.id in declared
                                and not _under_lock(ctx, node)):
                            yield ctx.finding(
                                self.name, node,
                                f"rebinding module global '{t.id}' "
                                "outside a lock in a thread-spawning "
                                "module",
                            )
                        elif (isinstance(t, ast.Subscript)
                              and isinstance(t.value, ast.Name)
                              and t.value.id in containers
                              and not _under_lock(ctx, node)):
                            yield ctx.finding(
                                self.name, node,
                                f"item assignment on module container "
                                f"'{t.value.id}' outside a lock in a "
                                "thread-spawning module",
                            )
                elif isinstance(node, ast.Call):
                    f = node.func
                    if (isinstance(f, ast.Attribute)
                            and f.attr in _MUTATORS
                            and isinstance(f.value, ast.Name)
                            and f.value.id in containers
                            and not _under_lock(ctx, node)):
                        yield ctx.finding(
                            self.name, node,
                            f"mutation '{f.value.id}.{f.attr}()' of a "
                            "module container outside a lock in a "
                            "thread-spawning module",
                        )

    # ---- lock-owning class discipline ----------------------------------
    def _check_locked_classes(self, ctx):
        for cls in ast.walk(ctx.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            lock_attrs = self._lock_attrs(cls)
            if not lock_attrs:
                continue
            shared = self._container_attrs(cls)
            for method in cls.body:
                if not isinstance(
                    method, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                exempt = (
                    method.name.endswith("_locked")
                    or method.name in ("__init__", "__post_init__")
                )
                for node in ast.walk(method):
                    if isinstance(node, ast.Call):
                        f = node.func
                        # calling a *_locked helper asserts the caller
                        # holds the lock — verify it lexically does
                        if (isinstance(f, ast.Attribute)
                                and f.attr.endswith("_locked")
                                and isinstance(f.value, ast.Name)
                                and f.value.id == "self"
                                and not method.name.endswith("_locked")
                                and not _under_lock(ctx, node)):
                            yield ctx.finding(
                                self.name, node,
                                f"call to self.{f.attr}() outside a "
                                "with-lock block — *_locked methods "
                                "assert the caller holds the lock",
                            )
                            continue
                        if exempt:
                            continue
                        if (isinstance(f, ast.Attribute)
                                and f.attr in _MUTATORS
                                and self._is_self_attr(f.value, shared)
                                and not _under_lock(ctx, node)):
                            yield ctx.finding(
                                self.name, node,
                                f"mutation 'self.{f.value.attr}."
                                f"{f.attr}()' outside 'with self."
                                f"{sorted(lock_attrs)[0]}' in a "
                                "lock-owning class",
                            )
                    elif isinstance(node, (ast.Assign, ast.AugAssign)) \
                            and not exempt:
                        targets = (
                            node.targets if isinstance(node, ast.Assign)
                            else [node.target]
                        )
                        for t in targets:
                            if (isinstance(t, ast.Subscript)
                                    and self._is_self_attr(t.value, shared)
                                    and not _under_lock(ctx, node)):
                                yield ctx.finding(
                                    self.name, node,
                                    f"item assignment on 'self."
                                    f"{t.value.attr}' outside 'with "
                                    f"self.{sorted(lock_attrs)[0]}' in "
                                    "a lock-owning class",
                                )

    @staticmethod
    def _is_self_attr(node, shared) -> bool:
        return (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr in shared)

    @staticmethod
    def _lock_attrs(cls) -> set:
        """Attributes holding a lock: assigned ``threading.Lock()`` /
        ``RLock()`` in __init__, or a dataclass field whose
        default_factory is a Lock."""
        out: set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                d = dotted_name(node.value.func)
                if d.endswith(("Lock", "RLock")):
                    for t in node.targets:
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            out.add(t.attr)
            if isinstance(node, ast.AnnAssign) and isinstance(
                node.value, ast.Call
            ):
                # dataclass: x: threading.Lock = field(default_factory=...)
                if terminal_name(node.value.func) == "field":
                    for kw in node.value.keywords:
                        if kw.arg == "default_factory" and dotted_name(
                            kw.value
                        ).endswith(("Lock", "RLock")):
                            if isinstance(node.target, ast.Name):
                                out.add(node.target.id)
        return out

    @staticmethod
    def _container_attrs(cls) -> set:
        """Instance attributes initialized as containers (assigned in
        __init__/__post_init__ or dataclass container fields)."""
        out: set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign):
                v = node.value
                is_container = isinstance(
                    v, (ast.Dict, ast.List, ast.Set)
                ) or (isinstance(v, ast.Call)
                      and terminal_name(v.func) in _CONTAINER_FACTORIES)
                if not is_container:
                    continue
                for t in node.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        out.add(t.attr)
            elif isinstance(node, ast.AnnAssign) and isinstance(
                node.value, ast.Call
            ):
                if terminal_name(node.value.func) == "field":
                    for kw in node.value.keywords:
                        if kw.arg == "default_factory" and terminal_name(
                            kw.value
                        ) in _CONTAINER_FACTORIES:
                            if isinstance(node.target, ast.Name):
                                out.add(node.target.id)
        return out
