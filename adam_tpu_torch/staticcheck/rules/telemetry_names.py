"""Rule ``telemetry-contract``: telemetry names and heartbeat fields
are declared and documented (copied from
``adam_tpu/staticcheck/rules/telemetry_names.py``, over the port's
registry; the port's names and heartbeat fields are the JAX package's, so
the documentation it is held to is the same):

* every string-literal name at a tracer call site
  (``TRACE/tr/tracer .span/.count/.gauge/.observe/.add_span``) must be
  declared in the ``adam_tpu_torch/utils/telemetry.py`` registry — a renamed
  or ad-hoc metric can't silently fork the contract;
* every dotted registry name must appear in docs/OBSERVABILITY.md's
  name contract or, for a name of this package only, in its own
  ``adam_tpu_torch/OBSERVABILITY.md`` (whole-token match, so a prefix
  can't ride on a longer documented name);
* every ``telemetry.HEARTBEAT_FIELDS`` member must appear in
  docs/OBSERVABILITY.md's heartbeat schema.

The declared-name set comes from a static parse of the registry module:
the ``_span("...")``/``_metric("...")`` literal registrations, the names
registered in a loop over ``instrumentation`` constants (resolved from a
static parse of ``utils/instrumentation.py``) and the
``HEARTBEAT_FIELDS`` tuple.  Nothing is imported, so the rule needs no
torch.  The fault-point docs check belongs to the ``fault-registry``
rule."""

from __future__ import annotations

import ast
import re

from adam_tpu_torch.staticcheck.core import Finding, Rule, register
from adam_tpu_torch.staticcheck.rules._astutil import terminal_name

REGISTRY_MODULE = "adam_tpu_torch/utils/telemetry.py"
#: Where the display names registered in a loop are defined.
INSTRUMENTATION_MODULE = "adam_tpu_torch/utils/instrumentation.py"
DOC_FILE = "docs/OBSERVABILITY.md"
#: Where names of this package only may be documented instead.
PORT_DOC_FILE = "adam_tpu_torch/OBSERVABILITY.md"

#: Prometheus mangling contract (gateway/metrics.py mirrors
#: utils/telemetry.prometheus_name/prometheus_name_valid; kept as
#: literals here so the rule lints without importing them — tests pin
#: the two in sync).
PROMETHEUS_PREFIX = "adam_tpu_"
_PROM_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")

_TRACER_RECEIVERS = frozenset({"TRACE", "tr", "tracer"})
_TRACER_METHODS = frozenset({"span", "count", "gauge", "observe",
                             "add_span"})


def _string_constants(tree) -> dict:
    """Module-level ``NAME = "literal"`` bindings."""
    out = {}
    for node in tree.body if tree is not None else ():
        if isinstance(node, ast.Assign) and isinstance(
            node.value, ast.Constant
        ) and isinstance(node.value.value, str):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node.value.value
    return out


def parse_registry(tree, constants=None) -> tuple[set, tuple]:
    """Static view of the registry: literal ``_span``/``_metric``
    registrations, registrations in a ``for`` loop over a tuple of
    literals or of ``constants`` (``instrumentation`` names, by attribute
    name), and the HEARTBEAT_FIELDS literal tuple."""
    constants = constants or {}
    declared: set[str] = set()
    heartbeat: tuple = ()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and terminal_name(node.func) in (
            "_span", "_metric"
        ):
            if node.args and isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                declared.add(node.args[0].value)
        elif isinstance(node, ast.For) and isinstance(
            node.target, ast.Name
        ) and isinstance(node.iter, (ast.Tuple, ast.List)):
            registers = any(
                isinstance(c, ast.Call)
                and terminal_name(c.func) in ("_span", "_metric")
                and c.args and isinstance(c.args[0], ast.Name)
                and c.args[0].id == node.target.id
                for c in ast.walk(node)
            )
            if not registers:
                continue
            for e in node.iter.elts:
                if isinstance(e, ast.Constant) and isinstance(e.value, str):
                    declared.add(e.value)
                elif terminal_name(e) in constants:
                    declared.add(constants[terminal_name(e)])
        elif isinstance(node, ast.Assign):
            if any(isinstance(t, ast.Name) and t.id == "HEARTBEAT_FIELDS"
                   for t in node.targets):
                v = node.value
                if isinstance(v, (ast.Tuple, ast.List)):
                    heartbeat = tuple(
                        e.value for e in v.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)
                    )
    return declared, heartbeat


def _whole_token(name: str, doc: str, charset: str = "a-z0-9_.") -> bool:
    return bool(re.search(
        rf"(?<![{charset}]){re.escape(name)}(?![{charset}])", doc
    ))


@register
class TelemetryContractRule(Rule):
    name = "telemetry-contract"
    summary = ("undeclared telemetry names at tracer call sites; "
               "registry names / heartbeat fields missing from "
               "OBSERVABILITY.md")
    contract = (
        "Span/counter/gauge/histogram names used at call sites are "
        "declared in utils/telemetry.py and documented in docs/"
        "OBSERVABILITY.md, as are the heartbeat NDJSON fields — the "
        "stable consumer contract (docs/OBSERVABILITY.md)."
    )

    def __init__(self, declared=None, heartbeat_fields=None):
        # injectable for fixture tests; resolved lazily otherwise
        self._declared = set(declared) if declared is not None else None
        self._heartbeat = (tuple(heartbeat_fields)
                           if heartbeat_fields is not None else None)
        self._sites: list = []  # (name, relpath, line, col, snippet)

    def visit(self, ctx):
        if ctx.relpath == REGISTRY_MODULE:
            return ()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (isinstance(f, ast.Attribute)
                    and f.attr in _TRACER_METHODS):
                continue
            recv = terminal_name(f.value)
            if recv not in _TRACER_RECEIVERS:
                continue
            if node.args and isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                self._sites.append((
                    node.args[0].value, ctx.relpath, node.lineno,
                    node.col_offset, ctx.line_text(node.lineno),
                ))
        return ()

    def _resolve_registry(self, project) -> tuple[set, tuple]:
        if self._declared is not None:
            return self._declared, self._heartbeat or ()
        tree = project.parse_module(REGISTRY_MODULE)
        if tree is None:
            return set(), ()
        return parse_registry(tree, _string_constants(
            project.parse_module(INSTRUMENTATION_MODULE)
        ))

    def finalize(self, project):
        declared, heartbeat = self._resolve_registry(project)
        if not declared:
            return  # no registry in this tree: nothing to lint against
        for name, path, line, col, snippet in self._sites:
            if name not in declared:
                yield Finding(
                    self.name, path, line, col,
                    f"undeclared telemetry name {name!r} — declare it "
                    "in adam_tpu_torch/utils/telemetry.py (and docs/"
                    "OBSERVABILITY.md) or use a declared one",
                    snippet,
                )
        doc = project.read_doc(DOC_FILE)
        if doc is None:
            return
        names_doc = doc + "\n" + (project.read_doc(PORT_DOC_FILE) or "")
        for name in sorted(declared):
            if re.fullmatch(r"[a-z0-9_.]+", name) and "." in name and \
                    not _whole_token(name, names_doc):
                yield Finding(
                    self.name, REGISTRY_MODULE, 1, 0,
                    f"registry name '{name}' missing from {DOC_FILE}'s "
                    f"name contract (or {PORT_DOC_FILE}'s)",
                    "",
                )
        for fld in heartbeat:
            if not _whole_token(fld, doc, charset="a-zA-Z0-9_"):
                yield Finding(
                    self.name, REGISTRY_MODULE, 1, 0,
                    f"heartbeat field '{fld}' missing from {DOC_FILE}'s "
                    "heartbeat schema",
                    "",
                )
        # Prometheus exposition contract (gateway GET /metrics): every
        # dotted contract name must mangle ('.' -> '_' under the
        # adam_tpu_ prefix) to a VALID metric name, and no two distinct
        # names may collide once mangled — a collision would silently
        # merge two series in every scraper.  Display-style
        # instrumentation timer names (spaces/parens) sit outside the
        # dotted contract; the renderer sanitizes them instead.
        mangled: dict = {}
        for name in sorted(declared):
            if not (re.fullmatch(r"[a-z0-9_.]+", name) and "." in name):
                continue
            prom = PROMETHEUS_PREFIX + name.replace(".", "_")
            if not _PROM_NAME_RE.fullmatch(prom):
                yield Finding(
                    self.name, REGISTRY_MODULE, 1, 0,
                    f"registry name '{name}' mangles to '{prom}', not a "
                    "valid Prometheus metric name",
                    "",
                )
            prior = mangled.get(prom)
            if prior is not None:
                yield Finding(
                    self.name, REGISTRY_MODULE, 1, 0,
                    f"registry names '{prior}' and '{name}' collide as "
                    f"Prometheus metric '{prom}' — every scraper would "
                    "merge their series",
                    "",
                )
            else:
                mangled[prom] = name
