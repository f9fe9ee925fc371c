"""Checker engine: rule registry, suppressions, baseline, runner (copied
from ``adam_tpu/staticcheck/core.py``; the scan surface is the port's
package and the baseline lives in it).

The engine is deliberately dependency-free (stdlib ``ast`` only) so
``python -m adam_tpu_torch check`` runs in CI images without torch or
numpy and costs one parse per file.  Rules are plugins: anything exposing
the :class:`Rule` interface can be registered — the built-ins live in
``adam_tpu_torch/staticcheck/rules/`` and third-party rules load via
``--plugin dotted.module`` (the module either calls
:func:`register` at import or exposes a module-level ``RULES``
iterable).

Three layers decide what a finding means:

* **suppressions** — ``# adam-tpu: noqa[rule-a,rule-b] reason=...`` on
  the flagged line (or a comment-only line directly above it) silences
  a finding *in place*; the reason is mandatory, because a suppression
  without one is exactly the undocumented drift the checker exists to
  kill (a reason-less directive is itself reported, rule
  ``suppression``).
* **baseline** — a committed JSON file (default
  ``adam_tpu_torch/staticcheck/baseline.json``) of triaged pre-existing findings,
  each with a justification.  Baselined findings don't fail the run;
  entries with an empty reason or entries whose finding no longer
  exists (stale) do, so the baseline can only shrink or stay honest.
* **new findings** — anything else fails the run (exit 1).

Exit codes are deterministic so CI can gate: 0 clean, 1 findings (new,
unjustified-baseline or reason-less suppression), 2 usage/internal
error.  ``--json`` emits schema ``adam_tpu.staticcheck/1``.
"""

from __future__ import annotations

import ast
import hashlib
import importlib
import json
import os
import re
from dataclasses import dataclass, field

SCHEMA = "adam_tpu.staticcheck/1"
BASELINE_SCHEMA = "adam_tpu.staticcheck_baseline/1"
#: Relative to the checked root (the JAX package's baseline is the
#: root's ``.staticcheck-baseline.json``; the port keeps its own).
DEFAULT_BASELINE = "adam_tpu_torch/staticcheck/baseline.json"

EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_ERROR = 2

#: Scan surface: the port's package (the tests, tools and scripts of the
#: repo are the JAX checker's).
SCAN_ROOTS = ("adam_tpu_torch",)

_SUPPRESS_RE = re.compile(
    r"#\s*adam-tpu:\s*noqa\[([A-Za-z0-9_*,\- ]+)\]"
    r"(?:\s+reason=(.*?))?\s*$"
)


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str  # repo-relative, posix separators
    line: int
    col: int
    message: str
    snippet: str = ""  # stripped source line — the fingerprint anchor

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"


class Rule:
    """Plugin interface.  Subclasses set ``name`` (the suppression /
    ``--rules`` token), ``summary`` (one line for ``--list-rules``)
    and ``contract`` (the convention being enforced, rendered in
    docs/STATIC_ANALYSIS.md terms), then implement :meth:`visit` for
    per-file checks and optionally :meth:`finalize` for cross-file
    checks run after every file has been visited."""

    name: str = ""
    summary: str = ""
    contract: str = ""

    def visit(self, ctx: "FileContext"):
        return ()

    def finalize(self, project: "Project"):
        return ()


class FileContext:
    """One parsed source file handed to every rule's :meth:`Rule.visit`
    — parse once, share the tree and the parent map."""

    def __init__(self, root: str, path: str):
        self.root = root
        self.path = path
        self.relpath = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as fh:
            self.source = fh.read()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=self.relpath)
        self._parents: dict | None = None

    # parent links let rules walk from a call site out to an enclosing
    # ``with`` / ``def`` without a full custom visitor per rule
    @property
    def parents(self) -> dict:
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    def ancestors(self, node):
        p = self.parents.get(node)
        while p is not None:
            yield p
            p = self.parents.get(p)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, node, message: str) -> Finding:
        line = getattr(node, "lineno", 0)
        col = getattr(node, "col_offset", 0)
        return Finding(rule, self.relpath, line, col, message,
                       self.line_text(line))


class Project:
    """Cross-file state shared with :meth:`Rule.finalize`."""

    def __init__(self, root: str):
        self.root = root
        self.files: list[str] = []  # relpaths visited

    def read_doc(self, relpath: str) -> str | None:
        """A docs file's text, or None when absent (fixture trees) —
        doc-side contract checks degrade to skipped, like the
        scripts/check-telemetry-names behavior they absorbed."""
        try:
            with open(os.path.join(self.root, relpath),
                      encoding="utf-8") as fh:
                return fh.read()
        except OSError:
            return None

    def parse_module(self, relpath: str):
        """Parse one in-repo module to an AST (None when absent)."""
        try:
            with open(os.path.join(self.root, relpath),
                      encoding="utf-8") as fh:
                return ast.parse(fh.read(), filename=relpath)
        except (OSError, SyntaxError):
            return None


# -------------------------------------------------------------------------
# Rule registry (the plugin API)
# -------------------------------------------------------------------------
_REGISTRY: dict[str, type] = {}


def register(rule_cls: type) -> type:
    """Register a Rule class (usable as a decorator).  Re-registering a
    name replaces the previous rule — that's how a plugin can override
    a built-in."""
    if not getattr(rule_cls, "name", ""):
        raise ValueError(f"rule {rule_cls!r} has no name")
    _REGISTRY[rule_cls.name] = rule_cls
    return rule_cls


def all_rules() -> dict[str, type]:
    _load_builtins()
    return dict(_REGISTRY)


_BUILTINS_LOADED = False


def _load_builtins() -> None:
    global _BUILTINS_LOADED
    if not _BUILTINS_LOADED:
        importlib.import_module("adam_tpu_torch.staticcheck.rules")
        _BUILTINS_LOADED = True


def load_plugins(specs) -> None:
    """Import plugin modules: each either registers rules at import
    time via :func:`register` or exposes ``RULES`` (iterable of Rule
    classes).  Also honors ``ADAM_TPU_CHECK_PLUGINS`` (colon-separated
    dotted module paths)."""
    for spec in specs:
        mod = importlib.import_module(spec)
        for rule_cls in getattr(mod, "RULES", ()):
            register(rule_cls)


# -------------------------------------------------------------------------
# Suppressions
# -------------------------------------------------------------------------
@dataclass
class Suppression:
    line: int
    rules: frozenset
    reason: str
    used: bool = False


def scan_suppressions(lines) -> list[Suppression]:
    out = []
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = frozenset(
            r.strip() for r in m.group(1).split(",") if r.strip()
        )
        reason = (m.group(2) or "").strip()
        out.append(Suppression(i, rules, reason))
    return out


def _suppression_for(finding: Finding, by_line: dict, lines) -> Suppression | None:
    """The directive covering ``finding``: same line, or a comment-only
    line directly above (for lines too long to carry the directive)."""
    for ln in (finding.line, finding.line - 1):
        sup = by_line.get(ln)
        if sup is None:
            continue
        if ln != finding.line:
            text = lines[ln - 1].lstrip() if 0 < ln <= len(lines) else ""
            if not text.startswith("#"):
                continue  # code line above — its directive is its own
        if finding.rule in sup.rules or "*" in sup.rules:
            return sup
    return None


# -------------------------------------------------------------------------
# Baseline
# -------------------------------------------------------------------------
def load_baseline(path: str) -> dict:
    """fingerprint -> entry dict.  A missing file is an empty baseline;
    a torn/invalid one is a hard error (exit 2) — CI must not pass on
    a baseline it couldn't read."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("schema") != BASELINE_SCHEMA:
        raise ValueError(
            f"{path}: unknown baseline schema {doc.get('schema')!r} "
            f"(expected {BASELINE_SCHEMA})"
        )
    return {e["fingerprint"]: e for e in doc.get("entries", [])}


def write_baseline(path: str, entries: list) -> None:
    doc = {
        "schema": BASELINE_SCHEMA,
        "entries": sorted(
            entries, key=lambda e: (e["path"], e["rule"], e["line"])
        ),
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")


def fingerprint(finding: Finding, occurrence: int) -> str:
    """Stable identity for baseline matching: rule + file + the flagged
    line's text + the occurrence index among identical (rule, file,
    text) findings.  Line NUMBERS are deliberately excluded so edits
    elsewhere in the file don't churn the baseline; editing the flagged
    line itself retires the entry (it must be re-triaged)."""
    # finalize()-produced findings carry no source line; anchor those
    # on the message instead, or same-file same-rule findings would be
    # distinguished only by sort order (fixing one would silently
    # re-map its baseline entry onto a different finding)
    anchor = finding.snippet or finding.message
    basis = "|".join(
        (finding.rule, finding.path, anchor, str(occurrence))
    )
    return hashlib.sha256(basis.encode()).hexdigest()[:16]


# -------------------------------------------------------------------------
# Runner
# -------------------------------------------------------------------------
def iter_source_files(root: str):
    for sub in SCAN_ROOTS:
        top = os.path.join(root, sub)
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = sorted(
                d for d in dirnames
                if d not in {"__pycache__", ".git", "_build"}
            )
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


@dataclass
class Report:
    root: str
    rules: list
    entries: list = field(default_factory=list)  # dicts, see to_json
    files_scanned: int = 0
    parse_errors: list = field(default_factory=list)

    @property
    def new_findings(self) -> list:
        return [e for e in self.entries if e["status"] == "new"]

    @property
    def ok(self) -> bool:
        return not self.new_findings and not self.parse_errors

    @property
    def exit_code(self) -> int:
        return EXIT_CLEAN if self.ok else EXIT_FINDINGS

    def counts(self) -> dict:
        c = {"new": 0, "baselined": 0, "suppressed": 0}
        for e in self.entries:
            c[e["status"]] = c.get(e["status"], 0) + 1
        c["files"] = self.files_scanned
        return c

    def to_json(self) -> dict:
        return {
            "schema": SCHEMA,
            "root": self.root,
            "rules": list(self.rules),
            "counts": self.counts(),
            "findings": list(self.entries),
            "parse_errors": list(self.parse_errors),
            "ok": self.ok,
        }

    def render(self) -> str:
        out = []
        order = {"new": 0, "baselined": 1, "suppressed": 2}
        for e in sorted(
            self.entries,
            key=lambda e: (order[e["status"]], e["path"], e["line"]),
        ):
            if e["status"] == "suppressed":
                continue  # silenced in place; only the count prints
            tag = "" if e["status"] == "new" else " [baselined]"
            out.append(
                f"{e['path']}:{e['line']}:{e['col']}: "
                f"[{e['rule']}]{tag} {e['message']}"
            )
            if e.get("snippet"):
                out.append(f"    {e['snippet']}")
        for err in self.parse_errors:
            out.append(f"PARSE ERROR: {err}")
        c = self.counts()
        out.append(
            f"adam-tpu check: {c['new']} finding(s), "
            f"{c['baselined']} baselined, {c['suppressed']} suppressed "
            f"({c['files']} files, rules: {', '.join(self.rules)})"
        )
        out.append("OK" if self.ok else "FAIL")
        return "\n".join(out)


def run_checks(
    root: str,
    rule_names=None,
    plugins=(),
    baseline_path: str | None = None,
    update_baseline: bool = False,
    files=None,
) -> Report:
    """Run the checker over ``root``.  ``rule_names`` restricts the
    rule set (None = all registered); ``files`` restricts the scanned
    files (absolute paths; None = the standard scan surface)."""
    _load_builtins()
    env_plugins = [
        p for p in os.environ.get("ADAM_TPU_CHECK_PLUGINS", "").split(":")
        if p
    ]
    load_plugins(list(plugins) + env_plugins)

    registry = dict(_REGISTRY)
    if rule_names is not None:
        unknown = sorted(set(rule_names) - set(registry))
        if unknown:
            raise ValueError(
                f"unknown rule(s): {', '.join(unknown)} "
                f"(known: {', '.join(sorted(registry))})"
            )
        registry = {n: registry[n] for n in rule_names}
    rules = [cls() for _, cls in sorted(registry.items())]

    root = os.path.abspath(root)
    project = Project(root)
    report = Report(root=root, rules=[r.name for r in rules])

    raw: list[Finding] = []
    suppressions: dict[str, tuple] = {}  # relpath -> (by_line, lines)
    paths = list(files) if files is not None else list(iter_source_files(root))
    for path in paths:
        try:
            ctx = FileContext(root, path)
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            report.parse_errors.append(f"{path}: {e}")
            continue
        report.files_scanned += 1
        project.files.append(ctx.relpath)
        sups = scan_suppressions(ctx.lines)
        suppressions[ctx.relpath] = ({s.line: s for s in sups}, ctx.lines)
        for rule in rules:
            raw.extend(rule.visit(ctx) or ())
    for rule in rules:
        raw.extend(rule.finalize(project) or ())

    # reason-less suppressions are findings in their own right
    for relpath, (by_line, _lines) in sorted(suppressions.items()):
        for sup in by_line.values():
            if not sup.reason:
                raw.append(Finding(
                    "suppression", relpath, sup.line, 0,
                    "suppression without a reason= justification "
                    "(# adam-tpu: noqa[rule] reason=...)",
                    _lines[sup.line - 1].strip()
                    if 0 < sup.line <= len(_lines) else "",
                ))

    baseline_file = (
        baseline_path
        if baseline_path is not None
        else os.path.join(root, DEFAULT_BASELINE)
    )
    baseline = load_baseline(baseline_file) if baseline_file else {}

    occ: dict[tuple, int] = {}
    matched_fps = set()
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.col, f.rule)):
        key = (f.rule, f.path, f.snippet)
        k = occ.get(key, 0)
        occ[key] = k + 1
        fp = fingerprint(f, k)
        by_line, lines = suppressions.get(f.path, ({}, []))
        sup = _suppression_for(f, by_line, lines)
        if sup is not None and sup.reason and f.rule != "suppression":
            sup.used = True
            # a suppressed finding still EXISTS: its baseline entry (if
            # any) is matched, not stale
            if fp in baseline:
                matched_fps.add(fp)
            status, reason = "suppressed", sup.reason
        elif fp in baseline:
            matched_fps.add(fp)
            reason = baseline[fp].get("reason", "")
            status = "baselined" if reason else "new"
            if not reason:
                f = Finding(
                    f.rule, f.path, f.line, f.col,
                    f.message + " [baselined without justification — "
                    "add a reason to the baseline entry]", f.snippet,
                )
        else:
            status, reason = "new", ""
        report.entries.append({
            "rule": f.rule, "path": f.path, "line": f.line, "col": f.col,
            "message": f.message, "snippet": f.snippet,
            "fingerprint": fp, "status": status, "reason": reason,
        })

    # unused suppressions: a directive whose finding no longer fires is
    # the noqa twin of a stale baseline entry — report it so exemption
    # debt shrinks too.  Only judged when every rule it names ran (a
    # --rules subset must not condemn directives for the other rules).
    active = {r.name for r in rules}
    for relpath, (by_line, _lines) in sorted(suppressions.items()):
        for sup in by_line.values():
            if (sup.reason and not sup.used and "*" not in sup.rules
                    and sup.rules <= active):
                report.entries.append({
                    "rule": "suppression", "path": relpath,
                    "line": sup.line, "col": 0,
                    "message": (
                        "unused suppression — no finding of "
                        f"[{', '.join(sorted(sup.rules))}] fires here; "
                        "remove the directive"
                    ),
                    "snippet": _lines[sup.line - 1].strip()
                    if 0 < sup.line <= len(_lines) else "",
                    "fingerprint": "", "status": "new", "reason": "",
                })

    # stale baseline entries: the finding they excuse no longer exists
    # — fail so the baseline shrinks with the debt it records.  Only
    # entries belonging to an ACTIVE rule can be judged stale (a
    # --rules subset run must not condemn the other rules' entries).
    for fp, entry in sorted(baseline.items()):
        if entry.get("rule") not in active:
            continue
        if fp not in matched_fps:
            report.entries.append({
                "rule": "baseline", "path": entry.get("path", "?"),
                "line": int(entry.get("line", 0)), "col": 0,
                "message": (
                    f"stale baseline entry {fp} "
                    f"[{entry.get('rule', '?')}]: finding no longer "
                    "exists — remove it from the baseline"
                ),
                "snippet": entry.get("snippet", ""),
                "fingerprint": fp, "status": "new", "reason": "",
            })

    if update_baseline and baseline_file:
        # entries of rules not in this run carry over untouched (a
        # --rules subset update must not drop the others' triage)
        entries = [
            e for e in baseline.values()
            if e.get("rule") not in active
        ]
        for e in report.entries:
            # meta findings (stale-baseline, suppression hygiene) are
            # fixed in place, never baselined — and suppressed findings
            # already carry their justification at the site
            if (e["rule"] in ("baseline", "suppression")
                    or not e["fingerprint"]
                    or e["status"] == "suppressed"):
                continue
            old = baseline.get(e["fingerprint"], {})
            entries.append({
                "fingerprint": e["fingerprint"], "rule": e["rule"],
                "path": e["path"], "line": e["line"],
                "snippet": e["snippet"],
                "reason": old.get("reason", e.get("reason", "")),
            })
        write_baseline(baseline_file, entries)

    return report
