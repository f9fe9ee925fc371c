"""Rule ``fault-registry``: fault-injection sites and
``faults.KNOWN_POINTS`` stay a closed, documented vocabulary.

The fault-spec grammar (``--fault-spec`` / ``ADAM_TPU_FAULTS``) can
only arm sites named in ``faults.KNOWN_POINTS`` — a typo'd site errors
at install time precisely because an unarmable clause would silently
test nothing (PR 4).  This rule closes the remaining gaps statically:

* every ``faults.point("...")`` call site in the package names a
  ``KNOWN_POINTS`` member (a site the spec grammar can't reach is dead
  injection plumbing);
* every ``KNOWN_POINTS`` member has at least one call site (a member
  with no site is a spec vocabulary entry that can never fire — the
  inverse silent-nothing);
* every member appears in docs/ROBUSTNESS.md's fault-point table (the
  docs ARE the spec author's reference — absorbed from
  scripts/check-telemetry-names' ``_fault_point_gaps``).

``KNOWN_POINTS`` is parsed statically from
``adam_tpu_torch/utils/faults.py`` (it is a frozenset literal), so the
rule runs on fixture trees and torch-less CI images alike.  The port's
vocabulary is the JAX package's, so the documentation it is held to is
the same table (copied from ``adam_tpu/staticcheck/rules/faultpoints.py``;
the doc is read as text, not imported)."""

from __future__ import annotations

import ast
import re

from adam_tpu_torch.staticcheck.core import Finding, Rule, register
from adam_tpu_torch.staticcheck.rules._astutil import dotted_name, terminal_name

FAULTS_MODULE = "adam_tpu_torch/utils/faults.py"
DOC_FILE = "docs/ROBUSTNESS.md"


def parse_known_points(tree) -> tuple[set, int]:
    """The KNOWN_POINTS frozenset literal -> (members, lineno)."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(isinstance(t, ast.Name) and t.id == "KNOWN_POINTS"
                   for t in node.targets):
            continue
        v = node.value
        if isinstance(v, ast.Call) and v.args:
            v = v.args[0]
        if isinstance(v, (ast.Set, ast.Tuple, ast.List)):
            return (
                {e.value for e in v.elts
                 if isinstance(e, ast.Constant)
                 and isinstance(e.value, str)},
                node.lineno,
            )
    return set(), 0


@register
class FaultRegistryRule(Rule):
    name = "fault-registry"
    summary = ("faults.point sites vs KNOWN_POINTS vs ROBUSTNESS.md: "
               "unknown sites, unreferenced members, undocumented "
               "members")
    contract = (
        "Every injection site names a faults.KNOWN_POINTS member, "
        "every member has >=1 site and a docs/ROBUSTNESS.md entry, so "
        "the chaos matrix's vocabulary can neither drift nor rot "
        "(docs/ROBUSTNESS.md fault-spec grammar)."
    )

    def __init__(self):
        self._sites: dict[str, list] = {}  # site -> [(path, line)]

    def visit(self, ctx):
        if not ctx.relpath.startswith("adam_tpu_torch/"):
            return
        if ctx.relpath == FAULTS_MODULE:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func)
            if not (d.endswith("faults.point")
                    or (terminal_name(node.func) == "point"
                        and d == "point")):
                continue
            if not node.args:
                continue
            a = node.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                self._sites.setdefault(a.value, []).append(
                    (ctx.relpath, node.lineno)
                )
            else:
                yield ctx.finding(
                    self.name, node,
                    "faults.point with a non-literal site name — the "
                    "registry cross-check (and grep) cannot see it",
                )
        return

    def finalize(self, project):
        tree = project.parse_module(FAULTS_MODULE)
        if tree is None:
            return  # fixture tree without a faults module: nothing to check
        known, known_line = parse_known_points(tree)
        for site, locs in sorted(self._sites.items()):
            if site not in known:
                path, line = locs[0]
                yield Finding(
                    self.name, path, line, 0,
                    f"fault point '{site}' is not in faults."
                    "KNOWN_POINTS — no --fault-spec clause can ever "
                    "arm it",
                    "",
                )
        for member in sorted(known - set(self._sites)):
            yield Finding(
                self.name, FAULTS_MODULE, known_line, 0,
                f"KNOWN_POINTS member '{member}' has no faults.point "
                "call site — a spec naming it arms a clause that can "
                "never fire",
                "",
            )
        doc = project.read_doc(DOC_FILE)
        if doc is not None:
            for member in sorted(known):
                if not re.search(
                    rf"(?<![a-z0-9_.]){re.escape(member)}(?![a-z0-9_.])",
                    doc,
                ):
                    yield Finding(
                        self.name, FAULTS_MODULE, known_line, 0,
                        f"KNOWN_POINTS member '{member}' missing from "
                        f"{DOC_FILE}'s fault-point table — spec "
                        "authors can't discover it",
                        "",
                    )
