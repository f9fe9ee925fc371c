"""Rule ``durability``: durability-bearing paths publish only through
``utils/durability`` helpers (copied from
``adam_tpu/staticcheck/rules/durability.py``, over the port's paths).

PR 6's crash matrix (docs/ROBUSTNESS.md "Durable window-granular
resume") holds because every artifact a resume trusts — Parquet parts,
checkpoint manifests, the run journal, barrier sidecars — publishes
via ``fsync(tmp) -> os.replace -> fsync(dir)`` in ``utils/durability``.
A raw ``os.replace`` elsewhere in these files is crash-consistent but
NOT power-loss durable; a raw ``json.dump`` / write-mode ``open`` to a
final name is neither.  This rule bans the primitives in the
durability-bearing modules:

* ``os.replace`` / ``os.rename`` — use ``durability.publish_file``;
* ``json.dump(obj, fh)`` — use ``durability.atomic_write_json``;
* write-mode ``open(path, "w"/"wb"/"a"/"x")`` whose target is not
  visibly a staging name (containing ``tmp``/``temp``/``staging`` in
  an identifier or literal) — staging writes are the protocol's first
  step and stay legal, the *publish* is what must be durable;
* ``np.save``/``np.savez*`` straight to a path literal (sidecars
  serialize to bytes and go through ``atomic_write_bytes``)."""

from __future__ import annotations

import ast

from adam_tpu_torch.staticcheck.core import Rule, register
from adam_tpu_torch.staticcheck.rules._astutil import dotted_name

#: Files whose writes a resume/restart later trusts.
SCOPE_FILES = frozenset({
    "adam_tpu_torch/pipelines/checkpoint.py",
    "adam_tpu_torch/io/parquet.py",
    # the zero-copy column assembly feeds the part writer's encode
    # stage: it must never open/publish files of its own — any write
    # it grew would bypass the staging + durable-publish protocol the
    # sharded writer pool guarantees per part
    "adam_tpu_torch/io/arrow_pack.py",
    "adam_tpu_torch/pipelines/streamed.py",
    # the multi-job scheduler's JOB.json records gate crash recovery:
    # they must publish through utils/durability like every other
    # resume-bearing artifact
    "adam_tpu_torch/serve/scheduler.py",
    # the cross-job coalescer and quota manager sit ON the output path
    # (fused pass-C dispatches feed the part writers) but own no
    # durable artifacts of their own — any file write they grew would
    # bypass the staging + durable-publish protocol
    "adam_tpu_torch/serve/batching.py",
    "adam_tpu_torch/serve/quota.py",
    # the gateway's discovery document (gateway.json) and the client's
    # verified part downloads are resume-bearing too: a fetched part
    # must publish exactly like a written one (staging name + durable
    # publish), or a crash mid-download could leave a torn final file
    "adam_tpu_torch/gateway/server.py",
    "adam_tpu_torch/gateway/client.py",
})

_STAGING_MARKERS = ("tmp", "temp", "staging")


def _mentions_staging(expr) -> bool:
    """The path expression visibly names a staging target: any
    identifier / attribute / string literal fragment containing a
    staging marker."""
    for node in ast.walk(expr):
        text = ""
        if isinstance(node, ast.Name):
            text = node.id
        elif isinstance(node, ast.Attribute):
            text = node.attr
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            text = node.value
        low = text.lower()
        if any(m in low for m in _STAGING_MARKERS):
            return True
    return False


def _is_pathlike(expr) -> bool:
    """A visibly path-like target: a string literal, an f-string, a
    ``+``/``%`` build, or an ``os.path.join``-style call.  A bare name
    is typically an in-memory buffer (the ``np.savez(buf, ...)`` ->
    ``atomic_write_bytes`` idiom) and stays legal."""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str)
    if isinstance(expr, (ast.JoinedStr, ast.BinOp)):
        return True
    if isinstance(expr, ast.Call):
        return dotted_name(expr.func).endswith("path.join")
    return False


def _open_mode(call) -> str | None:
    if len(call.args) >= 2:
        a = call.args[1]
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            return a.value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            return str(kw.value.value)
    return None


@register
class DurabilityRule(Rule):
    name = "durability"
    summary = ("raw open(w)/os.replace/json.dump in durability-bearing "
               "paths instead of utils/durability helpers")
    contract = (
        "Parts, manifests, journal and sidecars publish through "
        "utils/durability (fsync + atomic rename + dir fsync) so the "
        "resume contract survives power loss, not just crashes "
        "(docs/ROBUSTNESS.md 'Durable window-granular resume')."
    )

    def visit(self, ctx):
        if ctx.relpath not in SCOPE_FILES:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func)
            if d in ("os.replace", "os.rename"):
                yield ctx.finding(
                    self.name, node,
                    f"raw {d} publish — use durability.publish_file "
                    "(fsync data + atomic rename + fsync dir)",
                )
            elif d == "json.dump":
                yield ctx.finding(
                    self.name, node,
                    "raw json.dump — use durability.atomic_write_json "
                    "so the document publishes atomically and durably",
                )
            elif d in ("np.save", "numpy.save", "np.savez",
                       "numpy.savez", "np.savez_compressed",
                       "numpy.savez_compressed"):
                if node.args and _is_pathlike(node.args[0]) \
                        and not _mentions_staging(node.args[0]):
                    yield ctx.finding(
                        self.name, node,
                        f"{d} straight to a final path — serialize to "
                        "bytes and publish via durability."
                        "atomic_write_bytes",
                    )
            elif d == "open" or (isinstance(node.func, ast.Name)
                                 and node.func.id == "open"):
                mode = _open_mode(node)
                if mode and any(c in mode for c in "wax"):
                    if node.args and _mentions_staging(node.args[0]):
                        continue  # staging write: protocol step 1
                    yield ctx.finding(
                        self.name, node,
                        f"write-mode open(..., {mode!r}) to a non-"
                        "staging path — write a temp name and publish "
                        "via durability.publish_file / atomic_write_*",
                    )
