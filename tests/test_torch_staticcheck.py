"""The port's static contract checker (``adam_tpu_torch/staticcheck``).

Four layers: the engine's mechanics (suppressions, baseline round trip,
exit codes, JSON schema, plugins), held equal to the JAX package's engine
on the same fixture trees with the package paths renamed; each rule
catching its seeded violation and staying quiet on the compliant twin, in
torch's idiom where the rule is about the device (``host-sync``,
``dispatch-ledger`` with its kernel containment, ``residency``); the
clean-tree gate (the port reports zero new findings and every exemption
carries a reason); and the ``check`` verb's JSON and exit codes.

Fixture sources spell the suppression directive ``@NOQA@``: both
checkers read directives line by line, and this file is in the JAX
checker's scan."""

import json
import os
import textwrap

import pytest

from adam_tpu_torch.staticcheck import core

PKG = "adam_tpu_torch"


def _write(root, relpath, src):
    path = os.path.join(str(root), relpath)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    src = textwrap.dedent(src).replace("@NOQA@", "adam-tpu: noqa")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(src)
    return path


#: durability's scope is an explicit file list — fixtures must land on it
DURABLE_FILE = f"{PKG}/pipelines/checkpoint.py"


def _run(root, rules, baseline=None, update=False, engine=core):
    return engine.run_checks(
        str(root), rule_names=rules,
        baseline_path=baseline or os.path.join(str(root), "bl.json"),
        update_baseline=update,
    )


def _new(report, rule=None):
    return [e for e in report.new_findings
            if rule is None or e["rule"] == rule]


# -------------------------------------------------------------------------
# engine
# -------------------------------------------------------------------------
def test_suppression_requires_reason(tmp_path):
    _write(tmp_path, DURABLE_FILE, """\
        import os
        def f(path):
            os.replace(path, path + ".pub")  # @NOQA@[durability]
    """)
    rep = _run(tmp_path, ["durability"])
    assert sorted(e["rule"] for e in rep.new_findings) == [
        "durability", "suppression"]
    assert not rep.ok


@pytest.mark.parametrize("placement", ["same line", "line above"])
def test_suppression_with_reason_silences(tmp_path, placement):
    if placement == "same line":
        body = 'os.replace(path, path + ".pub")  # @NOQA@[durability] reason=unit fixture'
    else:
        body = ('# @NOQA@[durability] reason=publish is fsynced by the caller\n'
                '    os.replace(path, path + ".pub")')
    _write(tmp_path, DURABLE_FILE, f"import os\ndef f(path):\n    {body}\n")
    rep = _run(tmp_path, ["durability"])
    assert rep.ok and rep.counts()["suppressed"] == 1


def test_baseline_round_trip(tmp_path):
    _write(tmp_path, DURABLE_FILE, """\
        import os
        def f(path):
            os.replace(path, path + ".pub")
    """)
    bl = os.path.join(str(tmp_path), "bl.json")
    rep = _run(tmp_path, ["durability"], baseline=bl)
    assert len(_new(rep, "durability")) == 1
    # update writes the baseline; the entry still fails without a reason
    _run(tmp_path, ["durability"], baseline=bl, update=True)
    entries = core.load_baseline(bl)
    assert len(entries) == 1
    assert not _run(tmp_path, ["durability"], baseline=bl).ok
    (fp, e), = entries.items()
    e["reason"] = "triaged in the unit fixture"
    core.write_baseline(bl, [e])
    rep = _run(tmp_path, ["durability"], baseline=bl)
    assert rep.ok and rep.counts()["baselined"] == 1
    # fixed code -> the entry is stale and fails the run
    _write(tmp_path, DURABLE_FILE, "def f(path):\n    return path\n")
    rep = _run(tmp_path, ["durability"], baseline=bl)
    assert not rep.ok
    assert any(x["rule"] == "baseline" for x in rep.new_findings)


def test_baseline_subset_run_keeps_other_rules(tmp_path):
    bl = os.path.join(str(tmp_path), "bl.json")
    core.write_baseline(bl, [{
        "fingerprint": "0" * 16, "rule": "host-sync",
        "path": f"{PKG}/pipelines/y.py", "line": 1, "snippet": "x",
        "reason": "belongs to a rule not in this run",
    }])
    _write(tmp_path, f"{PKG}/pipelines/x.py", "VALUE = 1\n")
    assert _run(tmp_path, ["durability"], baseline=bl).ok
    _run(tmp_path, ["durability"], baseline=bl, update=True)
    assert "0" * 16 in core.load_baseline(bl)


def test_suppressing_a_baselined_finding_is_not_stale(tmp_path):
    _write(tmp_path, DURABLE_FILE, """\
        import os
        def f(path):
            os.replace(path, path + ".pub")
    """)
    bl = os.path.join(str(tmp_path), "bl.json")
    _run(tmp_path, ["durability"], baseline=bl, update=True)
    entries = list(core.load_baseline(bl).values())
    entries[0]["reason"] = "triaged"
    core.write_baseline(bl, entries)
    _write(tmp_path, DURABLE_FILE, """\
        import os
        def f(path):
            # @NOQA@[durability] reason=now suppressed in place
            os.replace(path, path + ".pub")
    """)
    rep = _run(tmp_path, ["durability"], baseline=bl)
    assert not any(e["rule"] == "baseline" for e in rep.new_findings)
    assert rep.ok


def test_unused_suppression_reported(tmp_path):
    _write(tmp_path, DURABLE_FILE, """\
        import os
        def f(path):
            return path  # @NOQA@[durability] reason=nothing fires here anymore
    """)
    rep = _run(tmp_path, ["durability"])
    assert any(e["rule"] == "suppression" and "unused suppression" in e["message"]
               for e in rep.new_findings)
    # a subset run for another rule does not condemn it
    assert not any("unused suppression" in e["message"]
                   for e in _run(tmp_path, ["fault-registry"]).new_findings)
    # and --update-baseline does not absorb hygiene findings
    bl = os.path.join(str(tmp_path), "bl.json")
    _run(tmp_path, ["durability"], baseline=bl, update=True)
    assert core.load_baseline(bl) == {}


def test_json_schema_and_exit_codes(tmp_path):
    _write(tmp_path, f"{PKG}/pipelines/x.py", "VALUE = 1\n")
    rep = _run(tmp_path, ["durability"])
    doc = rep.to_json()
    assert doc["schema"] == "adam_tpu.staticcheck/1"
    assert set(doc) == {"schema", "root", "rules", "counts", "findings",
                        "parse_errors", "ok"}
    assert rep.exit_code == core.EXIT_CLEAN
    _write(tmp_path, DURABLE_FILE, "import os\ndef f(p):\n    os.replace(p, p)\n")
    assert _run(tmp_path, ["durability"]).exit_code == core.EXIT_FINDINGS
    with pytest.raises(ValueError):
        core.run_checks(str(tmp_path), rule_names=["no-such-rule"])


def test_default_baseline_lives_in_the_package(tmp_path):
    """Without ``baseline_path`` the engine reads the package's baseline
    under the checked root (the root's ``.staticcheck-baseline.json`` is
    the JAX package's)."""
    _write(tmp_path, DURABLE_FILE, "import os\ndef f(p):\n    os.replace(p, p)\n")
    _write(tmp_path, ".staticcheck-baseline.json", "{not json")
    _write(tmp_path, f"{PKG}/staticcheck/__init__.py", "")
    rep = core.run_checks(str(tmp_path), rule_names=["durability"],
                          update_baseline=True)
    assert not rep.ok
    entries = core.load_baseline(str(tmp_path / core.DEFAULT_BASELINE))
    assert [e["rule"] for e in entries.values()] == ["durability"]
    assert core.DEFAULT_BASELINE == f"{PKG}/staticcheck/baseline.json"


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_plugin_rule_registration(tmp_path, monkeypatch, how):
    mod = _write(tmp_path, "myportplugin.py", f"""\
        from {PKG}.staticcheck.core import Rule

        class EveryFile(Rule):
            name = "every-file"
            summary = "fires once per file"
            def visit(self, ctx):
                yield ctx.finding(self.name, ctx.tree, "seen")

        RULES = [EveryFile]
    """)
    monkeypatch.syspath_prepend(os.path.dirname(mod))
    # plugin registration is process-global by design: keep it from
    # leaking into the other tests' full-registry runs
    core._load_builtins()
    monkeypatch.setattr(core, "_REGISTRY", dict(core._REGISTRY))
    _write(tmp_path, f"{PKG}/pipelines/x.py", "VALUE = 1\n")
    plugins = ["myportplugin"]
    if how == "environment":
        monkeypatch.setenv("ADAM_TPU_CHECK_PLUGINS", "myportplugin")
        plugins = []
    rep = core.run_checks(
        str(tmp_path), rule_names=["every-file"], plugins=plugins,
        baseline_path=os.path.join(str(tmp_path), "bl.json"),
    )
    assert len(_new(rep, "every-file")) == 1


# -------------------------------------------------------------------------
# the engine and the language-neutral rules, against the JAX package's
# -------------------------------------------------------------------------
FAULTS_SRC = """\
    KNOWN_POINTS = frozenset({
        "device.fetch",
        "ghost.point",
    })

    def point(site, device=None):
        pass
"""

#: (rules, {package-relative path: source}, docs) — each runs through
#: both engines, the JAX one with the sources under adam_tpu/
PARITY_CASES = {
    "durability": (["durability"], {
        "pipelines/checkpoint.py": """\
            import json
            import os

            def publish(doc, path):
                with open(path, "w") as fh:
                    json.dump(doc, fh)
                os.replace(path, path + ".final")
                with open(path + ".tmp", "wb") as fh:
                    fh.write(b"x")
                # @NOQA@[durability] reason=fixture
                os.rename(path, path + ".x")
                os.replace(path, path)  # @NOQA@[durability]
                return path  # @NOQA@[durability] reason=nothing here
        """,
        "serve/scheduler.py": "import numpy as np\n\ndef f(a):\n"
                              "    np.save('final.npy', a)\n",
    }, {}),
    "fault-registry": (["fault-registry"], {
        "utils/faults.py": FAULTS_SRC,
        "pipelines/x.py": """\
            from x.utils import faults

            def f(name):
                faults.point("device.fetch")
                faults.point("device.typo")
                faults.point(name)
        """,
    }, {"docs/ROBUSTNESS.md": "`device.fetch` only\n"}),
    "lock-discipline": (["lock-discipline"], {
        "utils/pool.py": """\
            import threading

            _SEEN = set()
            _LOCK = threading.Lock()
            ENABLED = False

            def spawn():
                threading.Thread(target=lambda: None).start()

            def bad(key):
                global ENABLED
                _SEEN.add(key)
                ENABLED = True

            def good(key):
                global ENABLED
                with _LOCK:
                    _SEEN.add(key)
                    ENABLED = True
        """,
        "utils/reg.py": """\
            import threading

            class Registry:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.items = {}

                def _get_locked(self, k):
                    return self.items.setdefault(k, 0)

                def bad_call(self, k):
                    return self._get_locked(k)

                def bad_mutate(self, k):
                    self.items[k] = 1

                def good(self, k):
                    with self._lock:
                        self.items[k] = self._get_locked(k) + 1
        """,
    }, {}),
    "baseline and suppressions": (["durability", "lock-discipline"], {
        "pipelines/checkpoint.py": """\
            import os

            def f(p):
                os.replace(p, p + ".a")
                os.replace(p, p + ".a")
                # @NOQA@[durability,lock-discipline] reason=both named
                os.replace(p, p + ".b")
        """,
    }, {}),
}


def _parity_tree(root, pkg, files, docs):
    for rel, src in files.items():
        _write(root, f"{pkg}/{rel}", src.replace("x.utils", f"{pkg}.utils"))
    for rel, text in docs.items():
        _write(root, rel, text)


@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_engine_and_neutral_rules_equal_jax(tmp_path, case):
    """The same fixture tree (package paths renamed) through both engines:
    the same (rule, line, col, status) entries, counts and JSON keys, and
    the same baseline after an update."""
    from adam_tpu.staticcheck import core as jax_core

    rules, files, docs = PARITY_CASES[case]
    reports = {}
    for pkg, engine in (("adam_tpu", jax_core), (PKG, core)):
        root = tmp_path / pkg
        _parity_tree(root, pkg, files, docs)
        bl = str(root / "bl.json")
        first = _run(root, rules, baseline=bl, engine=engine)
        _run(root, rules, baseline=bl, update=True, engine=engine)
        entries = sorted((e["rule"], e["line"], e["snippet"], e["reason"])
                         for e in engine.load_baseline(bl).values())
        reports[pkg] = (first, entries)

    def view(rep):
        return (sorted((e["rule"], e["path"].split("/", 1)[1], e["line"], e["col"],
                        e["status"]) for e in rep.entries),
                rep.counts(), sorted(rep.to_json()), rep.exit_code)

    (jrep, jbl), (trep, tbl) = reports["adam_tpu"], reports[PKG]
    assert view(trep) == view(jrep)
    assert tbl == jbl
    assert trep.entries, "the fixture seeds at least one finding"
    # the same fingerprint for the same finding, path and occurrence
    for e in trep.entries:
        f = core.Finding(e["rule"], e["path"], e["line"], e["col"], e["message"],
                         e["snippet"])
        jf = jax_core.Finding(*(getattr(f, k) for k in (
            "rule", "path", "line", "col", "message", "snippet")))
        assert core.fingerprint(f, 2) == jax_core.fingerprint(jf, 2)


# -------------------------------------------------------------------------
# host-sync (torch's idiom)
# -------------------------------------------------------------------------
HOT = f"{PKG}/pipelines/hot.py"

HOST_SYNC_CASES = {
    "cpu() of a kernel result": ("""\
        def run(x, observe_kernel):
            out = observe_kernel(x)
            return out.cpu().numpy()
    """, 1),
    "device_fetch launders": ("""\
        import numpy as np
        from adam_tpu_torch.utils.transfer import device_fetch

        def run(x, observe_kernel):
            out = device_fetch(observe_kernel(x))
            return np.asarray(out), int(out.sum()), out.tolist()
    """, 0),
    "taint through unpack and methods": ("""\
        import torch

        def run(x, pair_kernel):
            a, b = pair_kernel(x)
            c = a.to(torch.int32)[:4]
            return float(c.sum()), b.item()
    """, 2),
    "isinstance guard narrows": ("""\
        import numpy as np

        def run(x, my_kernel):
            out = my_kernel(x)
            if isinstance(out, np.ndarray):
                return np.asarray(out)
            return None
    """, 0),
    "else-branch taint survives the join": ("""\
        import numpy as np

        def run(x, cond, my_kernel):
            if cond:
                out = np.zeros(3)
            else:
                out = my_kernel(x)
            return np.asarray(out)
    """, 1),
    "comprehension taint": ("""\
        import numpy as np

        def run(xs, my_kernel):
            vals = [my_kernel(x) for x in xs]
            return np.asarray(vals[0])
    """, 1),
    "conditional def walked once": ("""\
        import numpy as np

        try:
            import fastpath
        except ImportError:
            def fallback(a, my_kernel):
                return np.asarray(my_kernel(a))
    """, 1),
    "synchronize and cpu() flagged whatever the value": ("""\
        import torch

        def run(x):
            torch.cuda.synchronize()
            return x.cpu()
    """, 2),
    "putter placer taints": ("""\
        from adam_tpu_torch.parallel.device_pool import putter

        def run(slot, a):
            put = putter(slot)
            t = put(a)
            return t.tolist()
    """, 1),
    "to(device) taints, to(dtype) does not": ("""\
        import torch

        def run(a, dev):
            x = torch.from_numpy(a)
            y = x.to(torch.int64)
            z = x.to(dev)
            return y.tolist(), z.tolist(), int(x.sum())
    """, 1),
    "a local function returning a placed tensor": ("""\
        import torch

        def run(a, dev):
            def put(n):
                return torch.from_numpy(n).to(dev)
            return int(put(a).sum())
    """, 1),
    "torch factories given device=": ("""\
        import torch

        def run(dev):
            t = torch.zeros(3, device=dev)
            u = torch.zeros(3, device="cpu")
            v = torch.searchsorted(t, t)
            return t.item(), u.item(), v.tolist()
    """, 2),
    "warm, probe and bench functions are exempt": ("""\
        import torch

        def warm_shapes(k):
            torch.cuda.synchronize()

        def probe_device(k, my_kernel):
            return float(my_kernel(k))

        def kernel_bench(k):
            return k.cpu()
    """, 0),
}


@pytest.mark.parametrize("case", list(HOST_SYNC_CASES))
def test_hostsync(tmp_path, case):
    src, want = HOST_SYNC_CASES[case]
    _write(tmp_path, HOT, src)
    assert len(_new(_run(tmp_path, ["host-sync"]), "host-sync")) == want


def test_hostsync_kernel_wrappers_taint_and_scope(tmp_path):
    """A function of ops/ that launches through kernels.launch returns
    tensors on the card; utils/ is out of the rule's scope."""
    _write(tmp_path, f"{PKG}/ops/myhist.py", """\
        from adam_tpu_torch.ops import kernels

        def my_hist(x):
            kernels.launch("observe_hist", x, device=x.device)
            return x
    """)
    _write(tmp_path, HOT, """\
        from adam_tpu_torch.ops.myhist import my_hist

        def run(x):
            return my_hist(x).numpy()
    """)
    _write(tmp_path, f"{PKG}/utils/helper.py",
           "import torch\n\ndef f(x):\n    torch.cuda.synchronize()\n    return x.cpu()\n")
    flagged = _new(_run(tmp_path, ["host-sync"]), "host-sync")
    assert [(f["path"], f["line"]) for f in flagged] == [(HOT, 4)]


# -------------------------------------------------------------------------
# dispatch-ledger (torch's idiom) and kernel containment
# -------------------------------------------------------------------------
DISPATCH_FILE = f"{PKG}/pipelines/streamed.py"  # in the rule's scope
PREWARM_FILE = f"{PKG}/parallel/device_pool.py"


def _outside(rep):
    return [f for f in _new(rep, "dispatch-ledger")
            if "outside compile_ledger" in f["message"]]


def _orphans(rep):
    return [f for f in _new(rep, "dispatch-ledger")
            if "no prewarm registry entry" in f["message"]]


def test_dispatch_untracked_flagged_tracked_ok(tmp_path):
    _write(tmp_path, DISPATCH_FILE, """\
        from adam_tpu_torch.utils import compile_ledger

        def bad(b, observe_kernel):
            return observe_kernel(b)

        def good(b, observe_kernel, dev):
            with compile_ledger.track(("k.observe", 8), dev):
                return observe_kernel(b)

        def good_bound(b, apply_body, slot):
            ledger = compile_ledger.track(("k.observe", 8), slot)
            with ledger:
                return apply_body(b)
    """)
    rep = _run(tmp_path, ["dispatch-ledger"])
    assert [f["line"] for f in _outside(rep)] == [4]


def test_dispatch_nested_def_retry_idiom_covered(tmp_path):
    _write(tmp_path, DISPATCH_FILE, """\
        from adam_tpu_torch.utils import compile_ledger
        from adam_tpu_torch.utils import retry as _retry

        def run(b, observe_kernel, dev):
            def dispatch():
                return observe_kernel(b)

            with compile_ledger.track(("k.observe", 8), dev):
                return _retry.retry_call(dispatch, site="x")
    """)
    assert not _outside(_run(tmp_path, ["dispatch-ledger"]))


def test_dispatch_tracked_dispatcher_idiom(tmp_path):
    """Work handed to a dispatch helper that tracks and calls it (the
    port's ``bqsr._dispatch``), as a nested def or a lambda, is covered;
    its key argument feeds the prewarm cross-check, also across modules."""
    _write(tmp_path, f"{PKG}/pipelines/bqsr.py", """\
        from adam_tpu_torch.utils import compile_ledger

        def _dispatch(site_key, rw, fn):
            def unit():
                return fn()
            ledger = compile_ledger.track(site_key, rw)
            with ledger:
                return unit()

        def observe_window(b, rw, mesh, observe_packed_body):
            def run():
                if mesh is None:
                    return observe_packed_body(b)
                return mesh.shard_map(lambda k, *a: observe_packed_body(*a), b)

            name = "k.mesh_observe" if mesh is not None else "k.observe"
            return _dispatch((name, 8), rw, run)
    """)
    _write(tmp_path, f"{PKG}/pipelines/markdup.py", """\
        from adam_tpu_torch.pipelines.bqsr import _dispatch

        def columns(b, rw, markdup_body):
            return _dispatch(("k.markdup", 8), rw, lambda: markdup_body(b))

        def stray(b, rw, markdup_body):
            return rw.run(lambda: markdup_body(b))
    """)
    _write(tmp_path, PREWARM_FILE, """\
        def observe_prewarm_entry(g):
            def warm(slot):
                pass
            return (("k.observe", g), warm)
    """)
    _write(tmp_path, f"{PKG}/parallel/partitioner.py", """\
        def mesh_observe_prewarm_entry(g):
            return _mesh_entry("k.mesh_observe", g)
    """)
    rep = _run(tmp_path, ["dispatch-ledger"])
    # the stray lambda goes to no tracked dispatcher (markdup.py is in
    # the rule's scope)
    assert [(f["path"], f["line"]) for f in _outside(rep)] == [
        (f"{PKG}/pipelines/markdup.py", 7)]
    assert [f["message"].split("'")[1] for f in _orphans(rep)] == ["k.markdup"]


def test_dispatch_prewarm_cross_check(tmp_path):
    _write(tmp_path, DISPATCH_FILE, """\
        from adam_tpu_torch.utils import compile_ledger

        def run(b, my_kernel, dev):
            with compile_ledger.track(("k.orphan", 8), dev):
                my_kernel(b)
            with compile_ledger.track(("k.covered", 8), dev):
                my_kernel(b)
    """)
    _write(tmp_path, PREWARM_FILE, """\
        def covered_prewarm_entry(g):
            def warm(dev):
                pass
            return (("k.covered", g), warm)
    """)
    orphans = _orphans(_run(tmp_path, ["dispatch-ledger"]))
    assert len(orphans) == 1 and "k.orphan" in orphans[0]["message"]


def test_dispatch_calls_inside_a_launched_unit_exempt(tmp_path):
    """A body's own kernel calls are the unit its caller launches (the
    counterpart of JAX's trace-time calls inside a jit), and warm
    thunks run under the prewarm's own track."""
    _write(tmp_path, DISPATCH_FILE, """\
        def outer_kernel(x):
            return inner_kernel(x) + observe_packed_body(x)

        def fused_bc_body(x):
            return outer_kernel(x)

        def warm(slot, x):
            fused_bc_body(x)
    """)
    assert not _outside(_run(tmp_path, ["dispatch-ledger"]))


def test_kernel_containment(tmp_path):
    """A hand kernel launches only through ops/kernels.launch: a
    ``library()`` call or a ``<kernel>_launch`` call anywhere else is a
    finding; ops/kernels.py itself, a method named ``_launch`` and
    ``kernels.launch`` are not."""
    _write(tmp_path, f"{PKG}/ops/kernels.py", """\
        def library(name):
            pass

        def launch(name, *args, device):
            lib = library(name)
            lib.observe_hist_launch(*args)
    """)
    _write(tmp_path, f"{PKG}/ops/rogue.py", """\
        from adam_tpu_torch.ops import kernels

        def fast(x):
            lib = kernels.library("observe_hist")
            lib.observe_hist_launch(x)
            kernels.launch("observe_hist", x, device=x.device)

        class Coalescer:
            def go(self, body):
                return self._launch(body)
    """)
    flagged = _new(_run(tmp_path, ["dispatch-ledger"]), "dispatch-ledger")
    assert [(f["path"], f["line"]) for f in flagged] == [
        (f"{PKG}/ops/rogue.py", 4), (f"{PKG}/ops/rogue.py", 5)]
    assert all("ops/kernels.launch" in f["message"] for f in flagged)


# -------------------------------------------------------------------------
# durability
# -------------------------------------------------------------------------
def test_durability_primitives_flagged(tmp_path):
    _write(tmp_path, DURABLE_FILE, """\
        import json
        import os

        def publish(doc, path):
            with open(path, "w") as fh:
                json.dump(doc, fh)
            os.replace(path, path + ".final")
    """)
    flagged = _new(_run(tmp_path, ["durability"]), "durability")
    msgs = "\n".join(f["message"] for f in flagged)
    assert "os.replace" in msgs and "json.dump" in msgs and "open" in msgs
    assert len(flagged) == 3


def test_durability_staging_and_reads_ok(tmp_path):
    _write(tmp_path, DURABLE_FILE, """\
        from adam_tpu_torch.utils.durability import atomic_write_json, publish_file

        def publish(doc, path):
            tmp = path + ".tmp"
            with open(tmp, "wb") as fh:
                fh.write(b"x")
            publish_file(tmp, path)
            atomic_write_json(path + ".json", doc)
            with open(path, "rb") as fh:
                return fh.read()
    """)
    assert _new(_run(tmp_path, ["durability"]), "durability") == []


# -------------------------------------------------------------------------
# fault-registry
# -------------------------------------------------------------------------
def test_fault_registry_unknown_site_and_unused_member(tmp_path):
    _write(tmp_path, f"{PKG}/utils/faults.py", FAULTS_SRC)
    _write(tmp_path, f"{PKG}/pipelines/x.py", """\
        from adam_tpu_torch.utils import faults

        def f():
            faults.point("device.fetch")
            faults.point("device.typo")
    """)
    msgs = [f["message"] for f in _new(_run(tmp_path, ["fault-registry"]))]
    assert any("device.typo" in m and "not in faults.KNOWN_POINTS" in m for m in msgs)
    assert any("ghost.point" in m and "no faults.point call site" in m for m in msgs)


def test_fault_registry_docs_gap(tmp_path):
    _write(tmp_path, f"{PKG}/utils/faults.py",
           'KNOWN_POINTS = frozenset({"device.fetch"})\n')
    _write(tmp_path, f"{PKG}/pipelines/x.py",
           "from adam_tpu_torch.utils import faults\n\ndef f():\n"
           "    faults.point(\"device.fetch\")\n")
    assert _run(tmp_path, ["fault-registry"]).ok  # no docs: skipped
    _write(tmp_path, "docs/ROBUSTNESS.md", "fault points: (none listed)\n")
    assert any("missing from docs/ROBUSTNESS.md" in f["message"]
               for f in _new(_run(tmp_path, ["fault-registry"])))


# -------------------------------------------------------------------------
# lock-discipline
# -------------------------------------------------------------------------
def test_lock_module_global_mutation(tmp_path):
    _parity_tree(tmp_path, PKG, {"utils/pool.py": PARITY_CASES["lock-discipline"][1]
                                 ["utils/pool.py"]}, {})
    flagged = _new(_run(tmp_path, ["lock-discipline"]))
    assert sorted(f["line"] for f in flagged) == [12, 13]


def test_lock_class_discipline_and_locked_convention(tmp_path):
    _parity_tree(tmp_path, PKG, {"utils/reg.py": PARITY_CASES["lock-discipline"][1]
                                 ["utils/reg.py"]}, {})
    msgs = [f["message"] for f in _new(_run(tmp_path, ["lock-discipline"]))]
    assert len(msgs) == 2
    assert any("_get_locked" in m for m in msgs)
    assert any("item assignment" in m for m in msgs)


def test_lock_quiet_without_threads_or_lock(tmp_path):
    _write(tmp_path, f"{PKG}/utils/simple.py",
           "CACHE = {}\n\ndef put(k, v):\n    CACHE[k] = v\n")
    assert _run(tmp_path, ["lock-discipline"]).ok


# -------------------------------------------------------------------------
# residency (torch's placers)
# -------------------------------------------------------------------------
RESIDENT_FILE = f"{PKG}/pipelines/bqsr.py"


def test_residency_placements_flagged_outside_ingest(tmp_path):
    _write(tmp_path, RESIDENT_FILE, """\
        import torch
        from adam_tpu_torch.parallel.device_pool import putter

        def observe(b, slot, dev):
            put = putter(slot)
            a = put(b.bases)
            q = torch.from_numpy(b.quals).to(dev)
            c = torch.as_tensor(b.bases, device=dev)
            d = b.bases.to(torch.int64)
            # @NOQA@[residency] reason=fixture fallback re-ships the host copy
            e = put(b.quals)
            return a, q, c, d, e

        def make_resident_window(b, slot):
            put = putter(slot)
            return put(b.bases), torch.from_numpy(b.quals).to(slot.device)
    """)
    rep = _run(tmp_path, ["residency"])
    assert sorted(f["line"] for f in _new(rep, "residency")) == [6, 7, 8]
    assert rep.counts()["suppressed"] == 1


def test_residency_out_of_scope_file_quiet(tmp_path):
    _write(tmp_path, f"{PKG}/pipelines/trim.py",
           "import torch\n\ndef f(b, dev):\n    return torch.from_numpy(b.quals).to(dev)\n")
    assert _run(tmp_path, ["residency"]).ok


# -------------------------------------------------------------------------
# telemetry-contract
# -------------------------------------------------------------------------
FIXTURE_TELE = """\
    _R = set()

    def _span(name):
        _R.add(name)
        return name

    def _metric(name):
        _R.add(name)
        return name

    SPAN_GOOD = _span("pipeline.good")
    HEARTBEAT_FIELDS = ("schema", "undocumented_field")
"""
TELE_FILE = f"{PKG}/utils/telemetry.py"


def test_telemetry_undeclared_name(tmp_path):
    _write(tmp_path, TELE_FILE, FIXTURE_TELE)
    _write(tmp_path, f"{PKG}/pipelines/x.py", """\
        def f(tr):
            with tr.span("pipeline.good"):
                tr.count("pipeline.rogue")
    """)
    flagged = _new(_run(tmp_path, ["telemetry-contract"]))
    assert len(flagged) == 1 and "pipeline.rogue" in flagged[0]["message"]


def test_telemetry_docs_gaps(tmp_path):
    _write(tmp_path, TELE_FILE, FIXTURE_TELE)
    _write(tmp_path, "docs/OBSERVABILITY.md", "names: `schema` only is documented here\n")
    msgs = [f["message"] for f in _new(_run(tmp_path, ["telemetry-contract"]))]
    assert any("pipeline.good" in m and "name contract" in m for m in msgs)
    assert any("undocumented_field" in m for m in msgs)


@pytest.mark.parametrize("port_doc,flagged", [
    ("the port's own span `pipeline.good`\n", False),
    ("the port's own span `pipeline.good_not`\n", True),
    (None, True),
])
def test_telemetry_port_doc_documents_names(tmp_path, port_doc, flagged):
    """A registry name documented in the package's own OBSERVABILITY.md
    (whole token) meets the name contract; the heartbeat schema stays
    the shared doc's."""
    from adam_tpu_torch.staticcheck.rules import telemetry_names as rule_mod

    _write(tmp_path, TELE_FILE, FIXTURE_TELE)
    _write(tmp_path, "docs/OBSERVABILITY.md", "`schema` `undocumented_field`\n")
    if port_doc is not None:
        _write(tmp_path, rule_mod.PORT_DOC_FILE, port_doc)
    msgs = [f["message"] for f in _new(_run(tmp_path, ["telemetry-contract"]))]
    assert any("pipeline.good" in m and "name contract" in m for m in msgs) == flagged, msgs
    assert len(msgs) == int(flagged)


def test_telemetry_loop_registered_names_resolve_statically(tmp_path):
    """Names registered in a loop over instrumentation constants are
    declared without importing anything (the rule needs no torch)."""
    _write(tmp_path, f"{PKG}/utils/instrumentation.py",
           'CODEC = "BGZF Codec (native)"\nWALK = "walk.rows"\n')
    _write(tmp_path, TELE_FILE, FIXTURE_TELE + """\
    from adam_tpu_torch.utils import instrumentation as _ins

    for _n in (_ins.CODEC, _ins.WALK, "literal.name"):
        _span(_n)
    """)
    _write(tmp_path, f"{PKG}/pipelines/x.py", """\
        def f(tracer):
            tracer.span("walk.rows")
            tracer.span("literal.name")
            tracer.span("BGZF Codec (native)")
            tracer.span("never.declared")
    """)
    flagged = _new(_run(tmp_path, ["telemetry-contract"]))
    assert [f["line"] for f in flagged] == [5]


@pytest.mark.parametrize("names,docs,want", [
    (("sched.batch.fill", "sched.batch_fill"),
     "`sched.batch.fill` `sched.batch_fill` `schema`\n", "collide"),
    (("reads.ingested", "BGZF Codec (native)"), "`reads.ingested` `schema`\n", None),
])
def test_telemetry_prometheus_mangling(tmp_path, names, docs, want):
    """Two dotted names that merge under '.' -> '_' collide; display
    names (spaces, parens) sit outside the dotted contract."""
    regs = "\n".join(f'C_{i} = _metric("{n}")' for i, n in enumerate(names))
    _write(tmp_path, TELE_FILE, "_R = set()\n\ndef _metric(name):\n    _R.add(name)\n"
           f"    return name\n\n{regs}\nHEARTBEAT_FIELDS = (\"schema\",)\n")
    _write(tmp_path, "docs/OBSERVABILITY.md", docs)
    msgs = [f["message"] for f in _new(_run(tmp_path, ["telemetry-contract"]))]
    if want is None:
        assert msgs == []
    else:
        assert any(want in m and "adam_tpu_sched_batch_fill" in m for m in msgs), msgs


def test_telemetry_rule_literals_pin_registry():
    from adam_tpu_torch.staticcheck.rules import telemetry_names as rule_mod
    from adam_tpu_torch.utils import telemetry as tele

    assert rule_mod.PROMETHEUS_PREFIX == tele.PROMETHEUS_PREFIX
    for probe, ok in (
        ("adam_tpu_reads_ingested", True),
        ("adam_tpu_x:y", True),
        ("9leading_digit", False),
        ("adam_tpu_bad name", False),
        ("adam_tpu_bad-name", False),
    ):
        assert bool(rule_mod._PROM_NAME_RE.fullmatch(probe)) == ok == \
            tele.prometheus_name_valid(probe), probe


def test_telemetry_static_registry_equals_the_imported_one():
    from adam_tpu_torch.staticcheck.rules import telemetry_names as rule_mod
    from adam_tpu_torch.utils import telemetry as tele

    declared, heartbeat = rule_mod.TelemetryContractRule()._resolve_registry(
        core.Project(_repo_root()))
    assert declared == set(tele.registered_names())
    assert heartbeat == tuple(tele.HEARTBEAT_FIELDS)


# -------------------------------------------------------------------------
# the clean-tree gate, a seeded violation per rule, the check verb
# -------------------------------------------------------------------------
def _repo_root():
    import adam_tpu_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(adam_tpu_torch.__file__)))


def test_port_tree_is_clean():
    """``check`` runs clean on the port: zero new findings, and every
    baselined or suppressed finding carries a reason."""
    rep = core.run_checks(_repo_root())
    assert rep.parse_errors == []
    assert rep.new_findings == [], "\n".join(
        f"{e['path']}:{e['line']}: [{e['rule']}] {e['message']}"
        for e in rep.new_findings)
    assert rep.counts()["files"] > 100
    assert set(rep.rules) == {"host-sync", "dispatch-ledger", "durability",
                              "fault-registry", "lock-discipline", "residency",
                              "telemetry-contract"}
    for e in rep.entries:
        if e["status"] in ("baselined", "suppressed"):
            assert e["reason"].strip(), f"unjustified exemption: {e}"
    with open(os.path.join(_repo_root(), core.DEFAULT_BASELINE)) as fh:
        doc = json.load(fh)
    assert doc["schema"] == core.BASELINE_SCHEMA
    assert all(e["reason"].strip() for e in doc["entries"])


#: rule -> {path: source}: one violation of the rule each
SEEDS = {
    "host-sync": {HOT: "def f(x):\n    return x.cpu()\n"},
    "dispatch-ledger": {DISPATCH_FILE: "def f(b, observe_kernel):\n"
                                       "    return observe_kernel(b)\n"},
    "durability": {DURABLE_FILE: "import os\n\ndef f(p):\n    os.replace(p, p)\n"},
    "fault-registry": {f"{PKG}/utils/faults.py": 'KNOWN_POINTS = frozenset({"a.b"})\n',
                       f"{PKG}/pipelines/x.py": "def f(faults):\n    faults.point('a.b')\n"
                                                "    faults.point('a.typo')\n"},
    "lock-discipline": {f"{PKG}/utils/pool.py": "import threading\n\nSEEN = set()\n\n"
                                                "def f(k):\n    threading.Thread()\n"
                                                "    SEEN.add(k)\n"},
    "residency": {RESIDENT_FILE: "def f(b, put_rows):\n    return put_rows(b.bases)\n"},
    "telemetry-contract": {TELE_FILE: "def _span(n):\n    return n\n\nS = _span('a.b')\n"
                                      "HEARTBEAT_FIELDS = ()\n",
                           f"{PKG}/pipelines/x.py": "def f(tr):\n    tr.count('a.rogue')\n"},
}


@pytest.mark.parametrize("rule", sorted(SEEDS))
def test_a_seeded_violation_of_each_rule_exits_1(tmp_path, rule, capsys):
    from adam_tpu_torch.staticcheck.cli import main

    for rel, src in SEEDS[rule].items():
        _write(tmp_path, rel, src)
    bl = str(tmp_path / "bl.json")
    out = str(tmp_path / "r.json")
    assert main(["--root", str(tmp_path), "--baseline", bl, "--json", out,
                 "--quiet"]) == core.EXIT_FINDINGS
    with open(out) as fh:
        doc = json.load(fh)
    assert doc["ok"] is False
    assert {f["rule"] for f in doc["findings"] if f["status"] == "new"} == {rule}


def test_check_verb_json_and_exit_codes(tmp_path, capsys):
    from adam_tpu_torch.cli.main import main

    out_path = str(tmp_path / "report.json")
    assert main(["check", "--json", out_path, "--quiet"]) == 0
    with open(out_path) as fh:
        doc = json.load(fh)
    assert doc["schema"] == "adam_tpu.staticcheck/1"
    assert doc["ok"] is True and doc["counts"]["new"] == 0
    assert doc["root"] == _repo_root()
    capsys.readouterr()
    assert main(["check", "--json", "-"]) == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True
    _write(tmp_path, DURABLE_FILE, "import os\n\ndef f(p):\n    os.replace(p, p)\n")
    assert main(["check", "--root", str(tmp_path), "--baseline",
                 str(tmp_path / "bl.json")]) == 1
    assert "FAIL" in capsys.readouterr().out
    assert main(["check", "--rules", "no-such-rule"]) == 2
    assert "unknown rule" in capsys.readouterr().err


def test_check_verb_list_rules(capsys):
    from adam_tpu_torch.cli.main import main

    assert main(["check", "--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in SEEDS:
        assert f"{rule}: " in out
