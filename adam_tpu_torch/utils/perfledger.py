"""Append-only per-run perf history + the regression sentinel
(docs/OBSERVABILITY.md "The perf ledger").

``scripts/bench-diff`` can compare any TWO artifacts, but a single
pairwise diff cannot tell a noisy run from a trend.  This module keeps
the longitudinal record: on every completed run/job the bench-diff key
extractor (mirrored here so the script stays dependency-free) books
the run's direction-aware perf keys — span walls, the derived
``stages.*`` tail identities, h2d/d2h transfer totals, the
``compiles.in_window`` count, kernelbench rows when present — as one
NDJSON line in ``<run-root>/PERF_LEDGER.ndjson``.  A **sentinel** then
compares the new run against the rolling median of the previous
``ADAM_TPU_PERF_BASELINE_N`` runs (median, not mean: one straggler run
must not poison the baseline) and flags direction-aware regressions
past ``ADAM_TPU_PERF_THRESHOLD`` percent — each flagged run emits a
``perf.regression`` incident bundle, counts ``perf.regressions``, and
charges the SLO error budget (a confirmed regression spends budget
even when no individual job missed its bound).

The ledger is append-only NDJSON: concurrent appends from scheduler
job threads interleave whole lines (single ``write`` under a lock), a
torn final line from a crash is skipped on read, and the history
survives restarts for free.  ``adam-tpu perf`` renders the trend table
(``--json`` for machines) and exits 1 when the newest run regresses —
the CI leg.

The sentinel needs at least :data:`MIN_BASELINE_RUNS` prior entries
before it will flag anything: with one or two runs of history a
"regression" is indistinguishable from noise (and a resumed run's
second booking must not page anyone).

The port's copy of ``adam_tpu/utils/perfledger.py``; the files it writes are JAX's.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import threading
import time
from typing import Optional

from adam_tpu_torch.utils import telemetry as tele

log = logging.getLogger(__name__)

#: Schema tag on every ledger line.
LEDGER_SCHEMA = "adam_tpu.perf_ledger/1"

#: Ledger file name under the run root.
LEDGER_FILENAME = "PERF_LEDGER.ndjson"

#: Default regression threshold, percent (``ADAM_TPU_PERF_THRESHOLD``).
DEFAULT_THRESHOLD_PCT = 25.0

#: Default rolling-baseline depth (``ADAM_TPU_PERF_BASELINE_N``).
DEFAULT_BASELINE_N = 5

#: The sentinel stays silent with fewer prior runs than this.
MIN_BASELINE_RUNS = 3

#: Walls below this (seconds / counts) are noise, not signal: a
#: 0.8 ms span doubling to 1.6 ms is scheduler jitter, not a perf
#: regression.  Keys whose baseline median sits under the floor are
#: booked but never flagged.
MIN_BASELINE_VALUE = 5e-3

_APPEND_LOCK = threading.Lock()


def perf_threshold_pct() -> float:
    """``ADAM_TPU_PERF_THRESHOLD`` (percent; malformed or nonpositive
    warns and keeps the default)."""
    from adam_tpu_torch.utils.retry import env_float

    v = env_float("ADAM_TPU_PERF_THRESHOLD", DEFAULT_THRESHOLD_PCT)
    if v <= 0:
        log.warning("ADAM_TPU_PERF_THRESHOLD=%s is not positive; using "
                    "default %.0f%%", v, DEFAULT_THRESHOLD_PCT)
        return DEFAULT_THRESHOLD_PCT
    return v


def baseline_n() -> int:
    """``ADAM_TPU_PERF_BASELINE_N`` (rolling median depth)."""
    from adam_tpu_torch.utils.retry import _env_int

    v = _env_int("ADAM_TPU_PERF_BASELINE_N", DEFAULT_BASELINE_N)
    if v <= 0:
        log.warning("ADAM_TPU_PERF_BASELINE_N=%s is not positive; using "
                    "default %d", v, DEFAULT_BASELINE_N)
        return DEFAULT_BASELINE_N
    return v


def booking_enabled() -> bool:
    """``ADAM_TPU_PERF_LEDGER`` (default on): whether completed runs
    book into the ledger at all."""
    from adam_tpu_torch.utils.retry import env_toggle

    return env_toggle("ADAM_TPU_PERF_LEDGER", True)


def snapshot_keys(doc: dict) -> dict:
    """Telemetry snapshot -> ``{key: (value, direction)}`` — the
    bench-diff ``--metrics-json`` key extractor, with the sentinel's
    direction choices: span walls and the derived ``stages.*`` tail
    identities are lower-is-better, the ``compiles.in_window`` count
    is lower-is-better here (a NEW in-window cold compile between runs
    of the same input IS a prewarm-coverage regression), transfer
    totals and counters are informational (input-size dependent),
    kernelbench rows are lower-is-better except interpret mode."""
    out = {}
    for k, v in (doc.get("counters") or {}).items():
        if isinstance(v, (int, float)):
            out[f"counters.{k}"] = (float(v), None)
    spans = doc.get("spans") or {}

    def span_s(name):
        e = spans.get(name)
        t = e.get("total_s") if isinstance(e, dict) else None
        return float(t) if isinstance(t, (int, float)) else None

    for name, e in spans.items():
        t = e.get("total_s") if isinstance(e, dict) else None
        if isinstance(t, (int, float)):
            out[f"spans.{name}.total_s"] = (float(t), "lower")
    pass_c = span_s("streamed.pass_c")
    write_wait = span_s("streamed.write_wait")
    if pass_c is not None:
        apply_split = max(
            0.0,
            pass_c
            - (span_s("streamed.apply.dispatch") or 0.0)
            - (span_s("streamed.apply.fetch") or 0.0)
            - (span_s("device.pool.prewarm.pass_c") or 0.0),
        )
        out["stages.apply_split_s"] = (apply_split, "lower")
        if write_wait is not None:
            out["stages.apply_split_plus_write_wait_s"] = (
                apply_split + write_wait, "lower",
            )
    xfer = doc.get("transfers") or {}
    for direction in ("h2d", "d2h"):
        per_pass = {}
        for _dev, per in (xfer.get(direction) or {}).items():
            for p, v in (per or {}).items():
                b = v.get("bytes", 0) if isinstance(v, dict) else 0
                per_pass[p] = per_pass.get(p, 0) + b
        total = sum(b for p, b in per_pass.items() if p != "prewarm")
        if per_pass:
            out[f"transfers.{direction}.total.bytes"] = (float(total), None)
    compiles = doc.get("compiles") or {}
    entries = compiles.get("entries")
    if isinstance(entries, list):
        n_in_window = sum(
            1 for e in entries
            if isinstance(e, dict) and e.get("in_window"))
        out["compiles.in_window"] = (float(n_in_window), "lower")
    elif isinstance(compiles.get("in_window"), list):
        # bench secondary-line shape (utilization.chip.compiles)
        out["compiles.in_window"] = (
            float(len(compiles["in_window"])), "lower")
    for row in (doc.get("kernels") or {}).get("rows") or []:
        if not isinstance(row, dict) or "error" in row:
            continue
        base = (f"kernels.{row.get('kernel')}.{row.get('backend')}"
                f".g{row.get('g')}x{row.get('gl')}")
        direction = None if row.get("mode") == "interpret" else "lower"
        for key in ("mean_s", "best_s"):
            v = row.get(key)
            if isinstance(v, (int, float)):
                out[f"{base}.{key}"] = (float(v), direction)
    return out


def ledger_path(root: str) -> str:
    """Accepts a run root or the ledger file itself."""
    if os.path.basename(root) == LEDGER_FILENAME:
        return root
    return os.path.join(root, LEDGER_FILENAME)


def book(root: str, snapshot: dict, *, run_id: Optional[str] = None,
         kind: str = "run") -> dict:
    """Append one ledger entry for ``snapshot`` (a telemetry snapshot
    or an already-extracted key map) and return it."""
    if snapshot and all(isinstance(v, tuple) for v in snapshot.values()):
        keys = snapshot
    else:
        keys = snapshot_keys(snapshot or {})
    entry = {
        "schema": LEDGER_SCHEMA,
        "ts": time.time(),
        "run_id": run_id,
        "kind": kind,
        "keys": {k: [v, d] for k, (v, d) in sorted(keys.items())},
    }
    path = ledger_path(root)
    line = json.dumps(entry, sort_keys=True) + "\n"
    with _APPEND_LOCK:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a", encoding="utf-8") as fh:
            fh.write(line)
            fh.flush()
    return entry


def read_ledger(root: str) -> list:
    """All well-formed entries, oldest first; a torn final line (crash
    mid-append) and foreign lines are skipped, never fatal."""
    path = ledger_path(root)
    entries = []
    try:
        with open(path, encoding="utf-8") as fh:
            for ln in fh:
                ln = ln.strip()
                if not ln:
                    continue
                try:
                    doc = json.loads(ln)
                except ValueError:
                    continue
                if (isinstance(doc, dict)
                        and doc.get("schema") == LEDGER_SCHEMA):
                    entries.append(doc)
    except OSError:
        return []
    return entries


def _entry_keys(entry: dict) -> dict:
    """Ledger entry -> {key: (value, direction)}."""
    out = {}
    for k, pair in (entry.get("keys") or {}).items():
        if (isinstance(pair, list) and len(pair) == 2
                and isinstance(pair[0], (int, float))):
            out[k] = (float(pair[0]), pair[1])
    return out


def rolling_baseline(entries: list, n: Optional[int] = None) -> dict:
    """Per-key median over the last ``n`` entries -> {key: (median,
    direction, count)}.  A key only enters the baseline when a
    majority of the sampled entries carry it (a key that appears once
    in five runs is a feature-flag artifact, not a trend)."""
    n = n if n is not None else baseline_n()
    window = entries[-n:] if n > 0 else list(entries)
    if not window:
        return {}
    per_key: dict = {}
    for e in window:
        for k, (v, d) in _entry_keys(e).items():
            per_key.setdefault(k, ([], d))[0].append(v)
    quorum = len(window) // 2 + 1
    return {
        k: (statistics.median(vals), d, len(vals))
        for k, (vals, d) in per_key.items()
        if len(vals) >= quorum
    }


def compare(entry: dict, baseline: dict,
            threshold_pct: Optional[float] = None) -> list:
    """Direction-aware regressions of ``entry`` vs ``baseline`` ->
    ``[{key, baseline, value, delta_pct}, ...]``.  Informational keys
    (direction None) and sub-noise-floor baselines never flag."""
    thr = threshold_pct if threshold_pct is not None else perf_threshold_pct()
    regressions = []
    for k, (value, direction) in sorted(_entry_keys(entry).items()):
        row = baseline.get(k)
        if row is None or direction is None:
            continue
        base, _d, _n = row
        if base < MIN_BASELINE_VALUE:
            continue
        delta = (value - base) / base * 100.0
        regressed = (delta > thr if direction == "lower"
                     else delta < -thr)
        if regressed:
            regressions.append({
                "key": k,
                "baseline": base,
                "value": value,
                "delta_pct": round(delta, 3),
                "direction": direction,
            })
    return regressions


def check_latest(root: str, *, threshold_pct: Optional[float] = None,
                 n: Optional[int] = None) -> list:
    """Regressions of the NEWEST ledger entry vs the rolling median of
    the entries before it; empty when history is too shallow
    (< :data:`MIN_BASELINE_RUNS` priors)."""
    entries = read_ledger(root)
    if len(entries) < MIN_BASELINE_RUNS + 1:
        return []
    baseline = rolling_baseline(entries[:-1], n)
    return compare(entries[-1], baseline, threshold_pct)


def sentinel(root: str, snapshot: dict, *, run_id: Optional[str] = None,
             kind: str = "run",
             threshold_pct: Optional[float] = None,
             n: Optional[int] = None) -> list:
    """Book ``snapshot`` and judge it: compare against the rolling
    median of the prior runs, and on any regression count
    ``perf.regressions``, emit a ``perf.regression`` incident bundle,
    and charge the SLO error budget.  Returns the regression list."""
    prior = read_ledger(root)
    entry = book(root, snapshot, run_id=run_id, kind=kind)
    if len(prior) < MIN_BASELINE_RUNS:
        return []
    baseline = rolling_baseline(prior, n)
    regressions = compare(entry, baseline, threshold_pct)
    if not regressions:
        return []
    tele.TRACE.count(tele.C_PERF_REGRESSIONS, len(regressions))
    worst = max(regressions, key=lambda r: abs(r["delta_pct"]))
    reason = (
        f"run {run_id or '?'}: {len(regressions)} perf key(s) regressed "
        f"past threshold; worst {worst['key']} "
        f"{worst['delta_pct']:+.1f}% vs rolling median "
        f"{worst['baseline']:.4g}"
    )
    from adam_tpu_torch.utils import incidents

    incidents.maybe_record("perf.regression", trace_id=run_id,
                           reason=reason)
    from adam_tpu_torch.utils import slo

    slo.note_perf_regression(len(regressions), reason=reason)
    return regressions


def trend(entries: list, *, n: Optional[int] = None,
          threshold_pct: Optional[float] = None) -> list:
    """Per-entry trend rows for ``adam-tpu perf``: each entry judged
    against the rolling median of the entries BEFORE it (the first
    :data:`MIN_BASELINE_RUNS` rows are baseline-building, never
    flagged)."""
    rows = []
    for i, e in enumerate(entries):
        keys = _entry_keys(e)
        wall = keys.get("spans.streamed.total.total_s")
        regressions = []
        if i >= MIN_BASELINE_RUNS:
            baseline = rolling_baseline(entries[:i], n)
            regressions = compare(e, baseline, threshold_pct)
        rows.append({
            "index": i,
            "ts": e.get("ts"),
            "run_id": e.get("run_id"),
            "kind": e.get("kind"),
            "n_keys": len(keys),
            "total_s": wall[0] if wall else None,
            "regressions": regressions,
        })
    return rows


# ---- module-level arm/disarm (the incident-recorder pattern) ----

_ROOT: Optional[str] = None


def install(run_root: str) -> None:
    """Arm the ledger on a service run root: completed jobs book
    there instead of their own run dirs."""
    global _ROOT
    _ROOT = os.path.abspath(run_root)


def uninstall() -> None:
    global _ROOT
    _ROOT = None


def installed() -> bool:
    return _ROOT is not None


def ledger_root() -> Optional[str]:
    return _ROOT


def _reset_for_tests() -> None:
    uninstall()
