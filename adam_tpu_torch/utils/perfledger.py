"""The perf ledger's read side (copied from ``adam_tpu/utils/perfledger.py``):
the key extractor, the ledger reader, the rolling-median baseline and the
trend rows that ``analyzer.analyze_path`` folds into its "Perf trend"
section when a ``PERF_LEDGER.ndjson`` sits beside an artifact.

Booking a run into the ledger and the regression sentinel (the incident
bundle and the SLO charge it raises) come with ROADMAP queue 1 item 5.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
from typing import Optional

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
