"""Prometheus text exposition for the gateway ``GET /metrics`` surface.

Pure rendering: :func:`render_prometheus` turns one
:meth:`~adam_tpu_torch.utils.telemetry.Tracer.snapshot` into exposition-format
text (version 0.0.4 — the format every Prometheus-compatible scraper
speaks), with no HTTP, no tracer access, and no state, so a test can
assert on the text without a server.

Naming: every registered telemetry name mangles via
:func:`~adam_tpu_torch.utils.telemetry.prometheus_name` (``.`` -> ``_``,
``adam_tpu_`` prefix).  Validity and collision-freedom of the mangled
set are the telemetry-names lint's job
(staticcheck/rules/telemetry_names.py), enforced at check time — this
renderer assumes them.

Sections rendered, in order: counters (as ``counter``), gauge last
values (as ``gauge``), histograms (cumulative ``_bucket{le=...}`` +
``_sum`` + ``_count`` rows from the fixed log-spaced buckets), the
per-tenant quota ledger (``tenant=`` labelled), the per-device health
board (``device=`` labelled state/score/transitions), and the live
job-trace gauge.  Budget rows appear only for tenants whose budgets
the QuotaManager knows — absent is absent, never a fabricated zero.

The port's copy of ``adam_tpu/gateway/metrics.py`` (stdlib and numpy code, no JAX): the
wire formats, schemas and file layouts are JAX's, byte for byte.
"""

from __future__ import annotations

import re

from adam_tpu_torch.utils import telemetry as tele

#: Content type the gateway serves the rendered body under.
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _metric_name(name: str) -> str:
    """Mangle one telemetry name for exposition.  Dotted contract
    names mangle cleanly (the lint guarantees it); the display-style
    instrumentation timer names ("BGZF Codec (native)") additionally
    sanitize every non-name character to ``_`` so the exposition stays
    parseable whatever lands in a snapshot."""
    m = tele.prometheus_name(name)
    if not tele.prometheus_name_valid(m):
        m = re.sub(r"[^a-zA-Z0-9_:]", "_", m)
        if not re.match(r"[a-zA-Z_:]", m):
            m = "_" + m
    return m


def _fmt(v) -> str:
    """One sample value: ints verbatim, floats via repr (full
    precision; Prometheus parses scientific notation)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    try:
        return repr(float(v))
    except (TypeError, ValueError):
        return "0"


def _label_value(v) -> str:
    """Escape one label value per the exposition grammar."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _labels(**kv) -> str:
    inner = ",".join(
        '%s="%s"' % (k, _label_value(v)) for k, v in kv.items()
    )
    return "{%s}" % inner if inner else ""


def render_prometheus(snap: dict, slo_status: dict | None = None) -> str:
    """One snapshot -> exposition-format text (trailing newline
    included, as the format requires).  ``slo_status`` is the armed
    SLO engine's :func:`adam_tpu.utils.slo.status` document; when
    given, per-objective burn/compliance/budget gauges render with an
    ``objective=`` label (the service-wide worst-burn and
    budget-remaining gauges already flow through the plain gauges
    section — they are registered telemetry names)."""
    out: list = []

    def head(name: str, kind: str, help_text: str) -> None:
        out.append("# HELP %s %s" % (name, help_text))
        out.append("# TYPE %s %s" % (name, kind))

    for name in sorted(snap.get("counters", {})):
        m = _metric_name(name)
        head(m, "counter", "adam_tpu counter %s" % name)
        out.append("%s %s" % (m, _fmt(snap["counters"][name])))

    for name in sorted(snap.get("gauges", {})):
        m = _metric_name(name)
        head(m, "gauge", "adam_tpu gauge %s (last sampled value)" % name)
        out.append("%s %s" % (m, _fmt(snap["gauges"][name]["last"])))

    for name in sorted(snap.get("histograms", {})):
        h = snap["histograms"][name]
        m = _metric_name(name)
        head(m, "histogram", "adam_tpu histogram %s" % name)
        # cumulative buckets over the fixed log-spaced edges: each
        # sparse bucket's UPPER edge becomes its le label, so two
        # scrapes of a growing histogram stay monotonically consistent
        # per edge (the edges are global constants, never data-derived)
        acc = 0
        items = sorted(
            (int(k), v) for k, v in (h.get("buckets") or {}).items()
        )
        for idx, n in items:
            acc += n
            le = tele.hist_bucket_bounds(idx)[1]
            out.append(
                "%s_bucket%s %d" % (m, _labels(le="%.6g" % le), acc)
            )
        out.append("%s_bucket%s %d" % (m, _labels(le="+Inf"), h["count"]))
        out.append("%s_sum %s" % (m, _fmt(h["sum"])))
        out.append("%s_count %d" % (m, h["count"]))

    quota = snap.get("quota") or {}
    if quota:
        rows = [
            ("adam_tpu_tenant_quota_charges", "counter", "charges",
             "quota charges accounted per tenant"),
            ("adam_tpu_tenant_quota_bytes", "counter", "bytes",
             "quota bytes consumed per tenant"),
            ("adam_tpu_tenant_quota_compute_seconds", "counter",
             "compute_s", "quota compute-seconds consumed per tenant"),
        ]
        for m, kind, key, help_text in rows:
            head(m, kind, help_text)
            for tenant in sorted(quota):
                out.append(
                    "%s%s %s" % (m, _labels(tenant=tenant),
                                 _fmt(quota[tenant].get(key, 0)))
                )
        for m, key, help_text in (
            ("adam_tpu_tenant_quota_budget_bytes", "budget_bytes",
             "per-tenant byte budget (absent when unknown)"),
            ("adam_tpu_tenant_quota_budget_compute_seconds",
             "budget_compute_s",
             "per-tenant compute-second budget (absent when unknown)"),
        ):
            budgeted = [
                t for t in sorted(quota)
                if quota[t].get(key) is not None
            ]
            if not budgeted:
                continue
            head(m, "gauge", help_text)
            for tenant in budgeted:
                out.append(
                    "%s%s %s" % (m, _labels(tenant=tenant),
                                 _fmt(quota[tenant][key]))
                )

    health = snap.get("health") or {}
    if health:
        head("adam_tpu_device_health_state", "gauge",
             "1 for each device's current health-board state")
        for dev in sorted(health):
            out.append(
                "adam_tpu_device_health_state%s 1"
                % _labels(device=dev, state=health[dev].get("state", ""))
            )
        head("adam_tpu_device_health_score", "gauge",
             "device health score (0 healthy, higher worse)")
        for dev in sorted(health):
            out.append(
                "adam_tpu_device_health_score%s %s"
                % (_labels(device=dev),
                   _fmt(health[dev].get("score", 0.0)))
            )
        head("adam_tpu_device_health_transitions", "counter",
             "health-board state transitions witnessed per device")
        for dev in sorted(health):
            out.append(
                "adam_tpu_device_health_transitions%s %s"
                % (_labels(device=dev),
                   _fmt(health[dev].get("transitions", 0)))
            )

    for row_name, key, help_text in (
        ("adam_tpu_slo_burn_short", "burn_short",
         "error-budget burn rate over the short window per objective"),
        ("adam_tpu_slo_burn_long", "burn_long",
         "error-budget burn rate over the long window per objective"),
        ("adam_tpu_slo_compliance", "compliance",
         "long-window compliance fraction per objective"),
        ("adam_tpu_slo_objective_budget_remaining", "budget_remaining",
         "error-budget fraction remaining per objective"),
    ):
        objectives = (slo_status or {}).get("objectives") or []
        if not objectives:
            break
        head(row_name, "gauge", help_text)
        for o in objectives:
            out.append(
                "%s%s %s" % (
                    row_name,
                    _labels(objective=o.get("key", ""),
                            tenant=o.get("tenant", "")),
                    _fmt(o.get(key, 0.0)),
                )
            )

    head("adam_tpu_traces_active", "gauge",
         "job traces currently active in this process")
    out.append("adam_tpu_traces_active %d" % len(tele.active_traces()))
    head("adam_tpu_traces_recorded", "gauge",
         "distinct job traces with recorded events in the snapshot")
    out.append(
        "adam_tpu_traces_recorded %d" % len(snap.get("traces") or {})
    )

    return "\n".join(out) + "\n"
