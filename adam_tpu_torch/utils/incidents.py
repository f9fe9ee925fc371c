"""The incident bundles' read side (copied from ``adam_tpu/utils/incidents.py``):
the list view of ``<run_dir>/incidents/`` that ``analyzer.analyze_path``
folds into its "Incidents" section.

Recording bundles (``install(run_dir)`` and the anomaly triggers) comes
with ROADMAP queue 1 item 5.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)

#: Schema tag every bundle carries.
INCIDENT_SCHEMA = "adam_tpu.incident/1"

#: Subdirectory of a run dir bundles land in.
INCIDENTS_DIRNAME = "incidents"


def summarize_bundle(doc: dict, path: str | None = None) -> dict:
    """One bundle's list-view row (the CLI table and the gateway
    ``/incidents`` payload share it)."""
    return {
        "id": doc.get("id"),
        "trigger": doc.get("trigger"),
        "reason": doc.get("reason") or "",
        "ts": doc.get("ts"),
        "device": doc.get("device"),
        "window": doc.get("window"),
        "trace_id": doc.get("trace_id"),
        "path": path,
    }


def list_bundles(run_dir: str) -> list:
    """Bundle summaries under ``<run_dir>/incidents/`` (or ``run_dir``
    itself when it already IS an incidents dir), oldest first.
    Malformed files are skipped with a warning — a torn bundle must not
    hide its siblings."""
    import json

    dirpath = str(run_dir)
    if os.path.basename(os.path.normpath(dirpath)) != INCIDENTS_DIRNAME:
        cand = os.path.join(dirpath, INCIDENTS_DIRNAME)
        if os.path.isdir(cand):
            dirpath = cand
    try:
        names = sorted(
            n for n in os.listdir(dirpath)
            if n.startswith("inc-") and n.endswith(".json")
        )
    except OSError:
        return []
    out = []
    for n in names:
        path = os.path.join(dirpath, n)
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            log.warning("skipping malformed incident bundle %s", path)
            continue
        if doc.get("schema") != INCIDENT_SCHEMA:
            log.warning("skipping %s: unknown schema %r", path,
                        doc.get("schema"))
            continue
        out.append(summarize_bundle(doc, path))
    return out
