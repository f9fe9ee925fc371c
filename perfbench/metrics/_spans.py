"""Shared by the span readers: the mean per job of a span's seconds, from
each job's ``<output>.trace.json`` (the program's ``--trace-out`` export
of a traced run).  The export's ``histograms[<span>]["sum"]`` outlives
the event ring's eviction.  None where a job's export is missing, or
where no job recorded the span (a program without it)."""

from __future__ import annotations

import json


def mean_span_s(run: dict, name: str):
    per_job = []
    for j in run["jobs"]:
        try:
            with open(j["output"] + ".trace.json") as fh:
                hists = json.load(fh).get("histograms") or {}
        except (OSError, ValueError):
            return None
        h = hists.get(name)
        per_job.append(h["sum"] if h else None)
    if not per_job or all(v is None for v in per_job):
        return None
    return sum(v or 0.0 for v in per_job) / len(per_job)
