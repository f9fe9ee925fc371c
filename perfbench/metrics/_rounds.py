"""Shared by the service readers: the driver's snapshot of each round's
service spans and ``sched.batch.*`` counters (``jobs[k]["trace"]``).
None where no round recorded the span or counter (a program without
it), never 0."""


def span_totals(run: dict, name: str):
    """-> (summed seconds, summed count, rounds) over the run's rounds."""
    rounds = [j["trace"] for j in run["jobs"] if "trace" in j]
    found = [t["spans"][name] for t in rounds if name in t["spans"]]
    if not found:
        return None
    return sum(s["total_s"] for s in found), sum(s["count"] for s in found), len(rounds)


def counter_total(run: dict, name: str):
    found = [j["trace"]["counters"][name] for j in run["jobs"]
             if name in j.get("trace", {}).get("counters", {})]
    return sum(found) if found else None
