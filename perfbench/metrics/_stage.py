"""Shared by the stage readers: the mean per job of stats-line keys."""


def mean_of(run: dict, *keys: str):
    stats = [j["stats"] for j in run["jobs"] if "stats" in j]
    if not stats or not any(k in stats[0] for k in keys):
        return None
    return sum(sum(s.get(k, 0.0) for k in keys) for s in stats) / len(stats)
