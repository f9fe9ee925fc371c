"""Shared by the idle readers: 100 - the device's busy share of the
traced jobs' walls (the union of kernel, copy and set intervals)."""


def idle_pct(run: dict):
    t = run.get("trace")
    if not t or t["window_s"] <= 0 or t["n_device_events"] == 0:
        return None
    return 100.0 - 100.0 * t["busy_s"] / t["window_s"]
