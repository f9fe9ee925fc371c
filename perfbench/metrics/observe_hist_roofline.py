"""observe_hist_roofline: kernel 1's share of its roofline, in percent:
the least time the bytes its data needs take at the card's HBM rate,
over the device time of its four launches (``count_kernel``,
``scan_kernel``, ``scatter_kernel``, ``accum_kernel`` in
``csrc/observe_hist.cu``) per job (profiler trace)."""

from perfbench.harness import roofline

NAMES = ("count_kernel", "scan_kernel", "scatter_kernel", "accum_kernel")


def read(run: dict):
    t, st = run.get("trace"), run["state"]
    if not t or getattr(st, "observed_residues", None) is None:
        return None
    dev_s = sum(t["device_s_by_name"].get(n, 0.0) for n in NAMES) / len(run["jobs"])
    return roofline.share(roofline.observe_hist_bytes(st.input, st.observed_residues), dev_s)
