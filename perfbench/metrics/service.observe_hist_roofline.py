"""service.observe_hist_roofline: kernel 1's share of its roofline over a
round of the service, in percent: the bytes the round's samples' data
needs (summed over the samples, as separate jobs would need them: a fused
histogram of all the bands writes what the separate ones would) at the
card's HBM rate, over the device time of kernel 1's four launches
(``count_kernel``, ``scan_kernel``, ``scatter_kernel``, ``accum_kernel``
in ``csrc/observe_hist.cu``) per round (profiler trace)."""

from perfbench.harness import roofline

NAMES = ("count_kernel", "scan_kernel", "scatter_kernel", "accum_kernel")


def read(run: dict):
    t, st = run.get("trace"), run["state"]
    observed = getattr(st, "observed", None)
    if not t or not observed:
        return None
    dev_s = sum(t["device_s_by_name"].get(n, 0.0) for n in NAMES) / len(run["jobs"])
    need = sum(roofline.observe_hist_bytes(inp, obs) for inp, obs in zip(st.inputs, observed))
    return roofline.share(need, dev_s)
