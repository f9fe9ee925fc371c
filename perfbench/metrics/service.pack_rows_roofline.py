"""service.pack_rows_roofline: kernel 2's share of its roofline over a
round of the service, in percent: the bytes the round's samples' data
needs (summed over the samples) at the card's HBM rate, over the device
time of its launches (``tile_sums_kernel``, ``tile_scan_kernel``,
``pack_kernel`` in ``csrc/pack_rows.cu``) per round (profiler trace)."""

from perfbench.harness import roofline

NAMES = ("tile_sums_kernel", "tile_scan_kernel", "pack_kernel")


def read(run: dict):
    t = run.get("trace")
    if not t:
        return None
    dev_s = sum(t["device_s_by_name"].get(n, 0.0) for n in NAMES) / len(run["jobs"])
    return roofline.share(sum(roofline.pack_rows_bytes(inp) for inp in run["state"].inputs), dev_s)
