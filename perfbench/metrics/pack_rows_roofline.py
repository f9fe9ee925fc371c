"""pack_rows_roofline: kernel 2's share of its roofline, in percent: the
least time the bytes its data needs take at the card's HBM rate, over
the device time of its launches (``tile_sums_kernel``,
``tile_scan_kernel``, ``pack_kernel`` in ``csrc/pack_rows.cu``) per job
(profiler trace)."""

from perfbench.harness import roofline

NAMES = ("tile_sums_kernel", "tile_scan_kernel", "pack_kernel")


def read(run: dict):
    t = run.get("trace")
    if not t:
        return None
    dev_s = sum(t["device_s_by_name"].get(n, 0.0) for n in NAMES) / len(run["jobs"])
    return roofline.share(roofline.pack_rows_bytes(run["state"].input), dev_s)
