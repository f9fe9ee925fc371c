"""transform.observe_snp_mask_s: seconds a job's pass B spends masking known SNPs on the host (SnpTable.mask_positions), the mean per job of the
program's own span ``bqsr.observe.snp_mask`` (each job's --trace-out export)."""

from perfbench.metrics._spans import mean_span_s


def read(run: dict):
    return mean_span_s(run, "bqsr.observe.snp_mask")
