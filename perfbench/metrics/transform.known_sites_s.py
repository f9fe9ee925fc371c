"""transform.known_sites_s: seconds a job spends loading the known sites before the run starts (BAM header, VCF, SnpTable), the mean per job of the
program's own span ``transform.known_sites.load`` (each job's --trace-out export)."""

from perfbench.metrics._spans import mean_span_s


def read(run: dict):
    return mean_span_s(run, "transform.known_sites.load")
