"""transform.realign_sweep_s: seconds a job's realign tail spends dispatching the sweeps and waiting on their fetch (the observe work overlapped under them excluded), the mean per job of the
program's own span ``realign.sweep`` (each job's --trace-out export)."""

from perfbench.metrics._spans import mean_span_s


def read(run: dict):
    return mean_span_s(run, "realign.sweep")
