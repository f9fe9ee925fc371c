"""transform.ingest_wait_s: seconds a job's pass A waits on the ingest thread's queue (BGZF inflate, BAM tokenizer), the mean per job of the
program's own span ``streamed.pass_a.wait`` (each job's --trace-out export)."""

from perfbench.metrics._spans import mean_span_s


def read(run: dict):
    return mean_span_s(run, "streamed.pass_a.wait")
