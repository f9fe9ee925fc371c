"""transform.ingest_pass_a_s: seconds a job spends in ingest (BGZF inflate, BAM tokenizer) and pass A (markdup columns), the mean per job of
the stats line's "ingest_pass_s" (the program's own span walls)."""

from perfbench.metrics._stage import mean_of


def read(run: dict):
    return mean_of(run, "ingest_pass_s")
