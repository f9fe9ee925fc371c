"""kmers.load_s: seconds a job spends in the projected Parquet load
(``io/context.load_alignments``), the mean per job, host clock."""


def read(run: dict):
    jobs = [j for j in run["jobs"] if "load_s" in j]
    return sum(j["load_s"] for j in jobs) / len(jobs) if jobs else None
