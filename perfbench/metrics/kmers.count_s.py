"""kmers.count_s: seconds a job spends in ``count_kmers`` (the device
histogram and the host decode to the table), the mean per job, host
clock."""


def read(run: dict):
    jobs = [j for j in run["jobs"] if "count_s" in j]
    return sum(j["count_s"] for j in jobs) / len(jobs) if jobs else None
