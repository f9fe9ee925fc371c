"""service.ticket_wait_s: the mean wait of a coalescer ticket, from its
submission to the start of its group's fused dispatch, over every ticket
of the traced rounds (the program's ``sched.batch.ticket_wait`` spans)."""

from perfbench.metrics._rounds import span_totals


def read(run: dict):
    got = span_totals(run, "sched.batch.ticket_wait")
    if got is None or got[1] == 0:
        return None
    return got[0] / got[1]
