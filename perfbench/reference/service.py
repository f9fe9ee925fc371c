"""The comparison that decides ``correct`` for the transform service:
each sample against the plain flagship reference for that sample alone.

Isolation and exactness are the service's guarantees.  So a sample's
published rows must be what :func:`perfbench.reference.transform.expected`
works out from that sample's reads and genome alone, whichever samples
shared its round, its fused dispatches and its card; a leak between jobs
(a band offset in a fused observe, one ticket's bytes handed to another)
shows as disagreements.  NumPy and the standard library only.

The reference's answer is cached beside each sample's input as the
flagship driver caches it (a digest of every compared column and the
count of observed residues), so a repeated seed runs no reference where
the published columns have that digest.
"""

from __future__ import annotations

import numpy as np

from perfbench.drivers.transform_cli import _digest, reference_digest
from perfbench.reference import compare, transform

SERVICE_CHECKS = compare.TRANSFORM_CHECKS + (
    "samples_with_other_bytes", "jobs_not_done", "fused_dispatches_failed")


def check(rounds: list, inputs: list, seed: int, sites: bool, device: str) -> tuple:
    """-> ([(name, value, limit)], observed residues per sample).

    ``rounds``: the driver's rounds, each with one output directory per
    sample (in ``inputs``' order), the jobs' final ``states`` and its
    ``trace`` counters.  One round, drawn from the seed, has each sample
    compared with its reference, the counts summed over the samples;
    every other round's samples against that round's same sample, byte
    for byte; every job of every round must be ``done``; no fused
    dispatch of the window may have failed over to a job's own path.
    Every limit is 0."""
    pick = int(np.random.default_rng(abs(seed) + 7).integers(0, len(rounds)))
    chosen = rounds[pick]["outputs"]
    totals = dict.fromkeys(compare.TRANSFORM_CHECKS, 0)
    observed = []
    for inp, out in zip(inputs, chosen):
        got = compare.read_transform_output(out)
        ref = None

        def compute(inp=inp):
            nonlocal ref
            ref = transform.expected(inp.reads(), known_sites=sites, device=device)
            return {"digest": compare.digest(compare.as_published(ref)),
                    "observed": ref["observed"]}

        ans = reference_digest(inp, "transform.sites" if sites else "transform.nosites", compute)
        observed.append(ans["observed"])
        if ref is None and ans["digest"] == compare.digest(got):
            continue
        if ref is None:
            compute()
        for name, v, _ in compare.compare_transform(ref, got):
            totals[name] += v
    want = [_digest(out) for out in chosen]
    other = sum(_digest(out) != w for r in rounds for out, w in zip(r["outputs"], want))
    not_done = sum(s != "done" for r in rounds for s in r["states"].values())
    failed = sum(r["trace"]["counters"].get("sched.batch.fallbacks", 0) for r in rounds)
    checks = [(name, v, 0) for name, v in totals.items()]
    checks += [("samples_with_other_bytes", other, 0), ("jobs_not_done", not_done, 0),
               ("fused_dispatches_failed", failed, 0)]
    return checks, observed
