"""Library submission seam for the multi-job transform service.

The thin front the ROADMAP's always-on-service direction names, sitting
next to :mod:`adam_tpu_torch.api.spark_executor` (the other embedding seam):
callers hand :class:`~adam_tpu_torch.serve.job.JobSpec`s to a
:class:`TransformService` and get typed admission results back — the
in-process analog of a submission RPC.  An HTTP/queue front would wrap
exactly this surface; keeping it transport-free is what lets the CLI,
the tests and the chaos harness drive the same scheduler.

Manifest format (``adam-tpu serve --jobs FILE``)::

    {"jobs": [{"job_id": "tenantA-1", "input": "a.bam",
               "output": "a.adam", "tenant": "A", "weight": 2.0,
               "window_reads": 4096}, ...]}

A bare JSON list of job objects is accepted too.  Field names are the
:class:`JobSpec` dataclass fields; unknown keys are rejected so a
typo'd flag cannot silently no-op.

The port's copy of ``adam_tpu/api/transform_service.py`` (stdlib and numpy code, no JAX): the
wire formats, schemas and file layouts are JAX's, byte for byte.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional, Union

from adam_tpu_torch.serve.job import Admitted, Busy, JobSpec
from adam_tpu_torch.serve.scheduler import JobScheduler
from adam_tpu_torch.utils.retry import DeadlineExceeded, call_with_deadline


def load_jobs_manifest(path: str) -> list:
    """Parse a jobs manifest file into validated :class:`JobSpec`s.

    Raises ``ValueError`` with the offending entry on any malformed
    job — a half-loaded manifest must never submit a prefix."""
    with open(path) as fh:
        doc = json.load(fh)
    if isinstance(doc, dict):
        doc = doc.get("jobs")
    if not isinstance(doc, list):
        raise ValueError(
            f"jobs manifest {path}: expected a list of job objects or "
            '{"jobs": [...]}'
        )
    specs = []
    seen = set()
    for i, entry in enumerate(doc):
        if not isinstance(entry, dict):
            raise ValueError(
                f"jobs manifest {path}: entry {i} is not an object"
            )
        unknown = set(entry) - set(JobSpec.__dataclass_fields__)
        if unknown:
            raise ValueError(
                f"jobs manifest {path}: entry {i} has unknown "
                f"field(s) {sorted(unknown)}"
            )
        try:
            spec = JobSpec.from_doc(entry)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"jobs manifest {path}: entry {i}: {e}"
            ) from None
        if spec.job_id in seen:
            raise ValueError(
                f"jobs manifest {path}: duplicate job_id "
                f"{spec.job_id!r}"
            )
        seen.add(spec.job_id)
        specs.append(spec)
    return specs


class TransformService:
    """The in-process service facade: one scheduler, typed submissions.

    Thin by design — every method is a one-line delegation plus the
    blocking-submit convenience, so the robustness contract lives in
    exactly one place (:class:`~adam_tpu_torch.serve.scheduler.JobScheduler`).
    """

    def __init__(self, run_root: str, **scheduler_kw):
        self.scheduler = JobScheduler(run_root, **scheduler_kw)

    # ---- submission -----------------------------------------------------
    def submit(self, spec: JobSpec) -> Union[Admitted, Busy]:
        return self.scheduler.submit(spec)

    def submit_blocking(self, spec: JobSpec,
                        deadline_s: Optional[float] = None,
                        poll_s: float = 0.1, *,
                        timeout: Optional[float] = None,
                        ) -> Union[Admitted, Busy]:
        """Submit, politely waiting out ``capacity`` rejections until a
        slot frees (the well-behaved client loop: `has_capacity` gates
        each attempt, so waiting does not spam the admission counters
        or the ``sched.admit`` fault point).  ``draining`` and
        ``duplicate`` rejections return immediately — retrying those
        would spin forever.

        ``deadline_s`` bounds the wait through
        :func:`~adam_tpu_torch.utils.retry.call_with_deadline` — the bound
        holds even when the scheduler itself is WEDGED (a stuck
        ``wait`` under a hung job, not merely slow slot turnover), in
        which case a typed ``Busy(kind="capacity")`` surfaces instead
        of the caller spinning at ``poll_s`` forever.  ``timeout`` is
        the deprecated alias.  ``deadline_s=None`` waits indefinitely
        (the embedding caller owns its own bound)."""
        if deadline_s is None:
            deadline_s = timeout
        if deadline_s is not None and deadline_s <= 0:
            # zero budget = exactly one attempt (call_with_deadline
            # treats <=0 as "no deadline", which would invert this
            # into an unbounded wait)
            return self.scheduler.submit(spec)
        gave_up = threading.Event()
        attempted = threading.Event()
        # terminal submit results the worker reached, deadline or not:
        # an Admitted that lands as the deadline expires must reach
        # the caller — returning Busy for a job that IS running would
        # leak a slot the caller believes was refused
        outcome: list = []

        def wait_for_slot() -> Union[Admitted, Busy]:
            last: Optional[Busy] = None
            while not gave_up.is_set():
                # first pass always submits (duplicate/draining must
                # surface even with zero capacity); later passes gate
                # on has_capacity so the poll doesn't spam rejections
                if last is None or self.scheduler.has_capacity():
                    got = self.scheduler.submit(spec)
                    attempted.set()
                    if isinstance(got, Admitted) or got.kind != "capacity":
                        outcome.append(got)
                        return got
                    last = got
                self.scheduler.wait(timeout=poll_s)
            return last if last is not None else Busy(
                "submission abandoned", kind="capacity",
            )

        if deadline_s is None:
            return wait_for_slot()
        try:
            return call_with_deadline(
                wait_for_slot, deadline_s, site="service.submit_blocking"
            )
        except DeadlineExceeded:
            gave_up.set()
            # grace window: the worker may be INSIDE submit() right
            # now; a short wait collects a just-landed admission.  A
            # genuinely wedged scheduler never reaches outcome, and
            # the residual race (submit outliving the grace) is
            # recoverable by design — re-submitting the same spec
            # surfaces Busy(kind=duplicate), the idempotency signal.
            grace = time.monotonic() + max(poll_s, 0.1)
            while time.monotonic() < grace:
                if outcome:
                    return outcome[0]
                time.sleep(0.005)
            return Busy(
                f"no job slot freed within {deadline_s:.1f}s"
                + ("" if attempted.is_set()
                   else " (scheduler wedged: the admission check never "
                        "completed)"),
                kind="capacity",
            )
        finally:
            # unblock the watchdog's worker so an abandoned attempt
            # stops polling the scheduler instead of leaking a spinner
            gave_up.set()

    def cancel(self, job_id: str) -> bool:
        return self.scheduler.cancel(job_id)

    # ---- lifecycle ------------------------------------------------------
    def recover(self) -> list:
        return self.scheduler.recover()

    def request_drain(self) -> None:
        self.scheduler.request_drain()

    def drain(self, timeout: Optional[float] = None) -> bool:
        return self.scheduler.drain(timeout)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.scheduler.wait(timeout)

    def status(self) -> dict:
        return self.scheduler.status()

    def close(self) -> None:
        self.scheduler.close()
