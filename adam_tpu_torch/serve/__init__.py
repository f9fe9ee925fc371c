"""Multi-job transform service: shared-pool scheduling for the
streamed flagship (docs/ROBUSTNESS.md "Fault-isolated multi-job
scheduling").

* :mod:`adam_tpu_torch.serve.job` — the JSON-roundtrip job model and the
  typed admission results (:class:`Admitted` / :class:`Busy`).
* :mod:`adam_tpu_torch.serve.fairness` — per-tenant weighted window
  interleaving (virtual-time fair queuing over the shared pool).
* :mod:`adam_tpu_torch.serve.scheduler` — admission control, job quarantine,
  graceful drain and whole-process crash recovery.
* :mod:`adam_tpu_torch.serve.batching` — continuous cross-job window
  batching: the :class:`WindowCoalescer` merges concurrent jobs'
  windows into one fused dispatch per pass (docs/SERVING.md
  "Continuous batching & quotas").
* :mod:`adam_tpu_torch.serve.quota` — per-tenant rolling-window byte/compute
  budgets, surfaced as the gateway's typed 429 quota leg.

The thin front-ends live next door: ``adam_tpu/api/transform_service``
is the library submission seam, ``adam-tpu serve`` the CLI one.

The port's copy of ``adam_tpu/serve/__init__.py``.
"""

from adam_tpu_torch.serve.batching import WindowCoalescer, batching_enabled
from adam_tpu_torch.serve.fairness import WeightedInterleaver
from adam_tpu_torch.serve.quota import QuotaManager
from adam_tpu_torch.serve.job import (
    DONE,
    INTERRUPTED,
    PENDING,
    QUARANTINED,
    RUNNING,
    Admitted,
    Busy,
    JobSpec,
)
from adam_tpu_torch.serve.scheduler import JobScheduler, default_job_retries

__all__ = [
    "Admitted",
    "Busy",
    "DONE",
    "INTERRUPTED",
    "JobScheduler",
    "JobSpec",
    "PENDING",
    "QUARANTINED",
    "QuotaManager",
    "RUNNING",
    "WeightedInterleaver",
    "WindowCoalescer",
    "batching_enabled",
    "default_job_retries",
]
