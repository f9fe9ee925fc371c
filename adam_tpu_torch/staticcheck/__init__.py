"""``python -m adam_tpu_torch check`` — the AST-based contract checker of
the port (the counterpart of ``adam_tpu/staticcheck/``).

The port rests on conventions no compiler enforces: every device->host
fetch crosses in ``utils/transfer.device_fetch`` (or the d2h ledger
under-counts and the fetch deadline, retry and fault point miss it),
every dispatch of the streamed path sits under ``compile_ledger.track``
keyed like a prewarm entry, a hand kernel is reached only through the
counting ``ops/kernels.launch``, every durability-bearing publish goes
through ``utils/durability``, every fault-injection site names a
``faults.KNOWN_POINTS`` member, shared mutable state in thread-spawning
modules stays behind its lock, and a window's bases/quals go to the card
once, at ingest.  This package turns each convention into a static rule
over the Python AST (docs/STATIC_ANALYSIS.md describes the JAX package's
rules, which these follow).  It imports neither torch nor numpy.

Entry points: ``python -m adam_tpu_torch check`` (the CLI verb) and
``python -m adam_tpu_torch.staticcheck``.
"""

from adam_tpu_torch.staticcheck.core import (  # noqa: F401
    EXIT_CLEAN,
    EXIT_ERROR,
    EXIT_FINDINGS,
    Finding,
    Project,
    Report,
    Rule,
    all_rules,
    register,
    run_checks,
)

__all__ = [
    "EXIT_CLEAN", "EXIT_FINDINGS", "EXIT_ERROR",
    "Finding", "Project", "Report", "Rule",
    "all_rules", "register", "run_checks",
]
