"""Validation stringency (copied from ``adam_tpu/utils/validation.py``).

The FASTQ pairing and export paths take htsjdk's ValidationStringency:
STRICT raises on malformed input, LENIENT logs and carries on, SILENT
carries on quietly.
"""

from __future__ import annotations

import enum
import logging

logger = logging.getLogger("adam_tpu.validation")


class ValidationStringency(enum.Enum):
    STRICT = "strict"
    LENIENT = "lenient"
    SILENT = "silent"

    @staticmethod
    def of(v) -> "ValidationStringency":
        if isinstance(v, ValidationStringency):
            return v
        return ValidationStringency(str(v).lower())


def handle(stringency, message: str, exc_type=ValueError) -> None:
    """STRICT: raise; LENIENT: warn; SILENT: nothing."""
    s = ValidationStringency.of(stringency)
    if s is ValidationStringency.STRICT:
        raise exc_type(message)
    if s is ValidationStringency.LENIENT:
        logger.warning(message)
