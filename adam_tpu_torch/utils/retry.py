"""Tuning-variable parsing (the port's copies of ``env_float``,
``env_toggle`` and ``_env_int`` from ``adam_tpu/utils/retry.py``, the JAX
package's parsers for its ``ADAM_TPU_*`` knobs)."""

from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)


def env_float(name: str, default: float) -> float:
    """Tolerantly parsed float env var (warn + default on a typo)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        log.warning("%s=%r is not a float; using default %s", name, raw,
                    default)
        return default


def env_toggle(name: str, default: bool) -> bool:
    """Tolerantly parsed boolean env toggle: ``auto``/unset ->
    ``default``; ``1/on/true`` and ``0/off/false`` force; anything else
    warns (naming the accepted set) and keeps the default."""
    raw = os.environ.get(name, "").strip().lower()
    if raw in ("", "auto"):
        return default
    if raw in ("1", "on", "true"):
        return True
    if raw in ("0", "off", "false"):
        return False
    log.warning(
        "%s=%r is not one of (auto, 0/off/false, 1/on/true); using the "
        "default", name, raw,
    )
    return default


def _env_int(name: str, default: int) -> int:
    """Tolerantly parsed positive int env var (warn + default on a
    typo; a value below 1 keeps the default)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        v = int(raw)
        return v if v >= 1 else default
    except ValueError:
        log.warning("%s=%r is not a positive int; using default %s", name,
                    raw, default)
        return default
