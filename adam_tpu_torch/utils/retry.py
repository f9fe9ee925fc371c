"""Tuning-variable parsing (the port's copy of ``env_toggle`` from
``adam_tpu/utils/retry.py``, the JAX package's parser for its
``ADAM_TPU_*`` on/off knobs)."""

from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)


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
