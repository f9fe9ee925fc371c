"""The port's device rule: the card unless the caller asks for the CPU.

Every entry point takes a ``device`` argument (default ``"cuda"``).
``"cpu"`` is the only way onto the CPU: asking for ``"cuda"`` on a
machine without a usable card raises instead of carrying on quietly on
the CPU, so a run that reports itself as a device run always was one.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` (default ``"cuda"``) -> a ``torch.device``.

    Raises ``RuntimeError`` for a CUDA device when CUDA is unavailable,
    and ``ValueError`` for any device type other than ``cuda``/``cpu``.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(
            f"device {str(dev)!r}: adam_tpu_torch runs on 'cuda' or 'cpu'"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_key(dev: torch.device) -> str:
    """A device's telemetry key: the CUDA index (``"0"``), as the JAX
    package keys a device by its id, so ``device=<k>`` span attributes
    and the heartbeat's HBM samples name a card alike; ``"cpu"`` for the
    CPU."""
    if dev.type == "cuda":
        return str(dev.index if dev.index is not None else torch.cuda.current_device())
    return dev.type
