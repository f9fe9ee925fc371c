"""Phred quality <-> probability (the port's counterpart of
``adam_tpu/ops/phred.py``, util/PhredUtils.scala): 256-entry f64 tables
(so Q40+ stays exact) gathered on the tensors' device, and the reference's
round(-10 log10 p) back to phred."""

import numpy as np
import torch

PHRED_TO_ERROR = 10.0 ** (-np.arange(256) / 10.0)
PHRED_TO_SUCCESS = 1.0 - PHRED_TO_ERROR


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _gather(table: np.ndarray, phred) -> torch.Tensor:
    q = _as_tensor(phred)
    t = torch.from_numpy(table).to(q.device)
    return t[torch.clamp(q.long(), 0, 255)]


def phred_to_error_probability(phred) -> torch.Tensor:
    """phred (integers) -> error probability, f64."""
    return _gather(PHRED_TO_ERROR, phred)


def phred_to_success_probability(phred) -> torch.Tensor:
    return _gather(PHRED_TO_SUCCESS, phred)


def error_probability_to_phred(p) -> torch.Tensor:
    """error probability -> phred i32, rounded as the reference rounds
    (Scala's math.round: floor(x + 0.5), not banker's rounding).  The
    cast saturates as XLA's does: p = 0 gives the largest i32, NaN 0."""
    p = _as_tensor(p).to(torch.float64)
    x = torch.floor(-10.0 * torch.log10(p) + 0.5)
    x = torch.nan_to_num(x, nan=0.0).clamp(-2.0**31, 2.0**31 - 1)
    return x.to(torch.int32)


def success_probability_to_phred(p) -> torch.Tensor:
    return error_probability_to_phred(1.0 - _as_tensor(p).to(torch.float64))
