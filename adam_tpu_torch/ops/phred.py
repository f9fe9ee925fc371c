"""Phred quality -> error and success probability (``adam_tpu/ops/phred.py``'s
constant tables; f64 so Q40+ stays exact)."""

import numpy as np

PHRED_TO_ERROR = 10.0 ** (-np.arange(256) / 10.0)
PHRED_TO_SUCCESS = 1.0 - PHRED_TO_ERROR
