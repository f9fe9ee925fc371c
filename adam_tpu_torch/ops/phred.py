"""Phred quality -> error probability (``adam_tpu/ops/phred.py``'s
constant table; f64 so Q40+ stays exact)."""

import numpy as np

PHRED_TO_ERROR = 10.0 ** (-np.arange(256) / 10.0)
