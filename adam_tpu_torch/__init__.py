"""adam_tpu_torch — the PyTorch/CUDA port of ``adam_tpu``.

The JAX package (``adam_tpu``) stays the reference; this package is its
counterpart for an NVIDIA H100, written with PyTorch for the tensor code
and hand-written CUDA C++ (``csrc/``) for the kernels that ``adam_tpu``
wrote in Pallas for the TPU.  It imports ``torch`` and never ``jax`` or
anything of ``adam_tpu``: the host-side modules it needs are copied and
adapted here, in the same sub-package layout, so each module's
counterpart is easy to find.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; see :mod:`adam_tpu_torch.device`.
"""

import os

# pyarrow's bundled mimalloc crashes (a segfault in a later arrow call)
# once short-lived threads that allocated through it have exited — the
# shape of the streamed transform's writer pool.  Pin the system
# allocator before pyarrow initializes; io/parquet.py repeats this with
# set_memory_pool for processes that imported pyarrow first.
os.environ.setdefault("ARROW_DEFAULT_MEMORY_POOL", "system")

__version__ = "0.1.0"
