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

__version__ = "0.1.0"
