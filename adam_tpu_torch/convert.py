"""State carried across from the JAX package.

This system has no weights: its state is the input batch and the solved
recalibration table.  Both cross as numpy arrays, so a test (or a user
moving a run between the two packages) can feed the same data to each.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from adam_tpu_torch.formats.batch import ReadBatch

_DTYPES = {
    "bases": np.uint8, "quals": np.uint8, "lengths": np.int32,
    "flags": np.int32, "contig_idx": np.int32, "start": np.int64,
    "end": np.int64, "mapq": np.int32, "cigar_ops": np.uint8,
    "cigar_lens": np.int32, "cigar_n": np.int32, "mate_contig_idx": np.int32,
    "mate_start": np.int64, "tlen": np.int32, "read_group_idx": np.int32,
    "has_qual": np.bool_, "valid": np.bool_,
}


def batch_from_numpy(arrays: Mapping[str, np.ndarray]) -> ReadBatch:
    """The numpy fields of a JAX ``ReadBatch`` (e.g. ``{f: getattr(b, f)}``
    of ``jax.tree.map(np.asarray, batch)``) -> the port's host batch.
    Every field must be present with the JAX package's dtype."""
    missing = set(_DTYPES) - set(arrays)
    if missing:
        raise ValueError(f"batch fields missing: {sorted(missing)}")
    out = {}
    for name, dt in _DTYPES.items():
        a = np.asarray(arrays[name])
        if a.dtype != dt:
            raise ValueError(f"field {name}: dtype {a.dtype}, expected {np.dtype(dt)}")
        out[name] = np.ascontiguousarray(a)
    return ReadBatch(**out)


def table_from_numpy(table: np.ndarray) -> torch.Tensor:
    """A solved recalibration table ``[n_rg, 94, n_cyc, 17]`` (as the JAX
    run journal's ``table.npz`` stores it) -> a CPU u8 tensor.

    As in the JAX package, the table is cast to u8 whatever its stored
    dtype, and its cycle axis may have any width: the apply takes its
    centre ``gl = (n_cyc - 1) // 2`` from the table's own shape, so a
    ``gl`` stored beside the table is not read."""
    from adam_tpu_torch.pipelines.bqsr import N_DINUC, N_QUAL

    t = np.ascontiguousarray(table, np.uint8)
    if t.ndim != 4 or t.shape[1] != N_QUAL or t.shape[3] != N_DINUC:
        raise ValueError(
            f"table must be [n_rg, {N_QUAL}, n_cyc, {N_DINUC}], got {list(t.shape)}"
        )
    return torch.from_numpy(t)
