"""Sort reads by reference position (copied from
``adam_tpu/pipelines/sort.py``).

Semantics of the reference's ``adamSortReadsByReferencePosition``: mapped
reads order by (referenceName, start) with reference names compared
lexicographically; unmapped reads (the FLAG bit, so placed-unmapped reads
too) sort after every mapped read, ordered by read name.  Both sorts are
stable.  As in the JAX package, the keys are packed and sorted on the
host: contig names become lexicographic ranks, each mapped read one i64
key (:func:`~adam_tpu_torch.models.positions.pack_position_key`).
"""

from __future__ import annotations

import numpy as np

from adam_tpu_torch.api.datasets import AlignmentDataset
from adam_tpu_torch.formats import schema
from adam_tpu_torch.models.positions import pack_position_key


def sort_keys(ds: AlignmentDataset) -> np.ndarray:
    """Permutation that coordinate-sorts the dataset's valid rows."""
    b = ds.batch.to_numpy()
    names = ds.seq_dict.names
    # lexicographic rank of each contig index
    order = (np.argsort(np.array(names, dtype=object), kind="stable") if names
             else np.array([], np.int64))
    rank_of = np.empty(max(len(names), 1), dtype=np.int64)
    rank_of[order] = np.arange(len(names)) if len(names) else 0

    contig = np.asarray(b.contig_idx)
    mapped = (
        ((np.asarray(b.flags) & schema.FLAG_UNMAPPED) == 0)
        & (contig >= 0)
        & np.asarray(b.valid)
    )
    ranks = np.where(mapped, rank_of[np.clip(contig, 0, max(len(names) - 1, 0))],
                     len(names))
    keys = pack_position_key(ranks.astype(np.int32), np.where(mapped, b.start, 0))

    rows = np.flatnonzero(np.asarray(b.valid))
    mapped_rows = rows[mapped[rows]]
    unmapped_rows = rows[~mapped[rows]]
    mapped_sorted = mapped_rows[np.argsort(keys[mapped_rows], kind="stable")]
    name_arr = np.array([ds.sidecar.names[i] for i in unmapped_rows], dtype=object)
    unmapped_sorted = unmapped_rows[np.argsort(name_arr, kind="stable")]
    return np.concatenate([mapped_sorted, unmapped_sorted])


def sort_by_reference_position(ds: AlignmentDataset) -> AlignmentDataset:
    return ds.take_rows(sort_keys(ds))
