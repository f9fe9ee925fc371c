"""The dataset handle: a read batch, its sidecar and its header
(the counterpart of ``adam_tpu/api/datasets.AlignmentDataset``, with the
pieces the streamed transform uses)."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import TYPE_CHECKING, Optional

import numpy as np

from adam_tpu_torch.formats.batch import ReadBatch, ReadSidecar

if TYPE_CHECKING:  # avoid an io <-> api import cycle at run time
    from adam_tpu_torch.io.sam import SamHeader


@dataclass
class AlignmentDataset:
    batch: ReadBatch
    sidecar: ReadSidecar
    header: "SamHeader"

    def __len__(self) -> int:
        return self.batch.n_valid()

    @property
    def seq_dict(self):
        return self.header.seq_dict

    @property
    def read_groups(self):
        return self.header.read_groups

    def with_batch(
        self, batch: ReadBatch, sidecar: Optional[ReadSidecar] = None
    ) -> "AlignmentDataset":
        return replace(
            self, batch=batch,
            sidecar=sidecar if sidecar is not None else self.sidecar,
        )

    def take_rows(self, idx) -> "AlignmentDataset":
        idx = np.asarray(idx)
        return replace(
            self, batch=self.batch.to_numpy().take(idx),
            sidecar=self.sidecar.take(idx),
        )

    @staticmethod
    def concat(parts: list["AlignmentDataset"]) -> "AlignmentDataset":
        """Splice datasets sharing a header (window reassembly)."""
        if not parts:
            from adam_tpu_torch.io.sam import SamHeader

            return AlignmentDataset(ReadBatch.empty(), ReadSidecar(), SamHeader())
        if len(parts) == 1:
            return parts[0]
        return AlignmentDataset(
            ReadBatch.concat([p.batch for p in parts]),
            ReadSidecar.concat([p.sidecar for p in parts]),
            parts[0].header,
        )

    def realign_indels(self, **kw) -> "AlignmentDataset":
        from adam_tpu_torch.pipelines.realign import realign_indels

        return realign_indels(self, **kw)
