"""The dataset handle: a read batch, its sidecar and its header
(the minimal counterpart of ``adam_tpu/api/datasets.AlignmentDataset``)."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import TYPE_CHECKING, Optional

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
