"""Device-resident windows — the counterpart of
``adam_tpu/parallel/device_pool.ResidentWindow`` (one device; the
multi-device pool is not ported yet).

Each window's bases, quals, lengths, flags and read-group index go to the
device once, at ingest, padded to the window's ``[g, gl]`` grid; pass A
(markdup keys), pass B (observe) and pass C (apply + pack) all read them
from here, so the later passes ship only their per-pass inputs (the
bit-packed MD masks, the post-barrier ``read_ok``/``has_qual``/``valid``
bools).  The duplicate flags resolved at barrier 1 change only the host
batch: the device kernels read ``flags`` solely for the orientation bits,
which duplicate marking never touches.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from adam_tpu_torch.formats import schema
from adam_tpu_torch.formats.batch import grid_cols, grid_rows, pad_rows_np


@dataclass
class ResidentWindow:
    bases: torch.Tensor           # u8[g, gl]
    quals: torch.Tensor           # u8[g, gl]
    lengths: torch.Tensor         # i32[g]
    flags: torch.Tensor           # i32[g]
    read_group_idx: torch.Tensor  # i32[g]
    g: int
    gl: int

    @property
    def device(self) -> torch.device:
        return self.bases.device

    def args(self) -> tuple:
        """The five resident tensors, in kernel-argument order."""
        return (self.bases, self.quals, self.lengths, self.flags,
                self.read_group_idx)

    @staticmethod
    def place(b, device) -> "ResidentWindow":
        """Pad host batch ``b`` to its grid and copy it to ``device``."""
        g = grid_rows(b.n_rows)
        gl = grid_cols(b.lmax)

        def put(arr, fill, cols=None):
            return torch.from_numpy(pad_rows_np(arr, g, fill, cols=cols)).to(device)

        return ResidentWindow(
            bases=put(b.bases, schema.BASE_PAD, gl),
            quals=put(b.quals, schema.QUAL_PAD, gl),
            lengths=put(b.lengths, 0),
            flags=put(b.flags, schema.FLAG_UNMAPPED),
            read_group_idx=put(b.read_group_idx, -1),
            g=g, gl=gl,
        )
