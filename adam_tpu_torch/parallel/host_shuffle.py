"""Host-side out-of-core genome shuffle — the port of
``adam_tpu/parallel/host_shuffle.py``.

Streams columnar batches (from the windowed SAM/BAM reader), routes every
read to its genome-bin shard with the cumulative-offset partitioner, and
appends each shard's rows to its own store: the raw Arrow IPC spill of
``parallel/spill.py`` or a Parquet file of the interchange schema.  Only
one streamed batch is resident at a time.

The shard key is the 5'-clipped position, computed on ``device`` by
``ops/cigar.five_prime_position`` (integer work, exact against the JAX
package's host walk) and fetched for the host partitioner.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator

import numpy as np
import torch

from adam_tpu_torch.parallel.partitioner import position_partition


def five_prime_positions(b, device) -> np.ndarray:
    """i64[N] 5'-clipped position of each row of host batch ``b``,
    computed on ``device``."""
    from adam_tpu_torch.ops import cigar as cigar_ops

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    # adam-tpu: noqa[host-sync] reason=the JAX package's shuffle computes the 5' positions on the host (no device work, no fetch to route); one i64 vector per streamed batch
    return cigar_ops.five_prime_position(
        put(b.start), put(b.end), put(b.flags), put(b.cigar_ops),
        put(b.cigar_lens), put(b.cigar_n),
    ).cpu().numpy()


def shuffle_alignments_to_shards(batches: Iterable, n_shards: int, out_dir: str,
                                 compression: str = "zstd", fmt: str = "parquet",
                                 device="cuda") -> list[str]:
    """Stream (batch, sidecar, header) triples into per-genome-bin shards
    -> the ordered shard paths (``shard-00000.adam`` ... then
    ``shard-unmapped.adam`` when unplaced reads exist; ``.arrows`` with
    ``fmt="raw"``).  Rows keep their input order inside a shard."""
    import pyarrow.parquet as pq

    from adam_tpu_torch.device import resolve_device
    from adam_tpu_torch.io.parquet import parquet_codec_kw, to_arrow_alignments
    from adam_tpu_torch.parallel import spill

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    writers: dict[int, object] = {}
    paths: dict[int, str] = {}
    raw = fmt == "raw"

    def shard_path(s: int) -> str:
        ext = "arrows" if raw else "adam"
        name = f"shard-{s:05d}.{ext}" if s < n_shards else f"shard-unmapped.{ext}"
        return os.path.join(out_dir, name)

    try:
        for batch, side, header in batches:
            b = batch.to_numpy()
            valid = np.asarray(b.valid)
            # the 5'-CLIPPED position decides the bin, not `start`
            # (rich/RichAlignmentRecord.scala:104-126): the PCR duplicates
            # of one fragment co-locate whatever each copy's clipping, so
            # each shard's duplicate groups are whole
            five = five_prime_positions(b, dev)
            part = position_partition(header.seq_dict, b.contig_idx,
                                      np.maximum(five, 0), n_shards)
            for s in np.unique(part[valid]):
                rows = np.flatnonzero(valid & (part == s))
                sub, sub_side = b.take(rows), side.take(rows)
                s = int(s)
                if raw:
                    if s not in writers:
                        paths[s] = shard_path(s)
                        writers[s] = spill.RawShardWriter(paths[s])
                    writers[s].append(sub, sub_side, header)
                    continue
                table = to_arrow_alignments(sub, sub_side, header)
                if s not in writers:
                    paths[s] = shard_path(s)
                    writers[s] = pq.ParquetWriter(paths[s], table.schema,
                                                  **parquet_codec_kw(compression))
                writers[s].write_table(table)
    finally:
        for w in writers.values():
            w.close()
    return [paths[s] for s in sorted(paths)]


def shuffle_bam_to_shards(bam_path: str, n_shards: int, out_dir: str,
                          batch_reads: int = 500_000, compression: str = "zstd",
                          device="cuda") -> list[str]:
    """Windowed BAM reader -> genome-bin Parquet shards, out of core end
    to end."""
    from adam_tpu_torch.io.sam import iter_bam_batches

    return shuffle_alignments_to_shards(
        iter_bam_batches(bam_path, batch_reads=batch_reads), n_shards, out_dir,
        compression=compression, device=device)


def iter_shards(paths: Iterable[str]) -> Iterator:
    """Load shards one at a time -> (ReadBatch, ReadSidecar, SamHeader):
    an ``.arrows`` raw spill or a Parquet shard."""
    from adam_tpu_torch.io.parquet import load_alignments
    from adam_tpu_torch.parallel import spill

    for p in paths:
        if str(p).endswith(".arrows"):
            yield spill.read_raw_shard(p)
        else:
            yield load_alignments(p)
