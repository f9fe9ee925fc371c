"""The Spark embedding executor: the per-partition kernel server (the
port's counterpart of ``adam_tpu/api/spark_executor.py``).

A Spark pipeline uses this process as a backend inside
``mapPartitions``: each executor ships its partition across the Arrow
seam, the stages run here on the card, and the marked, realigned and
recalibrated records stream back.

Protocol (one process per executor, ``transform -backend spark - -``):

* stdin: one Arrow IPC stream; each record batch is one partition in
  the AlignmentRecord column layout (``io/parquet.to_arrow_alignments``).
* stdout: one Arrow IPC stream with exactly one batch per input
  partition, in order, and nothing else; zero partitions still give a
  valid, empty stream.
* stderr: logs, and the CLI's stats line.

Stages see one partition at a time, as Spark's ``mapPartitions`` has
it: a duplicate pair that spans two partitions is not resolved, exactly
as in the JAX package.  Within a partition they run in the reference
Transform order: duplicate marking, indel realignment, BQSR.  Nothing
carries from one partition to the next: each stage builds its targets,
masks and tables from the partition alone.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import BinaryIO, Optional


@dataclass
class StageConfig:
    """Every stage is opt-in, matching the reference Transform flags;
    the stages run on ``device`` (default: the card)."""

    mark_duplicates: bool = False
    recalibrate: bool = False
    realign: bool = False
    known_snps: object = None
    known_indels: object = None
    consensus_model: str = "reads"
    device: str = "cuda"


def apply_stages(ds, cfg: StageConfig, stats: Optional[dict] = None):
    """markdup -> realign -> BQSR over one dataset (Transform.scala's
    composition).  ``stats``, when given, accumulates each stage's wall
    in seconds (``mark_duplicates_s``, ``realign_indels_s``, ``bqsr_s``)."""
    stats = {} if stats is None else stats

    def timed(key, fn, ds):
        t0 = time.monotonic()
        out = fn(ds)
        stats[key] = stats.get(key, 0.0) + time.monotonic() - t0
        return out

    if cfg.mark_duplicates:
        ds = timed("mark_duplicates_s",
                   lambda d: d.mark_duplicates(device=cfg.device), ds)
    if cfg.realign:
        kw = {}
        if cfg.known_indels is not None:
            kw = dict(consensus_model="knowns", known_indels=cfg.known_indels)
        elif cfg.consensus_model != "reads":
            kw = dict(consensus_model=cfg.consensus_model)
        ds = timed("realign_indels_s",
                   lambda d: d.realign_indels(device=cfg.device, **kw), ds)
    if cfg.recalibrate:
        ds = timed("bqsr_s", lambda d: d.recalibrate_base_qualities(
            known_snps=cfg.known_snps, device=cfg.device), ds)
    return ds


def _empty_schema():
    from adam_tpu_torch.formats.batch import ReadBatch, ReadSidecar
    from adam_tpu_torch.io.parquet import to_arrow_alignments
    from adam_tpu_torch.io.sam import SamHeader

    return to_arrow_alignments(ReadBatch.empty(), ReadSidecar(), SamHeader()).schema


def serve(cfg: StageConfig, inp: Optional[BinaryIO] = None,
          outp: Optional[BinaryIO] = None, stats: Optional[dict] = None) -> int:
    """Drain an Arrow IPC stream of partitions, transform each, stream the
    results back -> the number of partitions served.  ``stats``, when
    given, receives the counts and walls: ``n_partitions``, ``n_reads``
    (rows in), ``n_rows_out``, ``read_s`` (stream read and
    ``from_arrow``), the stage walls of :func:`apply_stages`, and
    ``write_s`` (``to_arrow`` and the stream write)."""
    import pyarrow as pa

    from adam_tpu_torch.api.datasets import AlignmentDataset
    from adam_tpu_torch.device import resolve_device

    resolve_device(cfg.device)
    stats = {} if stats is None else stats
    for key in ("n_partitions", "n_reads", "n_rows_out"):
        stats.setdefault(key, 0)
    for key in ("read_s", "write_s"):
        stats.setdefault(key, 0.0)
    inp = inp if inp is not None else sys.stdin.buffer
    outp = outp if outp is not None else sys.stdout.buffer
    t0 = time.monotonic()
    reader = pa.ipc.open_stream(inp)
    writer = None
    served = 0
    try:
        for rb in reader:
            ds = AlignmentDataset.from_arrow(rb)
            t1 = time.monotonic()
            stats["read_s"] += t1 - t0
            stats["n_reads"] += rb.num_rows
            ds = apply_stages(ds, cfg, stats)
            t2 = time.monotonic()
            table = ds.compact().to_arrow().combine_chunks()
            # an empty table has no batch to take: build it from the
            # (combined, empty) columns
            out_rb = (
                table.to_batches()[0]
                if table.num_rows
                else pa.record_batch([c.combine_chunks() for c in table.columns],
                                     schema=table.schema)
            )
            if writer is None:
                writer = pa.ipc.new_stream(outp, out_rb.schema)
            writer.write_batch(out_rb)
            served += 1
            stats["n_rows_out"] += out_rb.num_rows
            t0 = time.monotonic()
            stats["write_s"] += t0 - t2
    finally:
        if writer is None:
            # zero partitions: still a valid (empty) stream, so that the
            # driver's open_stream on the reply pipe succeeds
            writer = pa.ipc.new_stream(outp, _empty_schema())
        writer.close()
        outp.flush()
    stats["n_partitions"] += served
    return served
