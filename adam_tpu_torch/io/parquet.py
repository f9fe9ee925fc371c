"""Parquet part writing — the part-writer subset of
``adam_tpu/io/parquet.py``.

The on-disk format is the JAX package's: the AlignmentRecord field
layout, the header dictionaries as JSON under the schema metadata key
``b"adam_tpu.header"``, zstd at level 1, and the Spark executor
``part-r-NNNNN.parquet`` naming where the number is the window index.
Each part is written under ``<out>/_temporary/`` and published by an
fsync'd atomic rename, so readers never see a torn part.  pyarrow is
imported only inside the functions that write.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from adam_tpu_torch.formats import schema
from adam_tpu_torch.formats.batch import ReadBatch, ReadSidecar
from adam_tpu_torch.io.sam import SamHeader

TMP_DIR_NAME = "_temporary"
PART_NAME_FORMAT = "part-r-{:05d}.parquet"


def part_path(out_dir: str, idx: int) -> str:
    return os.path.join(out_dir, PART_NAME_FORMAT.format(idx))


def purge_stale_staging(out_dir: str) -> None:
    """Remove a previous (crashed) run's staging dir under ``out_dir``;
    call once at startup, before any writer is live."""
    stale = os.path.join(out_dir, TMP_DIR_NAME)
    if os.path.isdir(stale):
        shutil.rmtree(stale, ignore_errors=True)


def _staging_path(path: str) -> str:
    tmp_dir = os.path.join(os.path.dirname(os.path.abspath(path)), TMP_DIR_NAME)
    os.makedirs(tmp_dir, exist_ok=True)
    return os.path.join(tmp_dir, os.path.basename(path) + ".tmp")


def parquet_codec_kw(compression: str) -> dict:
    """Writer kwargs for a codec name (zstd pinned at level 1)."""
    kw = {"compression": compression}
    if compression == "zstd":
        kw["compression_level"] = 1
    return kw


def _header_meta(header: SamHeader) -> dict[bytes, bytes]:
    meta = {
        "sequences": [
            {"name": r.name, "length": r.length, "md5": r.md5, "url": r.url}
            for r in header.seq_dict
        ],
        "read_groups": [
            {"name": g.name, "sample": g.sample, "library": g.library,
             "platform": g.platform, "platform_unit": g.platform_unit}
            for g in header.read_groups
        ],
        "programs": header.program_lines,
        "comments": header.comment_lines,
        "hd": header.hd_line,
    }
    return {b"adam_tpu.header": json.dumps(meta).encode()}


def to_arrow_alignments(batch: ReadBatch, side: ReadSidecar,
                        header: SamHeader, packed=None):
    """Host batch -> arrow Table in the AlignmentRecord field layout.

    ``packed`` (an :class:`~adam_tpu_torch.io.arrow_pack.PackedColumns`,
    pass C's device-packed payload) supplies the ``qual`` and
    ``sequence`` columns; without it (a run that did not recalibrate)
    both are encoded from the batch's matrices.  Either way the bytes
    are the JAX package's."""
    import pyarrow as pa

    from adam_tpu_torch import native
    from adam_tpu_torch.formats.strings import StringColumn
    from adam_tpu_torch.io.arrow_pack import (
        index_name_array, packed_base_array, packed_qual_array,
    )

    b = batch.to_numpy()
    valid = np.asarray(b.valid)
    if not valid.all():
        rows = np.flatnonzero(valid)
        b = ReadBatch(**{k: np.asarray(v)[rows] for k, v in b.arrays().items()})
        side = side.take(rows)
        if packed is not None:
            packed = packed.take(rows)
    n = b.n_rows

    def masked_int(vals, dtype):
        vals = np.asarray(vals)
        return pa.array(vals, dtype, mask=vals < 0)

    def decoded_col(mat, lut256, col_valid):
        lens = np.where(col_valid, np.asarray(b.lengths), 0)
        buf, off = native.lut_compact_rows(mat, lens, lut256)
        return StringColumn(buf, off, col_valid).to_arrow()

    if packed is not None:
        sequence = packed_base_array(packed.bases)
        qual = packed_qual_array(packed.quals, np.asarray(b.has_qual))
    else:
        sequence = decoded_col(b.bases, schema.BASE_DECODE_LUT256, np.ones(n, bool))
        qual = decoded_col(b.quals, schema.QUAL_SANGER_LUT256, np.asarray(b.has_qual))
    cig_buf, cig_off = native.cigar_strings(b.cigar_ops, b.cigar_lens, b.cigar_n)
    table = pa.table(
        {
            "readName": StringColumn.of(side.names).to_arrow(),
            "sequence": sequence,
            "qual": qual,
            "flags": pa.array(np.asarray(b.flags, np.int32), pa.int32()),
            "contig": index_name_array(b.contig_idx, header.seq_dict.names),
            "start": masked_int(b.start, pa.int64()),
            "end": masked_int(b.end, pa.int64()),
            "mapq": pa.array(np.asarray(b.mapq, np.int32), pa.int32()),
            "cigar": StringColumn(cig_buf, cig_off).to_arrow(),
            "mateContig": index_name_array(
                b.mate_contig_idx, header.seq_dict.names
            ),
            "mateAlignmentStart": masked_int(b.mate_start, pa.int64()),
            "inferredInsertSize": pa.array(
                np.asarray(b.tlen, np.int32), pa.int32()
            ),
            "recordGroupName": index_name_array(
                b.read_group_idx, header.read_groups.names
            ),
            "attributes": StringColumn.of(side.attrs).to_arrow(),
            "mismatchingPositions": StringColumn.of(side.md).to_arrow(),
            "origQual": StringColumn.of(side.orig_quals).to_arrow(),
            "basesTrimmedFromStart": pa.array(
                np.asarray(side.trimmed_from_start, np.int32), pa.int32()
            ),
            "basesTrimmedFromEnd": pa.array(
                np.asarray(side.trimmed_from_end, np.int32), pa.int32()
            ),
        }
    )
    return table.replace_schema_metadata(_header_meta(header))


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_part(table, path: str, compression: str) -> None:
    """Write one encoded part: staging file, fsync, atomic rename, fsync
    of the directory."""
    import pyarrow.parquet as pq

    tmp = _staging_path(path)
    try:
        # dictionary-encode only the low-cardinality name columns
        pq.write_table(
            table, tmp,
            use_dictionary=["contig", "mateContig", "recordGroupName"],
            **parquet_codec_kw(compression),
        )
        _fsync_path(tmp)
        os.replace(tmp, path)
        _fsync_path(os.path.dirname(os.path.abspath(path)))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class PartWriterPool:
    """The streamed pipeline's pass-C sink: encoder threads turn a window
    into an arrow table, one write thread compresses and publishes it.
    At most ``INFLIGHT_PARTS`` parts are alive in the pool (the producer
    blocks in :meth:`submit`), which bounds memory in decoded windows.
    The first worker failure fails later submits and re-raises from
    :meth:`close`."""

    N_ENCODERS = 2
    INFLIGHT_PARTS = 3

    def __init__(self, compression: str = "zstd"):
        import pyarrow as pa

        # the system allocator, not pyarrow's mimalloc: see
        # adam_tpu_torch/__init__.py (pyarrow may have been imported first)
        pa.set_memory_pool(pa.system_memory_pool())
        self._enc = ThreadPoolExecutor(self.N_ENCODERS)
        self._io = ThreadPoolExecutor(1)
        self._gate = threading.Semaphore(self.INFLIGHT_PARTS)
        self._compression = compression
        self._futures: list = []
        self._failed: BaseException | None = None
        self._fail_lock = threading.Lock()
        self._staging_dirs: set = set()

    def _record_failure(self, e: BaseException) -> None:
        with self._fail_lock:
            if self._failed is None:
                self._failed = e

    def submit(self, path: str, batch: ReadBatch, side: ReadSidecar,
               header: SamHeader, packed=None) -> None:
        if self._failed is not None:
            raise RuntimeError(
                f"PartWriterPool worker already failed; aborting submit of {path}"
            ) from self._failed
        self._staging_dirs.add(
            os.path.join(os.path.dirname(os.path.abspath(path)), TMP_DIR_NAME)
        )

        def write(table):
            try:
                write_part(table, path, self._compression)
            except BaseException as e:
                self._record_failure(e)
                raise
            finally:
                self._gate.release()

        def encode():
            try:
                table = to_arrow_alignments(batch, side, header, packed=packed)
                return self._io.submit(write, table)
            except BaseException as e:
                self._record_failure(e)
                self._gate.release()
                raise

        self._gate.acquire()
        try:
            self._futures.append(self._enc.submit(encode))
        except BaseException:
            self._gate.release()
            raise

    def _discard_staging(self) -> None:
        for d in self._staging_dirs:
            shutil.rmtree(d, ignore_errors=True)

    def close(self, abort: bool = False) -> None:
        """Drain both stages; re-raise the first worker error.  With
        ``abort=True`` (the producer is unwinding from its own error)
        drain, discard staging files, and raise nothing."""
        errs = []
        for f in self._futures:
            try:
                f.result().result()
            except BaseException as e:
                errs.append(e)
        self._enc.shutdown()
        self._io.shutdown()
        first = self._failed or (errs[0] if errs else None)
        if abort or first is not None:
            self._discard_staging()
        else:
            # published parts leave the staging dir empty
            for d in self._staging_dirs:
                try:
                    os.rmdir(d)
                except OSError:
                    pass
        if first is not None and not abort:
            raise first
