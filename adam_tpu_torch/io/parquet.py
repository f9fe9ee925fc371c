"""Parquet storage (copied from ``adam_tpu/io/parquet.py``): the part
writer, the single-file dataset save and the alignment read path, and
the genotype, feature and contig-fragment stores.

The on-disk format is the JAX package's: the AlignmentRecord field
layout, the header dictionaries as JSON under the schema metadata key
``b"adam_tpu.header"``, zstd at level 1, and the Spark executor
``part-r-NNNNN.parquet`` naming where the number is the window index.
Each part is written under ``<out>/_temporary/`` and published by an
fsync'd atomic rename, so readers never see a torn part.  pyarrow is
imported only inside the functions that write or read.

The reader (:func:`load_alignments`) is the inverse of the writer: a
part file or a part directory -> (ReadBatch, ReadSidecar, SamHeader),
with column projection and a pyarrow filter pushed into the read.  The
genotype store is a directory of ``variants.parquet`` and
``genotypes.parquet`` (recognized INFO keys as typed ``ann_*`` columns),
the feature and fragment stores one file each; the genotype and fragment
stores carry the sequence dictionary as JSON under
``b"adam_tpu.seq_dict"``.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from adam_tpu_torch.formats import schema
from adam_tpu_torch.formats.batch import ReadBatch, ReadSidecar
from adam_tpu_torch.io.sam import SamHeader
from adam_tpu_torch.models.dictionaries import (
    RecordGroup,
    RecordGroupDictionary,
    SequenceDictionary,
    SequenceRecord,
)

TMP_DIR_NAME = "_temporary"
#: the part index is the window index (the realigned part is
#: ``n_windows``), recoverable from the name alone, which is how the run
#: journal maps published parts back onto the window plan
PART_NAME_FORMAT = "part-r-{:05d}.parquet"
_PART_NAME_RE = re.compile(r"^part-r-(\d{5,})\.parquet$")


def part_name(idx: int) -> str:
    """The canonical part file name for window/part index ``idx``."""
    return PART_NAME_FORMAT.format(idx)


def part_path(out_dir: str, idx: int) -> str:
    return os.path.join(out_dir, part_name(idx))


def part_index(path: str) -> Optional[int]:
    """The window/part index of a part path, or None when the name is
    not a canonical part file name (staging or sidecar files)."""
    m = _PART_NAME_RE.match(os.path.basename(path))
    return int(m.group(1)) if m else None


#: the full alignment column list, in the Parquet schema's order (the
#: AlignmentRecordField analog; ``formats.fields.ALIGNMENT_FIELDS`` is
#: the same names as a set)
ALIGNMENT_FIELDS = [
    "readName", "sequence", "qual", "flags", "contig", "start", "end",
    "mapq", "cigar", "mateContig", "mateAlignmentStart", "inferredInsertSize",
    "recordGroupName", "attributes", "mismatchingPositions", "origQual",
    "basesTrimmedFromStart", "basesTrimmedFromEnd",
]


def purge_stale_staging(out_dir: str) -> None:
    """Remove a previous (crashed) run's staging dir under ``out_dir``;
    call once at startup, before any writer is live."""
    stale = os.path.join(out_dir, TMP_DIR_NAME)
    if os.path.isdir(stale):
        shutil.rmtree(stale, ignore_errors=True)


def _staging_path(path: str) -> str:
    tmp_dir = os.path.join(os.path.dirname(os.path.abspath(path)), TMP_DIR_NAME)
    # single-level mkdir: a missing parent directory stays an error
    try:
        os.mkdir(tmp_dir)
    except FileExistsError:
        pass
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


def _header_from_meta(meta: dict | None) -> SamHeader:
    """The header a part's schema metadata carries (an empty header when
    it carries none)."""
    if not meta or b"adam_tpu.header" not in meta:
        return SamHeader()
    d = json.loads(meta[b"adam_tpu.header"])
    return SamHeader(
        seq_dict=SequenceDictionary(
            tuple(
                SequenceRecord(s["name"], s["length"], md5=s.get("md5"),
                               url=s.get("url"))
                for s in d["sequences"]
            )
        ),
        read_groups=RecordGroupDictionary(
            tuple(
                RecordGroup(g["name"], sample=g.get("sample"),
                            library=g.get("library"), platform=g.get("platform"),
                            platform_unit=g.get("platform_unit"))
                for g in d["read_groups"]
            )
        ),
        hd_line=d.get("hd"),
        program_lines=d.get("programs", []),
        comment_lines=d.get("comments", []),
    )


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


def _encode_bytes_in(batch, side, packed=None) -> int:
    """Decoded column-payload bytes entering a part encode (the
    ``parquet.encode.bytes_in`` counter): the [N, L]/[N, C] batch
    matrices plus the sidecar's flat string buffers, with the quals (and
    bases) matrix replaced by the device-packed payload when pass C
    shipped one."""
    from adam_tpu_torch.io.arrow_pack import PackedColumns

    packed_bases = None
    if isinstance(packed, PackedColumns):
        packed_bases = packed.bases
        packed = packed.quals
    total = 0
    for name in ("bases", "quals", "cigar_ops", "cigar_lens"):
        arr = getattr(batch, name, None)
        if name == "quals" and packed is not None:
            total += int(getattr(packed.buf, "nbytes", 0))
            continue
        if name == "bases" and packed_bases is not None:
            total += int(getattr(packed_bases.buf, "nbytes", 0))
            continue
        total += int(getattr(arr, "nbytes", 0) or 0)
    for name in ("names", "attrs", "md", "orig_quals"):
        col = getattr(side, name, None)
        buf = getattr(col, "buf", None)
        total += int(getattr(buf, "nbytes", 0) or 0)
    return total


def _count_encode_bytes(tr, batch, side, table, packed=None) -> None:
    from adam_tpu_torch.utils import telemetry as tele

    if not tr.recording:
        return
    tr.count(tele.C_ENCODE_BYTES_IN, _encode_bytes_in(batch, side, packed))
    tr.count(tele.C_ENCODE_BYTES_OUT, int(table.nbytes))


def _count_written(tr, path: str) -> None:
    """The part and byte counters of one published part, on ``tr``."""
    from adam_tpu_torch.utils import telemetry as tele

    if not tr.recording:
        return
    tr.count(tele.C_PARTS_WRITTEN)
    try:
        tr.count(tele.C_BYTES_WRITTEN, os.path.getsize(path))
    except OSError:
        pass


def write_part(table, path: str, compression: str) -> None:
    """Write one encoded part: staging file, then the durable publish
    (fsync, atomic rename, fsync of the directory).  Fault points:
    ``parquet.write`` before the staging write, ``proc.kill`` (phase
    ``write``) once the part is published and before the caller's
    bookkeeping (the journal record), so a resume must tolerate a
    published part the journal does not know of.  The write is timed
    (``Write ADAM Record (part file)``) and spanned (``parquet.part.write``)
    on the global tracer; the callers count the part (:func:`_count_written`)."""
    import pyarrow.parquet as pq

    from adam_tpu_torch.utils import faults
    from adam_tpu_torch.utils import instrumentation as ins
    from adam_tpu_torch.utils import telemetry as tele
    from adam_tpu_torch.utils.durability import publish_file

    tmp = _staging_path(path)
    with ins.TIMERS.time(ins.PARQUET_WRITE), tele.TRACE.span(
        tele.SPAN_PART_WRITE, path=os.path.basename(path)
    ):
        faults.point("parquet.write")
        # claim the staging slot with an empty file first: concurrent
        # writers share the staging directory, and a sibling's rmdir of it
        # (once it is empty, in save_alignments) may land between the
        # mkdir and the write; a non-empty directory survives the rmdir
        while True:
            try:
                with open(tmp, "wb"):
                    pass
                break
            except FileNotFoundError:
                tmp = _staging_path(path)
        try:
            # dictionary-encode only the low-cardinality name columns
            pq.write_table(
                table, tmp,
                use_dictionary=["contig", "mateContig", "recordGroupName"],
                **parquet_codec_kw(compression),
            )
            publish_file(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        faults.point("proc.kill", device="write")


def save_alignments(path: str, batch: ReadBatch, side: ReadSidecar,
                    header: SamHeader, compression: str = "zstd") -> None:
    """The whole dataset as one Parquet file at ``path``, published as a
    part is (staging file under ``_temporary/`` beside it, fsync, atomic
    rename); the staging directory goes once it is empty."""
    import pyarrow as pa

    from adam_tpu_torch.utils import instrumentation as ins
    from adam_tpu_torch.utils import telemetry as tele

    pa.set_memory_pool(pa.system_memory_pool())  # see PartWriterPool
    with ins.TIMERS.time(ins.PARQUET_ENCODE), tele.TRACE.span(
        tele.SPAN_PART_ENCODE, rows=int(batch.n_rows)
    ):
        table = to_arrow_alignments(batch, side, header)
    if tele.TRACE.recording:
        tele.TRACE.count(tele.C_BYTES_ENCODED, int(table.nbytes))
    _count_encode_bytes(tele.TRACE, batch, side, table)
    write_part(table, path, compression)
    _count_written(tele.TRACE, path)
    try:
        os.rmdir(os.path.join(os.path.dirname(os.path.abspath(path)), TMP_DIR_NAME))
    except OSError:  # another writer's file is still staged there
        pass


def _affinity_cap(floor: int = 1, ceil: int = 8) -> int:
    """Cores this process may run on, clamped to [floor, ceil]: the
    bound on every adaptive writer-pool growth decision."""
    try:
        n = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # not Linux
        n = os.cpu_count() or 1
    return max(floor, min(ceil, n))


def resolve_writer_shards(requested: Optional[int] = None) -> int:
    """Number of independent write threads: ``requested``, else
    ``ADAM_TPU_WRITER_SHARDS`` (clamped to [1, 8]; a non-integer warns
    and keeps the default), else 2 where the affinity allows it and 1 on
    a single core."""
    if requested is not None:
        return max(1, min(8, int(requested)))
    raw = os.environ.get("ADAM_TPU_WRITER_SHARDS", "").strip()
    if raw:
        try:
            return max(1, min(8, int(raw)))
        except ValueError:
            import logging

            logging.getLogger(__name__).warning(
                "ADAM_TPU_WRITER_SHARDS=%r is not an int; using the "
                "affinity-derived default", raw,
            )
    return min(2, _affinity_cap())


def writer_adaptive_enabled(default: bool = True) -> bool:
    """``ADAM_TPU_WRITER_ADAPTIVE``: ``0/off/false`` pins the pool at its
    construction bounds (parsed by ``utils/retry.env_toggle``)."""
    from adam_tpu_torch.utils.retry import env_toggle

    return env_toggle("ADAM_TPU_WRITER_ADAPTIVE", default)


#: A submit that waited longer than this on the gate counts as gated
_GATED_WAIT_S = 0.02
#: grow when at least ``_GATE_TRIP`` of the last ``_GATE_WINDOW`` submits
#: gated: one slow flush is noise, repeated gating is a sizing signal
_GATE_WINDOW = 4
_GATE_TRIP = 2


class PartWriterPool:
    """The streamed pipeline's pass-C sink, sharded and adaptive (JAX's
    ``PartWriterPool``).

    Encoder threads turn a window into an arrow table and hand it to one
    of ``n_io`` independent write threads (compression and disk), part
    ``i`` on shard ``i % n_io``, so one part's flush never stalls
    another's and each shard writes in submission order.  At most
    ``inflight_parts`` parts are alive in the pool (the producer blocks
    in :meth:`submit`), which bounds memory in decoded windows.  With
    ``adaptive`` (default ``ADAM_TPU_WRITER_ADAPTIVE``, on) the bound
    widens by one part whenever submits repeatedly gate for more than
    ``_GATED_WAIT_S``, up to ``min(_affinity_cap() + n_io, 2 *
    inflight_parts)``.  ``on_published(path)`` runs on the write thread
    after a part's durable publish (the run journal's "window complete"
    record); a hook failure is a worker failure.  The first worker
    failure fails later submits and re-raises from :meth:`close`.
    Which thread writes a part never changes its bytes.

    Telemetry, as in the JAX pool: the encode is timed and spanned on the
    global tracer, and the byte and part counters, the queue-depth and
    bound gauges and the ``parquet.pool.submit_wait`` histogram go to
    ``tracer`` (the streamed run tracer) when given, else to the global
    one."""

    def __init__(self, n_encoders: int = 2, inflight_parts: int = 3,
                 compression: str = "zstd", on_published=None,
                 tracer=None, n_io: Optional[int] = None,
                 adaptive: Optional[bool] = None):
        import pyarrow as pa

        # the system allocator, not pyarrow's mimalloc: see
        # adam_tpu_torch/__init__.py (pyarrow may have been imported first)
        pa.set_memory_pool(pa.system_memory_pool())
        self._adaptive = (
            writer_adaptive_enabled() if adaptive is None else adaptive
        )
        n_io = resolve_writer_shards(n_io)
        self._bound = max(1, inflight_parts)
        # every admitted part pins one decoded window: growth may
        # stretch the caller's memory budget (2x), never ignore it
        self._bound_cap = (
            max(self._bound, min(_affinity_cap() + n_io, 2 * self._bound))
            if self._adaptive else self._bound
        )
        enc_cap = max(1, n_encoders)
        if self._adaptive:
            enc_cap = max(enc_cap, _affinity_cap())
        # workers spawn lazily: capacity above the bound costs nothing
        # until growth admits work
        self._enc = ThreadPoolExecutor(enc_cap)
        self._io = [ThreadPoolExecutor(1) for _ in range(n_io)]
        self._io_rr = itertools.count()  # non-part names round-robin
        self._gate = threading.Semaphore(self._bound)
        self._gate_lock = threading.Lock()
        self._gated_recent: deque = deque(maxlen=_GATE_WINDOW)
        self._compression = compression
        self._on_published = on_published
        self._tracer = tracer
        self._futures: list = []
        # parts alive in the pool, sampled into the queue-depth gauge at
        # submit and at release (kept whether or not recording is on)
        self._depth = 0
        self._depth_lock = threading.Lock()
        self._failed: BaseException | None = None
        self._fail_lock = threading.Lock()
        self._staging_dirs: set = set()

    def _record_failure(self, e: BaseException) -> None:
        with self._fail_lock:
            if self._failed is None:
                self._failed = e

    @property
    def failed(self) -> BaseException | None:
        """The first worker failure so far, or None."""
        with self._fail_lock:
            return self._failed

    @property
    def n_io(self) -> int:
        return len(self._io)

    @property
    def inflight_bound(self) -> int:
        """The live admission bound (grows under adaptive sizing)."""
        with self._gate_lock:
            return self._bound

    def _metric_tracer(self):
        from adam_tpu_torch.utils import telemetry as tele

        return self._tracer if self._tracer is not None else tele.TRACE

    def _sample_depth(self, delta: int) -> None:
        from adam_tpu_torch.utils import telemetry as tele

        # the gauge is written under the depth lock, so the last sample
        # is always the current depth
        tr = self._metric_tracer()
        with self._depth_lock:
            self._depth += delta
            tr.gauge(tele.G_POOL_DEPTH, self._depth)

    def _io_shard(self, path: str) -> ThreadPoolExecutor:
        idx = part_index(path)
        if idx is None:
            idx = next(self._io_rr)
        return self._io[idx % len(self._io)]

    def _maybe_grow(self, gated: bool) -> None:
        """Widen the gate one part when submits repeatedly gate, up to
        the cap; one more slot admits one more concurrent encoder."""
        if not self._adaptive:
            return
        with self._gate_lock:
            self._gated_recent.append(gated)
            if (sum(self._gated_recent) < _GATE_TRIP
                    or self._bound >= self._bound_cap):
                return
            self._bound += 1
            self._gated_recent.clear()
            bound = self._bound
        self._gate.release()
        from adam_tpu_torch.utils import telemetry as tele

        self._metric_tracer().gauge(tele.G_POOL_BOUND, bound)

    def submit(self, path: str, batch: ReadBatch, side: ReadSidecar,
               header: SamHeader, packed=None) -> None:
        from adam_tpu_torch.utils import faults
        from adam_tpu_torch.utils import instrumentation as ins
        from adam_tpu_torch.utils import telemetry as tele

        first = self.failed
        if first is not None:
            raise RuntimeError(
                f"PartWriterPool worker already failed; aborting submit of {path}"
            ) from first
        self._staging_dirs.add(
            os.path.join(os.path.dirname(os.path.abspath(path)), TMP_DIR_NAME)
        )

        def release():
            # the depth drops before the gate reopens: a submitter it
            # unblocks never sees a depth above the admission bound
            self._sample_depth(-1)
            self._gate.release()

        def write(table):
            try:
                write_part(table, path, self._compression)
                # the journal record first: a kill after the next publish
                # must find it as early as it could without telemetry
                if self._on_published is not None:
                    self._on_published(path)
                _count_written(self._metric_tracer(), path)
            except BaseException as e:
                self._record_failure(e)
                raise
            finally:
                release()

        def encode():
            try:
                faults.point("parquet.encode")
                # encoder threads carry no trace scope: stamp it explicitly
                enc_attrs = {"rows": int(batch.n_rows)}
                job_trace = getattr(self._tracer, "trace", None)
                if job_trace:
                    enc_attrs["trace"] = job_trace
                with ins.TIMERS.time(ins.PARQUET_ENCODE), tele.TRACE.span(
                    tele.SPAN_PART_ENCODE, **enc_attrs
                ):
                    table = to_arrow_alignments(batch, side, header, packed=packed)
                tr = self._metric_tracer()
                if tr.recording:
                    tr.count(tele.C_BYTES_ENCODED, int(table.nbytes))
                _count_encode_bytes(tr, batch, side, table, packed)
                return self._io_shard(path).submit(write, table)
            except BaseException as e:
                # release on the error path: the producer may be blocked
                # in submit() on a full gate
                self._record_failure(e)
                release()
                raise

        # the time the producer blocks on the gate is the writer pool's
        # backpressure, kept as a histogram (a p99, not only a total)
        tr = self._metric_tracer()
        t_gate = time.monotonic()
        self._gate.acquire()
        wait_s = time.monotonic() - t_gate
        tr.observe(tele.H_POOL_SUBMIT_WAIT, wait_s)
        self._maybe_grow(wait_s > _GATED_WAIT_S)
        self._sample_depth(+1)
        try:
            self._futures.append(self._enc.submit(encode))
        except BaseException:
            release()
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
        for ex in self._io:
            ex.shutdown()
        first = self.failed or (errs[0] if errs else None)
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


# --------------------------------------------------------------------------
# the read path
# --------------------------------------------------------------------------
#: columns every load reads, whatever the projection: a batch needs them
ESSENTIAL_FIELDS = {"sequence", "qual", "flags", "cigar", "start", "contig"}


def load_alignments(
    path: str, projection=None, predicate=None, round_rows_to: int = 1,
) -> tuple[ReadBatch, ReadSidecar, SamHeader]:
    """Load a part file or part directory, with an optional column
    ``projection`` (the essential columns are always read) and a pyarrow
    ``filters``-style ``predicate``; the batch's rows pad up to a multiple
    of ``round_rows_to``."""
    import pyarrow.parquet as pq

    from adam_tpu_torch.utils import telemetry as tele

    cols = None
    if projection is not None:
        cols = sorted(set(projection) | ESSENTIAL_FIELDS)
    with tele.TRACE.span(tele.SPAN_PARQUET_READ):
        table = pq.read_table(path, columns=cols, filters=predicate)
    with tele.TRACE.span(tele.SPAN_PARQUET_FROM_ARROW):
        return from_arrow_alignments(table, round_rows_to=round_rows_to)


def _string_column_or(table, name: str, n: int, default=None):
    """A string column of ``table``, or ``n`` rows of ``default`` when
    the column was not read."""
    from adam_tpu_torch.formats.strings import StringColumn

    if name in table.column_names:
        return StringColumn.from_arrow(table[name])
    return StringColumn.full(n, default)


def _int_col(table, name: str, n: int, default, dtype):
    import pyarrow.compute as pc

    if name not in table.column_names:
        return np.full(n, default, dtype)
    return np.asarray(
        pc.fill_null(table[name], default).combine_chunks()
    ).astype(dtype)


def _name_index_col(col, lookup) -> np.ndarray:
    """Dictionary-index a string column: unique names -> lookup() once."""
    uniq, inv = np.unique(col.to_fixed_bytes(), return_inverse=True)
    idx = np.array(
        [lookup(u.decode("utf-8", "replace")) if u else -1 for u in uniq],
        np.int32,
    )
    out = idx[inv]
    return np.where(col.valid, out, -1).astype(np.int32)


def from_arrow_alignments(table, round_rows_to: int = 1
                          ) -> tuple[ReadBatch, ReadSidecar, SamHeader]:
    """Arrow Table in the AlignmentRecord layout -> host batch, sidecar
    and header (the header from the schema metadata): one native pass
    for the bases and qualities, the native CIGAR parse, dictionary-indexed
    name columns.  The batch's rows (not the sidecar's, as in JAX) pad up
    to a multiple of ``round_rows_to``."""
    from adam_tpu_torch import native

    header = _header_from_meta(table.schema.metadata)
    sd, rgd = header.seq_dict, header.read_groups
    n = table.num_rows

    seq_col = _string_column_or(table, "sequence", n)
    qual_col = _string_column_or(table, "qual", n)
    bases, quals, lengths, has_qual = native.arrow_codes(
        seq_col.buf, seq_col.offsets, seq_col.valid,
        qual_col.buf, qual_col.offsets, qual_col.valid)

    cig_col = _string_column_or(table, "cigar", n)
    cig_lens_b = np.where(cig_col.valid, cig_col.lengths(), 0)
    is_digit = (cig_col.buf >= ord("0")) & (cig_col.buf <= ord("9"))
    n_ops_cap = (
        np.add.reduceat(
            (~is_digit).astype(np.int64),
            np.minimum(cig_col.offsets[:-1], max(len(cig_col.buf) - 1, 0)),
        )
        if len(cig_col.buf) and n
        else np.zeros(n, np.int64)
    )
    # rows with empty spans get garbage from reduceat; zero them
    n_ops_cap = np.where(cig_lens_b > 0, n_ops_cap, 0)
    cmax = max(1, int(n_ops_cap.max()) if n else 1)
    cigar_ops, cigar_lens, cigar_n = native.cigar_cols(
        cig_col.buf, cig_col.offsets, cmax)
    cigar_n = np.where(cig_col.valid, cigar_n, 0).astype(np.int32)

    start = _int_col(table, "start", n, -1, np.int64)
    flags = _int_col(table, "flags", n, 4, np.int32)
    # end: the stored column, else start + the reference span
    if "end" in table.column_names:
        end = _int_col(table, "end", n, -1, np.int64)
    else:
        r_consume = schema.CIGAR_CONSUMES_REF[np.minimum(cigar_ops, 15)].astype(np.int64)
        rlen = (cigar_lens * r_consume).sum(axis=1)
        end = np.where(start >= 0, start + rlen, -1)

    batch = ReadBatch(
        bases=bases,
        quals=quals,
        lengths=lengths,
        flags=flags,
        contig_idx=_name_index_col(_string_column_or(table, "contig", n), sd.index_or),
        start=start,
        end=end,
        mapq=_int_col(table, "mapq", n, 255, np.int32),
        cigar_ops=cigar_ops,
        cigar_lens=cigar_lens,
        cigar_n=cigar_n,
        mate_contig_idx=_name_index_col(
            _string_column_or(table, "mateContig", n), sd.index_or
        ),
        mate_start=_int_col(table, "mateAlignmentStart", n, -1, np.int64),
        tlen=_int_col(table, "inferredInsertSize", n, 0, np.int32),
        read_group_idx=_name_index_col(
            _string_column_or(table, "recordGroupName", n), rgd.index_or
        ),
        has_qual=has_qual,
        valid=np.ones(n, bool),
    )
    side = ReadSidecar(
        names=_string_column_or(table, "readName", n, default=""),
        attrs=_string_column_or(table, "attributes", n, default=""),
        md=_string_column_or(table, "mismatchingPositions", n),
        orig_quals=_string_column_or(table, "origQual", n),
        trimmed_from_start=_int_col(table, "basesTrimmedFromStart", n, 0, np.int32),
        trimmed_from_end=_int_col(table, "basesTrimmedFromEnd", n, 0, np.int32),
    )
    g = ((n + round_rows_to - 1) // round_rows_to) * round_rows_to
    if g != n:
        batch = batch.pad_rows(g)
    return batch, side, header


# --------------------------------------------------------------------------
# the genotype store (vcf2adam / anno2adam target): a directory of two
# tables, variants.parquet + genotypes.parquet, linked by
# genotype.variantIdx (a sites-only VCF gives an empty genotype table)
# --------------------------------------------------------------------------
def _seq_dict_meta(seq_dict) -> dict[bytes, bytes]:
    meta = [
        {"name": r.name, "length": r.length, "md5": r.md5, "url": r.url}
        for r in seq_dict
    ]
    return {b"adam_tpu.seq_dict": json.dumps(meta).encode()}


def _seq_dict_from_meta(meta) -> SequenceDictionary:
    if not meta or b"adam_tpu.seq_dict" not in meta:
        return SequenceDictionary(())
    return SequenceDictionary(tuple(
        SequenceRecord(s["name"], s["length"], md5=s.get("md5"), url=s.get("url"))
        for s in json.loads(meta[b"adam_tpu.seq_dict"])
    ))


def save_genotypes(path: str, variants, genotypes, seq_dict, compression: str = "zstd",
                   typed_annotations=None) -> None:
    """``typed_annotations``: ``{adamKey: [value-or-None per variant]}``
    (``formats/annotations.split_typed``), stored as typed ``ann_<adamKey>``
    columns; by default the recognized INFO keys are split out (``{}``
    keeps every key in the generic map)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(path, exist_ok=True)
    vside = variants.sidecar
    cols = {
        "contig": pa.array([seq_dict.names[c] for c in variants.contig_idx], pa.string()),
        "start": pa.array(variants.start.tolist(), pa.int64()),
        "end": pa.array(variants.end.tolist(), pa.int64()),
        "referenceAllele": pa.array(vside.ref_allele, pa.string()),
        "alternateAllele": pa.array(vside.alt_allele, pa.string()),
        "qual": pa.array([None if np.isnan(q) else float(q) for q in variants.qual],
                         pa.float64()),
        "filtersApplied": pa.array(variants.filters_applied.tolist(), pa.bool_()),
        "filtersPassed": pa.array(variants.passing.tolist(), pa.bool_()),
        "name": pa.array(vside.names, pa.string()),
        "filters": pa.array(vside.filters, pa.list_(pa.string())),
        "annotations": pa.array([json.dumps(d) for d in vside.info], pa.string()),
        # row index: a pushed-down variant predicate selects the matching
        # genotype rows without reading the whole genotype table
        "variantIdx": pa.array(np.arange(len(variants.start), dtype=np.int32), pa.int32()),
    }
    if typed_annotations is None:
        from adam_tpu_torch.formats.annotations import split_typed

        typed_annotations, leftover = split_typed(vside.info)
        if typed_annotations:
            cols["annotations"] = pa.array([json.dumps(d) for d in leftover], pa.string())
    if typed_annotations:
        from adam_tpu_torch.formats.annotations import arrow_type

        for adam_key in sorted(typed_annotations):
            cols[f"ann_{adam_key}"] = pa.array(typed_annotations[adam_key],
                                               arrow_type(adam_key))
    vt = pa.table(cols).replace_schema_metadata(_seq_dict_meta(seq_dict))
    pq.write_table(vt, os.path.join(path, "variants.parquet"),
                   **parquet_codec_kw(compression))

    gt = pa.table({
        "variantIdx": pa.array(genotypes.variant_idx.tolist(), pa.int32()),
        "sampleId": pa.array([genotypes.samples[s] for s in genotypes.sample_idx],
                             pa.string()),
        "allele0": pa.array(genotypes.alleles[:, 0].tolist(), pa.int8()),
        "allele1": pa.array(genotypes.alleles[:, 1].tolist(), pa.int8()),
        "genotypeQuality": pa.array(genotypes.gq.tolist(), pa.int32()),
        "readDepth": pa.array(genotypes.dp.tolist(), pa.int32()),
        "referenceReadDepth": pa.array(genotypes.ref_depth.tolist(), pa.int32()),
        "alternateReadDepth": pa.array(genotypes.alt_depth.tolist(), pa.int32()),
        "isPhased": pa.array(genotypes.phased.tolist(), pa.bool_()),
        "genotypeLikelihoods": pa.array(genotypes.pl.tolist(), pa.list_(pa.int32())),
        "nonReferenceLikelihoods": pa.array(genotypes.nonref_pl.tolist(),
                                            pa.list_(pa.int32())),
        "splitFromMultiAllelic": pa.array(genotypes.split_from_multiallelic.tolist(),
                                          pa.bool_()),
        "genotypeFilters": pa.array(list(genotypes.genotype_filters), pa.string()),
    })
    pq.write_table(gt, os.path.join(path, "genotypes.parquet"),
                   **parquet_codec_kw(compression))


def _likelihood_matrix(col, m: int, what: str) -> np.ndarray:
    """Genotype likelihood lists -> i32[m, 3]; lists of another length
    (a file written elsewhere) are padded with 0 or truncated, with a
    warning."""
    if not m:
        return np.zeros((0, 3), np.int32)
    rows = col.to_pylist()
    if all(r is not None and len(r) == 3 for r in rows):
        return np.array(rows, np.int32).reshape(m, 3)
    import logging

    logging.getLogger(__name__).warning(
        "%s: lists are not uniformly length 3; padding/truncating "
        "(bi-allelic PL layout expected)", what,
    )
    out = np.zeros((m, 3), np.int32)
    for i, r in enumerate(rows):
        if r:
            out[i, : min(3, len(r))] = r[:3]
    return out


def _pylist_or(t, name: str, n: int, default):
    """Column as pylist, or defaults when projected away."""
    if name in t.column_names:
        return t[name].to_pylist()
    return [default] * n


def load_genotypes(path: str, contig_names=None, projection=None, filters=None):
    """-> (VariantBatch, GenotypeBatch, SequenceDictionary).

    ``contig_names`` fixes the contig index space (as in
    :func:`adam_tpu_torch.io.vcf.read_vcf`).  ``projection`` is a subset
    of VARIANT_FIELDS | GENOTYPE_FIELDS (``formats/fields.py``): only those
    columns are read, the rest come back as defaults.  ``filters`` is a
    pyarrow predicate over the variant columns, pushed into the variants
    read; the matching genotype rows are selected by a pushed
    ``variantIdx in ...`` predicate and re-indexed."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    from adam_tpu_torch.formats import variants as vf
    from adam_tpu_torch.formats.fields import (
        GENOTYPE_FIELDS,
        VARIANT_FIELDS,
        validate_projection,
    )

    v_cols = g_cols = None
    if projection is not None:
        proj = set(projection)
        bad = sorted(proj - (VARIANT_FIELDS | GENOTYPE_FIELDS))
        if bad:
            raise ValueError(f"unknown genotype/variant projection field(s) {bad}")
        v_cols = validate_projection(
            sorted(proj & VARIANT_FIELDS), VARIANT_FIELDS,
            ("contig", "start", "end", "referenceAllele", "alternateAllele", "variantIdx"),
            "variant",
        )
        g_cols = validate_projection(
            sorted(proj & GENOTYPE_FIELDS), GENOTYPE_FIELDS,
            ("variantIdx", "sampleId", "allele0", "allele1"), "genotype",
        )
    v_path = os.path.join(path, "variants.parquet")
    if v_cols is not None:
        # legacy stores predate the variantIdx row-index column
        present = set(pq.read_schema(v_path).names)
        if "annotations" in v_cols:
            # the annotations field means all of them, the typed ann_*
            # columns included
            v_cols = v_cols + sorted(c for c in present if c.startswith("ann_"))
        v_cols = [c for c in v_cols if c in present]
    vt = pq.read_table(v_path, columns=v_cols, filters=filters)
    if contig_names is not None:
        seq_dict = SequenceDictionary(tuple(SequenceRecord(n, 0) for n in contig_names))
    else:
        seq_dict = _seq_dict_from_meta(vt.schema.metadata)
    name_idx = {n: i for i, n in enumerate(seq_dict.names)}
    contigs = vt["contig"].to_pylist()
    for c in contigs:
        if c not in name_idx:
            name_idx[c] = len(name_idx)
    names = [None] * len(name_idx)
    for n, i in name_idx.items():
        names[i] = n
    if len(names) > len(seq_dict.names):
        seq_dict = SequenceDictionary(tuple(
            list(seq_dict.records)
            + [SequenceRecord(n, 0) for n in names[len(seq_dict.names):]]
        ))

    nv = vt.num_rows
    info = [json.loads(s) if s else {} for s in _pylist_or(vt, "annotations", nv, None)]
    ann_cols = [c for c in vt.column_names if c.startswith("ann_")]
    if ann_cols:
        # typed annotation columns merge back under their VCF keys
        from adam_tpu_torch.formats.annotations import merge_typed

        cols = {}
        for c in ann_cols:
            vals = vt[c].to_pylist()
            if vt.schema.field(c).type == pa.float32():
                # legacy float32 store: keep the column's own precision
                vals = [None if v is None else np.float32(v) for v in vals]
            cols[c[4:]] = vals
        info = merge_typed(cols, info)
    side = vf.VariantSidecar(
        ref_allele=vt["referenceAllele"].to_pylist(),
        alt_allele=vt["alternateAllele"].to_pylist(),
        names=_pylist_or(vt, "name", nv, None),
        filters=_pylist_or(vt, "filters", nv, None),
        info=info,
    )
    quals = [np.nan if q is None else q for q in _pylist_or(vt, "qual", nv, None)]
    variants = vf.VariantBatch(
        contig_idx=np.array([name_idx[c] for c in contigs], np.int32),
        start=np.array(vt["start"].to_pylist(), np.int64),
        end=np.array(vt["end"].to_pylist(), np.int64),
        ref_len=np.array([len(r) for r in side.ref_allele], np.int32),
        alt_len=np.array([len(a) if a else 0 for a in side.alt_allele], np.int32),
        qual=np.array(quals, np.float32),
        filters_applied=np.array(_pylist_or(vt, "filtersApplied", nv, False), bool),
        passing=np.array(_pylist_or(vt, "filtersPassed", nv, False), bool),
        sidecar=side,
    )

    g_path = os.path.join(path, "genotypes.parquet")
    g_filters = None
    remap = None
    if filters is not None:
        # the surviving variant rows select the genotype rows, whose
        # variant_idx then re-indexes into the filtered variant batch
        if "variantIdx" in vt.column_names:
            keep = np.asarray(vt["variantIdx"].combine_chunks(), np.int64)
        else:
            # a legacy store without the row-index column: read it whole
            # with a synthesized row index and filter in memory
            expr = (filters if isinstance(filters, pc.Expression)
                    else pq.filters_to_expression(filters))
            full = pq.read_table(v_path)
            full = full.append_column(
                "__row", pa.array(np.arange(full.num_rows, dtype=np.int64)))
            keep = np.asarray(full.filter(expr)["__row"].combine_chunks(), np.int64)
        keep = np.sort(keep)
        g_filters = pc.field("variantIdx").isin(pa.array(keep))
        remap = keep
    gt = pq.read_table(g_path, columns=g_cols, filters=g_filters)
    sample_names = gt["sampleId"].to_pylist()
    samples: list = []
    sample_idx = {}
    si = []
    for s in sample_names:
        if s not in sample_idx:
            sample_idx[s] = len(samples)
            samples.append(s)
        si.append(sample_idx[s])
    m = gt.num_rows
    vidx = np.array(gt["variantIdx"].to_pylist(), np.int64)
    if remap is not None and m:
        vidx = np.searchsorted(remap, vidx)

    def _pl(name):
        if name in gt.column_names:
            return _likelihood_matrix(gt[name], m, name)
        return np.zeros((m, 3), np.int32)

    genotypes = vf.GenotypeBatch(
        variant_idx=vidx.astype(np.int32),
        sample_idx=np.array(si, np.int32),
        alleles=np.stack([
            np.array(gt["allele0"].to_pylist(), np.int8),
            np.array(gt["allele1"].to_pylist(), np.int8),
        ], axis=1) if m else np.zeros((0, 2), np.int8),
        gq=np.clip(np.array(_pylist_or(gt, "genotypeQuality", m, 0), np.int32),
                   0, 32767).astype(np.int16),
        dp=np.array(_pylist_or(gt, "readDepth", m, -1), np.int32),
        ref_depth=np.array(_pylist_or(gt, "referenceReadDepth", m, -1), np.int32),
        alt_depth=np.array(_pylist_or(gt, "alternateReadDepth", m, -1), np.int32),
        phased=np.array(_pylist_or(gt, "isPhased", m, False), bool),
        pl=_pl("genotypeLikelihoods"),
        nonref_pl=_pl("nonReferenceLikelihoods"),
        split_from_multiallelic=np.array(_pylist_or(gt, "splitFromMultiAllelic", m, False),
                                         bool),
        samples=samples,
        genotype_filters=_pylist_or(gt, "genotypeFilters", m, None),
    )
    return variants, genotypes, seq_dict


# --------------------------------------------------------------------------
# the feature store (features2adam target)
# --------------------------------------------------------------------------
def save_features(path: str, feats, compression: str = "zstd") -> None:
    import pyarrow as pa
    import pyarrow.parquet as pq

    side = feats.sidecar
    t = pa.table({
        "contig": pa.array([feats.contig_names[c] for c in feats.contig_idx], pa.string()),
        "start": pa.array(feats.start.tolist(), pa.int64()),
        "end": pa.array(feats.end.tolist(), pa.int64()),
        "strand": pa.array(feats.strand.tolist(), pa.int8()),
        "score": pa.array([None if np.isnan(s) else float(s) for s in feats.score],
                          pa.float64()),
        "featureId": pa.array(side.feature_id, pa.string()),
        "featureType": pa.array(side.feature_type, pa.string()),
        "source": pa.array(side.source, pa.string()),
        "parentIds": pa.array(side.parent_ids, pa.list_(pa.string())),
        "attributes": pa.array([json.dumps(d) for d in side.attributes], pa.string()),
    })
    pq.write_table(t, path, **parquet_codec_kw(compression))


def load_features(path: str, projection=None, filters=None):
    """``projection``: a subset of FEATURE_FIELDS; ``filters``: a pyarrow
    predicate pushed into the read."""
    import pyarrow.parquet as pq

    from adam_tpu_torch.formats.features import FeatureBatch, FeatureSidecar
    from adam_tpu_torch.formats.fields import FEATURE_FIELDS, validate_projection

    cols = validate_projection(projection, FEATURE_FIELDS, ("contig", "start", "end"),
                               "feature")
    t = pq.read_table(path, columns=cols, filters=filters)
    n = t.num_rows
    contigs = t["contig"].to_pylist()
    names: list = []
    idx = {}
    ci = []
    for c in contigs:
        if c not in idx:
            idx[c] = len(names)
            names.append(c)
        ci.append(idx[c])
    scores = [np.nan if s is None else s for s in _pylist_or(t, "score", n, None)]
    return FeatureBatch(
        contig_idx=np.array(ci, np.int32),
        start=np.array(t["start"].to_pylist(), np.int64),
        end=np.array(t["end"].to_pylist(), np.int64),
        strand=np.array(_pylist_or(t, "strand", n, 0), np.int8),
        score=np.array(scores, np.float32),
        contig_names=names,
        sidecar=FeatureSidecar(
            feature_id=_pylist_or(t, "featureId", n, None),
            feature_type=_pylist_or(t, "featureType", n, None),
            source=_pylist_or(t, "source", n, None),
            parent_ids=_pylist_or(t, "parentIds", n, None),
            attributes=[json.loads(s) if s else {}
                        for s in _pylist_or(t, "attributes", n, None)],
        ),
    )


# --------------------------------------------------------------------------
# the contig-fragment store (fasta2adam target)
# --------------------------------------------------------------------------
def save_fragments(path: str, fragments, seq_dict, descriptions=None,
                   compression: str = "zstd") -> None:
    """``descriptions``: contig index -> description, as a dict or as
    ``read_fasta``'s per-contig list."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    b = fragments.to_numpy()
    rows = np.flatnonzero(np.asarray(b.valid))
    if isinstance(descriptions, (list, tuple)):
        descriptions = {i: d for i, d in enumerate(descriptions) if d}
    t = pa.table({
        "contig": pa.array([seq_dict.names[int(b.contig_idx[i])] for i in rows],
                           pa.string()),
        "description": pa.array([(descriptions or {}).get(int(b.contig_idx[i]))
                                 for i in rows], pa.string()),
        "fragmentSequence": pa.array([schema.decode_bases(b.bases[i], int(b.lengths[i]))
                                      for i in rows], pa.string()),
        "fragmentStartPosition": pa.array([int(b.start[i]) for i in rows], pa.int64()),
        "fragmentNumber": pa.array([int(b.fragment_number[i]) for i in rows], pa.int32()),
        "numberOfFragmentsInContig": pa.array([int(b.num_fragments[i]) for i in rows],
                                              pa.int32()),
    }).replace_schema_metadata(_seq_dict_meta(seq_dict))
    pq.write_table(t, path, **parquet_codec_kw(compression))


def load_fragments(path: str, projection=None, filters=None):
    """-> (FragmentBatch, SequenceDictionary, descriptions dict).
    ``projection``: a subset of FRAGMENT_FIELDS; ``filters``: a pyarrow
    predicate pushed into the read.  Contigs missing from the stored
    dictionary extend it (length 0)."""
    import pyarrow.parquet as pq

    from adam_tpu_torch.formats.fields import FRAGMENT_FIELDS, validate_projection
    from adam_tpu_torch.formats.fragments import FragmentBatch

    cols = validate_projection(
        projection, FRAGMENT_FIELDS,
        ("contig", "fragmentSequence", "fragmentStartPosition", "fragmentNumber",
         "numberOfFragmentsInContig"),
        "fragment",
    )
    t = pq.read_table(path, columns=cols, filters=filters)
    seq_dict = _seq_dict_from_meta(t.schema.metadata)
    name_idx = {n: i for i, n in enumerate(seq_dict.names)}
    contigs = t["contig"].to_pylist()
    extra = []
    for c in contigs:
        if c not in name_idx:
            name_idx[c] = len(name_idx)
            extra.append(SequenceRecord(c, 0))
    if extra:
        seq_dict = SequenceDictionary(tuple(list(seq_dict.records) + extra))
    seqs = t["fragmentSequence"].to_pylist()
    n = t.num_rows
    fmax = max((len(s) for s in seqs), default=1)
    out = FragmentBatch(
        bases=np.full((n, fmax), schema.BASE_PAD, np.uint8),
        lengths=np.zeros(n, np.int32),
        contig_idx=np.zeros(n, np.int32),
        start=np.array(t["fragmentStartPosition"].to_pylist(), np.int64),
        fragment_number=np.array(t["fragmentNumber"].to_pylist(), np.int32),
        num_fragments=np.array(t["numberOfFragmentsInContig"].to_pylist(), np.int32),
        valid=np.ones(n, bool),
    )
    descriptions = {}
    descs = _pylist_or(t, "description", n, None)
    for i in range(n):
        out.bases[i, : len(seqs[i])] = schema.encode_bases(seqs[i])
        out.lengths[i] = len(seqs[i])
        out.contig_idx[i] = name_idx[contigs[i]]
        if descs[i]:
            descriptions[int(out.contig_idx[i])] = descs[i]
    return out, seq_dict, descriptions
