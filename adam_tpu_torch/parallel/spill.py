"""Raw columnar shard spill (Arrow IPC) — the port of
``adam_tpu/parallel/spill.py``, the out-of-core shard store of the sharded
transform (``parallel/sharded.py``).

Unlike the Parquet interchange layout (``io/parquet.py``), the spill keeps
the batch's own columns: base and qual code matrices as one binary value
per row, the cigar columns as packed bytes, the sidecar strings as Arrow
strings.  Writing is a memcpy (no ASCII encode), reading a memcpy and a
pad (no tokenize), and the file is plain Arrow IPC.  The column order and
the schema metadata are the JAX package's, so a shard written by either
package reads back in the other, and the two write the same bytes for
the same batch.
"""

from __future__ import annotations

import numpy as np

from adam_tpu_torch.formats.batch import ReadBatch, ReadSidecar


def _binary_rows(mat: np.ndarray):
    """[N, W] u8 matrix -> large_binary array of N W-byte values (one
    memcpy; 64-bit offsets so long-read batches cannot wrap)."""
    import pyarrow as pa

    mat = np.ascontiguousarray(mat, np.uint8)
    n, w = mat.shape
    offsets = np.arange(n + 1, dtype=np.int64) * w
    return pa.LargeBinaryArray.from_buffers(
        pa.large_binary(), n, [None, pa.py_buffer(offsets), pa.py_buffer(mat)])


def _i32_matrix_rows(mat: np.ndarray):
    """[N, C] i32 matrix -> binary array of N 4C-byte values."""
    mat = np.ascontiguousarray(mat, np.int32)
    return _binary_rows(mat.view(np.uint8).reshape(mat.shape[0], -1))


def _string_array(col):
    from adam_tpu_torch.formats.strings import StringColumn

    return StringColumn.of(col).to_arrow()


def batch_to_raw_table(batch: ReadBatch, side: ReadSidecar, header):
    """Valid rows of a batch -> raw-layout Arrow table (the header in the
    schema metadata, as the Parquet parts carry it)."""
    import pyarrow as pa

    from adam_tpu_torch.io.parquet import _header_meta

    b = batch.to_numpy()
    valid = np.asarray(b.valid)
    if not valid.all():
        rows = np.flatnonzero(valid)
        b = b.take(rows)
        side = side.take(rows)

    def ints(x, dtype, typ):
        return pa.array(np.asarray(x, dtype), typ)

    cols = {
        "bases": _binary_rows(b.bases),
        "quals": _binary_rows(b.quals),
        "lengths": ints(b.lengths, np.int32, pa.int32()),
        "flags": ints(b.flags, np.int32, pa.int32()),
        "contig_idx": ints(b.contig_idx, np.int32, pa.int32()),
        "start": ints(b.start, np.int64, pa.int64()),
        "end": ints(b.end, np.int64, pa.int64()),
        "mapq": ints(b.mapq, np.int32, pa.int32()),
        "cigar_ops": _binary_rows(b.cigar_ops),
        "cigar_lens": _i32_matrix_rows(b.cigar_lens),
        "cigar_n": ints(b.cigar_n, np.int32, pa.int32()),
        "mate_contig_idx": ints(b.mate_contig_idx, np.int32, pa.int32()),
        "mate_start": ints(b.mate_start, np.int64, pa.int64()),
        "tlen": ints(b.tlen, np.int32, pa.int32()),
        "read_group_idx": ints(b.read_group_idx, np.int32, pa.int32()),
        "has_qual": ints(b.has_qual, bool, pa.bool_()),
        "names": _string_array(side.names),
        "attrs": _string_array(side.attrs),
        "md": _string_array(side.md),
        "orig_quals": _string_array(side.orig_quals),
        "trimmed_from_start": ints(side.trimmed_from_start, np.int32, pa.int32()),
        "trimmed_from_end": ints(side.trimmed_from_end, np.int32, pa.int32()),
    }
    return pa.table(cols).replace_schema_metadata(_header_meta(header))


class RawShardWriter:
    """Appendable raw-spill writer for one shard file."""

    def __init__(self, path: str):
        self.path = path
        self._writer = None

    def append(self, batch: ReadBatch, side: ReadSidecar, header) -> None:
        import pyarrow as pa

        table = batch_to_raw_table(batch, side, header)
        if self._writer is None:
            self._writer = pa.ipc.new_file(self.path, table.schema)
        for rb in table.to_batches():
            self._writer.write_batch(rb)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def _rows_matrix(chunks, dtype, pad_value):
    """Binary chunked array -> [N, Wmax] matrix of ``dtype`` (i32 rows
    come back as [N, Wmax/4]).  A chunk's rows share one width (they came
    from one matrix), so each chunk is one buffer reshape; chunks of
    differing width pad to the widest."""
    widths, parts = [], []
    for ch in chunks:
        n = len(ch)
        if n == 0:
            continue
        # the reads below start at the buffers' position 0, which holds
        # only for unsliced chunks (every RawShardWriter chunk is)
        if ch.offset != 0:
            raise ValueError("_rows_matrix requires unsliced chunks (offset=0); got "
                             f"a chunk with offset {ch.offset}")
        buf = np.frombuffer(ch.buffers()[2], np.uint8, ch.buffers()[2].size)
        off = np.frombuffer(ch.buffers()[1], np.int64, n + 1)
        w = int(off[1] - off[0])
        parts.append(buf[off[0]: off[0] + n * w].reshape(n, w))
        widths.append(w)
    if not parts:
        return np.zeros((0, 0), dtype)
    wmax = max(widths)
    out = []
    for mat in parts:
        if mat.shape[1] < wmax:
            # i32 rows pad with whole little-endian zero elements
            fill = 0 if dtype is np.int32 else pad_value
            pad = np.full((mat.shape[0], wmax - mat.shape[1]), fill, np.uint8)
            mat = np.concatenate([mat, pad], axis=1)
        out.append(mat)
    full = np.concatenate(out, axis=0) if len(out) > 1 else out[0].copy()
    if dtype is np.int32:
        return full.view(np.int32).reshape(full.shape[0], -1)
    return full.astype(dtype, copy=False)


def read_raw_shard(path: str):
    """Raw spill file -> (ReadBatch, ReadSidecar, SamHeader), every array
    a fresh writable copy."""
    import pyarrow as pa

    from adam_tpu_torch.formats import schema
    from adam_tpu_torch.formats.strings import StringColumn
    from adam_tpu_torch.io.parquet import _header_from_meta

    with pa.memory_map(path) as source:
        table = pa.ipc.open_file(source).read_all()
    header = _header_from_meta(table.schema.metadata)
    n = table.num_rows

    def col(name):
        return table.column(name)

    def ints(name, dtype):
        # Arrow- and mmap-backed views are read-only: copy
        return np.asarray(col(name).combine_chunks()).astype(dtype, copy=True)

    def strings(name):
        return StringColumn.from_arrow(col(name))

    batch = ReadBatch(
        bases=_rows_matrix(col("bases").chunks, np.uint8, schema.BASE_PAD),
        quals=_rows_matrix(col("quals").chunks, np.uint8, schema.QUAL_PAD),
        lengths=ints("lengths", np.int32),
        flags=ints("flags", np.int32),
        contig_idx=ints("contig_idx", np.int32),
        start=ints("start", np.int64),
        end=ints("end", np.int64),
        mapq=ints("mapq", np.int32),
        cigar_ops=_rows_matrix(col("cigar_ops").chunks, np.uint8, schema.CIGAR_PAD),
        cigar_lens=_rows_matrix(col("cigar_lens").chunks, np.int32, 0),
        cigar_n=ints("cigar_n", np.int32),
        mate_contig_idx=ints("mate_contig_idx", np.int32),
        mate_start=ints("mate_start", np.int64),
        tlen=ints("tlen", np.int32),
        read_group_idx=ints("read_group_idx", np.int32),
        has_qual=ints("has_qual", bool),
        valid=np.ones(n, bool),
    )
    side = ReadSidecar(
        names=strings("names"),
        attrs=strings("attrs"),
        md=strings("md"),
        orig_quals=strings("orig_quals"),
        trimmed_from_start=ints("trimmed_from_start", np.int32),
        trimmed_from_end=ints("trimmed_from_end", np.int32),
    )
    return batch, side, header
