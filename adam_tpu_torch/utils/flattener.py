"""Nested-schema flattening (util/Flattener.scala + Flatten command).

Copied from ``adam_tpu/utils/flattener.py``; the writer settings are the
port's ``io/parquet.parquet_codec_kw``, so the file is byte for byte the
JAX verb's.

The reference flattens nested Avro records into dotted-name flat columns
so SQL engines (Impala) can query them (``Flattener.flattenSchema`` /
``flattenRecord``). The columnar port works on Arrow tables: struct
columns expand (recursively) to ``parent__child`` columns — the
reference uses ``__`` as its separator too (Flattener.scala NAME_SEPARATOR).
List columns have no flat relational form and are JSON-stringified.
"""

from __future__ import annotations

import json

import pyarrow as pa
import pyarrow.parquet as pq

SEPARATOR = "__"


def flatten_table(table: pa.Table) -> pa.Table:
    # expand struct columns one level at a time until none remain; only
    # the child columns produced by the expansion get the `__` separator
    # (literal dots in pre-existing column names are left alone), and a
    # flattened name colliding with an existing column is an error rather
    # than a silently dropped column
    while any(pa.types.is_struct(f.type) for f in table.schema):
        cols, names = [], []
        for field, col in zip(table.schema, table.columns):
            if pa.types.is_struct(field.type):
                chunked = col.combine_chunks()
                for child_field, child in zip(
                    field.type, chunked.flatten()
                ):
                    cols.append(child)
                    names.append(f"{field.name}{SEPARATOR}{child_field.name}")
            else:
                cols.append(col)
                names.append(field.name)
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(
                f"flattening collides with existing columns: {sorted(dupes)}"
            )
        table = pa.Table.from_arrays(cols, names=names)
    cols, names = [], []
    for name, col in zip(table.column_names, table.columns):
        if pa.types.is_list(col.type) or pa.types.is_large_list(col.type):
            col = pa.array(
                [None if v is None else json.dumps(v) for v in col.to_pylist()],
                pa.string(),
            )
        cols.append(col)
        names.append(name)
    return pa.Table.from_arrays(
        [pa.array(c) if not isinstance(c, (pa.Array, pa.ChunkedArray)) else c
         for c in cols],
        names=names,
    )


def flatten_parquet(in_path: str, out_path: str,
                    compression: str = "zstd") -> None:
    table = pq.read_table(in_path)
    meta = table.schema.metadata
    flat = flatten_table(table)
    if meta:
        flat = flat.replace_schema_metadata(meta)
    from adam_tpu_torch.io.parquet import parquet_codec_kw

    pq.write_table(flat, out_path, **parquet_codec_kw(compression))
