"""Durable-write primitives (copied from ``adam_tpu/utils/durability.py``).

Renaming a finished temp file over its final name is atomic, but on a
power loss some filesystems persist the rename before the file's data.
So every durable publish is::

    fsync(tmp)          # the bytes are on disk before the name moves
    os.replace(tmp, dst)
    fsync(dir(dst))     # the directory entry (the rename) is on disk

The Parquet part writer (``io/parquet.py``) and the checkpoint manifest
(``pipelines/checkpoint.py``) publish through these helpers.

``fsync_dir`` is best-effort: some filesystems refuse ``open(dir)`` or
its ``fsync``; there the publish keeps plain atomic-rename semantics.
"""

from __future__ import annotations

import json
import os


def fsync_file(path: str) -> None:
    """fsync an already-written file by path."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """Best-effort directory fsync (persists renames and creates within)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def publish_file(tmp: str, dst: str) -> None:
    """Durably publish ``tmp`` as ``dst``: fsync the data, atomically
    rename, fsync the destination directory.  A crash at any earlier
    point leaves ``dst`` as it was (absent or its previous version)."""
    fsync_file(tmp)
    os.replace(tmp, dst)
    fsync_dir(os.path.dirname(os.path.abspath(dst)))


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Durable whole-file write via ``<path>.tmp`` + :func:`publish_file`.
    Callers own the directory and serialize their writes, so a stale temp
    from a crashed predecessor is simply overwritten."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
        publish_file(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj) -> None:
    atomic_write_bytes(path, json.dumps(obj).encode())
