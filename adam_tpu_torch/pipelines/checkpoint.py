"""Stage checkpoint-restart (the stage half of
``adam_tpu/pipelines/checkpoint.py``, copied; its streamed run journal,
``RunJournal``, is not ported yet).

Each completed stage of the dataset-level ``transform`` can persist its
whole dataset to Parquet under a checkpoint directory, beside a manifest
(``MANIFEST.json``: ``stages``, ``completed`` and ``fingerprint``) that
records the stage order and which stages completed.  A rerun of the same
pipeline over the same input resumes after the deepest completed stage
instead of recomputing.  Resume validity is decided by input content
identity and flag composition (:func:`input_fingerprint`,
:func:`compose_fingerprint`), not by whatever happens to be on disk.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Callable, Optional, Sequence

from adam_tpu_torch.utils.durability import atomic_write_json

logger = logging.getLogger(__name__)

_MANIFEST = "MANIFEST.json"

#: Inputs at or under this size hash fully; larger ones hash
#: size + head + tail windows of this size.
_FULL_HASH_LIMIT = 64 << 20
_EDGE_HASH_BYTES = 8 << 20


def input_fingerprint(path: str) -> str:
    """Content-identity digest of an input file (or columnar store dir).

    Files up to 64 MiB digest in full; larger files digest
    ``size + first 8 MiB + last 8 MiB``.  Directories (a ``.adam``
    store) digest the sorted non-underscore entry list with sizes.  The
    path itself is not part of the identity: the same bytes moved
    elsewhere still resume.
    """
    h = hashlib.sha256()
    p = os.path.abspath(path)
    if os.path.isdir(p):
        h.update(b"dir:")
        for name in sorted(os.listdir(p)):
            if name.startswith(("_", ".")):
                continue
            try:
                size = os.path.getsize(os.path.join(p, name))
            except OSError:
                size = -1
            h.update(f"{name}={size};".encode())
        return h.hexdigest()
    size = os.path.getsize(p)
    h.update(f"file:{size};".encode())
    with open(p, "rb") as fh:
        if size <= _FULL_HASH_LIMIT:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                h.update(chunk)
        else:
            remaining = _EDGE_HASH_BYTES
            while remaining:
                chunk = fh.read(min(remaining, 1 << 20))
                if not chunk:
                    break
                h.update(chunk)
                remaining -= len(chunk)
            fh.seek(size - _EDGE_HASH_BYTES)
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                h.update(chunk)
    return h.hexdigest()


def _canon(v):
    """JSON-able canonical form of one fingerprint field (numpy arrays
    and array tuples digest by content)."""
    import numpy as np

    if isinstance(v, np.ndarray):
        a = np.ascontiguousarray(v)
        return {
            "ndarray": hashlib.sha256(a.tobytes()).hexdigest(),
            "dtype": str(a.dtype),
            "shape": list(a.shape),
        }
    if isinstance(v, (list, tuple)):
        return [_canon(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _canon(v[k]) for k in sorted(v)}
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, np.generic):
        return v.item()
    # objects exposing array fields (SnpTable-style): digest their dict
    d = getattr(v, "__dict__", None)
    if d:
        return _canon(d)
    return repr(v)


def compose_fingerprint(fields: dict) -> str:
    """Stable digest of a flag-composition dict (include the
    :func:`input_fingerprint` as one of the fields)."""
    doc = json.dumps(_canon(fields), sort_keys=True)
    return hashlib.sha256(doc.encode()).hexdigest()


class StageCheckpointer:
    """Tracks stage completion under ``directory``.

    A stage is resumable only if the manifest's stage list equals the
    current pipeline's AND the fingerprints agree: a changed flag
    composition or a changed input invalidates the stage stores (with a
    warning) instead of reloading data derived from other bytes.  A torn
    or unreadable manifest means a restart, not an error.
    """

    def __init__(self, directory: str, stages: Sequence[str],
                 fingerprint: Optional[str] = None):
        self.dir = directory
        self.stages = list(stages)
        self.fingerprint = fingerprint
        os.makedirs(directory, exist_ok=True)
        self._completed: list[str] = []
        mpath = os.path.join(directory, _MANIFEST)
        m = None
        if os.path.exists(mpath):
            try:
                with open(mpath) as fh:
                    m = json.load(fh)
                if not isinstance(m, dict):
                    raise ValueError(f"manifest is {type(m).__name__}, "
                                     "not an object")
            except (OSError, ValueError) as e:
                logger.warning(
                    "checkpoint manifest %s is unreadable (%s); treating "
                    "as no checkpoint and restarting", mpath, e,
                )
                m = None
        if m is not None:
            if m.get("stages") != self.stages:
                logger.warning(
                    "checkpoint dir %s was built for stages %s (now %s); "
                    "ignoring old checkpoints", directory,
                    m.get("stages"), self.stages,
                )
            elif (fingerprint is not None
                  and m.get("fingerprint") != fingerprint):
                # a manifest without a fingerprint is indistinguishable
                # from a changed input: recompute
                logger.warning(
                    "checkpoint dir %s was built for a different input/"
                    "flag fingerprint (%s, now %s); ignoring old "
                    "checkpoints", directory, m.get("fingerprint"),
                    fingerprint,
                )
            else:
                self._completed = [
                    s for s in m.get("completed", [])
                    if os.path.exists(self.path(s))
                ]

    def path(self, stage: str) -> str:
        return os.path.join(self.dir, f"{stage}.adam")

    def last_completed(self) -> Optional[str]:
        """Deepest stage that completed as a prefix of the stage list."""
        last = None
        for s in self.stages:
            if s in self._completed:
                last = s
            else:
                break
        return last

    def mark(self, stage: str) -> None:
        # idempotent: a re-executed stage must not grow a duplicate entry
        if stage not in self._completed:
            self._completed.append(stage)
        doc = {"stages": self.stages, "completed": self._completed}
        if self.fingerprint is not None:
            doc["fingerprint"] = self.fingerprint
        # temp + fsync + atomic rename: a crash mid-write leaves the old
        # manifest or the new one, never a torn file
        atomic_write_json(os.path.join(self.dir, _MANIFEST), doc)


def run_stages(
    ds,
    stages: Sequence[tuple[str, Callable]],
    checkpoint_dir: Optional[str] = None,
    fingerprint: Optional[str] = None,
):
    """Run ``(name, fn)`` stages over a dataset, with optional
    checkpoint-restart.

    With a checkpoint dir, each stage's output is saved to
    ``<dir>/<name>.adam`` and recorded; a rerun resumes after the deepest
    completed stage (loading its store) instead of recomputing.
    ``fingerprint`` (:func:`compose_fingerprint` over the input identity
    and flag values) invalidates stores from another input or
    composition.
    """
    if not checkpoint_dir:
        for _, fn in stages:
            ds = fn(ds)
        return ds

    from adam_tpu_torch.api.datasets import AlignmentDataset

    ck = StageCheckpointer(checkpoint_dir, [n for n, _ in stages],
                           fingerprint=fingerprint)
    resume_after = ck.last_completed()
    skipping = resume_after is not None
    if skipping:
        logger.info("resuming after checkpointed stage %r", resume_after)
        ds = AlignmentDataset.load(ck.path(resume_after))
    for name, fn in stages:
        if skipping:
            if name == resume_after:
                skipping = False
            continue
        ds = fn(ds)
        ds.save(ck.path(name))
        ck.mark(name)
    return ds
