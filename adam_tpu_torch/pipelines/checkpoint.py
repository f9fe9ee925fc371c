"""Checkpoint / restart (``adam_tpu/pipelines/checkpoint.py``, copied):
stage materialization and the streamed run journal.

* **Stage checkpoints** (:class:`StageCheckpointer`, :func:`run_stages`):
  each completed stage of the dataset-level ``transform`` can persist
  its whole dataset to Parquet under a checkpoint directory, beside a
  manifest (``MANIFEST.json``: ``stages``, ``completed`` and
  ``fingerprint``) that records the stage order and which stages
  completed.  A rerun of the same pipeline over the same input resumes
  after the deepest completed stage instead of recomputing.
* **The run journal** (:class:`RunJournal`): the streamed pipeline's
  window-granular durable resume (``--run-dir`` / ``--resume``): a
  fingerprinted record of which output parts are durably published, plus
  atomic sidecars of each window's observe histogram and of the solved
  recalibration table, so a host-process death (SIGKILL, OOM,
  preemption) costs only the windows not yet published.

Resume validity is decided by input content identity and flag
composition (:func:`input_fingerprint`, :func:`compose_fingerprint`),
not by whatever happens to be on disk.  The files are the JAX package's,
so a run directory of either package resumes in the other.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
from typing import Callable, Optional, Sequence

from adam_tpu_torch.utils.durability import atomic_write_bytes, atomic_write_json

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


# ---------------------------------------------------------------------------
# Window-granular durable resume: the streamed run journal
# ---------------------------------------------------------------------------
class RunJournal:
    """Durable resume state for one streamed run (``--run-dir``).

    Layout under ``run_dir``::

        JOURNAL.json           fingerprint, window plan, completed
                               window -> part-name map (rewritten whole,
                               durably, on every record)
        obs/window-NNNNN.npz   one atomic sidecar per window's pass-B
                               observe histogram (total, mism, gl),
                               written at barrier 2
        table.npz              the solved (or known) recalibration table
                               + gl, written once after barrier 2

    A window is recorded complete only after its Parquet part is durably
    published (the writer pool's ``on_published`` hook), so every entry
    is backed by readable bytes.  On resume the fingerprint (input
    content, flag composition, window sizing) is checked again: any
    mismatch, and a torn or foreign journal, is refused with a clean
    restart (journal, sidecars and previously published parts are
    discarded), never mixed output.  A refusal counts ``resume.refused``
    on ``tracer`` (the streamed run tracer; the global tracer when None)
    and in ``stats`` (the run's stats dict) when given."""

    SCHEMA = "adam_tpu.run_journal/1"
    JOURNAL_NAME = "JOURNAL.json"
    OBS_DIR_NAME = "obs"
    TABLE_NAME = "table.npz"

    def __init__(self, run_dir: str, fingerprint: str, out_dir: str,
                 resume: bool = False, stats: Optional[dict] = None,
                 tracer=None):
        self.dir = run_dir
        self.out_dir = out_dir
        self.fingerprint = fingerprint
        self._stats = stats
        self._tracer = tracer
        # record_window runs on the writer pool's write shards at once
        self._lock = threading.Lock()
        self._windows: dict[int, str] = {}
        self._n_windows: Optional[int] = None
        self.resumed = False
        os.makedirs(run_dir, exist_ok=True)
        os.makedirs(self._obs_dir, exist_ok=True)
        if resume:
            self.resumed = self._load()
            if not self.resumed:
                self._count_refused()
        if not self.resumed:
            with self._lock:
                self._start_fresh_locked()

    @classmethod
    def peek(cls, run_dir: str) -> Optional[dict]:
        """Read-only summary of a run dir's journal -> ``{"fingerprint",
        "n_windows", "completed"}``, or None when absent, unreadable or
        not a journal.  No side effects and no say in a resume."""
        path = os.path.join(run_dir, cls.JOURNAL_NAME)
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return None
        if not isinstance(doc, dict) or doc.get("schema") != cls.SCHEMA:
            return None
        return {
            "fingerprint": doc.get("fingerprint"),
            "n_windows": doc.get("n_windows"),
            "completed": len(doc.get("windows") or {}),
        }

    # ---- paths ---------------------------------------------------------
    @property
    def _journal_path(self) -> str:
        return os.path.join(self.dir, self.JOURNAL_NAME)

    @property
    def _obs_dir(self) -> str:
        return os.path.join(self.dir, self.OBS_DIR_NAME)

    @property
    def _table_path(self) -> str:
        return os.path.join(self.dir, self.TABLE_NAME)

    def observation_path(self, win: int) -> str:
        return os.path.join(self._obs_dir, f"window-{win:05d}.npz")

    # ---- lifecycle -----------------------------------------------------
    def _count_refused(self) -> None:
        from adam_tpu_torch.utils import telemetry as tele

        (self._tracer or tele.TRACE).count(tele.C_RESUME_REFUSED)
        if self._stats is not None:
            self._stats["resume.refused"] = self._stats.get("resume.refused", 0) + 1

    def _load(self) -> bool:
        """Validate and load an existing journal; False = refuse (the
        caller restarts clean)."""
        path = self._journal_path
        if not os.path.exists(path):
            logger.warning(
                "--resume requested but %s has no journal; starting a "
                "fresh run", self.dir,
            )
            return False
        try:
            with open(path) as fh:
                doc = json.load(fh)
            if not isinstance(doc, dict):
                raise ValueError(f"journal is {type(doc).__name__}, "
                                 "not an object")
        except (OSError, ValueError) as e:
            # torn or corrupt: a clean restart, never a guess at which
            # windows might be complete
            logger.warning(
                "run journal %s is unreadable (%s); refusing resume and "
                "restarting clean", path, e,
            )
            return False
        if doc.get("schema") != self.SCHEMA:
            logger.warning(
                "run journal %s has schema %r (want %r); refusing resume "
                "and restarting clean", path, doc.get("schema"),
                self.SCHEMA,
            )
            return False
        if doc.get("fingerprint") != self.fingerprint:
            logger.warning(
                "run journal %s was recorded for a different input/flag "
                "fingerprint (%s, now %s); refusing resume and restarting "
                "clean — a resume against changed inputs would silently "
                "mix stale and fresh windows", path,
                doc.get("fingerprint"), self.fingerprint,
            )
            return False
        try:
            windows = {
                int(k): str(v) for k, v in (doc.get("windows") or {}).items()
            }
            n_windows = doc.get("n_windows")
            if n_windows is not None:
                n_windows = int(n_windows)
        except (TypeError, ValueError, AttributeError) as e:
            logger.warning(
                "run journal %s has malformed window records (%s); "
                "refusing resume and restarting clean", path, e,
            )
            return False
        # every journaled part must still be readable bytes on disk: a
        # deleted part degrades its window to "incomplete" (it runs
        # again), never to a hole in the output
        kept = {}
        for win, name in windows.items():
            part = os.path.join(self.out_dir, name)
            if os.path.isfile(part) and os.path.getsize(part) > 0:
                kept[win] = name
            else:
                logger.warning(
                    "journaled part %s for window %d is missing; that "
                    "window will re-execute", part, win,
                )
        self._windows = kept
        self._n_windows = n_windows
        return True

    def _start_fresh_locked(self) -> None:
        """Discard every prior artifact: journal, sidecars, and the
        previously published parts (another run's output must never mix
        with this one's).  The caller holds ``self._lock``."""
        from adam_tpu_torch.io.parquet import part_index

        self._windows = {}
        self._n_windows = None
        for p in (self._journal_path, self._table_path):
            try:
                os.unlink(p)
            except OSError:
                pass
        try:
            for name in os.listdir(self._obs_dir):
                try:
                    os.unlink(os.path.join(self._obs_dir, name))
                except OSError:
                    pass
        except OSError:
            pass
        if os.path.isdir(self.out_dir):
            for name in os.listdir(self.out_dir):
                if part_index(name) is not None:
                    try:
                        os.unlink(os.path.join(self.out_dir, name))
                    except OSError:
                        pass
        self._flush_locked()

    def confirm_plan(self, n_windows: int) -> None:
        """Pin (or check again) the window plan once pass A fixes it.  The
        fingerprint already covers input identity and window sizing, so
        a mismatch means the journal lies: restart clean."""
        with self._lock:
            if self.resumed and self._n_windows is not None \
                    and self._n_windows != n_windows:
                logger.warning(
                    "run journal %s recorded %d windows but this input "
                    "tokenizes to %d; discarding the journal and "
                    "restarting clean", self._journal_path,
                    self._n_windows, n_windows,
                )
                self.resumed = False
                self._count_refused()
                self._start_fresh_locked()
            self._n_windows = n_windows
            self._flush_locked()

    # ---- window completion ---------------------------------------------
    def completed_windows(self) -> frozenset:
        """Window/part indices durably complete from a prior run."""
        with self._lock:
            return frozenset(self._windows) if self.resumed else frozenset()

    def record_window(self, win: int, part: str) -> None:
        """Durably record window ``win`` as complete (its part file
        ``part``, a name under ``out_dir``, is already published).
        Idempotent; safe from the writer pool's write threads."""
        with self._lock:
            if self._windows.get(win) == part:
                return
            self._windows[win] = part
            self._flush_locked()

    def _flush_locked(self) -> None:
        atomic_write_json(self._journal_path, {
            "schema": self.SCHEMA,
            "fingerprint": self.fingerprint,
            "n_windows": self._n_windows,
            "windows": {str(k): v for k, v in sorted(self._windows.items())},
        })

    # ---- observe-histogram / table sidecars ----------------------------
    def has_observation(self, win: int) -> bool:
        return os.path.isfile(self.observation_path(win))

    @staticmethod
    def _npz_bytes(**arrays) -> bytes:
        import io

        import numpy as np

        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        return buf.getvalue()

    def save_observation(self, win, total, mism, gl) -> None:
        """Persist one window's observe histogram (host arrays; atomic,
        idempotent)."""
        import numpy as np

        path = self.observation_path(win)
        if os.path.exists(path):
            return
        atomic_write_bytes(path, self._npz_bytes(
            total=np.asarray(total), mism=np.asarray(mism),
            gl=np.int64(gl),
        ))

    def load_observation(self, win: int):
        """-> (total, mism, gl) host arrays, or None (absent or
        unreadable: the window observes again)."""
        import numpy as np

        path = self.observation_path(win)
        if not os.path.isfile(path):
            return None
        try:
            with np.load(path) as z:
                return z["total"], z["mism"], int(z["gl"])
        except Exception as e:
            logger.warning(
                "observe sidecar %s is unreadable (%s); window %d will "
                "re-observe", path, e, win,
            )
            return None

    def save_table(self, table, gl) -> None:
        """Persist the applied recalibration table (once, after barrier
        2; a host array)."""
        import numpy as np

        atomic_write_bytes(self._table_path, self._npz_bytes(
            table=np.asarray(table), gl=np.int64(gl),
        ))

    def load_table(self):
        """-> (table, gl), or None when absent, unreadable or not
        resumed."""
        import numpy as np

        if not (self.resumed and os.path.isfile(self._table_path)):
            return None
        try:
            with np.load(self._table_path) as z:
                return z["table"], int(z["gl"])
        except Exception as e:
            logger.warning(
                "recalibration-table sidecar %s is unreadable (%s); "
                "re-solving from observations", self._table_path, e,
            )
            return None
