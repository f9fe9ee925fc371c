"""Continuous cross-job window batching — the port's counterpart of
``adam_tpu/serve/batching.py``.

The scheduler interleaves concurrent jobs at window granularity, so N
small jobs pay N per-window dispatches, each one under-filling the card.
A :class:`WindowCoalescer` sits between the ``JobScheduler`` and the
dispatch sites: it collects ready windows from concurrent jobs (ordered
by the fairness interleaver's tenant clocks, bounded batching delay
``ADAM_TPU_BATCH_WAIT_MS``) and merges up to :data:`MAX_GROUP_TICKETS`
of them into **one fused dispatch per pass**, on its own thread:

* **markdup**: the per-ticket columns concatenated and
  ``pipelines/markdup.markdup_columns_local`` run once; each row's key
  and score depend on that row alone, so each ticket's slice is its solo
  column.
* **observe** (kernel 1, ``observe_hist``): each ticket's null read
  group resolves to its own ``n_rg_i - 1`` and its read groups offset by
  its band base *before* the concatenation; the bit-packed residue and
  mismatch rows concatenate as they are (packing is per row); one
  ``observe_packed_body`` at ``n_rg = sum(n_rg_i)``.  Integer counts over
  disjoint bands commute with the concatenation, so each ticket's band
  is bitwise its solo histogram.
* **apply** (kernel 2, ``pack_rows``): every job's solved table centred
  into the widest cycle axis and concatenated in job-sorted order
  (placed once per job set), one table gather and the two row-prefix
  packs of the port's pass C (``bqsr.apply_pack2_body``: the quals
  SANGER-encoded, the bases decoded) over the fused grid; each ticket's
  byte range is an exact prefix sum, so its slice is its solo payload,
  and only the real bytes come home.

Threads and streams: torch's current device and stream are per thread,
so the dispatch thread enters the target slot's scope
(``parallel/device_pool.Slot.scope``) for every launch; a resident
window a job thread placed on its slot crosses to the target slot only
through ``device_pool.move_to``, and results come home through
``utils/transfer.device_fetch`` from the target slot's stream.  Without
a pool the target is the scheduler's device (``solo_slot(device)``).

The fault contract is JAX's: a fused dispatch that fails fails only the
tickets it carried, each of which re-dispatches on its job's own card
path (``sched.batch.fallbacks`` counts them).  Nothing here routes a
window onto the CPU or onto a plain version: on a card the fused bodies
reach the CUDA kernels, and the plain versions run only for CPU
tensors.  The ``sched.batch`` fault point arrives once per fused
dispatch (the pass kind in the ``device`` slot); ``proc.kill
device=batch`` is the chaos harness's mid-batch kill phase.

Each ticket's wait, from its submission to the start of its group's
dispatch, is one ``sched.batch.ticket_wait`` span (recording on only).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np
import torch

from adam_tpu_torch.utils import faults
from adam_tpu_torch.utils import telemetry as tele

log = logging.getLogger(__name__)

#: Bounded batching delay (milliseconds): how long the coalescer holds a
#: group open for more jobs' windows before dispatching what it has.
DEFAULT_BATCH_WAIT_MS = 25.0

#: Backstop on a blocking ticket wait: the dispatcher resolves or fails
#: every ticket it accepts, but a wedged card must surface as a fallback,
#: not a hang.
_RESULT_TIMEOUT_S = 600.0

#: Tickets per fused dispatch, capped (JAX's bound on the executable set;
#: here it also bounds the fused grid and the first-sight warm set).
#: Overflow tickets form the next group.
MAX_GROUP_TICKETS = 8


def batch_wait_ms() -> float:
    """``ADAM_TPU_BATCH_WAIT_MS`` (default 25 ms; a malformed or negative
    value warns and keeps the default)."""
    from adam_tpu_torch.utils.retry import env_float

    v = env_float("ADAM_TPU_BATCH_WAIT_MS", DEFAULT_BATCH_WAIT_MS)
    if v < 0:
        log.warning("ADAM_TPU_BATCH_WAIT_MS=%s is negative; using default "
                    "%.0fms", v, DEFAULT_BATCH_WAIT_MS)
        return DEFAULT_BATCH_WAIT_MS
    return v


def batching_enabled(default: bool = False) -> bool:
    """``ADAM_TPU_BATCH`` toggle (default off; ``serve --batch`` sets
    it)."""
    from adam_tpu_torch.utils.retry import env_toggle

    return env_toggle("ADAM_TPU_BATCH", default)


class CoalesceError(RuntimeError):
    """A ticket's fused dispatch failed (or the coalescer is stopping):
    the caller falls back to its own dispatch path."""


class _Future:
    """Event-backed single-value future.  ``dataset`` carries an apply
    ticket's pre-recalibration dataset for the fallback."""

    __slots__ = ("_ev", "_value", "_error", "dataset")

    def __init__(self):
        self._ev = threading.Event()
        self._value = None
        self._error = None
        self.dataset = None

    def set_result(self, value) -> None:
        self._value = value
        self._ev.set()

    def set_error(self, exc: BaseException) -> None:
        self._error = exc
        self._ev.set()

    def result(self, timeout: float = _RESULT_TIMEOUT_S):
        if not self._ev.wait(timeout):
            raise CoalesceError(f"fused dispatch did not resolve within {timeout:.0f}s")
        if self._error is not None:
            raise self._error
        return self._value


class _Ticket:
    __slots__ = ("kind", "key", "job", "tenant", "window", "seq", "t_submit",
                 "n", "g", "gl", "payload", "fut", "trace")

    def __init__(self, kind, key, job, tenant, window, seq, n, g, gl, payload,
                 trace=None):
        self.kind = kind
        self.key = key
        self.job = job
        self.tenant = tenant
        self.window = window
        self.seq = seq
        self.trace = trace  # the submitting job's trace id (fan-in link)
        self.t_submit = time.monotonic()
        self.n = n          # real rows
        self.g = g          # grid rows (the block's leading dim)
        self.gl = gl
        self.payload = payload
        self.fut = _Future()


# --------------------------------------------------------------------------
# The fused bodies: concatenate the per-ticket blocks, run the solo body
# once.  On the card they reach the CUDA kernels; on CPU tensors, their
# plain versions.
# --------------------------------------------------------------------------
def _band_rg(rg: torch.Tensor, base: int, n_rg_i: int) -> torch.Tensor:
    """A ticket's read-group indices in its band of the fused table: the
    null group resolved to its own last bin, clamped into its band (as
    the solo gather clamps), offset by the band's base."""
    rg = rg.to(torch.int64)
    own = torch.clamp(torch.where(rg >= 0, rg, n_rg_i - 1), 0, n_rg_i - 1)
    return (own + base).to(torch.int32)


def fused_markdup_body(cols):
    """cols: per ticket (start, end, flags, ops, lens, n_ops, quals,
    lengths), each ``[g_i(, gc/gl)]`` -> (five, score) over the fused
    grid."""
    from adam_tpu_torch.pipelines.markdup import markdup_columns_local

    cat = [torch.cat(xs, dim=0) for xs in zip(*cols)]
    return markdup_columns_local(*cat)


def fused_observe_body(cols, masks, segs, n_rg: int, lmax: int):
    """cols: per ticket (bases, quals, lengths, flags, read_group_idx);
    masks: per ticket (res_bits, mm_bits, read_ok), the masks bit-packed
    per row; segs: per ticket ``(rg_base, n_rg_i)`` -> (total, mism)
    i64[n_rg, 94, 2*lmax+1, 17] from one ``observe_hist`` launch."""
    from adam_tpu_torch.pipelines.bqsr import observe_packed_body

    parts = []
    for (bases, quals, lengths, flags, rg), (res, mm, ok), (base, nri) in zip(
            cols, masks, segs):
        parts.append((bases, quals, lengths, flags, _band_rg(rg, base, nri),
                      res, mm, ok))
    cat = [torch.cat(xs, dim=0) for xs in zip(*parts)]
    return observe_packed_body(*cat, n_rg, lmax)


def fused_apply_body(cols, extras, table, segs, lmax: int, size: int):
    """cols as in :func:`fused_observe_body`; extras: per ticket
    (has_qual, valid); table: the fused (centred, concatenated) u8 table;
    segs: per ticket ``(band base, band rows)`` -> (packed quals, packed
    bases), each u8[size]: one table gather and the two ``pack_rows``
    launches of pass C over the fused grid."""
    from adam_tpu_torch.pipelines.bqsr import apply_pack2_body

    parts = []
    for (bases, quals, lengths, flags, rg), (hq, vd), (base, nri) in zip(
            cols, extras, segs):
        parts.append((bases, quals, lengths, flags, _band_rg(rg, base, nri), hq, vd))
    cat = [torch.cat(xs, dim=0) for xs in zip(*parts)]
    return apply_pack2_body(*cat, table, lmax, size)


def _zeros_like_tree(tree):
    """Zeros of the same shapes, dtypes and devices (the warm call's
    payload: only the shapes matter)."""
    if isinstance(tree, (tuple, list)):
        return tuple(_zeros_like_tree(x) for x in tree)
    return torch.zeros_like(tree)


class CoalescerClient:
    """One job's bound handle onto the shared coalescer: what the
    scheduler passes to ``transform_streamed(coalescer=...)``."""

    def __init__(self, coalescer: "WindowCoalescer", job: str, tenant: str,
                 trace: Optional[str] = None):
        self._c = coalescer
        self.job = job
        self.tenant = tenant
        self.trace = trace

    def submit_markdup(self, window, batch, resident=None) -> _Future:
        return self._c.submit_markdup(self.job, self.tenant, window, batch, resident)

    def submit_observe(self, window, ds, known_snps=None, resident=None) -> _Future:
        return self._c.submit_observe(self.job, self.tenant, window, ds, known_snps,
                                      resident)

    def submit_apply(self, window, ds, table, resident=None) -> _Future:
        return self._c.submit_apply(self.job, self.tenant, window, ds, table, resident)


class WindowCoalescer:
    """Cross-job fused-dispatch engine (module docstring).

    ``pool``: the scheduler's shared ``DevicePool`` (None on one card:
    fused dispatches then run on ``device``, the scheduler's device).
    ``interleaver``: the WFQ interleaver whose tenant clocks order the
    tickets inside a fused grid.  ``quota``: an optional
    ``serve/quota.QuotaManager`` charged per fused dispatch with each
    tenant's compute share."""

    def __init__(self, pool=None, wait_ms: Optional[float] = None,
                 interleaver=None, quota=None, tracer=None, device="cuda"):
        from adam_tpu_torch.device import resolve_device
        from adam_tpu_torch.parallel.device_pool import solo_slot

        self.pool = pool
        self.device = resolve_device(device)
        self._solo = solo_slot(self.device)
        self.wait_s = (batch_wait_ms() if wait_ms is None else float(wait_ms)) / 1e3
        self.interleaver = interleaver
        self.quota = quota
        self.tracer = tracer if tracer is not None else tele.TRACE
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._jobs: dict = {}        # job -> tenant (the eligible set)
        self._job_traces: dict = {}  # job -> trace id (fan-in links)
        self._pending: list = []
        self._seq = 0
        self._rr = 0
        self._stopped = False
        self._warmed: set = set()
        # the fused table placed per (job-sorted (job, table id) tuple,
        # n_cyc, slot): a job's table is constant for its run, so the
        # centre + concat + h2d happens once per job set.  The cached
        # values hold the tables, so an id in a key cannot be recycled.
        self._table_cache: dict = {}
        self._largest: dict = {}  # kind -> (grid rows, n_rg, tickets)
        self._thread = threading.Thread(target=self._run, name="adam-tpu-coalescer",
                                        daemon=True)
        self._thread.start()

    # ---- job lifecycle (scheduler side) --------------------------------
    def client(self, job: str, tenant: str = "default",
               trace: Optional[str] = None) -> CoalescerClient:
        """Register a job as coalesce-eligible -> its bound client."""
        with self._lock:
            self._jobs[job] = tenant
            if trace is not None:
                self._job_traces[job] = trace
            self._cond.notify_all()
        return CoalescerClient(self, job, tenant, trace)

    def deregister(self, job: str) -> None:
        """Drop a job from the eligible set (idempotent); groups waiting
        on its windows flush at their next check."""
        with self._lock:
            self._jobs.pop(job, None)
            self._job_traces.pop(job, None)
            self._cond.notify_all()

    def stop(self) -> None:
        """Stop the dispatcher: pending groups flush at once, new
        submissions raise (callers fall back to their own path)."""
        with self._lock:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=30.0)

    # ---- ticket submission (pipeline side, through CoalescerClient) ----
    def _submit(self, kind, key, job, tenant, window, n, g, gl, payload) -> _Future:
        with self._lock:
            if self._stopped:
                raise CoalesceError("coalescer is stopped")
            self._seq += 1
            t = _Ticket(kind, key, job, tenant, window, self._seq, n, g, gl, payload,
                        trace=self._job_traces.get(job))
            self._pending.append(t)
            self._cond.notify_all()
        return t.fut

    def submit_markdup(self, job, tenant, window, batch, resident=None) -> _Future:
        from adam_tpu_torch.formats import schema
        from adam_tpu_torch.formats.batch import (
            grid_cigar_cols, grid_cols, grid_rows, pad_rows_np,
        )

        b = batch.to_numpy()
        g = grid_rows(b.n_rows)
        gl = grid_cols(b.lmax)
        gc = grid_cigar_cols(b.cigar_ops.shape[1] if b.cigar_ops.ndim == 2 else 1)
        payload = {
            "b": b,
            "resident": resident,
            # the markdup columns always ship, as the solo dispatch's do
            "fresh": (
                pad_rows_np(b.start, g, -1),
                pad_rows_np(b.end, g, -1),
                pad_rows_np(b.cigar_ops, g, schema.CIGAR_PAD, cols=gc),
                pad_rows_np(b.cigar_lens, g, 0, cols=gc),
                pad_rows_np(b.cigar_n, g, 0),
            ),
        }
        return self._submit("markdup", ("markdup", gl, gc), job, tenant, window,
                            b.n_rows, g, gl, payload)

    def submit_observe(self, job, tenant, window, ds, known_snps=None,
                       resident=None) -> _Future:
        from adam_tpu_torch.formats.batch import grid_cols, grid_rows
        from adam_tpu_torch.pipelines.bqsr import _observe_host_masks

        # the host mask prep runs on the job's thread (in parallel across
        # jobs); the dispatch thread only fuses and launches
        b = ds.batch.to_numpy()
        g = grid_rows(b.n_rows)
        gl = grid_cols(b.lmax)
        payload = {
            "b": b,
            "resident": resident,
            "n_rg": len(ds.read_groups) + 1,
            "masks": _observe_host_masks(ds, b, g, gl, known_snps),
        }
        return self._submit("observe", ("observe", gl), job, tenant, window,
                            b.n_rows, g, gl, payload)

    def submit_apply(self, job, tenant, window, ds, table, resident=None) -> _Future:
        from adam_tpu_torch.formats.batch import grid_cols, grid_rows
        from adam_tpu_torch.ops.colpack import pack_lengths
        from adam_tpu_torch.pipelines.bqsr import _apply_host_masks

        # the table's cycle half-width is not passed: the fused gather
        # derives it from the fused table's own shape, as the solo one does
        b = ds.batch.to_numpy()
        g = grid_rows(b.n_rows)
        gl = grid_cols(b.lmax)
        payload = {
            "ds": ds,
            "b": b,
            "resident": resident,
            "table": np.ascontiguousarray(table, np.uint8),
            "extras": _apply_host_masks(b, g),
            "lens_q": pack_lengths(b.lengths, b.valid, b.has_qual),
            "lens_b": pack_lengths(b.lengths, b.valid),
        }
        fut = self._submit("apply", ("apply", gl), job, tenant, window,
                           b.n_rows, g, gl, payload)
        fut.dataset = ds
        return fut

    # ---- the dispatch thread ---------------------------------------------
    def _wfq_rank(self, t: _Ticket):
        """Order inside a fused grid: the tenant's WFQ clock first (the
        most underserved tenant's rows lead), then submission order."""
        vt = self.interleaver.tenant_clock(t.tenant) if self.interleaver is not None else None
        return (vt if vt is not None else 0.0, t.tenant, t.seq)

    def _take_group_locked(self) -> Optional[list]:
        """The oldest pending (kind, key) group once it is ripe: every
        eligible job is in it or busy with a ticket of another bucket, the
        bounded delay expired, or the coalescer is stopping.  None = keep
        waiting.  Caller holds the lock."""
        if not self._pending:
            return None
        head = min(self._pending, key=lambda t: t.seq)
        grp = []
        busy_elsewhere = set()
        for t in self._pending:
            if (t.kind, t.key) == (head.kind, head.key):
                grp.append(t)
            else:
                busy_elsewhere.add(t.job)
        jobs_in = {t.job for t in grp}
        ripe = (
            self._stopped
            or (jobs_in | busy_elsewhere) >= set(self._jobs)
            or time.monotonic() - head.t_submit >= self.wait_s
        )
        if not ripe:
            return None
        if len(grp) > MAX_GROUP_TICKETS:
            grp = sorted(grp, key=lambda t: t.seq)[:MAX_GROUP_TICKETS]
        drop = {id(t) for t in grp}
        self._pending = [t for t in self._pending if id(t) not in drop]
        return grp

    def _run(self) -> None:
        while True:
            with self._lock:
                while True:
                    grp = self._take_group_locked()
                    if grp is not None:
                        break
                    if self._stopped and not self._pending:
                        return
                    if not self._pending:
                        self._cond.wait()
                        continue
                    head = min(self._pending, key=lambda t: t.seq)
                    timeout = max(1e-3, head.t_submit + self.wait_s - time.monotonic())
                    self._cond.wait(min(timeout, 0.05))
            self._dispatch_group(grp)

    def _target_slot(self, grp: list):
        """The fused dispatch's slot: the first live resident window's
        (so coalescing reads resident tensors in place), else a
        round-robin pool survivor, else the scheduler's device."""
        for t in grp:
            rw = t.payload.get("resident")
            if rw is not None and rw.alive and not isinstance(rw.slot, str):
                return rw.slot
        if self.pool is not None:
            alive = self.pool.alive_devices()
            if alive:
                self._rr += 1
                return alive[self._rr % len(alive)]
        return self._solo

    def _resident_cols(self, t: _Ticket, slot, put):
        """The five kernel columns of one ticket on ``slot``: its resident
        tensors when they are alive on that device at the same grid,
        moved onto ``slot``'s stream; else the grid-padded host copy,
        placed fresh."""
        from adam_tpu_torch.parallel.device_pool import ResidentWindow, move_to

        rw = t.payload.get("resident")
        if (rw is not None and not isinstance(rw.slot, str)
                and rw.slot.device == slot.device and rw.g == t.g and rw.gl == t.gl):
            try:
                return tuple(move_to(x, rw.slot, slot) for x in rw.args())
            except RuntimeError:
                pass  # released since the check: re-ship from the host copy
        host = ResidentWindow.host_arrays(t.payload["b"], t.g, t.gl)
        return tuple(put(host[f]) for f in ResidentWindow.FIELDS)

    def _warm(self, body, args, statics, key, slot) -> None:
        """First sight of a fused shape: run the body once on zero tensors
        of the group's shapes under a prewarm scope, so the real dispatch
        is a compile-ledger hit (``device.compile.in_window`` stays 0)
        and the warm launches count in ``kernels.prewarm_launches``."""
        from adam_tpu_torch.parallel.device_pool import span_attrs
        from adam_tpu_torch.utils import compile_ledger

        cache_key = (key, compile_ledger.device_cache_key(slot))
        with self._lock:
            if cache_key in self._warmed:
                return
            self._warmed.add(cache_key)
        try:
            with self.tracer.span(tele.SPAN_POOL_PREWARM_COMPILE, kernel=str(key[0]),
                                  **span_attrs(slot)), \
                    compile_ledger.prewarm_scope(), tele.pass_scope("prewarm"), \
                    compile_ledger.track(key, slot), slot.scope():
                out = body(*_zeros_like_tree(args), **statics)
                slot.synchronize()
                del out
        except Exception:
            with self._lock:
                self._warmed.discard(cache_key)
            log.warning("fused prewarm of %s failed; the shape warms at dispatch "
                        "instead", key, exc_info=True)

    def _launch(self, body, args, statics, key, slot):
        """One fused dispatch on ``slot``: warm on first sight, then the
        ``device.dispatch`` fault point and the body, retried as a unit,
        inside the slot's scope and the compile ledger's record."""
        from adam_tpu_torch.utils import compile_ledger
        from adam_tpu_torch.utils import retry as retry_mod

        self._warm(body, args, statics, key, slot)

        def unit():
            faults.point("device.dispatch",
                         device=slot.id if slot.attributed else None)
            with slot.scope():
                return body(*args, **statics)

        with compile_ledger.track(key, slot):
            out = retry_mod.retry_call(unit, site="sched.batch.dispatch")
        self.tracer.count(tele.C_DEVICE_DISPATCHED)
        return out

    def _dispatch_group(self, grp: list) -> None:
        """Fuse and dispatch one group; resolve every ticket's future (a
        failure fails the whole group, and each caller re-dispatches on
        its own path)."""
        grp.sort(key=self._wfq_rank)
        kind = grp[0].kind
        now_ns = time.monotonic_ns()
        for t in grp:  # each ticket's wait, submission -> this dispatch
            t0_ns = int(t.t_submit * 1e9)
            self.tracer.add_span(tele.SPAN_BATCH_TICKET_WAIT, t0_ns, now_ns - t0_ns,
                                 kind=kind, job=t.job, window=t.window)
        links = [{"job": t.job, "window": t.window, "trace": t.trace} for t in grp]
        try:
            faults.point("sched.batch", device=kind)
            faults.point("proc.kill", device="batch")
            with self.tracer.span(tele.SPAN_BATCH_FUSED, kind=kind, windows=len(grp),
                                  links=links), tele.pass_scope("batch"):
                if kind == "markdup":
                    results, wall = self._fuse_markdup(grp)
                elif kind == "observe":
                    results, wall = self._fuse_observe(grp)
                else:
                    results, wall = self._fuse_apply(grp)
        except BaseException as e:
            self.tracer.count(tele.C_BATCH_FALLBACKS, len(grp))
            log.warning("fused %s dispatch of %d window(s) failed (%s); every "
                        "carried job re-dispatches on its own path", kind, len(grp), e)
            err = CoalesceError(f"fused {kind} dispatch failed: {type(e).__name__}: {e}")
            for t in grp:
                t.fut.set_error(err)
            return
        rows_occ = sum(t.n for t in grp)
        rows_disp = sum(t.g for t in grp)
        tr = self.tracer
        tr.count(tele.C_BATCH_DISPATCHES)
        tr.count(tele.C_BATCH_WINDOWS, len(grp))
        tr.count(tele.C_BATCH_ROWS_OCCUPIED, rows_occ)
        tr.count(tele.C_BATCH_ROWS_DISPATCHED, rows_disp)
        tr.observe(tele.H_BATCH_FILL, rows_occ / max(rows_disp, 1))
        tr.gauge(tele.G_BATCH_JOBS, len({t.job for t in grp}))
        if self.quota is not None:
            # the compute leg of each tenant's budget: its rows' share of
            # the fused dispatch + fetch wall (the byte leg is charged at
            # the pacer's grant)
            for t in grp:
                self.quota.charge(t.tenant, compute_s=wall * t.n / max(rows_occ, 1))
        for t, res in zip(grp, results):
            t.fut.set_result(res)

    def _note_group(self, grp: list, n_rg: int) -> None:
        shape = (sum(t.g for t in grp), n_rg, len(grp))
        with self._lock:
            self._largest[grp[0].kind] = max(self._largest.get(grp[0].kind, shape), shape)

    def largest_groups(self) -> dict:
        """Kind -> the largest fused group so far, by grid rows then
        read-group bins: ``{"tickets", "g", "n_rg"}``."""
        with self._lock:
            return {k: {"tickets": v[2], "g": v[0], "n_rg": v[1]}
                    for k, v in self._largest.items()}

    # ---- the three fused executors ---------------------------------------
    def _fuse_markdup(self, grp: list):
        from adam_tpu_torch.parallel.device_pool import putter
        from adam_tpu_torch.utils.transfer import device_fetch

        slot = self._target_slot(grp)
        put = putter(slot)
        cols = []
        for t in grp:
            start, end, ops, lens, n_ops = t.payload["fresh"]
            _bases, quals, lengths, flags, _rg = self._resident_cols(t, slot, put)
            cols.append((put(start), put(end), flags, put(ops), put(lens), put(n_ops),
                         quals, lengths))
        key = ("batch.markdup", tuple((t.g, t.gl, grp[0].key[2]) for t in grp))
        self._note_group(grp, 0)
        t_d = time.monotonic()
        five, score = self._launch(fused_markdup_body, (tuple(cols),), {}, key, slot)
        five = device_fetch(five, slot)
        score = device_fetch(score, slot)
        wall = time.monotonic() - t_d
        self.tracer.count(tele.C_DEVICE_FETCHED)
        results = []
        r0 = 0
        for t in grp:
            results.append((np.ascontiguousarray(five[r0:r0 + t.n]),
                            np.ascontiguousarray(score[r0:r0 + t.n])))
            r0 += t.g
        return results, wall

    def _fuse_observe(self, grp: list):
        from adam_tpu_torch.parallel.device_pool import putter
        from adam_tpu_torch.utils.transfer import device_fetch

        slot = self._target_slot(grp)
        put = putter(slot)
        gl = grp[0].gl
        cols, masks, segs = [], [], []
        base = 0
        for t in grp:
            cols.append(self._resident_cols(t, slot, put))
            masks.append(tuple(put(a) for a in t.payload["masks"]))
            segs.append((base, t.payload["n_rg"]))
            base += t.payload["n_rg"]
        n_rg = base
        key = ("batch.observe", tuple((t.g, t.payload["n_rg"]) for t in grp), gl)
        statics = {"segs": tuple(segs), "n_rg": n_rg, "lmax": gl}
        self._note_group(grp, n_rg)
        t_d = time.monotonic()
        total, mism = self._launch(fused_observe_body, (tuple(cols), tuple(masks)),
                                   statics, key, slot)
        # one fetch for the group; each ticket's band is its solo histogram
        total = device_fetch(total, slot)
        mism = device_fetch(mism, slot)
        wall = time.monotonic() - t_d
        self.tracer.count(tele.C_DEVICE_FETCHED)
        results = [(np.ascontiguousarray(total[b0:b0 + nri]),
                    np.ascontiguousarray(mism[b0:b0 + nri]), gl)
                   for b0, nri in segs]
        return results, wall

    def _fused_table(self, grp: list, slot, put):
        """The group's fused table on ``slot`` and each job's band: every
        job's table centred into the widest cycle axis (the merge's
        centring) and concatenated in job-sorted order, so the layout
        does not depend on the WFQ row order and the cache hits across
        dispatches of one job set."""
        from adam_tpu_torch.utils import compile_ledger

        job_tables = dict(sorted({t.job: t.payload["table"] for t in grp}.items()))
        n_cyc = max(tb.shape[2] for tb in job_tables.values())
        cache_key = (tuple((j, id(tb)) for j, tb in job_tables.items()), n_cyc,
                     compile_ledger.device_cache_key(slot))
        with self._lock:
            cached = self._table_cache.get(cache_key)
        if cached is not None:
            return cached[1], cached[2], n_cyc
        tparts, bands, base = [], {}, 0
        for j, tbl in job_tables.items():
            off = (n_cyc - tbl.shape[2]) // 2
            wide = tbl
            if off:
                wide = np.zeros((tbl.shape[0], tbl.shape[1], n_cyc, tbl.shape[3]), np.uint8)
                wide[:, :, off:off + tbl.shape[2], :] = tbl
            tparts.append(wide)
            bands[j] = (base, tbl.shape[0])
            base += tbl.shape[0]
        with tele.pass_scope("table"):
            table_dev = put(np.ascontiguousarray(np.concatenate(tparts, axis=0)))
        with self._lock:
            if len(self._table_cache) >= 8:
                self._table_cache.clear()
            self._table_cache[cache_key] = (tuple(job_tables.values()), table_dev, bands)
        return table_dev, bands, n_cyc

    def _fuse_apply(self, grp: list):
        from adam_tpu_torch.io.arrow_pack import PackedColumns, PackedQuals
        from adam_tpu_torch.parallel.device_pool import putter
        from adam_tpu_torch.pipelines.bqsr import stash_orig_quals
        from adam_tpu_torch.utils.transfer import device_fetch

        slot = self._target_slot(grp)
        put = putter(slot)
        gl = grp[0].gl
        table_dev, bands, n_cyc = self._fused_table(grp, slot, put)
        segs = [bands[t.job] for t in grp]
        cols = [self._resident_cols(t, slot, put) for t in grp]
        extras = [tuple(put(a) for a in t.payload["extras"]) for t in grp]
        size = sum(t.g for t in grp) * gl
        key = ("batch.apply", tuple((t.g, t.payload["table"].shape[0]) for t in grp),
               gl, n_cyc)
        statics = {"segs": tuple(segs), "lmax": gl, "size": size}
        self._note_group(grp, int(table_dev.shape[0]))
        t_d = time.monotonic()
        pq, pb = self._launch(fused_apply_body, (tuple(cols), tuple(extras), table_dev),
                              statics, key, slot)
        # each column comes home at its exact size, and each job's byte
        # range is a prefix sum of the rows before it
        tot_q = [int(t.payload["lens_q"].sum()) for t in grp]
        tot_b = [int(t.payload["lens_b"].sum()) for t in grp]
        buf_q = device_fetch(pq[:sum(tot_q)], slot)
        buf_b = device_fetch(pb[:sum(tot_b)], slot)
        wall = time.monotonic() - t_d
        self.tracer.count(tele.C_DEVICE_FETCHED)
        results = []
        oq = ob = 0
        for t, nq, nb in zip(grp, tot_q, tot_b):
            packed = PackedColumns(
                quals=PackedQuals(buf_q[oq:oq + nq], t.payload["lens_q"]),
                bases=PackedQuals(buf_b[ob:ob + nb], t.payload["lens_b"]),
            )
            oq += nq
            ob += nb
            results.append((stash_orig_quals(t.payload["ds"], t.payload["b"]), packed))
        return results, wall
