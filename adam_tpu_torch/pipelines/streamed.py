"""The streamed markdup + realign + BQSR transform on one device, a
device pool or a mesh — the counterpart of
``adam_tpu/pipelines/streamed.transform_streamed``.

The input is tokenized in windows by an ingest thread while the main
thread runs three passes with two global barriers:

  pass A     per window: place the window on the device (ingest-once:
             bases, quals, lengths, flags, read groups), dispatch its
             duplicate-marking reductions (5' keys, scores) and fold the
             fetched columns into a compact host summary; with
             realignment, extract the window's indel events.
  barrier 1  resolve duplicates over all windows' summaries (the 9-key
             lexsort on the device) and set the duplicate flags; merge
             the indel events of all windows into realignment targets.
  split      per window: rows mapped to a target are gathered as
             realignment candidates and masked out of the window.
  pass B     per window: host MD walk -> bit-packed residue-ok (known
             SNPs masked out) and mismatch masks, shipped to the device;
             covariate keys and the observe histogram (CUDA kernel
             ``observe_hist``) run there and stay there until the barrier.
             With a known recalibration table (the fused B->C tier) the
             window's apply + pack follows from the same dispatch.
  tail       realign the concatenated candidates (the sweeps, and under
             ``consensus_model="smithwaterman"`` the Smith-Waterman fill
             ``sw_fill``, on the device), with pass B running between the
             sweeps' dispatch and their fetch (``overlap_work``), then
             observe the realigned part as window ``n_windows`` with its
             post-realignment alignments (markdup -> realign -> BQSR, the
             reference's composition).
  barrier 2  fetch and merge the histograms in window order, solve the
             recalibration table on the host (f64 numpy) unless a known
             table was given.
  pass C     per window: table gather, SANGER encode, base decode and
             two row-prefix packs (CUDA kernel ``pack_rows``) on the
             device, double-buffered (a fused window only fetches); the
             packed columns come home (``sum(lengths)`` bytes each), OQ
             is stashed on the host and a writer pool encodes and
             publishes the Parquet part.  The realigned part goes
             first, as part ``n_windows``; a window whose rows were all
             realigned away writes no part.

With ``run_dir`` the run is journaled (``pipelines/checkpoint.RunJournal``,
the JAX package's files): the writer pool records each part after its
durable publish, barrier 2 persists every window's histogram and the
applied table, and ``resume=True`` skips the recorded parts (and, with a
journaled table, pass B's observe, the merge and the solve).  The
``proc.kill`` fault points (``utils/faults.py``) sit at the JAX package's
phase boundaries, so a test can SIGKILL the run anywhere and resume it.

Every Parquet part is byte-identical to the JAX package's streamed run on
the same input and flags (``tests/test_torch_streamed.py``).
"""

from __future__ import annotations

import hashlib
import logging
import os
import queue
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from adam_tpu_torch.api.datasets import AlignmentDataset
from adam_tpu_torch.device import device_key, resolve_device
from adam_tpu_torch.ops import kernels
from adam_tpu_torch.utils import faults
from adam_tpu_torch.utils import instrumentation as ins
from adam_tpu_torch.utils import telemetry as tele

log = logging.getLogger(__name__)

_SENTINEL = object()

#: A pass-B window whose observe rode the cross-job coalescer: its future
#: waits on the caller's ``defer`` list until every window has submitted.
_DEFERRED = object()


class RunCancelled(BaseException):
    """A cooperative stop at a window boundary (the service's drain or a
    job cancel), raised out of the ``pacer`` hook.  In pass C the writer
    pool closes gracefully first, so every part already submitted
    publishes and journals, and the resume starts right past them.  A
    ``BaseException`` so that no device recovery path, which catches
    ``Exception``, takes a drain for a card failure."""


def _ingest_windows(path: str, window_reads: int, out_q: queue.Queue,
                    abort: threading.Event, tr: tele.Tracer) -> None:
    """Ingest thread body: tokenize windows (a ``.bam``, after one ``.gz``
    is stripped, through the BAM reader, anything else as SAM text), push
    (batch, side, header);
    an exception is pushed for the consumer to raise.  ``abort`` unblocks
    the bounded put when the consumer dies mid-stream.  ``tr`` records one
    ``streamed.tokenize`` span per window on this thread's track."""

    def put(item) -> bool:
        while not abort.is_set():
            try:
                out_q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    try:
        from adam_tpu_torch.io import sam as sam_io

        p = str(path)
        base = p[:-3] if p.endswith(".gz") else p
        if base.endswith(".bam"):
            it = sam_io.iter_bam_batches(p, batch_reads=window_reads)
        else:
            it = sam_io.iter_sam_batches(p, batch_reads=window_reads)
        i = 0
        while True:
            with tr.span(tele.SPAN_TOKENIZE, window=i):
                item = next(it, _SENTINEL)
            if item is _SENTINEL:
                break
            if not put(item):
                return
            # one arrival per tokenized window
            faults.point("proc.kill", device="ingest")
            i += 1
        put(_SENTINEL)
    except BaseException as e:  # surface in the consumer
        put(e)


def run_fingerprint(path: str, *, mark_duplicates: bool, recalibrate: bool,
                    realign: bool, consensus_model: str, window_reads: int,
                    compression: str, max_indel_size: int,
                    max_consensus_number: int, lod_threshold: float,
                    max_target_size: int, known_snps=None, known_indels=None,
                    known_table=None) -> str:
    """The run journal's fingerprint of a streamed run: the JAX
    package's dict, key for key (input content, the stage flags, the
    resolved tuning, the known sites, and a known table as the sha256 of
    its u8 cast plus ``gl``), so the two packages compute equal strings
    and resume each other's run directories.  The device stays out: the
    card and the CPU write the same bytes."""
    from adam_tpu_torch.pipelines import checkpoint as ck

    return ck.compose_fingerprint({
        "schema": "adam_tpu.streamed/1",
        "input": ck.input_fingerprint(path),
        "mark_duplicates": mark_duplicates,
        "recalibrate": recalibrate,
        "realign": realign,
        "consensus_model": consensus_model,
        "window_reads": window_reads,
        "compression": compression,
        "max_indel_size": max_indel_size,
        "max_consensus_number": max_consensus_number,
        "lod_threshold": lod_threshold,
        "max_target_size": max_target_size,
        "known_snps": known_snps,
        "known_indels": known_indels,
        # absent (not None) without a known table, as in JAX
        **({"known_table": (
            hashlib.sha256(
                np.ascontiguousarray(known_table[0], np.uint8).tobytes()
            ).hexdigest(),
            int(known_table[1]),
        )} if known_table is not None else {}),
    })


def _start_heartbeat(tr: tele.Tracer, progress: Optional[str],
                     include_global: bool = True):
    """Build and start the live progress heartbeat, or None (the default:
    nothing is constructed).  As in the JAX package it samples the run
    tracer and the global ``TRACE`` (the fault counter lands on the
    latter); when no other sink already switched global recording on, it
    is switched on for the heartbeat's life and :func:`_stop_heartbeat`
    restores the flag and resets the tracer, so back-to-back runs in one
    process cannot sum each other's counters into a beat.
    ``include_global=False`` (a service job) samples the run tracer
    alone: concurrent jobs fold their tracers into ``TRACE`` as they
    finish, and a survivor's beat must not count its neighbours' work."""
    sink = progress if progress is not None else tele.progress_sink_from_env()
    if not sink:
        return None
    hb = tele.Heartbeat([tr, tele.TRACE] if include_global else [tr], sink)
    hb._hb_restore_recording = include_global and not tele.TRACE.recording
    if hb._hb_restore_recording:
        tele.TRACE.recording = True
    hb.start()
    return hb


def _stop_heartbeat(hb, ok: bool = True) -> None:
    """Idempotent heartbeat teardown: the final ``done`` line (``ok=False``
    on the exception paths) and the recording restore.  The normal finish
    calls it before the run tracer folds into ``TRACE`` (a sample after
    the absorb would count every counter twice)."""
    if hb is None:
        return
    hb.stop(ok=ok)
    if getattr(hb, "_hb_restore_recording", False):
        tele.TRACE.recording = False
        tele.TRACE.reset()
        hb._hb_restore_recording = False


def transform_streamed(
    path: str,
    out_path: str,
    *,
    mark_duplicates: bool = True,
    recalibrate: bool = True,
    realign: bool = True,
    known_snps=None,
    known_indels=None,
    consensus_model: str = "reads",
    window_reads: int = 262_144,
    compression: str = "zstd",
    n_writers: int = 3,
    max_indel_size: int | None = None,
    max_consensus_number: int | None = None,
    lod_threshold: float | None = None,
    max_target_size: int | None = None,
    dump_observations: Optional[str] = None,
    known_table: Optional[tuple] = None,
    run_dir: Optional[str] = None,
    resume: bool = False,
    progress: Optional[str] = None,
    devices: Optional[int] = None,
    partitioner: Optional[str] = None,
    device_pool=None,
    pacer=None,
    coalescer=None,
    trace: Optional[str] = None,
    device: str = "cuda",
) -> dict:
    """Run the streamed markdup + realign + BQSR transform -> stats (stage
    walls in seconds, read, window and candidate counts, resume counts,
    kernel launches in this run).

    Output is a Parquet part-file directory, ``out_path/part-r-NNNNN.parquet``
    with one part per input window that keeps rows, plus the realigned
    part ``n_windows``.  ``realign`` turns on indel realignment with the
    ``consensus_model`` ("reads", "smithwaterman" or "knowns") and the
    JAX package's tuning knobs (None = its defaults).  ``n_writers``
    sizes the writer pool (``n_writers - 1`` encoders; the write shards
    follow ``ADAM_TPU_WRITER_SHARDS``).  ``device`` is ``"cuda"``
    (default) or ``"cpu"``; the CPU runs each kernel's plain PyTorch
    version.

    The known-sites inputs, as in the JAX package: ``known_snps`` (a
    ``models.snp_table.SnpTable``) is masked out of every observe;
    ``known_indels`` (a ``models.snp_table.IndelTable``) supplies the
    consensuses, and turns the ``reads`` model into ``knowns``;
    ``known_table`` is a pre-solved recalibration table ``(table[n_rg, 94,
    n_cyc, 17], gl)``, cast to u8 and applied in place of the barrier-2
    solve with its cycle axis centred on ``(n_cyc - 1) // 2``, as JAX's
    gather centres it (the histograms are still merged, and dumped under
    ``dump_observations``).
    With a known table the fused B->C tier is armed (``ADAM_TPU_FUSED_BC``,
    on unless set to 0): each eligible window's observe and apply + pack
    run back to back from one dispatch in pass B, and pass C only fetches
    them.  Output bytes are the same fused or not.

    ``run_dir`` turns on the run journal (``pipelines/checkpoint.RunJournal``,
    the JAX package's files): each part is recorded complete after its
    durable publish, and the observe histograms and the applied table
    persist as sidecars at barrier 2.  With ``resume=True`` a rerun after
    a kill skips the recorded parts, and a journaled table skips pass B's
    observe, the merge and the solve; the output is byte-identical to an
    uninterrupted run, on either device.  A journal whose fingerprint
    (:func:`run_fingerprint`) differs is refused with a clean restart.
    A ``dump_observations`` resume observes again (the CSV needs the
    merged histograms) and arms the fused tier with the journaled table.

    Telemetry, as in the JAX package: the run records its stage spans,
    counters and gauges into a private, always-on tracer with a minted
    trace id, and the stage walls of ``stats`` are
    ``utils/telemetry.streamed_stats_view`` of its snapshot, so the two
    cannot disagree.  When recording is on (``-print_metrics``,
    ``--metrics-json``, ``--trace-out``, ``--report``) the tracer folds
    into the global ``TRACE`` at the end and the stage walls join the
    named-timer table.  ``progress`` names a live-heartbeat sink
    (``"stderr"`` or a file path; default ``ADAM_TPU_PROGRESS``, off when
    unset): one NDJSON line (``telemetry.HEARTBEAT_FIELDS``) every
    ``ADAM_TPU_PROGRESS_INTERVAL_S`` seconds and a last ``done`` line.
    Telemetry changes no output byte and no kernel launch.

    Several devices, as in the JAX package: ``devices`` caps the device
    pool (default every card, or ``ADAM_TPU_DEVICES``; capped at
    ``torch.cuda.device_count()`` with a warning, so one card runs one
    device); ``partitioner`` (``--partitioner`` / ``ADAM_TPU_PARTITIONER``)
    is ``"pool"`` (default: window ``i`` on slot ``i % n``) or ``"mesh"``
    (every window's rows split over the slots, the observe histograms
    summed on the card, one table per grid width fetched at barrier 2).
    ``device_pool`` (a ``parallel/device_pool.DevicePool`` or
    ``PoolLease``) substitutes a pool of the caller's: the only way to run
    two slots on one card, or CPU slots.  A slot that fails past its
    retries is evicted and its windows replay on the others
    (``device.pool.replay``); a mesh failure degrades to the pool
    (``device.mesh.degraded``); losing every slot raises
    ``AllDevicesEvicted``.  ``ADAM_TPU_AUDIT_RATE`` audits a sample of
    pass-C windows against the plain version on the CPU (a mismatch
    quarantines the slot and replays the window on another), and
    ``ADAM_TPU_HEDGE_FACTOR`` hedges late ones.  The parts are the same
    bytes on every device set.

    The service's seams (``serve/``), as in the JAX package: ``pacer(phase,
    index, size)`` is called once per window at pass A and once per part
    at pass C (``size`` the window's bytes); the scheduler's fairness
    interleaver blocks there, and raises :class:`RunCancelled` to stop the
    run at that boundary (parts already submitted still publish and
    journal).  ``coalescer`` (a ``serve/batching.CoalescerClient``) sends
    this run's markdup, observe and apply dispatches to the cross-job
    coalescer, which fuses concurrent jobs' windows into one dispatch per
    pass on the card; a window whose fused dispatch fails re-dispatches on
    this run's own path.  A coalesced run keeps pass B and pass C apart
    (no fused B->C tier).  ``trace`` is the job's trace id (minted when
    None).  With ``run_dir`` the incident recorder arms on it unless one
    is armed already (``utils/incidents.py``), and every completed run
    books its perf keys into the armed perf ledger's root, else its
    ``run_dir`` (``utils/perfledger.py``).  None of these changes an
    output byte."""
    from adam_tpu_torch.utils import incidents

    tr = tele.Tracer(recording=True)
    if trace is None:
        trace = tele.mint_trace_id()
    tr.set_trace(trace)
    tele.activate_trace(trace)
    armed_incidents = False
    if run_dir is not None and not incidents.installed():
        incidents.install(run_dir)
        armed_incidents = True
    hb = _start_heartbeat(tr, progress, include_global=pacer is None)
    try:
        stats = _transform_streamed_impl(
            path, out_path, tr, hb,
            mark_duplicates=mark_duplicates, recalibrate=recalibrate,
            realign=realign, known_snps=known_snps, known_indels=known_indels,
            consensus_model=consensus_model, window_reads=window_reads,
            compression=compression, n_writers=n_writers,
            max_indel_size=max_indel_size,
            max_consensus_number=max_consensus_number,
            lod_threshold=lod_threshold, max_target_size=max_target_size,
            dump_observations=dump_observations, known_table=known_table,
            run_dir=run_dir, resume=resume, devices=devices,
            partitioner=partitioner, device_pool=device_pool, pacer=pacer,
            coalescer=coalescer, device=device,
        )
        # perf-ledger booking: the armed ledger root (the service's), else
        # this run's own run_dir; a flagged regression records an incident
        # and charges the SLO budget.  Booking never fails the run.
        from adam_tpu_torch.utils import perfledger

        ledger_root = perfledger.ledger_root() or run_dir
        if ledger_root is not None and perfledger.booking_enabled():
            try:
                perfledger.sentinel(ledger_root, tr.snapshot(), run_id=trace)
            except Exception:
                log.warning("perf-ledger booking failed", exc_info=True)
        return stats
    except BaseException:
        # a crashed run's last heartbeat line carries ok=false
        _stop_heartbeat(hb, ok=False)
        raise
    finally:
        _stop_heartbeat(hb)  # a no-op after the normal finish
        tele.deactivate_trace(trace)
        if armed_incidents:
            incidents.uninstall()


def _inflight_per_device(queues: list, solo_key: str) -> dict:
    """Heartbeat provider body: in-flight depth per slot id (the solo
    path's one device under its key), sampled from the live deques whose
    items carry the slot at index 1."""
    from adam_tpu_torch.parallel.device_pool import Slot

    per: dict = {}
    for dq in queues:
        try:
            items = list(dq)
        except RuntimeError:
            continue
        for item in items:
            slot = item[1]
            if isinstance(slot, Slot):
                key = str(slot.id) if slot.attributed else solo_key
            elif slot == "batch":  # a ticket of the cross-job coalescer
                key = "batch"
            else:  # the mesh partitioner
                key = "mesh"
            per[key] = per.get(key, 0) + 1
    return per


def _where_attrs(where) -> dict:
    """Span attrs of a dispatch on a pool slot, or on the mesh."""
    from adam_tpu_torch.parallel import device_pool as dp

    return dp.span_attrs(where) if isinstance(where, dp.Slot) else {"device": "mesh"}


def _transform_streamed_impl(
    path, out_path, tr: tele.Tracer, hb, *, mark_duplicates, recalibrate,
    realign, known_snps, known_indels, consensus_model, window_reads,
    compression, n_writers, max_indel_size, max_consensus_number,
    lod_threshold, max_target_size, dump_observations, known_table, run_dir,
    resume, devices, partitioner, device_pool, pacer, coalescer, device,
) -> dict:
    from adam_tpu_torch.io.parquet import (
        PartWriterPool, part_index, part_path, purge_stale_staging,
    )
    from adam_tpu_torch.parallel import device_pool as dp
    from adam_tpu_torch.parallel import partitioner as part_mod
    from adam_tpu_torch.parallel.device_pool import ResidentWindow
    from adam_tpu_torch.pipelines import bqsr
    from adam_tpu_torch.pipelines import markdup as md
    from adam_tpu_torch.pipelines import realign as ra
    from adam_tpu_torch.pipelines.checkpoint import RunJournal
    from adam_tpu_torch.utils import health as health_mod

    t_start_ns = time.monotonic_ns()
    # ---- the device set: one device, a pool of slots, or a mesh --------
    # a shared pool (the library seam; a two-slot pool on one card is
    # built only here) substitutes for the run's own
    if device_pool is not None:
        dpool = device_pool
        dev = dpool.devices[0].device
    else:
        dev = resolve_device(device)
        dpool = dp.make_pool(devices, dev)
    dkey = device_key(dev)
    solo = dp.solo_slot(dev)
    stats: dict = {"device": str(dev), "resume.refused": 0,
                   "resume.windows_skipped": 0, "resume.histograms_loaded": 0}
    stats["n_devices"] = dpool.n if dpool is not None else 1
    # the card's kernels, or their plain versions on the CPU (the port has
    # no switch that would put a plain version on the card)
    stats["kernel_backend"] = "cuda" if dev.type == "cuda" else "plain"
    tr.gauge(tele.G_KERNEL_BACKEND, 1 if dev.type == "cuda" else 0)
    tr.gauge(tele.G_POOL_DEVICES, stats["n_devices"])
    # health, hedging and the SDC audit (utils/health.py): placement skips
    # probation slots; pass C hedges a late window past
    # ADAM_TPU_HEDGE_FACTOR x the apply's p99 and audits a deterministic
    # ADAM_TPU_AUDIT_RATE of windows against the plain version on the CPU
    health_board = health_mod.BOARD
    sdc_audit_rate = health_mod.audit_rate()
    stats["audit_rate"] = sdc_audit_rate
    exec_mode = part_mod.resolve_execution_mode(partitioner)
    mesh_part = None
    if exec_mode == "mesh":
        mesh_slots = (list(dpool.devices) if dpool is not None
                      else dp.make_slots([dev] * dp.resolve_device_count(devices, dev)))
        mesh_part = part_mod.MeshPartitioner(
            part_mod.healthy_subset(mesh_slots, health_board))
    exec_state = {"mesh": mesh_part, "mode": "mesh" if mesh_part is not None else "pool"}
    stats["partitioner"] = exec_state["mode"]
    # cross-job batching (serve/batching.py): every hook below skips the
    # coalescer while the mesh is live (the mesh already fuses the slots)
    stats["batched"] = coalescer is not None

    def win_nbytes(b) -> int:
        """A window's grant size for the fairness ring and the quota: the
        per-residue payload the device passes move."""
        return int(b.bases.nbytes) + int(b.quals.nbytes)

    if known_indels is not None and consensus_model == "reads":
        # known indels imply the knowns consensus model (the reference's
        # -known_indels semantics)
        consensus_model = "knowns"
    mis, mcn, lod, mts = ra.resolve_tuning(
        max_indel_size, max_consensus_number, lod_threshold, max_target_size
    )
    launches0 = kernels.launches()
    # the in-flight deques of pass A and pass C, sampled by the heartbeat
    inflight: list = []
    if hb is not None:
        # the HBM keys match the device= attribution of the spans
        hb.set_devices(sorted({s.device for s in (
            mesh_part.devices if mesh_part is not None
            else dpool.devices if dpool is not None else [solo])}, key=str))
        hb.set_provider(lambda: {
            "inflight_per_device": _inflight_per_device(inflight, dkey),
            # the live mode: a degraded mesh run reports "pool" from then on
            "partitioner": exec_state["mode"],
        })
    os.makedirs(out_path, exist_ok=True)
    # a killed run leaves its torn files only in the staging directory
    purge_stale_staging(out_path)
    journal = None
    if run_dir:
        journal = RunJournal(run_dir, run_fingerprint(
            path, mark_duplicates=mark_duplicates, recalibrate=recalibrate,
            realign=realign, consensus_model=consensus_model,
            window_reads=window_reads, compression=compression,
            max_indel_size=mis, max_consensus_number=mcn, lod_threshold=lod,
            max_target_size=mts, known_snps=known_snps,
            known_indels=known_indels, known_table=known_table,
        ), out_path, resume=resume, stats=stats, tracer=tr)
    known_np = None
    if recalibrate and known_table is not None:
        known_np = np.ascontiguousarray(known_table[0], np.uint8)
    # the fused B->C tier: with the applied table known before pass B (a
    # known table, or the journaled table of a -dump_observations resume,
    # which observes again only for the CSV), each eligible window's
    # observe and apply + pack run back to back
    fused_np = None
    if recalibrate and coalescer is None and bqsr.fused_bc_enabled():
        if known_np is not None:
            fused_np = known_np
        elif journal is not None and journal.resumed and dump_observations:
            lt = journal.load_table()
            if lt is not None:
                fused_np = np.ascontiguousarray(lt[0], np.uint8)
    fused_tables: dict = {}  # slot key or "mesh" -> the fused table placed there

    def placed(table_np, where, cache):
        """``table_np`` on a slot (or one copy per shard of the mesh),
        placed once per run and cached under its key in ``cache``."""
        key = "mesh" if where == "mesh" else where.key
        t = cache.get(key)
        if t is None:
            with tele.pass_scope("table"):
                t = (exec_state["mesh"].put_replicated(table_np) if where == "mesh"
                     else dp.putter(where)(table_np))
            cache[key] = t
        return t

    def fused_table_on(where):
        return placed(fused_np, where, fused_tables)

    # window idx -> (slot | "mesh", apply handle) of a fused dispatch
    fused_handles: dict = {}
    stats["fused_bc"] = fused_np is not None
    tr.gauge(tele.G_FUSED_BC, 1 if fused_np is not None else 0)

    # ---- resident windows: registry and lifecycle ----------------------
    resident_map: dict = {}
    resident_live = {"bytes": 0, "made": 0}

    def pick_slot(win):
        """Window ``win``'s slot (raises AllDevicesEvicted when none is
        left)."""
        return dpool.device(win) if dpool is not None else solo

    def make_resident(win, ds):
        """Place window ``win``'s payload once (on its slot, or as the
        mesh's row blocks) and register it."""
        b = ds.batch.to_numpy()
        mp = exec_state["mesh"]
        with tele.pass_scope("ingest"):
            if mp is not None:
                rw = part_mod.mesh_resident_window(b, win, mp)
            else:
                rw = ResidentWindow.place(b, pick_slot(win), window=win)
        resident_map[win] = rw
        resident_live["bytes"] += rw.nbytes
        resident_live["made"] += 1
        tr.count(tele.C_RESIDENT_WINDOWS)
        tr.count(tele.C_RESIDENT_BYTES, rw.nbytes)
        tr.gauge(tele.G_RESIDENT_LIVE, resident_live["bytes"])

    def release_resident(win, drop=False):
        rw = resident_map.pop(win, None)
        if rw is None:
            return
        rw.release()
        resident_live["bytes"] -= rw.nbytes
        tr.count(tele.C_RESIDENT_EVICTED if drop else tele.C_RESIDENT_RELEASED)
        tr.gauge(tele.G_RESIDENT_LIVE, resident_live["bytes"])

    def drop_resident_on(where):
        for win, rw in list(resident_map.items()):
            if rw.slot is where:
                release_resident(win, drop=True)

    def resident_on(win, ds, slot):
        """Window ``win``'s resident payload on ``slot``: the registered
        one when it lives there, else a fresh placement from the host copy
        (a replay or a degrade re-ships)."""
        rw = resident_map.get(win)
        if rw is not None and rw.alive and rw.slot is slot:
            return rw
        return ResidentWindow.place(ds.batch.to_numpy(), slot, window=win)

    def evict_or_raise(slot, exc):
        """A slot failed past its retries: evict it (its resident windows go
        with it).  Raises when it was the last one: the port does not carry
        on on the CPU (``AllDevicesEvicted``; without a pool, the error)."""
        drop_resident_on(slot)
        if dpool is None:
            raise exc
        dpool.evict(slot, reason=str(exc), tracer=tr)
        if not dpool.alive_devices():
            raise dp.AllDevicesEvicted(
                f"all {dpool.n} pool slots evicted (last: {exc})") from exc

    def on_survivors(win, fn):
        """THE recovery loop of every dispatch and replay site: ``fn(slot)``
        on window ``win``'s slot; on a failure (transient ones were retried
        inside) the slot is evicted and the window replays on the next
        survivor, under a ``device.pool.replay`` span attributed to the
        failed slot."""
        slot = pick_slot(win)
        try:
            return fn(slot)
        except dp.AllDevicesEvicted:
            raise
        except Exception as e:
            failed, exc = slot, e
        while True:
            with tr.span(tele.SPAN_POOL_REPLAY, window=win, **dp.span_attrs(failed)), \
                    dp.replay_scope():
                evict_or_raise(failed, exc)
                slot = pick_slot(win)
                try:
                    return fn(slot)
                except dp.AllDevicesEvicted:
                    raise
                except Exception as e:
                    failed, exc = slot, e

    # windows folded into the mesh's accumulator (replayed on a degrade)
    mesh_obs: list = []
    obs_parts: list = []
    obs_replays: list = []
    obs_windows: list = []
    obs_slots: list = []

    def add_part(win, got):
        (t, m, g), replay, slot = got
        obs_parts.append((t, m, g))
        obs_replays.append(replay)
        obs_windows.append(win)
        obs_slots.append(slot)

    def mesh_degrade(exc, where=""):
        """The mesh failed past its retries: run the rest of the run on the
        pool (or the one device), byte-identically; the windows already in
        the accumulator replay through the pool's observe."""
        mp = exec_state["mesh"]
        if mp is None:
            return
        exec_state["mesh"] = None
        exec_state["mode"] = "pool"
        stats["partitioner"] = "pool"
        for win, rw in list(resident_map.items()):
            if rw.slot == "mesh":
                release_resident(win, drop=True)
        for i in [i for i, (tag, _h) in fused_handles.items() if tag is mp]:
            del fused_handles[i]
        fused_tables.pop("mesh", None)
        tr.count(tele.C_MESH_DEGRADED)
        log.error("mesh partitioner failed%s (%s); degrading to the pool path%s",
                  f" at {where}" if where else "", exc,
                  f" and replaying {len(mesh_obs)} accumulated window(s)"
                  if mesh_obs else "")
        mp.reset_accumulator()
        if mesh_obs:
            with tr.span(tele.SPAN_POOL_REPLAY, device="mesh"), dp.replay_scope():
                for i, w in list(mesh_obs):
                    got = observe_window(i, w)
                    if got is not None:
                        add_part(i, got)
            mesh_obs.clear()

    # ---- prewarm: the kernel set on every slot before its first window --
    seen_shapes: set = set()

    def prewarm_window_shapes(ds):
        """First sight of a grid shape: run its kernel set on every slot (or
        the mesh) outside the timed windows.  Nothing on one device."""
        mp = exec_state["mesh"]
        if mp is None and dpool is None:
            return
        b = ds.batch.to_numpy()
        from adam_tpu_torch.formats.batch import grid_cigar_cols, grid_cols, grid_rows

        key = (grid_rows(b.n_rows), grid_cols(b.lmax),
               grid_cigar_cols(b.cigar_ops.shape[1] if b.cigar_ops.ndim == 2 else 1),
               exec_state["mode"])
        if key in seen_shapes:
            return
        seen_shapes.add(key)
        n_rg = len(ds.read_groups) + 1
        fused_cyc = fused_np.shape[2] if fused_np is not None else None
        t_pw = time.monotonic_ns()
        try:
            if mp is not None:
                entries = []
                if mark_duplicates:
                    entries.append(part_mod.mesh_markdup_prewarm_entry(b, mp))
                if recalibrate:
                    entries.append(part_mod.mesh_observe_prewarm_entry(b, n_rg, mp))
                    if fused_cyc is not None:
                        entries.append(part_mod.mesh_fused_bc_prewarm_entry(
                            b, n_rg, fused_cyc, mp))
                mp.prewarm(entries, tracer=tr)
            else:
                dpool.prewarm(dp.streamed_prewarm_entries(
                    b, n_rg, mark_duplicates=mark_duplicates,
                    recalibrate=recalibrate, fused_n_cyc=fused_cyc), tracer=tr)
        finally:
            tr.add_span(tele.SPAN_POOL_PREWARM, t_pw, time.monotonic_ns() - t_pw)

    def prewarm_observe_shape(ds):
        """The realigned part's grid, before its observe."""
        mp = exec_state["mesh"]
        if not recalibrate or (mp is None and dpool is None):
            return
        b = ds.batch.to_numpy()
        n_rg = len(ds.read_groups) + 1
        fused_cyc = fused_np.shape[2] if fused_np is not None else None
        t_pw = time.monotonic_ns()
        try:
            if mp is not None:
                entries = [part_mod.mesh_observe_prewarm_entry(b, n_rg, mp)]
                if fused_cyc is not None:
                    entries.append(part_mod.mesh_fused_bc_prewarm_entry(
                        b, n_rg, fused_cyc, mp))
                mp.prewarm(entries, tracer=tr)
            else:
                entries = [dp.observe_prewarm_entry(b, n_rg)]
                if fused_cyc is not None:
                    entries.append(dp.fused_bc_prewarm_entry(b, n_rg, fused_cyc))
                dpool.prewarm(entries, tracer=tr)
        finally:
            tr.add_span(tele.SPAN_POOL_PREWARM, t_pw, time.monotonic_ns() - t_pw)

    # ---- pass A: ingest || resident placement + markdup columns --------
    in_q: queue.Queue = queue.Queue(maxsize=3)
    abort = threading.Event()
    ingest = threading.Thread(
        target=_ingest_windows, args=(path, window_reads, in_q, abort, tr),
        daemon=True,
    )
    ingest.start()
    windows: list[AlignmentDataset] = []
    summaries: list[dict] = []
    events: list = []
    # a double buffer per slot (2n): round-robin keeps the drain order the
    # window order, so the summaries stay window-ordered
    md_depth = 2 if dpool is None else 2 * dpool.n
    pend_cols: deque = deque()  # (win, slot | "mesh", lazy cols)
    inflight.append(pend_cols)
    header = None
    n_reads = 0

    def md_dispatch(win, batch, coalesce=True):
        """Dispatch window ``win``'s markdup reductions -> (slot | "mesh",
        lazy cols), the mesh degrading to the pool on a failure; with a
        coalescer, ("batch", future) (``coalesce=False`` is the fallback
        of a failed fused dispatch)."""
        mp = exec_state["mesh"]
        if coalesce and coalescer is not None and mp is None:
            try:
                return "batch", coalescer.submit_markdup(win, batch, resident_map.get(win))
            except Exception as e:
                log.warning("coalesced markdup submit of window %d failed (%s); "
                            "dispatching on the job's own path", win, e)
        if mp is not None:
            try:
                cols = md.markdup_columns(batch, resident_map[win], mesh=mp)
                tr.count(tele.C_DEVICE_DISPATCHED)
                tr.count(tele.C_MESH_DISPATCHED)
                return mp, cols
            except Exception as e:
                mesh_degrade(e, "pass-A markdup")

        def on_slot(slot):
            cols = md.markdup_columns(batch, resident_on(win, windows[win], slot))
            tr.count(tele.C_DEVICE_DISPATCHED)
            return slot, cols

        return on_survivors(win, on_slot)

    def summarize(win, where, cols):
        n = windows[win].batch.n_rows
        if where == "batch":
            # a coalesced window: host (five, score), bitwise the solo
            # columns; a failed fused dispatch re-dispatches on this run's
            # own path
            try:
                five, score = cols.result()
            except Exception as e:
                log.warning("coalesced markdup of window %d fell back to the job's "
                            "own dispatch (%s)", win, e)
                where, cols = md_dispatch(win, windows[win].batch, coalesce=False)
            else:
                summaries.append(md.row_summary(windows[win], five, score))
                return
        while True:
            on_mesh = not isinstance(where, dp.Slot)
            try:
                with tr.span(tele.SPAN_MD_FETCH):
                    five, score = md.fetch_columns(
                        cols, n, slot=None if on_mesh else where,
                        mesh=where if on_mesh else None)
                break
            except dp.AllDevicesEvicted:
                raise
            except Exception as e:
                # the fetch failed past the transfer layer's retries: evict
                # the slot (or abandon the mesh) and replay the reductions
                with tr.span(tele.SPAN_POOL_REPLAY, window=win,
                             **_where_attrs(where)), dp.replay_scope():
                    if on_mesh:
                        mesh_degrade(e, "pass-A markdup fetch")
                    else:
                        evict_or_raise(where, e)
                    where, cols = md_dispatch(win, windows[win].batch)
        tr.count(tele.C_DEVICE_FETCHED)
        summaries.append(md.row_summary(windows[win], five, score))

    with tr.span(tele.SPAN_PASS_A), tele.pass_scope("a"):
        try:
            while True:
                item = in_q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, BaseException):
                    raise item
                batch, side, header = item
                windows.append(AlignmentDataset(batch, side, header))
                win = len(windows) - 1
                # counted per window: the heartbeat's reads/s reads it
                # mid-ingest
                n_window_reads = batch.n_valid()
                n_reads += n_window_reads
                tr.count(tele.C_READS_INGESTED, n_window_reads)
                tr.count(tele.C_WINDOWS_INGESTED)
                # one arrival per pass-A window, before its device work
                # (where the JAX package arrives)
                faults.point("proc.kill", device="pass_a")
                # the service's fairness turn (or RunCancelled: nothing of
                # this window is in flight yet, so a resume runs it again)
                if pacer is not None:
                    pacer("pass_a", win, win_nbytes(batch))
                prewarm_window_shapes(windows[win])
                make_resident(win, windows[win])
                if mark_duplicates:
                    # window i's reductions run on its slot while earlier
                    # windows' columns are fetched and summarized
                    pend_cols.append((win,) + md_dispatch(win, batch))
                    tr.gauge(tele.G_DEVICE_INFLIGHT, len(pend_cols))
                    if len(pend_cols) >= md_depth:
                        summarize(*pend_cols.popleft())
                if realign:
                    events.append(ra.extract_indel_event_arrays(batch, max_indel_size=mis))
            while pend_cols:
                summarize(*pend_cols.popleft())
        except BaseException:
            abort.set()
            raise
        finally:
            ingest.join()
    stats["n_reads"] = n_reads
    stats["n_windows"] = len(windows)
    # pin (or check) the window plan and fix the resumable set: a window,
    # or the realigned part (index n_windows), whose part the journal
    # records as published is not written again
    if journal is not None:
        journal.confirm_plan(len(windows))
    done_parts = journal.completed_windows() if journal is not None else frozenset()
    stats["windows_resumed"] = len(done_parts)
    stats["resume.windows_skipped"] = len(done_parts)
    if done_parts:
        tr.count(tele.C_RESUME_WINDOWS_SKIPPED, len(done_parts))
        log.info("resume: %d output window(s) already durably published; "
                 "re-executing only the remainder", len(done_parts))
    if hb is not None:
        hb.set_total(len(windows))

    # ---- barrier 1: resolve duplicates, merge realignment targets -----
    with tr.span(tele.SPAN_RESOLVE), tele.pass_scope("resolve"):
        if mark_duplicates and summaries:
            # the lexsort of the packed summary keys runs on the device: the
            # mesh's first slot, the pool's first placeable one, or the one
            mp = exec_state["mesh"]
            sort_slot = (mp.devices[0] if mp is not None
                         else dpool.alive_devices()[0] if dpool is not None else solo)
            tr.gauge(tele.G_RESOLVE_DEVICE_SORT, 1)
            dup = md.resolve_duplicates(md.concat_summaries(summaries), device=sort_slot)
            off = 0
            for i, w in enumerate(windows):
                b = w.batch.to_numpy()
                n = b.n_rows
                new_flags = md.apply_duplicate_flags(np.asarray(b.flags), dup[off : off + n])
                windows[i] = w.with_batch(b.replace(flags=new_flags))
                off += n
            stats["n_duplicates"] = int(dup.sum())
        del summaries
        names = header.seq_dict.names if header is not None else []
        targets = ra.merge_events(
            np.concatenate(events, axis=0) if events else np.zeros((0, 5), np.int64),
            names, mts,
        ) if realign else []
        del events

    # ---- split: candidate rows leave their windows (pre-BQSR) ----------
    candidates: list[AlignmentDataset] = []
    window_valid: list[int] = []
    with tr.span(tele.SPAN_SPLIT):
        for i, w in enumerate(windows):
            n_valid = w.batch.n_rows
            if targets:
                cand, w, n_valid = ra.split_realign_candidates(w, targets, names)
                if cand is not None:
                    candidates.append(cand)
                windows[i] = w
            window_valid.append(n_valid)
    stats["n_candidates"] = sum(c.batch.n_rows for c in candidates)

    # post-barrier-2 resume: the journaled table is the barrier's output,
    # so no observation can change it (a -dump_observations run merges
    # again for the CSV; its windows' sidecars still spare the card)
    resume_table = None
    if journal is not None and recalibrate and not dump_observations:
        resume_table = journal.load_table()

    # ---- pass B: observe every window (histograms stay on the device) --
    def obs_replay(i, w, slot):
        """Recovery hook for window i's barrier fetch: evict the slot that
        held its histograms and observe again on a survivor -> host parts."""
        from adam_tpu_torch.utils.transfer import device_fetch

        def on_slot(nd):
            t, m, g = bqsr.observe_window(w, resident_on(i, w, nd), known_snps)
            return device_fetch(t, nd), device_fetch(m, nd), g

        def replay(exc):
            with tr.span(tele.SPAN_POOL_REPLAY, window=i, **dp.span_attrs(slot)), \
                    dp.replay_scope():
                evict_or_raise(slot, exc)
                return on_survivors(i, on_slot)

        return replay

    def observe_window(i, w, defer=None, coalesce=True):
        """Observe window ``i`` -> ((total, mism, g), replay hook, slot), or
        None when its histograms went into the mesh's accumulator, or
        ``_DEFERRED`` when it rode the coalescer and its future waits on
        ``defer``.  A journaled sidecar loads instead; with the fused tier
        armed (and the window's part still to write) the window's apply +
        pack follows from the same dispatch.  ``coalesce=False`` is the
        fallback of a failed fused dispatch."""
        if journal is not None and journal.resumed:
            got = journal.load_observation(i)
            if got is not None:
                stats["resume.histograms_loaded"] += 1
                tr.count(tele.C_RESUME_HISTOGRAMS_LOADED)
                return got, None, None
        fused_ok = fused_np is not None and i not in done_parts
        mp = exec_state["mesh"]
        if mp is not None:
            rw = resident_map.get(i)
            if rw is None or not rw.alive or rw.slot != "mesh":
                make_resident(i, w)
                rw = resident_map[i]
            try:
                with tele.pass_scope("observe"):
                    got = None
                    if fused_ok:
                        faults.point("proc.kill", device="fused_bc")
                        got = bqsr.fused_bc_dispatch(w, fused_table_on("mesh"), rw,
                                                     known_snps, mesh=mp)
                    if got is not None:
                        handle, (t, m, g) = got
                    else:
                        t, m, g = bqsr.observe_window(w, rw, known_snps, mesh=mp)
                    mp.accumulate(t, m, g)
            except Exception as e:
                mesh_degrade(e, "pass-B observe")
            else:
                mesh_obs.append((i, w))
                tr.count(tele.C_DEVICE_DISPATCHED)
                tr.count(tele.C_MESH_DISPATCHED)
                if got is not None:
                    tr.count(tele.C_FUSED_DISPATCHED)
                    fused_handles[i] = (mp, handle)
                return None

        if coalesce and coalescer is not None and exec_state["mesh"] is None:
            # the window's band of the fused histogram is bitwise its solo
            # histogram; a failed submit or dispatch takes the own path
            try:
                fut = coalescer.submit_observe(i, w, known_snps, resident_map.get(i))
            except Exception as e:
                log.warning("coalesced observe submit of window %d failed (%s); "
                            "dispatching on the job's own path", i, e)
            else:
                if defer is not None:
                    defer.append((i, w, fut))
                    return _DEFERRED
                try:
                    with tele.pass_scope("observe"):
                        return fut.result(), None, None
                except Exception as e:
                    log.warning("coalesced observe of window %d fell back to the "
                                "job's own dispatch (%s)", i, e)

        def on_slot(slot):
            rw = resident_on(i, w, slot)
            got = None
            if fused_ok:
                faults.point("proc.kill", device="fused_bc")
                got = bqsr.fused_bc_dispatch(w, fused_table_on(slot), rw, known_snps)
            tr.count(tele.C_DEVICE_DISPATCHED)
            if got is not None:
                tr.count(tele.C_FUSED_DISPATCHED)
                fused_handles[i] = (slot, got[0])
                return got[1], obs_replay(i, w, slot), slot
            return bqsr.observe_window(w, rw, known_snps), obs_replay(i, w, slot), slot

        with tele.pass_scope("observe"):
            return on_survivors(i, on_slot)

    def observe_remainders():
        """Pass B over every window with rows left: the realign's overlap
        work, run between its sweeps' dispatch and their fetch."""
        if not recalibrate or resume_table is not None:
            return
        with tr.span(tele.SPAN_OBSERVE):
            # coalesced windows resolve after every window has submitted:
            # the coalescer sees the job's whole window set at once
            deferred: list = []
            for i, w in enumerate(windows):
                if window_valid[i]:
                    faults.point("proc.kill", device="pass_b")
                    got = observe_window(i, w, defer=deferred)
                    if got is _DEFERRED:
                        continue
                    if got is not None:
                        add_part(i, got)
            for i, w, fut in deferred:
                try:
                    with tele.pass_scope("observe"):
                        got = (fut.result(), None, None)
                except Exception as e:
                    log.warning("coalesced observe of window %d fell back to the "
                                "job's own dispatch (%s)", i, e)
                    got = observe_window(i, w, coalesce=False)
                if got is not None:
                    add_part(i, got)

    # ---- tail: realign the candidates (observing under the sweeps), then
    # observe the realigned part ----------------------------------------
    # resume fast path: a journaled realigned part whose contribution to
    # the table is recoverable (the table itself, or its sidecar) skips
    # the candidate realign; the sidecar is loaded, not only probed, so
    # an unreadable one forces the realign
    t_tail_ns = time.monotonic_ns()
    n_win = len(windows)
    realigned = None
    r_obs = None
    skip_realign = False
    hidden = False
    if candidates and journal is not None and journal.resumed and n_win in done_parts:
        if not recalibrate or resume_table is not None:
            skip_realign = True
        else:
            r_obs = journal.load_observation(n_win)
            skip_realign = r_obs is not None
    stats["n_realigned"] = 0
    if candidates and not skip_realign:
        cand = AlignmentDataset.concat(candidates)
        del candidates
        tr.count(tele.C_CANDIDATE_ROWS, int(cand.batch.n_rows))
        mp = exec_state["mesh"]
        sweep_slots = (mp.devices if mp is not None
                       else dpool.alive_devices() if dpool is not None else None)
        if sweep_slots is not None and len(sweep_slots) < 2:
            sweep_slots = None
        with tele.pass_scope("sweep"):
            realigned = ra.realign_indels(
                cand, consensus_model=consensus_model, known_indels=known_indels,
                max_indel_size=mis, max_consensus_number=mcn, lod_threshold=lod,
                max_target_size=mts, device=dev, overlap_work=observe_remainders,
                sweep_devices=sweep_slots,
            )
        hidden = bool(getattr(observe_remainders, "overlap_ran_in_dispatch", False))
        stats["n_realigned"] = _n_moved(cand.batch, realigned.batch)
        del cand
        if recalibrate and realigned.batch.n_rows and resume_table is None:
            prewarm_observe_shape(realigned)
            make_resident(n_win, realigned)
            got = observe_window(n_win, realigned)
            if got is not None:
                add_part(n_win, got)
    else:
        del candidates  # none, or their journaled part needs no realign
        observe_remainders()
        if r_obs is not None:
            # spliced in at its window-plan position: the same merge order
            # as the uninterrupted run
            stats["resume.histograms_loaded"] += 1
            tr.count(tele.C_RESUME_HISTOGRAMS_LOADED)
            add_part(n_win, (r_obs, None, None))
    tr.add_span(tele.SPAN_TAIL, t_tail_ns, time.monotonic_ns() - t_tail_ns)
    tr.gauge(tele.G_OBSERVE_HIDDEN, 1 if hidden else 0)
    stats["observe_overlap_hidden"] = hidden
    stats["n_fused_windows"] = len(fused_handles)

    # ---- barrier 2: merge histograms, solve the table ------------------
    # (a known table is applied as it is, with its own gl: the merge still
    # runs for the sidecars and the observation dump, the solve does not)
    table = None
    gl = 0
    mp_b2 = exec_state["mesh"]
    have_acc = mp_b2 is not None and mp_b2.has_accumulated()
    if resume_table is not None:
        table = np.ascontiguousarray(resume_table[0], np.uint8)
        gl = int(resume_table[1])
        tr.add_span(tele.SPAN_SOLVE, time.monotonic_ns(), 0)
    elif recalibrate and (obs_parts or have_acc):
        faults.point("proc.kill", device="barrier2")
        if have_acc:
            # the mesh's payoff: one merged table per grid width comes home
            try:
                with tele.pass_scope("observe"):
                    acc_parts = mp_b2.fetch_accumulated(tr)
                tr.count(tele.C_DEVICE_FETCHED, len(acc_parts))
                mesh_obs.clear()
                for tt, mm, g_acc in acc_parts:
                    add_part(None, ((tt, mm, int(g_acc)), None, None))
            except Exception as e:
                mesh_degrade(e, "barrier-2 accumulator fetch")

        def persist(win, tt, mm, g):
            # best-effort: the sidecars only speed a resume up, and a
            # full disk on the run dir must not fail a healthy run
            try:
                journal.save_observation(win, tt, mm, g)
            except OSError as e:
                log.warning("observe sidecar persist failed for window %d: %s",
                            win, e)

        n_dev_parts = sum(1 for t, _m, _g in obs_parts if isinstance(t, torch.Tensor))
        with tr.span(tele.SPAN_OBS_MERGE), tele.pass_scope("observe"):
            total, mism, gl = bqsr.merge_observations(
                obs_parts, window_ids=obs_windows,
                on_part=persist if journal is not None else None, tracer=tr,
                slots=obs_slots, replays=obs_replays,
            )
        if n_dev_parts:
            tr.count(tele.C_DEVICE_FETCHED, n_dev_parts)
        obs_parts.clear()
        obs_replays.clear()
        with tr.span(tele.SPAN_SOLVE):
            if dump_observations:
                bqsr.dump_observation_csv(
                    total, mism, header.read_groups.names + ["null"], gl,
                    dump_observations,
                )
            if known_np is None:
                table = bqsr.solve_recalibration_table(total, mism)
            else:
                table, gl = known_np, int(known_table[1])
        if journal is not None:
            try:
                journal.save_table(table, gl)
            except OSError as e:
                log.warning("recalibration-table persist failed: %s", e)
        # the table is journaled: a resume from here goes into pass C
        faults.point("proc.kill", device="barrier2")
    else:
        if known_np is not None:
            table, gl = known_np, int(known_table[1])
        tr.add_span(tele.SPAN_SOLVE, time.monotonic_ns(), 0)

    # ---- pass C: apply + pack || encode || part writes -----------------
    # the realigned part applies and submits first (it is the largest
    # part, so its encode and write overlap the window applies); windows
    # with no valid row left, or whose part is journaled, write no part
    if realigned is not None:
        windows.append(realigned)
        window_valid.append(realigned.batch.n_rows)
    parts = ([n_win] if realigned is not None and n_win not in done_parts else []) + [
        i for i in range(n_win) if window_valid[i] and i not in done_parts
    ]
    # what writes no part is freed now, its placement on the card too, so
    # the card holds only the parts still in flight
    keep = set(parts)
    for i in range(len(windows)):
        if i not in keep:
            windows[i] = None
            release_resident(i)
            fused_handles.pop(i, None)
    stats["windows_fresh"] = len(parts)
    if hb is not None:
        # the ETA extrapolates the parts written against this count
        hb.set_parts_total(len(parts))

    def on_published(p):
        # write thread: the part's bytes are durably on disk
        idx = part_index(p)
        if idx is not None:
            journal.record_window(idx, os.path.basename(p))

    pool = PartWriterPool(
        n_encoders=max(1, n_writers - 1), inflight_parts=3,
        compression=compression,
        on_published=on_published if journal is not None else None,
        tracer=tr,
    )

    def pace_c(i, batch):
        # one fairness turn per part; a RunCancelled here closes the writer
        # pool gracefully below (this part re-runs on resume)
        if pacer is not None:
            pacer("pass_c", i, win_nbytes(batch))

    def submit(i, done):
        pace_c(i, done[0].batch)
        faults.point("proc.kill", device="pass_c")
        pool.submit(part_path(out_path, i), *_submit_args(done))
        release_resident(i)
        windows[i] = None  # free as we go

    dev_tables: dict = {}  # slot key -> the table placed on that slot

    def table_on(slot):
        return placed(table, slot, dev_tables)

    def apply_on(i, w, slot):
        """Dispatch + fetch window ``i``'s apply on ``slot`` synchronously
        (a replay, a hedge, an audit's second opinion)."""
        with tr.span(tele.SPAN_APPLY_DISPATCH, window=i, **dp.span_attrs(slot)):
            h = bqsr.apply_dispatch(w, resident_on(i, w, slot), table_on(slot))
        tr.count(tele.C_DEVICE_DISPATCHED)
        return bqsr.apply_finish(h)

    def replay_apply(i, where, w, exc):
        """Window ``i``'s apply died on ``where``: evict it (or abandon the
        mesh) and run the window again on a survivor."""
        with tr.span(tele.SPAN_POOL_REPLAY, window=i, **_where_attrs(where)), \
                dp.replay_scope():
            if not isinstance(where, dp.Slot):
                mesh_degrade(exc, "pass-C apply")
            else:
                evict_or_raise(where, exc)
            return on_survivors(i, lambda nd: apply_on(i, w, nd))

    def audit(i, prod, w, done):
        """The SDC audit of a sampled window: its published bytes against
        the plain PyTorch version on the CPU (used for the comparison only,
        never published).  A mismatch quarantines the producing slot (its
        resident windows drop) and replays the window on another slot of
        the card, audited again; with no healthy slot left the run raises."""
        tr.count(tele.C_AUDIT_SAMPLED)
        attrs = _where_attrs(prod)
        with tr.span(tele.SPAN_AUDIT_CHECK, window=i, **attrs):
            ref = bqsr.apply_reference(w, table)
            ok = bqsr.packed_equal(done[1], ref)
        if ok:
            return done
        tr.count(tele.C_AUDIT_MISMATCH)
        log.error("SDC audit: window %d's card result does not match the CPU "
                  "recompute; quarantining %s and replaying the window", i,
                  f"slot {prod.key}" if isinstance(prod, dp.Slot) else "the mesh")
        from adam_tpu_torch.utils import incidents

        incidents.maybe_record(
            "audit.mismatch", device=attrs.get("device"), window=i,
            trace_id=tr.trace, tracer=tr,
            reason="SDC dual-compute mismatch on window %d; the window replays" % i)
        if not isinstance(prod, dp.Slot):
            mesh_degrade(RuntimeError(f"sdc audit mismatch on window {i}"),
                         "pass-C audit")
        else:
            health_board.quarantine(prod, reason=f"sdc audit mismatch on window {i}",
                                    tracer=tr)
            drop_resident_on(prod)
        others = ([s for s in dpool.alive_devices()
                   if s is not prod and not health_board.blocked(s)]
                  if dpool is not None else [])
        if not others:
            raise dp.AllDevicesEvicted(
                f"SDC audit mismatch on window {i} and no healthy slot left "
                "to replay it on")
        nd = others[i % len(others)]
        with tr.span(tele.SPAN_POOL_REPLAY, window=i, **attrs), dp.replay_scope():
            again = apply_on(i, w, nd)
        return audit(i, nd, w, again)

    def finish_checked(i, where, h):
        """Fetch a dispatched window (hedged on a pool with a hedge
        threshold), replay it on a failure, audit it when due."""
        w = bqsr.apply_handle_dataset(h)
        thr = None
        on_slot = isinstance(where, dp.Slot)
        if dpool is not None and on_slot and len(dpool.alive_devices()) > 1:
            thr = health_board.hedge_threshold("bqsr.apply")
        prod = where
        try:
            t_fetch = time.monotonic()
            hedged = False
            attrs = _where_attrs(where)
            # the fetch span holds the wait for the window's device work
            with tr.span(tele.SPAN_APPLY_FETCH, window=i, **attrs):
                if thr is None:
                    done = bqsr.apply_finish(h)
                else:
                    box: list = []

                    def hedge_fn():
                        others = [s for s in dpool.alive_devices() if s is not where]
                        if not others:
                            raise RuntimeError("no other slot to hedge on")
                        nd = others[i % len(others)]
                        box.append(nd)
                        return apply_on(i, w, nd)

                    done, winner, hedged = dp.hedged_call(
                        lambda: bqsr.apply_finish(h), hedge_fn, thr, tracer=tr)
                    if winner == "hedge":
                        prod = box[0]
                        health_board.note_hedge_lost(where, "bqsr.apply", tracer=tr)
            tr.count(tele.C_DEVICE_FETCHED)
            if not hedged and on_slot and where.attributed:
                health_board.observe_latency("bqsr.apply", where,
                                             time.monotonic() - t_fetch, tracer=tr)
        except dp.AllDevicesEvicted:
            raise
        except Exception as e:
            done = replay_apply(i, where, w, e)
            prod = None
        if sdc_audit_rate > 0 and health_mod.audit_due(i, sdc_audit_rate):
            done = audit(i, prod if prod is not None else pick_slot(i), w, done)
        return done

    def finish_batched(i, fut):
        """A coalesced window's result; a failed fused dispatch re-applies
        on this run's own card path.  A sampled audit that mismatches
        replays the window there too (a fused dispatch has no single slot
        to quarantine)."""
        w = fut.dataset
        try:
            with tr.span(tele.SPAN_APPLY_FETCH, window=i, device="batch"):
                done = fut.result()
        except Exception as e:
            log.warning("coalesced apply of window %d fell back to the job's own "
                        "dispatch (%s)", i, e)
            return on_survivors(i, lambda nd: apply_on(i, w, nd))
        if sdc_audit_rate > 0 and health_mod.audit_due(i, sdc_audit_rate):
            tr.count(tele.C_AUDIT_SAMPLED)
            with tr.span(tele.SPAN_AUDIT_CHECK, window=i, device="batch"):
                ok = bqsr.packed_equal(done[1], bqsr.apply_reference(w, table))
            if not ok:
                tr.count(tele.C_AUDIT_MISMATCH)
                from adam_tpu_torch.utils import incidents

                incidents.maybe_record(
                    "audit.mismatch", window=i, trace_id=tr.trace, tracer=tr,
                    reason="SDC dual-compute mismatch on coalesced window %d; "
                           "the window replays on the job's own path" % i)
                slot = pick_slot(i)
                with tr.span(tele.SPAN_POOL_REPLAY, window=i, device="batch"), \
                        dp.replay_scope():
                    again = apply_on(i, w, slot)
                done = audit(i, slot, w, again)
        return done

    pend: deque = deque()  # (window, slot | "mesh" | "batch", handle)
    inflight.append(pend)

    def fetch_one():
        i, where, h = pend[0]
        if where == "batch":
            done = finish_batched(i, h)
        else:
            done = finish_checked(i, where, h)
        pend.popleft()
        submit(i, done)

    def apply_parts_mesh(plist):
        """Mesh pass C: the table placed once per shard; every window's
        apply + packs run per shard, double-buffered.  Returns the parts
        still to do: none, or (after a mesh failure) the rest, for the
        pool path."""
        mp = exec_state["mesh"]
        try:
            with tele.pass_scope("table"):
                tbl = mp.put_replicated(table)
            t_pwc = time.monotonic_ns()
            seen = {}
            for i in plist:
                bw = windows[i].batch
                seen.setdefault((bw.n_rows, bw.lmax), windows[i])
            mp.prewarm([part_mod.mesh_apply_prewarm_entry(
                w.batch.to_numpy(), table.shape[0], table.shape[2], mp)
                for w in seen.values()], tracer=tr)
            tr.add_span(tele.SPAN_POOL_PREWARM_C, t_pwc, time.monotonic_ns() - t_pwc)
        except Exception as e:
            mesh_degrade(e, "pass-C table placement")
            return list(plist)
        k = 0
        while k < len(plist) or pend:
            if k < len(plist) and len(pend) < 2:
                i = plist[k]
                fh = fused_handles.pop(i, None)
                if fh is not None:
                    pend.append((i, mp, fh[1]))
                else:
                    rw = resident_map.get(i)
                    try:
                        if rw is None or not rw.alive or rw.slot != "mesh":
                            make_resident(i, windows[i])
                            rw = resident_map[i]
                        with tr.span(tele.SPAN_APPLY_DISPATCH, window=i, device="mesh"):
                            h = bqsr.apply_dispatch(windows[i], rw, tbl, mesh=mp)
                    except Exception as e:
                        mesh_degrade(e, "pass-C apply dispatch")
                        rest = [j for j, _w, _h in pend] + list(plist[k:])
                        pend.clear()
                        return rest
                    tr.count(tele.C_DEVICE_DISPATCHED)
                    tr.count(tele.C_MESH_DISPATCHED)
                    pend.append((i, mp, h))
                tr.gauge(tele.G_DEVICE_INFLIGHT, len(pend))
                k += 1
                continue
            fetch_one()
            if exec_state["mesh"] is not mp:
                # a replay degraded the mesh: the pool finishes the rest
                rest = [j for j, _w, _h in pend] + list(plist[k:])
                pend.clear()
                return rest
        return []

    def apply_parts_pool(plist):
        if dpool is not None:
            t_pwc = time.monotonic_ns()
            seen = {}
            for i in plist:
                bw = windows[i].batch
                seen.setdefault((bw.n_rows, bw.lmax), windows[i])
            dpool.prewarm([dp.apply_prewarm_entry(
                w.batch.to_numpy(), table.shape[0], table.shape[2])
                for w in seen.values()], tracer=tr)
            tr.add_span(tele.SPAN_POOL_PREWARM_C, t_pwc, time.monotonic_ns() - t_pwc)
        apply_depth = 2 if dpool is None else 2 * dpool.n
        for i in plist:
            if coalescer is not None:
                # the window's apply rides a fused dispatch; its future joins
                # the in-flight queue like a handle
                try:
                    fut = coalescer.submit_apply(i, windows[i], table,
                                                 resident=resident_map.get(i))
                except Exception as e:
                    log.warning("coalesced apply submit of window %d failed (%s); "
                                "dispatching on the job's own path", i, e)
                else:
                    pend.append((i, "batch", fut))
                    tr.gauge(tele.G_DEVICE_INFLIGHT, len(pend))
                    if len(pend) >= apply_depth:
                        fetch_one()
                    continue
            # a fused window's columns are already computed: fetch only
            fh = fused_handles.pop(i, None)
            if fh is not None and isinstance(fh[0], dp.Slot):
                pend.append((i, fh[0], fh[1]))
            else:
                def dispatch(slot, i=i):
                    with tr.span(tele.SPAN_APPLY_DISPATCH, window=i,
                                 **dp.span_attrs(slot)):
                        h = bqsr.apply_dispatch(windows[i], resident_on(i, windows[i], slot),
                                                table_on(slot))
                    tr.count(tele.C_DEVICE_DISPATCHED)
                    return slot, h

                pend.append((i,) + on_survivors(i, dispatch))
            tr.gauge(tele.G_DEVICE_INFLIGHT, len(pend))
            if len(pend) >= apply_depth:
                fetch_one()
        while pend:
            fetch_one()

    try:
        # the pass-C span wraps apply + submit; the device dispatch and
        # fetch walls are its disjoint child spans
        with tr.span(tele.SPAN_PASS_C), tele.pass_scope("apply"):
            if table is not None:
                todo = parts
                if exec_state["mesh"] is not None:
                    todo = apply_parts_mesh(parts)
                if todo:
                    apply_parts_pool(todo)
            else:
                for i in parts:
                    w = windows[i]
                    pace_c(i, w.batch)
                    faults.point("proc.kill", device="pass_c")
                    pool.submit(part_path(out_path, i), w.batch, w.sidecar, w.header)
                    release_resident(i)
                    windows[i] = None
        with tr.span(tele.SPAN_WRITE_WAIT):
            pool.close()
    except RunCancelled:
        # a drain at a pass-C boundary: every part already submitted
        # publishes and journals before the cancellation propagates (a
        # writer error raised by this close replaces it)
        with tr.span(tele.SPAN_WRITE_WAIT):
            pool.close()
        raise
    except BaseException:
        pool.close(abort=True)
        raise
    for win in list(resident_map):
        release_resident(win)
    stats["resident_windows"] = resident_live["made"]
    health_board.publish(tr)
    stats["writer_shards"] = pool.n_io
    stats["writer_inflight_bound"] = pool.inflight_bound
    stats["n_parts"] = len(parts)
    tr.add_span(tele.SPAN_TOTAL, t_start_ns, time.monotonic_ns() - t_start_ns)

    # the stage walls are a derived view of the run tracer's spans
    stats.update(tele.streamed_stats_view(tr.snapshot()))
    stats["obs_merge_s"] = stats.get("obs_merge_fetch_s", 0.0)
    stats["apply_s"] = tr.span_seconds()[tele.SPAN_PASS_C]
    stats["reads_per_s"] = n_reads / stats["total_s"] if stats["total_s"] else 0.0
    now = kernels.launches()
    stats["kernel_launches"] = {k: now[k] - launches0[k] for k in now}
    _finish_trace(tr, stats, hb)
    return stats


#: The named-timer rows of a streamed run (the JAX package's labels): each
#: stage wall of ``stats`` joins the ``-print_metrics`` table.
_STAGE_TIMERS = (
    ("ingest_pass_s", "Streamed Pass A (ingest + summaries)"),
    ("md_cols_fetch_s", "Streamed MarkDup Columns (device fetch)"),
    ("resolve_s", "Streamed Barrier (dup resolve + targets)"),
    ("split_s", "Streamed Pass B (candidate split)"),
    ("observe_s", "Streamed BQSR Observe (hidden under sweeps)"),
    ("realign_s", "Streamed Tail (realign net of overlap)"),
    ("obs_merge_fetch_s", "Streamed Observe Merge (device fetch)"),
    ("solve_s", "Streamed Barrier (solve recalibration)"),
    ("apply_device_dispatch_s", "Streamed Pass C (device dispatch)"),
    ("apply_device_fetch_s", "Streamed Pass C (device fetch)"),
    ("apply_split_s", "Streamed Pass C (apply)"),
    ("write_wait_s", "Streamed Write Wait"),
)


def _finish_trace(tr: tele.Tracer, stats: dict, hb=None) -> None:
    """End-of-run telemetry: stop the heartbeat (before the absorb, which
    would otherwise count every counter twice in a last sample), add the
    stage walls to the named-timer table, and fold the run tracer into
    the global ``TRACE`` when recording is on."""
    _stop_heartbeat(hb)
    for key, label in _STAGE_TIMERS:
        if key in stats:
            ins.TIMERS.add(label, int(stats[key] * 1e9))
    if tele.TRACE.recording:
        tele.TRACE.absorb(tr)


def _write_part(out_dir: str, part_idx: int, ds: AlignmentDataset,
                compression: str) -> None:
    """Synchronous single-part write (the sharded executor's sink; the
    streamed pipeline itself writes through ``PartWriterPool``)."""
    from adam_tpu_torch.io import parquet

    parquet.save_alignments(parquet.part_path(out_dir, part_idx), ds.batch,
                            ds.sidecar, ds.header, compression=compression)


def _n_moved(before, after) -> int:
    """Rows whose alignment (start or CIGAR) the realignment changed."""
    a, b = before.to_numpy(), after.to_numpy()
    moved = (np.asarray(a.start) != np.asarray(b.start)) | (
        np.asarray(a.cigar_n) != np.asarray(b.cigar_n)
    )
    moved |= (np.asarray(a.cigar_ops) != np.asarray(b.cigar_ops)).any(axis=1)
    moved |= (np.asarray(a.cigar_lens) != np.asarray(b.cigar_lens)).any(axis=1)
    return int(moved.sum())


def _submit_args(done):
    ds, packed = done
    return ds.batch, ds.sidecar, ds.header, packed
