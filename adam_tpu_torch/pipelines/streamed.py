"""The streamed markdup + realign + BQSR transform on one device — a
lean counterpart of ``adam_tpu/pipelines/streamed.transform_streamed``.

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
             ``sw_fill``, on the device), then observe the realigned part
             as window ``n_windows`` with its post-realignment alignments
             (markdup -> realign -> BQSR, the reference's composition).
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


def _start_heartbeat(tr: tele.Tracer, progress: Optional[str]):
    """Build and start the live progress heartbeat, or None (the default:
    nothing is constructed).  As in the JAX package it samples the run
    tracer and the global ``TRACE`` (the fault counter lands on the
    latter); when no other sink already switched global recording on, it
    is switched on for the heartbeat's life and :func:`_stop_heartbeat`
    restores the flag and resets the tracer, so back-to-back runs in one
    process cannot sum each other's counters into a beat."""
    sink = progress if progress is not None else tele.progress_sink_from_env()
    if not sink:
        return None
    hb = tele.Heartbeat([tr, tele.TRACE], sink)
    hb._hb_restore_recording = not tele.TRACE.recording
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
    Telemetry changes no output byte and no kernel launch."""
    tr = tele.Tracer(recording=True)
    trace = tele.mint_trace_id()
    tr.set_trace(trace)
    tele.activate_trace(trace)
    hb = _start_heartbeat(tr, progress)
    try:
        return _transform_streamed_impl(
            path, out_path, tr, hb,
            mark_duplicates=mark_duplicates, recalibrate=recalibrate,
            realign=realign, known_snps=known_snps, known_indels=known_indels,
            consensus_model=consensus_model, window_reads=window_reads,
            compression=compression, n_writers=n_writers,
            max_indel_size=max_indel_size,
            max_consensus_number=max_consensus_number,
            lod_threshold=lod_threshold, max_target_size=max_target_size,
            dump_observations=dump_observations, known_table=known_table,
            run_dir=run_dir, resume=resume, device=device,
        )
    except BaseException:
        # a crashed run's last heartbeat line carries ok=false
        _stop_heartbeat(hb, ok=False)
        raise
    finally:
        _stop_heartbeat(hb)  # a no-op after the normal finish
        tele.deactivate_trace(trace)


def _transform_streamed_impl(
    path, out_path, tr: tele.Tracer, hb, *, mark_duplicates, recalibrate,
    realign, known_snps, known_indels, consensus_model, window_reads,
    compression, n_writers, max_indel_size, max_consensus_number,
    lod_threshold, max_target_size, dump_observations, known_table, run_dir,
    resume, device,
) -> dict:
    from adam_tpu_torch.convert import table_from_numpy
    from adam_tpu_torch.io.parquet import (
        PartWriterPool, part_index, part_path, purge_stale_staging,
    )
    from adam_tpu_torch.parallel.device_pool import ResidentWindow
    from adam_tpu_torch.pipelines import bqsr
    from adam_tpu_torch.pipelines import markdup as md
    from adam_tpu_torch.pipelines import realign as ra
    from adam_tpu_torch.pipelines.checkpoint import RunJournal

    t_start_ns = time.monotonic_ns()
    dev = resolve_device(device)
    dkey = device_key(dev)
    if known_indels is not None and consensus_model == "reads":
        # known indels imply the knowns consensus model (the reference's
        # -known_indels semantics)
        consensus_model = "knowns"
    mis, mcn, lod, mts = ra.resolve_tuning(
        max_indel_size, max_consensus_number, lod_threshold, max_target_size
    )
    launches0 = kernels.launches()
    stats: dict = {"device": str(dev), "resume.refused": 0,
                   "resume.windows_skipped": 0, "resume.histograms_loaded": 0}
    # the in-flight deques of pass A and pass C, sampled by the heartbeat
    inflight: list = []
    if hb is not None:
        # the HBM keys match the device= attribution of the spans
        hb.set_devices([dev])
        hb.set_provider(lambda: {
            "inflight_per_device": {dkey: sum(len(q) for q in inflight)},
            "partitioner": "pool",
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
    known_dev = None
    if recalibrate and known_table is not None:
        known_dev = table_from_numpy(known_table[0]).to(dev)
    # the fused B->C tier: with the applied table known before pass B (a
    # known table, or the journaled table of a -dump_observations resume,
    # which observes again only for the CSV), each eligible window's
    # observe and apply + pack run back to back
    fused_dev = None
    if recalibrate and bqsr.fused_bc_enabled():
        if known_dev is not None:
            fused_dev = known_dev
        elif journal is not None and journal.resumed and dump_observations:
            lt = journal.load_table()
            if lt is not None:
                fused_dev = table_from_numpy(lt[0]).to(dev)
    fused_handles: dict = {}
    stats["fused_bc"] = fused_dev is not None
    tr.gauge(tele.G_FUSED_BC, 1 if fused_dev is not None else 0)

    # ---- pass A: ingest || resident placement + markdup columns --------
    in_q: queue.Queue = queue.Queue(maxsize=3)
    abort = threading.Event()
    ingest = threading.Thread(
        target=_ingest_windows, args=(path, window_reads, in_q, abort, tr),
        daemon=True,
    )
    ingest.start()
    windows: list[AlignmentDataset] = []
    resident: list = []
    summaries: list[dict] = []
    events: list = []
    pend_cols: deque = deque()
    inflight.append(pend_cols)
    header = None
    n_reads = 0

    def summarize(win, cols):
        five, score = cols
        with tr.span(tele.SPAN_MD_FETCH):
            five = five.cpu().numpy()
            score = score.cpu().numpy()
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
                resident.append(ResidentWindow.place(batch, dev))
                if mark_duplicates:
                    # double buffer: window i's reductions run on the device
                    # while window i-1's columns are fetched and summarized
                    pend_cols.append((win, md.markdup_columns(batch, resident[win])))
                    tr.count(tele.C_DEVICE_DISPATCHED)
                    tr.gauge(tele.G_DEVICE_INFLIGHT, len(pend_cols))
                    if len(pend_cols) >= 2:
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
            # the lexsort of the packed summary keys runs on the device
            tr.gauge(tele.G_RESOLVE_DEVICE_SORT, 1)
            dup = md.resolve_duplicates(md.concat_summaries(summaries), device=dev)
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
    def observe(i, w):
        """Observe window ``i`` -> its histograms: a journaled sidecar's
        host arrays, else lazy device tensors (fused with the window's
        apply + pack when the tier is armed, the window eligible and its
        part still to write)."""
        if journal is not None and journal.resumed:
            got = journal.load_observation(i)
            if got is not None:
                stats["resume.histograms_loaded"] += 1
                tr.count(tele.C_RESUME_HISTOGRAMS_LOADED)
                return got
        tr.count(tele.C_DEVICE_DISPATCHED)
        if fused_dev is not None and i not in done_parts:
            faults.point("proc.kill", device="fused_bc")
            got = bqsr.fused_bc_dispatch(w, fused_dev, resident[i], known_snps)
            if got is not None:
                tr.count(tele.C_FUSED_DISPATCHED)
                fused_handles[i] = got[0]
                return got[1]
        return bqsr.observe_window(w, resident[i], known_snps)

    obs_parts: list = []
    obs_windows: list = []
    with tr.span(tele.SPAN_OBSERVE):
        if recalibrate and resume_table is None:
            with tele.pass_scope("observe"):
                for i, w in enumerate(windows):
                    if window_valid[i]:
                        faults.point("proc.kill", device="pass_b")
                        obs_parts.append(observe(i, w))
                        obs_windows.append(i)

    # ---- tail: realign the candidates, observe the realigned part ------
    # resume fast path: a journaled realigned part whose contribution to
    # the table is recoverable (the table itself, or its sidecar) skips
    # the candidate realign; the sidecar is loaded, not only probed, so
    # an unreadable one forces the realign
    t_tail_ns = time.monotonic_ns()
    n_win = len(windows)
    realigned = None
    r_obs = None
    skip_realign = False
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
        with tele.pass_scope("sweep"):
            realigned = ra.realign_indels(
                cand, consensus_model=consensus_model, known_indels=known_indels,
                max_indel_size=mis, max_consensus_number=mcn, lod_threshold=lod,
                max_target_size=mts, device=dev,
            )
        stats["n_realigned"] = _n_moved(cand.batch, realigned.batch)
        del cand
    else:
        del candidates  # none, or their journaled part needs no realign
    if realigned is not None:
        # the realigned part is a window too: placed once, it serves both
        # its observe and its pass-C apply
        resident.append(ResidentWindow.place(realigned.batch, dev))
        if recalibrate and resume_table is None:
            with tele.pass_scope("observe"):
                obs_parts.append(observe(n_win, realigned))
            obs_windows.append(n_win)
    elif r_obs is not None:
        # spliced in at its window-plan position: the same merge order as
        # the uninterrupted run
        stats["resume.histograms_loaded"] += 1
        tr.count(tele.C_RESUME_HISTOGRAMS_LOADED)
        obs_parts.append(r_obs)
        obs_windows.append(n_win)
    tr.add_span(tele.SPAN_TAIL, t_tail_ns, time.monotonic_ns() - t_tail_ns)
    # the port observes the windows before the realign, never under its
    # sweeps: realign_s is the whole tail
    tr.gauge(tele.G_OBSERVE_HIDDEN, 0)
    stats["n_fused_windows"] = len(fused_handles)

    # ---- barrier 2: merge histograms, solve the table ------------------
    # (a known table is applied as it is, with its own gl: the merge still
    # runs for the sidecars and the observation dump, the solve does not)
    table_dev = known_dev
    if resume_table is not None:
        table_dev = table_from_numpy(resume_table[0]).to(dev)
        tr.add_span(tele.SPAN_SOLVE, time.monotonic_ns(), 0)
    elif obs_parts:
        faults.point("proc.kill", device="barrier2")

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
            )
        if n_dev_parts:
            tr.count(tele.C_DEVICE_FETCHED, n_dev_parts)
        obs_parts.clear()
        with tr.span(tele.SPAN_SOLVE):
            if dump_observations:
                bqsr.dump_observation_csv(
                    total, mism, header.read_groups.names + ["null"], gl,
                    dump_observations,
                )
            if known_dev is None:
                table = bqsr.solve_recalibration_table(total, mism)
                table_dev = torch.from_numpy(table).to(dev)
            else:
                table, gl = known_dev.cpu().numpy(), int(known_table[1])
        if journal is not None:
            try:
                journal.save_table(table, gl)
            except OSError as e:
                log.warning("recalibration-table persist failed: %s", e)
        # the table is journaled: a resume from here goes into pass C
        faults.point("proc.kill", device="barrier2")
    else:
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
            if i < len(resident):
                resident[i] = None
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

    def submit(i, *args):
        faults.point("proc.kill", device="pass_c")
        pool.submit(part_path(out_path, i), *args)

    pend: deque = deque()
    inflight.append(pend)

    def fetch_one():
        j, h = pend[0]
        # the fetch span holds the wait for the window's device work
        with tr.span(tele.SPAN_APPLY_FETCH, window=j):
            done = bqsr.apply_finish(h)
        pend.popleft()
        tr.count(tele.C_DEVICE_FETCHED)
        submit(j, *_submit_args(done))

    try:
        # the pass-C span wraps apply + submit; the device dispatch and
        # fetch walls are its disjoint child spans
        with tr.span(tele.SPAN_PASS_C), tele.pass_scope("apply"):
            if table_dev is not None:
                for i in parts:
                    # a fused window's columns are already computed: fetch only
                    h = fused_handles.pop(i, None)
                    if h is None:
                        with tr.span(tele.SPAN_APPLY_DISPATCH, window=i):
                            h = bqsr.apply_dispatch(windows[i], resident[i], table_dev)
                        tr.count(tele.C_DEVICE_DISPATCHED)
                    pend.append((i, h))
                    tr.gauge(tele.G_DEVICE_INFLIGHT, len(pend))
                    windows[i] = resident[i] = None  # free as we go
                    if len(pend) >= 2:
                        fetch_one()
                while pend:
                    fetch_one()
            else:
                for i in parts:
                    w = windows[i]
                    windows[i] = resident[i] = None
                    submit(i, w.batch, w.sidecar, w.header)
        with tr.span(tele.SPAN_WRITE_WAIT):
            pool.close()
    except BaseException:
        pool.close(abort=True)
        raise
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
