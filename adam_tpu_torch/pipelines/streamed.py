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

Every Parquet part is byte-identical to the JAX package's streamed run on
the same input and flags (``tests/test_torch_streamed.py``).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from adam_tpu_torch.api.datasets import AlignmentDataset
from adam_tpu_torch.device import resolve_device
from adam_tpu_torch.ops import kernels

_SENTINEL = object()


def _ingest_windows(path: str, window_reads: int, out_q: queue.Queue,
                    abort: threading.Event) -> None:
    """Ingest thread body: tokenize windows (a ``.bam``, after one ``.gz``
    is stripped, through the BAM reader, anything else as SAM text), push
    (batch, side, header);
    an exception is pushed for the consumer to raise.  ``abort`` unblocks
    the bounded put when the consumer dies mid-stream."""

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
        for item in it:
            if not put(item):
                return
        put(_SENTINEL)
    except BaseException as e:  # surface in the consumer
        put(e)


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
    max_indel_size: int | None = None,
    max_consensus_number: int | None = None,
    lod_threshold: float | None = None,
    max_target_size: int | None = None,
    dump_observations: Optional[str] = None,
    known_table: Optional[tuple] = None,
    device: str = "cuda",
) -> dict:
    """Run the streamed markdup + realign + BQSR transform -> stats (stage
    walls in seconds, read, window and candidate counts, kernel launches
    in this run).

    Output is a Parquet part-file directory, ``out_path/part-r-NNNNN.parquet``
    with one part per input window that keeps rows, plus the realigned
    part ``n_windows``.  ``realign`` turns on indel realignment with the
    ``consensus_model`` ("reads", "smithwaterman" or "knowns") and the
    JAX package's tuning knobs (None = its defaults).  ``device`` is
    ``"cuda"`` (default) or ``"cpu"``; the CPU runs each kernel's plain
    PyTorch version.

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
    them.  Output bytes are the same fused or not."""
    from adam_tpu_torch.io.parquet import (
        PartWriterPool, part_path, purge_stale_staging,
    )
    from adam_tpu_torch.parallel.device_pool import ResidentWindow
    from adam_tpu_torch.pipelines import bqsr
    from adam_tpu_torch.pipelines import markdup as md
    from adam_tpu_torch.pipelines import realign as ra

    dev = resolve_device(device)
    if known_indels is not None and consensus_model == "reads":
        # known indels imply the knowns consensus model (the reference's
        # -known_indels semantics)
        consensus_model = "knowns"
    mis, mcn, lod, mts = ra.resolve_tuning(
        max_indel_size, max_consensus_number, lod_threshold, max_target_size
    )
    launches0 = kernels.launches()
    t_start = time.monotonic()
    stats: dict = {"device": str(dev)}
    known_dev = None
    if recalibrate and known_table is not None:
        from adam_tpu_torch.convert import table_from_numpy

        known_dev = table_from_numpy(known_table[0]).to(dev)
    # the fused B->C tier: with the applied table known before pass B,
    # each eligible window's observe and apply + pack run back to back
    fused = known_dev is not None and bqsr.fused_bc_enabled()
    fused_handles: dict = {}
    stats["fused_bc"] = fused
    os.makedirs(out_path, exist_ok=True)
    purge_stale_staging(out_path)

    # ---- pass A: ingest || resident placement + markdup columns --------
    in_q: queue.Queue = queue.Queue(maxsize=3)
    abort = threading.Event()
    ingest = threading.Thread(
        target=_ingest_windows, args=(path, window_reads, in_q, abort),
        daemon=True,
    )
    ingest.start()
    windows: list[AlignmentDataset] = []
    resident: list = []
    summaries: list[dict] = []
    events: list = []
    pend_cols: deque = deque()
    header = None
    n_reads = 0

    def summarize(win, cols):
        five, score = cols
        summaries.append(md.row_summary(
            windows[win], five.cpu().numpy(), score.cpu().numpy()
        ))

    t0 = time.monotonic()
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
            n_reads += batch.n_valid()
            resident.append(ResidentWindow.place(batch, dev))
            if mark_duplicates:
                # double buffer: window i's reductions run on the device
                # while window i-1's columns are fetched and summarized
                pend_cols.append((win, md.markdup_columns(batch, resident[win])))
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
    stats["ingest_pass_s"] = time.monotonic() - t0
    stats["n_reads"] = n_reads
    stats["n_windows"] = len(windows)

    # ---- barrier 1: resolve duplicates, merge realignment targets -----
    t0 = time.monotonic()
    if mark_duplicates and summaries:
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
    stats["resolve_s"] = time.monotonic() - t0

    # ---- split: candidate rows leave their windows (pre-BQSR) ----------
    t0 = time.monotonic()
    candidates: list[AlignmentDataset] = []
    window_valid: list[int] = []
    for i, w in enumerate(windows):
        n_valid = w.batch.n_rows
        if targets:
            cand, w, n_valid = ra.split_realign_candidates(w, targets, names)
            if cand is not None:
                candidates.append(cand)
            windows[i] = w
        window_valid.append(n_valid)
    stats["split_s"] = time.monotonic() - t0
    stats["n_candidates"] = sum(c.batch.n_rows for c in candidates)

    # ---- pass B: observe every window (histograms stay on the device) --
    def observe(i, w):
        """Observe window ``i`` (fused with its apply + pack when the tier
        is armed and the window eligible) -> its lazy histograms."""
        if fused:
            got = bqsr.fused_bc_dispatch(w, known_dev, resident[i], known_snps)
            if got is not None:
                fused_handles[i] = got[0]
                return got[1]
        return bqsr.observe_window(w, resident[i], known_snps)

    t0 = time.monotonic()
    obs_parts = []
    if recalibrate:
        for i, w in enumerate(windows):
            if window_valid[i]:
                obs_parts.append(observe(i, w))
    stats["observe_s"] = time.monotonic() - t0

    # ---- tail: realign the candidates, observe the realigned part ------
    t0 = time.monotonic()
    realigned = None
    if candidates:
        cand = AlignmentDataset.concat(candidates)
        del candidates
        realigned = ra.realign_indels(
            cand, consensus_model=consensus_model, known_indels=known_indels,
            max_indel_size=mis, max_consensus_number=mcn, lod_threshold=lod,
            max_target_size=mts, device=dev,
        )
        stats["n_realigned"] = _n_moved(cand.batch, realigned.batch)
        del cand
    else:
        stats["n_realigned"] = 0
    stats["realign_s"] = time.monotonic() - t0
    if realigned is not None:
        t0 = time.monotonic()
        # the realigned part is a window too: placed once, it serves both
        # its observe and its pass-C apply
        resident.append(ResidentWindow.place(realigned.batch, dev))
        if recalibrate:
            obs_parts.append(observe(len(windows), realigned))
        stats["observe_s"] += time.monotonic() - t0
    stats["n_fused_windows"] = len(fused_handles)

    # ---- barrier 2: merge histograms, solve the table ------------------
    # (a known table is applied as it is, with its own gl: the merge still
    # runs for the observation dump, the solve does not)
    t0 = time.monotonic()
    table_dev = known_dev
    if obs_parts:
        total, mism, gl = bqsr.merge_observations(obs_parts)
        obs_parts.clear()
        stats["obs_merge_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        if dump_observations:
            bqsr.dump_observation_csv(
                total, mism, header.read_groups.names + ["null"], gl,
                dump_observations,
            )
        if known_dev is None:
            table_dev = torch.from_numpy(
                bqsr.solve_recalibration_table(total, mism)).to(dev)
    stats["solve_s"] = time.monotonic() - t0

    # ---- pass C: apply + pack || encode || part writes -----------------
    # the realigned part applies and submits first (it is the largest
    # part, so its encode and write overlap the window applies); windows
    # with no valid row left write no part
    t0 = time.monotonic()
    pool = PartWriterPool(compression=compression)
    n_win = len(windows)
    if realigned is not None:
        windows.append(realigned)
        window_valid.append(realigned.batch.n_rows)
    parts = ([n_win] if realigned is not None else []) + [
        i for i in range(n_win) if window_valid[i]
    ]
    try:
        if table_dev is not None:
            pend: deque = deque()
            for i in parts:
                # a fused window's columns are already computed: fetch only
                h = fused_handles.pop(i, None)
                if h is None:
                    h = bqsr.apply_dispatch(windows[i], resident[i], table_dev)
                pend.append((i, h))
                windows[i] = resident[i] = None  # free as we go
                if len(pend) >= 2:
                    j, h = pend.popleft()
                    pool.submit(part_path(out_path, j), *_submit_args(bqsr.apply_finish(h)))
            while pend:
                j, h = pend.popleft()
                pool.submit(part_path(out_path, j), *_submit_args(bqsr.apply_finish(h)))
        else:
            for i in parts:
                w = windows[i]
                windows[i] = resident[i] = None
                pool.submit(part_path(out_path, i), w.batch, w.sidecar, w.header)
        stats["apply_s"] = time.monotonic() - t0
        t1 = time.monotonic()
        pool.close()
        stats["write_wait_s"] = time.monotonic() - t1
    except BaseException:
        pool.close(abort=True)
        raise
    stats["n_parts"] = len(parts)
    stats["total_s"] = time.monotonic() - t_start
    stats["reads_per_s"] = n_reads / stats["total_s"] if stats["total_s"] else 0.0
    now = kernels.launches()
    stats["kernel_launches"] = {k: now[k] - launches0[k] for k in now}
    return stats


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
