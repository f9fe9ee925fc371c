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
  pass B     per window: host MD walk -> bit-packed residue-ok and
             mismatch masks, shipped to the device; covariate keys and
             the observe histogram (CUDA kernel ``observe_hist``) run
             there and stay there until the barrier.
  tail       realign the concatenated candidates (the sweeps, and under
             ``consensus_model="smithwaterman"`` the Smith-Waterman fill
             ``sw_fill``, on the device), then observe the realigned part
             as window ``n_windows`` with its post-realignment alignments
             (markdup -> realign -> BQSR, the reference's composition).
  barrier 2  fetch and merge the histograms in window order, solve the
             recalibration table on the host (f64 numpy).
  pass C     per window: table gather, SANGER encode, base decode and
             two row-prefix packs (CUDA kernel ``pack_rows``) on the
             device, double-buffered; the packed columns come home
             (``sum(lengths)`` bytes each), OQ is stashed on the host and
             a writer pool encodes and publishes the Parquet part.  The
             realigned part goes first, as part ``n_windows``; a window
             whose rows were all realigned away writes no part.

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
    """Ingest thread body: tokenize windows, push (batch, side, header);
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

        for item in sam_io.iter_sam_batches(path, batch_reads=window_reads):
            if not put(item):
                return
        put(_SENTINEL)
    except BaseException as e:  # surface in the consumer
        put(e)


def _observe_window(ds: AlignmentDataset, rw, device):
    """Pass B for one window -> lazy (total, mism) i64 device histograms
    and the window's grid width ``gl``."""
    from adam_tpu_torch.formats.batch import pad_rows_np
    from adam_tpu_torch.ops.colpack import pack_mask_bits
    from adam_tpu_torch.ops.mdtag import batch_md_arrays
    from adam_tpu_torch.pipelines import bqsr

    b = ds.batch.to_numpy()
    is_mm, _, has_md = batch_md_arrays(b, ds.sidecar, need_ref_codes=False)
    read_ok = bqsr.observe_read_mask(b, has_md)
    residue_ok = bqsr.observe_residue_mask(b)
    n_rg = len(ds.read_groups) + 1
    g, gl = rw.g, rw.gl

    def put(arr):
        return torch.from_numpy(arr).to(device)

    total, mism = bqsr.observe_packed_body(
        *rw.args(),
        put(pack_mask_bits(pad_rows_np(residue_ok, g, False, cols=gl))),
        put(pack_mask_bits(pad_rows_np(is_mm, g, False, cols=gl))),
        put(pad_rows_np(read_ok, g, False)),
        n_rg, gl,
    )
    return total, mism, gl


def _dispatch_apply(ds: AlignmentDataset, rw, table_dev):
    """Pass C dispatch for one window -> handle for :func:`_finish_apply`
    (the packed columns are still being computed on the device)."""
    from adam_tpu_torch.formats.batch import pad_rows_np
    from adam_tpu_torch.ops.colpack import pack_lengths
    from adam_tpu_torch.pipelines import bqsr

    b = ds.batch.to_numpy()
    g, gl, dev = rw.g, rw.gl, rw.device
    pq, pb = bqsr.apply_pack2_body(
        *rw.args(),
        torch.from_numpy(pad_rows_np(b.has_qual, g, False)).to(dev),
        torch.from_numpy(pad_rows_np(b.valid, g, False)).to(dev),
        table_dev, gl, g * gl,
    )
    lens_q = pack_lengths(b.lengths, b.valid, b.has_qual)
    lens_b = pack_lengths(b.lengths, b.valid)
    return ds, b, pq, lens_q, pb, lens_b


def _finish_apply(handle):
    """Fetch a dispatched window's packed columns (exactly
    ``sum(lengths)`` bytes each) and stash OQ -> (dataset, packed)."""
    from adam_tpu_torch.io.arrow_pack import PackedColumns, PackedQuals
    from adam_tpu_torch.pipelines import bqsr

    ds, b, pq, lens_q, pb, lens_b = handle
    packed = PackedColumns(
        quals=PackedQuals(pq[: int(lens_q.sum())].cpu().numpy(), lens_q),
        bases=PackedQuals(pb[: int(lens_b.sum())].cpu().numpy(), lens_b),
    )
    return bqsr.stash_orig_quals(ds, b), packed


def transform_streamed(
    path: str,
    out_path: str,
    *,
    mark_duplicates: bool = True,
    recalibrate: bool = True,
    realign: bool = False,
    consensus_model: str = "reads",
    window_reads: int = 262_144,
    compression: str = "zstd",
    max_indel_size: int | None = None,
    max_consensus_number: int | None = None,
    lod_threshold: float | None = None,
    max_target_size: int | None = None,
    dump_observations: Optional[str] = None,
    device: str = "cuda",
) -> dict:
    """Run the streamed markdup + realign + BQSR transform -> stats (stage
    walls in seconds, read, window and candidate counts, kernel launches
    in this run).

    Output is a Parquet part-file directory, ``out_path/part-r-NNNNN.parquet``
    with one part per input window that keeps rows, plus the realigned
    part ``n_windows``.  ``realign`` turns on indel realignment with the
    ``consensus_model`` ("reads", or "smithwaterman"; "knowns" without a
    table falls back to read consensuses, as in the JAX package) and the
    JAX package's tuning knobs (None = its defaults).  ``device`` is
    ``"cuda"`` (default) or ``"cpu"``; the CPU runs each kernel's plain
    PyTorch version."""
    from adam_tpu_torch.io.parquet import (
        PartWriterPool, part_path, purge_stale_staging,
    )
    from adam_tpu_torch.parallel.device_pool import ResidentWindow
    from adam_tpu_torch.pipelines import bqsr
    from adam_tpu_torch.pipelines import markdup as md
    from adam_tpu_torch.pipelines import realign as ra

    dev = resolve_device(device)
    mis, mcn, lod, mts = ra.resolve_tuning(
        max_indel_size, max_consensus_number, lod_threshold, max_target_size
    )
    launches0 = kernels.launches()
    t_start = time.monotonic()
    stats: dict = {"device": str(dev)}
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
    t0 = time.monotonic()
    obs_parts = []
    if recalibrate:
        for i, w in enumerate(windows):
            if window_valid[i]:
                obs_parts.append(_observe_window(w, resident[i], dev))
    stats["observe_s"] = time.monotonic() - t0

    # ---- tail: realign the candidates, observe the realigned part ------
    t0 = time.monotonic()
    realigned = None
    if candidates:
        cand = AlignmentDataset.concat(candidates)
        del candidates
        realigned = ra.realign_indels(
            cand, consensus_model=consensus_model, max_indel_size=mis,
            max_consensus_number=mcn, lod_threshold=lod, max_target_size=mts,
            device=dev,
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
            obs_parts.append(_observe_window(realigned, resident[-1], dev))
        stats["observe_s"] += time.monotonic() - t0

    # ---- barrier 2: merge histograms, solve the table ------------------
    t0 = time.monotonic()
    table = None
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
        table = bqsr.solve_recalibration_table(total, mism)
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
        if table is not None:
            table_dev = torch.from_numpy(table).to(dev)
            pend: deque = deque()
            for i in parts:
                pend.append((i, _dispatch_apply(windows[i], resident[i], table_dev)))
                windows[i] = resident[i] = None  # free as we go
                if len(pend) >= 2:
                    j, h = pend.popleft()
                    pool.submit(part_path(out_path, j), *_submit_args(_finish_apply(h)))
            while pend:
                j, h = pend.popleft()
                pool.submit(part_path(out_path, j), *_submit_args(_finish_apply(h)))
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
