"""The sharded, out-of-core markdup + realign + BQSR transform — the port of
``adam_tpu/parallel/sharded.py`` (``transform -shards N``).

The pass structure of ``pipelines/streamed.py`` with genome-bin shards on
disk as the unit instead of ingest windows, for input that does not fit
in memory:

1. **Shuffle**: the windowed SAM/BAM reader streams into per-genome-bin
   shards keyed by the 5'-clipped position (``parallel/host_shuffle``,
   the key computed on the device), so PCR duplicate groups co-locate.
2. **Pass A** (per shard, loaded then dropped): the duplicate-marking
   columns on the device, folded into compact summaries, and the indel
   events.
3. **Barrier**: the global duplicate resolve (its lexsort on the device)
   and the target merge, so duplicate groups whose mates landed in
   different bins and targets spanning a bin edge resolve as in one batch.
4. **Split**: per shard, the realignment candidates (pre-BQSR quals) are
   gathered out; a per-shard candidate bitmask is kept, not the shard.
5. **Tail**: each shard's remainder is observed under the resolved
   duplicate flags (kernel 1, once per row chunk of the shard), the
   candidates of all shards realign together, and the realigned part is
   observed with its new alignments (kernel 1 once more); the histograms
   merge and the table is solved on the host.  As in the JAX package the
   remainders are observed inside the realign's device wait
   (``overlap_work``: between the sweeps' dispatch and their fetch), and
   ``realign_s`` stays free of ``observe_s``.
6. **Pass C**: per shard, the table gathered into the quals on the device
   (no column pack: kernel 2 does not run here, as the JAX package's
   sharded pass C applies with ``pack=False``); a writer pool of 3
   threads with backpressure publishes part ``i`` for shard ``i``, and
   the realigned part last, as part ``len(shards)``.

Each pass reads its shards through a bounded LRU cache (``cache_bytes``,
default 4 GiB); ``cache_bytes=0`` keeps one shard resident at a time.
Every part is byte-identical to the JAX package's sharded run on the same
input and flags.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from collections import OrderedDict

import numpy as np
import torch

from adam_tpu_torch.api.datasets import AlignmentDataset


def _nbytes(ds: AlignmentDataset) -> int:
    n = sum(getattr(a, "nbytes", 0) for a in ds.batch.arrays().values())
    side = ds.sidecar
    for col in (side.names, side.attrs, side.md, side.orig_quals):
        n += getattr(getattr(col, "buf", None), "nbytes", 0)
    return n


def transform_sharded(
    path: str,
    out_path: str,
    n_shards: int,
    *,
    mark_duplicates: bool = True,
    recalibrate: bool = True,
    realign: bool = True,
    known_snps=None,
    known_indels=None,
    consensus_model: str = "reads",
    compression: str = "zstd",
    shuffle_dir: str | None = None,
    batch_reads: int = 500_000,
    max_indel_size: int | None = None,
    max_consensus_number: int | None = None,
    lod_threshold: float | None = None,
    max_target_size: int | None = None,
    dump_observations: str | None = None,
    shard_fmt: str = "raw",
    cache_bytes: int = 4 << 30,
    device: str = "cuda",
) -> dict:
    """Run the sharded transform of SAM/BAM ``path`` into the part
    directory ``out_path`` over ``n_shards`` genome bins -> the run's
    stats: the JAX package's stage walls (``shuffle_s``, ``summaries_s``,
    ``resolve_s``, ``split_s``, ``observe_s``, ``realign_s``, ``solve_s``,
    ``apply_split_s``, ``write_wait_s``, ``total_s``) and ``n_reads``,
    plus ``n_shards`` (shard files), ``shard_rows`` (rows per shard),
    ``shards_observed`` (the shards pass B observed), ``n_observed``
    (kernel-1 observes: one per row chunk of each observed shard, one for
    the realigned part), ``n_parts``, ``reads_per_s`` and
    ``kernel_launches``.  The
    tensor work runs on ``device`` (default the card)."""
    from concurrent.futures import ThreadPoolExecutor

    from adam_tpu_torch.device import resolve_device
    from adam_tpu_torch.io.parquet import purge_stale_staging
    from adam_tpu_torch.io.sam import iter_bam_batches, iter_sam_batches
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.parallel import host_shuffle
    from adam_tpu_torch.parallel.device_pool import ResidentWindow
    from adam_tpu_torch.pipelines import bqsr as bqsr_mod
    from adam_tpu_torch.pipelines import markdup as md_mod
    from adam_tpu_torch.pipelines import realign as realign_mod
    from adam_tpu_torch.pipelines.streamed import _write_part

    dev = resolve_device(device)
    launches0 = kernels.launches()
    t_start = time.perf_counter()
    stats: dict = {"device": str(dev)}
    os.makedirs(out_path, exist_ok=True)
    # a crashed run's staged part writes purge before any writer is live
    purge_stale_staging(out_path)
    tmp = shuffle_dir or tempfile.mkdtemp(prefix="adam_tpu_torch_shards_")
    own_tmp = shuffle_dir is None
    if known_indels is not None and consensus_model == "reads":
        # known indels imply the knowns consensus model (the reference's
        # -known_indels semantics)
        consensus_model = "knowns"
    mis, mcn, lod, mts = realign_mod.resolve_tuning(
        max_indel_size, max_consensus_number, lod_threshold, max_target_size)

    def finish() -> dict:
        stats["total_s"] = time.perf_counter() - t_start
        stats["reads_per_s"] = (stats["n_reads"] / stats["total_s"]
                                if stats["total_s"] else 0.0)
        now = kernels.launches()
        stats["kernel_launches"] = {k: now[k] - launches0[k] for k in now}
        return stats

    try:
        # ---- 1. shuffle to genome-bin shards --------------------------
        t = time.perf_counter()
        p = str(path)
        base = p[:-3] if p.endswith(".gz") else p
        reader = (iter_bam_batches(p, batch_reads=batch_reads) if base.endswith(".bam")
                  else iter_sam_batches(p, batch_reads=batch_reads))
        shard_paths = host_shuffle.shuffle_alignments_to_shards(
            reader, n_shards, tmp, compression=compression, fmt=shard_fmt, device=dev)
        stats["shuffle_s"] = time.perf_counter() - t
        stats["n_shards"] = len(shard_paths)
        stats["n_observed"] = 0
        stats["n_parts"] = 0
        if not shard_paths:
            stats["n_reads"] = 0
            return finish()

        # bounded LRU shard cache: shards that fit skip the re-decode on
        # the later passes; eviction keeps resident bytes under budget
        cache: OrderedDict[int, tuple[AlignmentDataset, int]] = OrderedDict()
        cache_total = [0]

        def load(si: int, insert: bool = True) -> AlignmentDataset:
            hit = cache.get(si)
            if hit is not None:
                cache.move_to_end(si)
                return hit[0]
            ds = AlignmentDataset(*next(host_shuffle.iter_shards([shard_paths[si]])))
            nb = _nbytes(ds)
            # the final pass never revisits a shard: inserting there would
            # only evict shards later in the same pass
            if insert and nb <= cache_bytes:
                while cache and cache_total[0] + nb > cache_bytes:
                    _, (_, old_nb) = cache.popitem(last=False)
                    cache_total[0] -= old_nb
                cache[si] = (ds, nb)
                cache_total[0] += nb
            return ds

        def with_dup_flags(ds: AlignmentDataset, si: int) -> AlignmentDataset:
            if dup_slices[si] is None:
                return ds
            b = ds.batch.to_numpy()
            return ds.with_batch(b.replace(
                flags=md_mod.apply_duplicate_flags(np.asarray(b.flags), dup_slices[si])))

        # ---- 2. pass A: summaries + events ----------------------------
        t = time.perf_counter()
        summaries, events, counts = [], [], []
        header = None
        for si in range(len(shard_paths)):
            ds = load(si)
            header = ds.header
            b = ds.batch.to_numpy()
            counts.append(b.n_rows)
            if mark_duplicates:
                five, score = md_mod.markdup_columns(b, ResidentWindow.place(b, dev))
                summaries.append(md_mod.row_summary(ds, five.cpu().numpy(),
                                                    score.cpu().numpy()))
            if realign:
                events.append(realign_mod.extract_indel_event_arrays(b, max_indel_size=mis))
        stats["n_reads"] = int(sum(counts))
        stats["shard_rows"] = counts
        stats["summaries_s"] = time.perf_counter() - t

        # ---- 3. barrier: resolve + targets ----------------------------
        t = time.perf_counter()
        dup_slices = [None] * len(shard_paths)
        if mark_duplicates and summaries:
            dup = md_mod.resolve_duplicates(md_mod.concat_summaries(summaries), device=dev)
            off = 0
            for si, n in enumerate(counts):
                dup_slices[si] = dup[off: off + n]
                off += n
            del summaries
        names = header.seq_dict.names
        targets = (
            realign_mod.merge_events(
                np.concatenate(events, axis=0) if events else np.zeros((0, 5), np.int64),
                names, mts)
            if realign else []
        )
        stats["resolve_s"] = time.perf_counter() - t

        # ---- 4. split: candidates out (pre-BQSR quals, the reference's
        # markdup -> realign -> BQSR, Transform.scala:121-144); only a
        # per-shard candidate bitmask is carried across passes ----------
        t = time.perf_counter()
        candidates, splits = [], []
        cand_masks: dict[int, np.ndarray] = {}
        for si in range(len(shard_paths)):
            ds = with_dup_flags(load(si), si)
            n_valid = ds.batch.n_rows
            if targets:
                b2 = ds.batch.to_numpy()
                mask = realign_mod.candidate_mask(b2, targets, names)
                cand_masks[si] = mask
                if mask.any():
                    candidates.append(ds.take_rows(np.flatnonzero(mask)))
                ds = realign_mod.mask_out_candidates(ds, targets, names, mask=mask)
                n_valid = int(np.asarray(ds.batch.valid).sum())
            splits.append((si, n_valid))
        stats["split_s"] = time.perf_counter() - t

        def remainder(si: int, insert: bool = True) -> AlignmentDataset:
            ds = with_dup_flags(load(si, insert), si)
            if si in cand_masks:
                ds = realign_mod.mask_out_candidates(ds, targets, names,
                                                     mask=cand_masks[si])
            return ds

        # ---- 5. tail: realign the candidates of all shards together,
        # observing the remainders under the sweeps, then observe the
        # realigned part ----------------------------------------------------
        obs_parts = []
        observed = [si for si, n_valid in splits if n_valid] if recalibrate else []

        def observe_remainders():
            # remainder rows are untouched by realignment, so observing them
            # on either side of it gives the same histograms
            t0 = time.perf_counter()
            for si in observed:
                obs_parts.extend(
                    bqsr_mod.observe_dataset(remainder(si), dev, known_snps)[1])
            stats["observe_s"] = time.perf_counter() - t0

        stats["shards_observed"] = observed
        t = time.perf_counter()
        realigned = None
        if candidates:
            realigned = realign_mod.realign_indels(
                AlignmentDataset.concat(candidates),
                consensus_model=consensus_model, known_indels=known_indels,
                max_indel_size=mis, max_consensus_number=mcn, lod_threshold=lod,
                max_target_size=mts, device=dev, overlap_work=observe_remainders,
            )
            if recalibrate and realigned.batch.n_rows:
                obs_parts += bqsr_mod.observe_dataset(realigned, dev, known_snps)[1]
        else:
            observe_remainders()
        stats["n_observed"] = len(obs_parts)
        stats["realign_s"] = time.perf_counter() - t - stats["observe_s"]

        # ---- barrier: merge histograms, solve the table ---------------
        t = time.perf_counter()
        table_dev = None
        if recalibrate and obs_parts:
            total, mism, gl = bqsr_mod.merge_observations(obs_parts)
            if dump_observations:
                bqsr_mod.dump_observation_csv(
                    total, mism, header.read_groups.names + ["null"], gl,
                    dump_observations)
            table_dev = torch.from_numpy(
                bqsr_mod.solve_recalibration_table(total, mism)).to(dev)
        del obs_parts
        stats["solve_s"] = time.perf_counter() - t

        def recalibrated(ds: AlignmentDataset) -> AlignmentDataset:
            if table_dev is None:
                return ds
            return bqsr_mod.apply_placed(bqsr_mod.place_chunks(ds, dev), table_dev)

        # ---- 6. pass C: apply || part writes --------------------------
        t = time.perf_counter()
        futures = []
        n_writers = 3
        with ThreadPoolExecutor(max_workers=n_writers) as pool:
            def submit_write(idx, ds):
                # backpressure: each pending write pins a whole shard
                while sum(1 for f in futures if not f.done()) >= n_writers:
                    next(f for f in futures if not f.done()).result()
                futures.append(pool.submit(_write_part, out_path, idx, ds, compression))

            for si in range(len(shard_paths)):
                ds = remainder(si, insert=False)
                ev = cache.pop(si, None)  # final pass: free as we go
                if ev is not None:
                    cache_total[0] -= ev[1]
                ds = recalibrated(ds)
                if int(np.asarray(ds.batch.valid).sum()):
                    submit_write(si, ds)
            if realigned is not None:
                submit_write(len(shard_paths), recalibrated(realigned))
            stats["apply_split_s"] = time.perf_counter() - t

            t = time.perf_counter()
            for f in futures:
                err = f.exception()
                if err is not None:
                    raise err
        stats["write_wait_s"] = time.perf_counter() - t
        stats["n_parts"] = len(futures)
        return finish()
    finally:
        if own_tmp:
            shutil.rmtree(tmp, ignore_errors=True)
