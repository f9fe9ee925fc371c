"""Smoke test of the PyTorch/CUDA port on one GPU (run: ``python3 chip_smoke.py``).

Phases, each of which fails the script on any error:

1. the card: its name, its name and power limit from nvidia-smi, and its
   instruction issue rate (SMs x 128 lanes x the maximum SM clock), the
   rate the Smith-Waterman kernels' operation bounds use;
2. build: the CUDA kernels (one nvcc per source, started together) and
   the native host codecs;
3. kernels: each kernel against its plain PyTorch version on the card,
   inputs from a numpy seed, bit equality required, times by CUDA events:
   observe_hist and pack_rows at the main path's shapes (g = 262,144
   rows, gl = 128 lanes, n_rg = 3), observe_hist once more at the
   dataset-level transform's shape (g = 1,048,576) and at the service's
   fused shape (g = 524,288: 8 windows of 65,536 rows, n_rg = 56, more
   than 4,096 slabs, so the kernel's grouped route), pack_rows once more with the SANGER
   encode fused in, timed beside the unfused ``sanger_body`` + pack pair;
   sw_score at ``benchmark_gcups``' shape (B = 8,192, lx = ly = 127) in
   f32 (weights 1, -0.333, -0.5, -0.5), i16 and bf16 (2, -1, -1, -1),
   each then driven through ``benchmark_gcups`` with its launches
   counted (GCUPS printed);
4. main path: a WGS-shaped SAM of 1,048,576 reads x 100 bp (4 contigs x
   800 kb, 2 read groups, PCR duplicates, soft clips) through
   ``python -m adam_tpu_torch transform -streaming -mark_duplicate_reads
   -realign_indels -recalibrate_base_qualities -window_reads 262144`` on
   the card, launch counts read around the run, parts read back (one per
   window plus the realigned part, some rows carrying OC:Z:); the same
   run once more under ``torch.profiler`` for the device's busy share;
   then the transform without realignment on the same input;
4b. the smithwaterman consensus model: ``transform_streamed(...,
   realign=True, consensus_model="smithwaterman")`` on the same input
   through the library call, every sw_fill launch's (B, lx, ly) and route
   logged; then sw_fill against its plain version at the median launch
   shape (warp route) and at SW_BLOCK_SHAPE (block route), and the
   ``moves.cpu()`` copy of the median launch's output timed;
4c. the known-sites path on the main path's input: its known-SNP VCF
   (``make_wgs(..., known_sites_out=...)``) and a known-indel VCF derived
   from the SAM (``tools/make_known_indels_vcf.py``) through the CLI's
   ``-known_snps -known_indels`` (the ``knowns`` consensus model),
   beside the same run without the SNP VCF; both dump their
   observations, and the SNP mask must leave fewer observed residues;
   the table the port solves there is saved as an ``.npz``;
4d. that table through ``-known_recalibration_table`` (with both VCFs),
   once with ``ADAM_TPU_FUSED_BC=1`` and once with ``=0``: the parts of
   the two legs and of 4c byte-identical, every observed part fused in
   the fused leg and none in the other, kernels 1 and 2 launched once
   per part (kernel 2 once per encode);
4e. BAM ingest: the main path's SAM written as a BAM by the port's
   ``write_bam`` (timed), its byte windows listed (``iter_bam_batches``),
   then ``transform in.bam -streaming -mark_duplicate_reads
   -realign_indels -recalibrate_base_qualities`` on the card: rows ==
   reads, parts == BAM windows + 1, kernel 1 launched at least once and
   kernel 2 exactly twice per part, and the rows, as a multiset, those of
   the main path's SAM run (markdup, realign and BQSR are global, so the
   windows do not change them); then the ``-mark_duplicate_reads``-only
   form (``BASELINE.json`` config 2);
4f. k-mers (``BASELINE.json`` config 1 on the port's own output):
   ``count_kmers <the main path's part directory> out.txt 21`` on the
   card (Parquet load, projected, and count, each timed); then
   ``device_kmer_histogram`` and ``device_qmer_weights`` alone at k = 21
   on the 1,048,576-read batch, one warm call and 5 timed ones
   (CUDA-synchronised), as k-mers/s over ``valid x (L - 21 + 1)`` (the
   count ``bench.py`` divides by), median and spread;
4g. the dataset-level transform on the main path's SAM: ``transform in.sam
   out.adam -mark_duplicate_reads -realign_indels -recalibrate_base_qualities
   -sort_reads`` without ``-streaming`` on the card (stage walls, kernel 1
   launched once), its output checked (N rows, coordinate-sorted, rows
   with OQ); ``flagstat out.adam`` on the card (timed; total N, duplicates
   those of the streamed main path's parts); the same command with
   ``-checkpoint_dir``, then rerun after the bqsr store is deleted and
   dropped from the manifest: only BQSR and sort run, kernel 1 once more,
   the output byte-identical; the known-SNP residue mask over the whole
   dataset timed on the host;
4h. the durable run on the main path's SAM: the main path's command with
   ``--run-dir`` (parts byte-identical to phase 4's, every part in
   ``JOURNAL.json``, one observe sidecar per observed part, ``table.npz``),
   then the command in a child process under
   ``ADAM_TPU_FAULTS=proc.kill=kill,device=pass_c,after=4,times=1`` (it
   must die of SIGKILL at its fifth and last part submit: the fourth
   waited at the writer's starting gate of 3 parts for a publish, so at
   least one part is journaled) and ``--resume`` here: phase 4's parts,
   at least one part resumed, kernel 1 launched never (the table was
   journaled) and
   kernel 2 twice per fresh part; then the same with ``device=barrier2,
   after=0`` (killed at barrier 2's entry, before any sidecar): phase 4's
   parts, kernel 1 again for every window; each resume's wall printed
   beside the uninterrupted run's, with its position in the process;
4i. the sharded, out-of-core transform on the main path's SAM:
   ``transform in.sam out.adam -shards 8 -mark_duplicate_reads
   -realign_indels -recalibrate_base_qualities`` on the card (stage walls
   and reads/s printed): kernel 1 launched once per row chunk of each
   observed shard plus once for the realigned part, kernel 2 never, rows
   == reads, and the rows, as a multiset, those of phase 4's streamed
   parts (markdup, realign and BQSR are global, so the shard cuts change
   no row); then kernel 1 against its plain version at the largest
   shard's grid (g = 131,072 on this input);
4j. ``depth`` and ``view`` on the main path's part directory with its
   known-SNP VCF: ``depth`` by the broadcast join and ``depth -stream
   -bin_size 100000`` (32 genome bins) on the card, each timed, their
   reports byte-identical; ``view -c -F 1024`` on the card, whose count
   must equal the reads less phase 4's duplicates;
4k. the other file formats, no hand kernel launched: ``adam2fastq`` of
   the main path's parts into two mate files, interleaved here and read
   back through ``transform pairs.ifq out.adam -force_load_ifastq`` (the
   reads, as a multiset of name, sequence and quality, phase 4's in
   sequencer orientation); ``transform <parts> out.fq
   -sort_fastq_output`` (names in order); ``fasta2adam`` and
   ``count_contig_kmers 21`` of a synthetic FASTA of E. coli K-12
   MG1655's length (4,641,652 bp) with N runs, on the FASTA and on the
   fragment store (the k-mer files byte-identical; the histogram timed
   on the card as k-mers/s, and the load, count and write walls);
   ``vcf2adam`` then ``adam2vcf`` of a generated trio VCF (100,000 sites,
   GT:AD:DP:GQ:PL), which must give back the same records (its data
   lines, the FT that ``adam2vcf`` adds aside);
   ``features2adam`` of a generated GTF of 20,000 genes x 2 transcripts
   x 5 exons; ``bam2adam`` of 4e's BAM;
4l. the Spark embedding executor on the main path's SAM: loaded, cut in
   file order into 8 partitions of 131,072 reads (as Spark's input splits
   hand a BAM's slices to executors), written as one Arrow IPC stream
   (``to_arrow_alignments``) and piped through ``python -m adam_tpu_torch
   transform - - -backend spark -mark_duplicate_reads -realign_indels
   -recalibrate_base_qualities -known_snps K.vcf`` on the card: 8 batches
   back with their partitions' rows, kernel 1 launched once per partition
   (the child's stats line on stderr: partitions, reads/s, stage walls);
4m. ``transform_step`` (``pipelines/transform_step.py``) at the graft
   entry's shape (256 x 100) and at a window's (262,144 x 100): one
   kernel-1 launch per call, every output (quals, observe totals, 5'
   positions, dup scores, flagstat) equal to the CPU run with the plain
   version, each call timed by CUDA events;
4n. telemetry: the main path's command with ``-print_metrics
   --metrics-json M --trace-out T --report R --progress P --xprof-dir X``:
   its parts byte-identical to phase 4's, kernels 1 and 2 launched as
   often as there; ``streamed_stats_view`` of M equal to the stats line
   and M's ``reads.ingested`` the input's reads; T loads and holds the
   ``streamed.total`` span; R has a row for device ``"0"``, whose busy
   share (host intervals of the device-attributed spans) is printed
   beside the busy share of the kernel, copy and set intervals in X's
   ``torch.profiler`` trace over the same run (neither asserted); P has
   a line with card memory in use on device ``"0"`` and a last ``done``
   line; X names the observe and pack kernels; then the main path 3
   times with recording off and 3 times with every flag but
   ``--xprof-dir``, in turns, their median reads/s printed;
4o. several devices, over two slots (two streams) of the one card, each
   leg through ``transform_streamed(..., device_pool=)`` on the main
   path's SAM with the counts reset before it, its parts byte-identical
   to phase 4's, its wall, launches per kernel, per device and per slot
   and part hashes printed: (i) the pool (kernel 1 five times and kernel
   2 ten times between the slots, the prewarm spans once per slot, no
   first launch inside a window); (ii) the mesh (kernel 1 shards x
   windows times, stated before the run; ``device.mesh.dispatched`` > 0);
   (iii) ``device.dispatch`` failing for good on slot 1 (evicted, its
   window replayed on slot 0 under ``device.pool.replay``); (iv) a mesh
   dispatch failing mid-run (``device.mesh.degraded`` 1, the pool takes
   over); (v) ``ADAM_TPU_AUDIT_RATE=1`` with one fetched pass-C column
   corrupted at ``device.fetch`` (the slot on probation, the window
   replayed, ``device.audit.check`` recorded); (vi) each
   ``parallel/dist.py`` function over a two-slot ``LocalMesh`` on 65,536
   reads equal to its one-slot result, then ``distributed_observe`` over
   a one-rank NCCL ``ProcessMesh`` equal to the local histograms;
4p. the transform service on the card: four jobs of 262,144 reads
   (``make_wgs`` seeds 11-14, made by four worker processes at 4p's
   start, each rewritten onto six read groups: six lanes of two
   libraries), tenant A (weight 2: jobs A1, A2) and B (weight 1: B1,
   B2), windows of 65,536 reads, ``max_jobs`` 4.  Each job's solo
   ``transform_streamed`` first, then five legs, each with its counts
   reset: (i) ``TransformService`` unbatched; (ii) batched; (iii) batched
   through ``GatewayServer`` on 127.0.0.1:0, one ``GatewayClient`` thread
   per job submitting twice with one key (the same reply), following its
   event stream and fetching its parts (A1's first part resumed by Range
   from its first half); (iv) batched, ``drain`` once the first part is
   published, then a new service's ``recover()`` on the same run root;
   (v) batched with ``sched.batch`` failing once.  Every leg: each job's
   parts its solo run's; walls, reads/s, kernel 1 and 2 launches,
   ``sched.batch.dispatches``/``windows``/``fallbacks``, the largest fused
   groups (tickets, g, n_rg) and ``device.compile.in_window`` printed;
   no fallback in (ii) and (iii), at least one in (v), and fewer kernel-1
   launches in (ii) than in (i);
5. card vs CPU: a 65,536-read input through markdup + realign + BQSR on
   the card and on the CPU (plain versions), under both consensus
   models, on the known-sites path (known SNPs + known indels + the
   4d table, fused) and as a BAM; the parts must be byte-identical; then
   ``count_kmers`` at k = 21 and ``count_kmers -countQmers`` at k = 21 on
   the BAM run's parts, whose output files must be byte-identical; the
   journaled run in windows of 8,192 reads killed on the card (pass C) and
   resumed on the CPU, and killed on the CPU (after a publish) and resumed
   on the card, each resuming and ending with the card run's parts; then
   the dataset-level transform with the trim flags, markdup, realign, BQSR
   and sort to ``.adam`` and to ``.sam``, and markdup alone to ``.bam``,
   with ``flagstat`` on each output: files and reports byte-identical;
   the reads-model runs' ``--metrics-json`` counters that do not depend
   on the device (reads, windows, parts and bytes written, and the rest
   of the run's counters) equal;
   ``transform -shards 4`` (part directories byte-identical, file for
   file), and ``depth`` (both forms) and ``view`` (SAM text and ``-c``)
   on the reads-model run's parts, whose standard output must be
   byte-identical; ``count_contig_kmers 21`` on a 3-contig FASTA and its
   fragment store, ``adam2fastq`` (single and paired) on the reads-model
   run's parts, ``transform -mark_duplicate_reads -sort_fastq_output`` to
   ``.fq`` and ``transform -force_load_ifastq`` of the paired output
   interleaved: output files byte-identical; ``transform -backend spark``
   on 4 partitions of 16,384 reads with the known SNPs (every output batch
   equal), ``plugin`` with a plugin and access control this script writes
   (the same lines), and ``buildinfo`` printed once; the pool and the
   mesh over two slots of the card and over two CPU slots, windows of
   16,384 reads, each equal to the one-device CPU run; two service jobs of
   16,384 reads in windows of 4,096 through the scheduler, batched and
   unbatched, on the card and on the CPU, every job's parts
   byte-identical across the four runs.

It imports nothing of JAX or of ``adam_tpu``.  Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero before
printing any result.  The line before the last is one JSON object with
the kernels' measurements; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

MAIN_READS = 1_048_576
WINDOW_READS = 262_144
SW_READS = 1_048_576
PARITY_READS = 65_536
PARITY_RESUME_WINDOW = 8_192  # phase 5's resume legs: 8 windows + the realigned part
SEED = 7
SHARDS = 8              # 4i: the sharded transform's genome-bin shards
PARITY_SHARDS = 4       # phase 5's sharded leg
DEPTH_STREAM_BIN = 100_000  # 4j: -stream's bin width (32 bins over 4 x 800 kb)
ECOLI_BP = 4_641_652    # 4k: E. coli K-12 MG1655 (GenBank U00096.3)
CONTIG_K = 21           # 4k: count_contig_kmers' k
TRIO_SITES = 100_000    # 4k: the trio VCF's sites
GTF_GENES = 20_000      # 4k: about a human annotation's protein-coding genes
PARITY_CONTIGS = (600_000, 250_000, 9_999)  # phase 5's FASTA
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
LANES_PER_SM = 128         # Hopper: an add, max, compare or select per lane per clock
SW_BLOCK_SHAPE = (1024, 160, 384)  # 150 bp reads: sw_fill's block route
SW_WEIGHTS = {"f32": (1.0, -0.333, -0.5, -0.5), "i16": (2.0, -1.0, -1.0, -1.0),
              "bf16": (2.0, -1.0, -1.0, -1.0)}


#: the script's start on the monotonic clock: every log line carries the
#: seconds since, so a run's phases can be timed from its output
_T0 = time.monotonic()


def _log(msg: str) -> None:
    print(f"[{time.monotonic() - _T0:7.1f} s] {msg}", flush=True)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def issue_rate() -> dict:
    """The card's non-tensor instruction issue rate: SMs (from torch) x
    128 lanes x the maximum SM clock (nvidia-smi), in operations/s.  An
    FMA counts one operation here, so this is half the f32 data-sheet
    FLOP/s; the SW kernels do adds, maxes, compares and selects."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    return {"sms": sms, "sm_clock_max_mhz": mhz,
            "ops_per_s": sms * LANES_PER_SM * mhz * 1e6}


def _time_ms(fn, iters: int = 20, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _kernel_inputs(dev, g: int = WINDOW_READS):
    """Main-path-shaped inputs of ``g`` rows: WGS-like quals (declining
    profile with jitter), 88% full-length reads, both orientations, 3
    read-group bins."""
    import numpy as np
    import torch

    from adam_tpu_torch.ops.colpack import pack_mask_bits

    gl, L = 128, 100
    rng = np.random.default_rng(SEED)
    pos = np.arange(gl)
    prof = 38.0 - 12.0 * (np.minimum(pos, L - 1) / (L - 1)) ** 2
    quals = np.clip(prof[None, :] + rng.normal(0, 3, (g, gl)), 2, 40).astype(np.uint8)
    lengths = np.where(rng.random(g) < 0.88, L, rng.integers(60, L, g)).astype(np.int32)
    quals[np.arange(gl)[None, :] >= lengths[:, None]] = 255
    inp = dict(
        bases=rng.integers(0, 4, (g, gl)).astype(np.uint8),
        quals=quals,
        lengths=lengths,
        flags=(0x1 | rng.choice([0x40, 0x80], g) | rng.choice([0, 0x10], g)).astype(np.int32),
        rg=rng.integers(-1, 2, g).astype(np.int32),
    )
    in_read = np.arange(gl)[None, :] < lengths[:, None]
    res = in_read & (rng.random((g, gl)) < 0.97)
    mm = res & (rng.random((g, gl)) < 0.01)
    t = {k: torch.from_numpy(v).to(dev) for k, v in inp.items()}
    t["res_bits"] = torch.from_numpy(pack_mask_bits(res)).to(dev)
    t["mm_bits"] = torch.from_numpy(pack_mask_bits(mm)).to(dev)
    t["read_ok"] = torch.from_numpy(rng.random(g) < 0.9).to(dev)
    t["res"] = torch.from_numpy(res).to(dev)
    t["mm"] = torch.from_numpy(mm).to(dev)
    return t, g, gl


def check_observe(t, g: int, gl: int, n_rg: int = 3) -> dict:
    """Kernel 1 against its plain version and ``torch.bincount`` on the
    inputs ``t`` of :func:`_kernel_inputs` -> its record."""
    import torch

    from adam_tpu_torch.ops import observe
    from adam_tpu_torch.pipelines import bqsr

    slab_w = (2 * gl + 1) * bqsr.N_DINUC
    size_h = n_rg * bqsr.N_QUAL * slab_w
    keys = bqsr.covariate_keys(t["bases"], t["quals"], t["lengths"], t["flags"],
                               t["rg"], n_rg, gl)
    args = (keys, t["res_bits"], t["mm_bits"], t["read_ok"], size_h, slab_w)
    got = observe.observe_hist(*args)
    want = observe.observe_hist_plain(*args)
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    kflat = keys.reshape(-1)
    inc = (t["res"] & t["read_ok"][:, None]).reshape(-1)
    mmi = inc & t["mm"].reshape(-1)

    def library():
        return (torch.bincount(kflat[inc], minlength=size_h),
                torch.bincount(kflat[mmi], minlength=size_h))

    lib_t, lib_m = library()
    equal = equal and torch.equal(lib_t.int(), want[0]) and torch.equal(lib_m.int(), want[1])
    # the least the data needs: the keys of the residues that count (the
    # rest are skipped on their mask bits), both masks, read_ok, and one
    # write of the two i32 histograms
    counted = int(want[0].sum())
    n_bytes = counted * 4 + 2 * t["res_bits"].numel() + g + 2 * 4 * size_h
    return dict(
        name="observe_hist", route="cuda",
        source="adam_tpu_torch/csrc/observe_hist.cu",
        replaces="adam_tpu/ops/pallas_observe.py:85",
        equal=equal, max_abs_err=err,
        ms=_time_ms(lambda: observe.observe_hist(*args)),
        plain_ms=_time_ms(lambda: observe.observe_hist_plain(*args)),
        library_ms=_time_ms(library),
        bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        residues_counted=counted, shape=[g, gl, n_rg],
    )


def check_kernels(dev) -> list:
    import torch

    from adam_tpu_torch.ops import colpack

    t, g, gl = _kernel_inputs(dev)
    # ---- kernel 1: observe_hist -----------------------------------------
    out = [check_observe(t, g, gl)]

    # ---- kernel 2: pack_rows, plain and with the SANGER encode fused ----
    quals = t["quals"]
    mat = colpack.sanger_body(quals)
    lens = t["lengths"].to(torch.int64)
    size_p = g * gl
    total = int(lens.sum())
    mask = torch.arange(gl, device=dev)[None, :] < lens[:, None]
    # the least it can take: the in-row bytes of mat, the i64 lens, one
    # write of the output
    n_bytes = total + 8 * g + size_p
    for encode, src in (("none", mat), ("sanger", quals)):
        got = colpack.pack_rows(src, lens, size_p, encode=encode)
        want = colpack.pack_rows_plain(mat, lens, size_p)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        lib = torch.masked_select(mat, mask)
        equal = torch.equal(got, want) and torch.equal(lib, want[:total]) \
            and not bool(want[total:].any())
        k = dict(
            name="pack_rows" if encode == "none" else f"pack_rows_{encode}",
            route="cuda", source="adam_tpu_torch/csrc/pack_rows.cu",
            replaces="adam_tpu/ops/colpack.py:111", encode=encode,
            equal=equal, max_abs_err=err,
            ms=_time_ms(lambda: colpack.pack_rows(src, lens, size_p, encode=encode)),
            bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            bytes_packed=total,
        )
        if encode == "none":
            k["plain_ms"] = _time_ms(lambda: colpack.pack_rows_plain(mat, lens, size_p))
            k["library_ms"] = _time_ms(lambda: torch.masked_select(mat, mask))
        else:  # no one PyTorch call encodes and packs
            k["plain_ms"] = _time_ms(lambda: colpack.pack_rows_plain(
                colpack.sanger_body(quals), lens, size_p))
            k["library_ms"] = None
            k["unfused_ms"] = _time_ms(lambda: colpack.pack_rows(
                colpack.sanger_body(quals), lens, size_p))
        out.append(k)
    for k in out:
        k["kernel_ms"] = k["ms"]
        if not k["equal"]:
            raise AssertionError(f"kernel {k['name']} disagrees with its plain version: {k}")
    return out


def _sw_score_ops_per_cell(lx: int) -> int:
    """f32/int operations the score fill does per cell (sw_score.cu): the
    substitution's compare and select, two adds and two maxes
    (``mx(mx(m, insert), 0)``), an add and a max per doubling step of the
    delete chain, then the clamp, the mask select and the running-best
    max: 23 at lx = 127."""
    n_shifts = 0
    s = 1
    while s < lx:
        n_shifts += 1
        s *= 2
    return 6 + 2 * n_shifts + 3


def check_sw_score(dev, B: int = 8192, lx: int = 127, ly: int = 127,
                   rate: dict | None = None) -> list:
    """sw_score against its plain version at benchmark_gcups' shape, f32,
    i16 and bf16; then each driven through benchmark_gcups (the GCUPS
    path), its launches counted around that call.  The operation bound is
    at the card's issue rate (:func:`issue_rate`); i16 and bf16 count two
    cells per lane-instruction, as the card's packed 16-bit forms (the
    i16 kernel's DPX s16x2 instructions, bf16x2) do."""
    import numpy as np
    import torch

    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.ops import smith_waterman as sw

    rate = rate or issue_rate()
    rng = np.random.default_rng(SEED)
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 4, (B, lx)).astype(np.int32), np.full(B, lx, np.int32),
        rng.integers(0, 4, (B, ly)).astype(np.int32), np.full(B, ly, np.int32))]
    out = []
    for dtype_name, w in SW_WEIGHTS.items():
        got = sw.sw_best_scores(*args, *w, dtype_name=dtype_name)
        want = sw.sw_score_plain(*args, *w, lx, ly, dtype_name)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ms = _time_ms(lambda: sw.sw_best_scores(*args, *w, dtype_name=dtype_name))
        plain_ms = _time_ms(lambda: sw.sw_score_plain(*args, *w, lx, ly, dtype_name),
                            iters=2, warm=1)
        cells = B * lx * ly
        per_lane = 2 if dtype_name in ("i16", "bf16") else 1
        ops_ms = cells * _sw_score_ops_per_cell(lx) / per_lane / rate["ops_per_s"] * 1e3
        bytes_ms = (4 * B * (lx + ly + 2) + 4 * B) / HBM_BYTES_PER_S * 1e3
        kernels.reset_launches()
        gcups_path = sw.benchmark_gcups(B, lx, ly, reps=6, dtype_name=dtype_name,
                                        trials=3, device="cuda")
        launched = kernels.launches()["sw_score"]
        if launched == 0:
            raise AssertionError("benchmark_gcups launched no sw_score kernel")
        out.append(dict(
            name="sw_score" if dtype_name == "f32" else f"sw_score_{dtype_name}",
            route="cuda", source="adam_tpu_torch/csrc/sw_score.cu",
            replaces="adam_tpu/ops/smith_waterman.py:516", dtype=dtype_name,
            equal=bool(torch.equal(got, want)), max_abs_err=err, launches=launched,
            ms=ms, plain_ms=plain_ms, library_ms=None,
            bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            shape=[B, lx, ly], gcups=cells / (ms / 1e3) / 1e9,
            benchmark_gcups=gcups_path, launched_by="benchmark_gcups",
        ))
    return out


def _sw_fill_inputs(B: int, lx: int, ly: int):
    """Read-vs-region pairs like the smithwaterman path's: 100-base reads
    cut from their region with 2% substitutions, regions filling the top
    128 lanes of the bucket."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    yl = rng.integers(max(1, ly - 127), ly + 1, B).astype(np.int32)
    xl = np.minimum(100, np.minimum(lx, yl)).astype(np.int32)
    yc = np.full((B, ly), 5, np.int32)
    xc = np.full((B, lx), 5, np.int32)
    for b in range(B):
        y = rng.integers(0, 4, int(yl[b]))
        s = int(rng.integers(0, yl[b] - xl[b] + 1))
        x = y[s:s + xl[b]].copy()
        mut = rng.random(len(x)) < 0.02
        x[mut] = rng.integers(0, 4, int(mut.sum()))
        yc[b, :yl[b]] = y
        xc[b, :xl[b]] = x
    return xc, xl, yc, yl


def check_sw_fill(dev, shape, launched: int, rate: dict | None = None,
                  block_shape=None) -> dict:
    """sw_fill against its plain version at one (B, lx, ly) launch shape,
    plus the ``moves.cpu()`` copy the smithwaterman path makes of each
    launch's output; with ``block_shape``, also the block route there."""
    import numpy as np
    import torch

    from adam_tpu_torch.ops import smith_waterman as sw

    rate = rate or issue_rate()
    B, lx, ly = shape
    inputs = _sw_fill_inputs(B, lx, ly)
    args = [torch.from_numpy(a).to(dev) for a in inputs]
    w = SW_WEIGHTS["f32"]
    got = sw.sw_fill(*args, *w, lx, ly)
    want = sw.sw_fill_plain(*args, *w, lx, ly)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    finite = torch.isfinite(want[1])
    err = max(int((got[0].int() - want[0].int()).abs().max()),
              float((got[1][finite] - want[1][finite]).abs().max()),
              int((got[2] - want[2]).abs().max()))
    D = lx + ly + 1
    # what these pairs need: one move byte per cell of each pair's
    # (xl+1) x (yl+1) matrix (the kernel also writes the cells outside it
    # and the bucket padding, which the trackback never reads), the best
    # rows up to xl, each code row and the lengths read once; ~12
    # operations per interior cell (the substitution's compare and select,
    # three adds, up to six comparisons of the move rule, the best's compare)
    xl = inputs[1].astype(np.int64)
    yl = inputs[3].astype(np.int64)
    matrix_cells = int(((xl + 1) * (yl + 1)).sum())
    n_bytes = matrix_cells + 8 * int((xl + 1).sum()) + 4 * int((xl + yl).sum()) + 8 * B
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 12 * int((xl * yl).sum()) / rate["ops_per_s"] * 1e3
    ms = _time_ms(lambda: sw.sw_fill(*args, *w, lx, ly))
    moves = got[0]
    d2h_ms = _time_ms(lambda: moves.cpu(), iters=5, warm=1)
    extra = {}
    if block_shape is not None:
        bB, blx, bly = block_shape
        if sw.sw_fill_route(blx) != "block":
            raise AssertionError(f"{block_shape} is not on the block route")
        bargs = [torch.from_numpy(a).to(dev) for a in _sw_fill_inputs(bB, blx, bly)]
        bgot = sw.sw_fill(*bargs, *w, blx, bly)
        bwant = sw.sw_fill_plain(*bargs, *w, blx, bly)
        torch.cuda.synchronize()
        extra = {"block_route_shape": [bB, blx, bly],
                 "block_route_equal": all(torch.equal(a, b) for a, b in zip(bgot, bwant)),
                 "block_route_ms": _time_ms(lambda: sw.sw_fill(*bargs, *w, blx, bly))}
        equal = equal and extra["block_route_equal"]
    return dict(
        name="sw_fill", route="cuda", source="adam_tpu_torch/csrc/sw_fill.cu",
        replaces="adam_tpu/ops/smith_waterman.py:261", equal=equal,
        max_abs_err=err, launches=launched, ms=ms,
        plain_ms=_time_ms(lambda: sw.sw_fill_plain(*args, *w, lx, ly), iters=1, warm=1),
        library_ms=None, bound_ms=max(ops_ms, bytes_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        shape=[B, lx, ly], moves_bytes_written=B * D * (lx + 1),
        matrix_cells=matrix_cells, cells_per_s=matrix_cells / (ms / 1e3),
        fill_route=sw.sw_fill_route(lx), moves_cpu_ms=d2h_ms, **extra,
    )


def _transform_argv(sam: str, out_dir: str, device: str, realign: bool = True,
                    extra: tuple = (), recalibrate: bool = True) -> list:
    """The streamed transform's command line (``extra``: more of its
    flags; a later ``-window_reads`` overrides the main path's)."""
    return [
        "transform", sam, out_dir, "-streaming", "-mark_duplicate_reads",
        *(["-realign_indels"] if realign else []),
        *(["-recalibrate_base_qualities"] if recalibrate else []),
        "-window_reads", str(WINDOW_READS), *extra, "--device", device,
    ]


def run_transform(sam: str, out_dir: str, device: str, realign: bool = True,
                  extra: tuple = (), recalibrate: bool = True) -> dict:
    """The user's entry point, in this process: the CLI's main (``extra``:
    more of its flags)."""
    from adam_tpu_torch.cli.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(_transform_argv(sam, out_dir, device, realign, extra, recalibrate))
    if rc != 0:
        raise RuntimeError(f"transform exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


#: the devices' Chrome-trace categories torch.profiler gives device work
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the CUDA functions of kernels 1 and 2, as the profiler names them
OBSERVE_KERNEL_NAMES = ("count_kernel", "scatter_kernel", "accum_kernel")
PACK_KERNEL_NAMES = ("pack_kernel",)
RECORDING_TURNS = 3  # 4n: runs with recording off and on, in turns


def _reset_telemetry() -> None:
    from adam_tpu_torch.utils import instrumentation as ins
    from adam_tpu_torch.utils import telemetry as tele

    tele.TRACE.reset()
    ins.TIMERS.reset()


def _profiler_busy(xprof_dir: str, total_s: float) -> dict:
    """The ``--xprof-dir`` trace -> the union of its device intervals
    (kernels, copies, sets) over the run's own wall, and the device
    names it holds."""
    (name,) = os.listdir(xprof_dir)
    with open(os.path.join(xprof_dir, name)) as fh:
        evs = json.load(fh)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                   for e in evs if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS)
    busy, end = 0.0, float("-inf")
    for s0, s1, _ in spans:
        busy += max(0.0, s1 - max(s0, end))
        end = max(end, s1)
    return {"file": name, "device_events": len(spans), "device_busy_s": busy / 1e6,
            "busy_share": busy / 1e6 / total_s,
            "names": sorted({n for _, _, n in spans})}


def check_observability(work: str, sam: str, main_hashes: dict, main_launched: dict) -> dict:
    """Phase 4n: the main path with every observability flag, its
    artifacts checked; then the cost of recording, in turns."""
    from adam_tpu_torch.cli.main import main as cli
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.utils import analyzer
    from adam_tpu_torch.utils import telemetry as tele

    out = os.path.join(work, "tele.adam")
    art = {k: os.path.join(work, f"tele.{k}") for k in ("m.json", "t.json", "r.txt", "p.ndjson",
                                                       "xprof")}
    flags = ("-print_metrics", "--metrics-json", art["m.json"], "--trace-out", art["t.json"],
             "--report", art["r.txt"], "--progress", art["p.ndjson"])
    _reset_telemetry()
    kernels.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(_transform_argv(sam, out, "cuda",
                                 extra=(*flags, "--xprof-dir", art["xprof"])))
    launched = kernels.launches()
    if rc != 0:
        raise RuntimeError(f"4n: transform exited {rc}")
    text = buf.getvalue()
    stats = json.loads(next(ln for ln in text.splitlines() if ln.startswith("{")))
    if _part_hashes(out) != main_hashes:
        raise AssertionError("4n: the parts differ from phase 4's")
    if (launched["observe_hist"], launched["pack_rows"]) != (
            main_launched["observe_hist"], main_launched["pack_rows"]):
        raise AssertionError(f"4n: launches {launched}, phase 4 {main_launched}")
    if "Timings\n=======" not in text or "Counters\n========" not in text:
        raise AssertionError("4n: -print_metrics printed no timer or counter table")
    with open(art["m.json"]) as fh:
        snap = json.load(fh)
    view = tele.streamed_stats_view(snap)
    if not view or {k: stats[k] for k in view} != view:
        raise AssertionError(f"4n: the stats line is not the snapshot's view: {view}")
    if snap["counters"][tele.C_READS_INGESTED] != MAIN_READS:
        raise AssertionError(f"4n: reads.ingested {snap['counters']}")
    with open(art["t.json"]) as fh:
        trace = json.load(fh)
    if not any(e.get("name") == tele.SPAN_TOTAL for e in trace["traceEvents"]):
        raise AssertionError("4n: the Chrome trace holds no streamed.total span")
    with open(art["r.txt"]) as fh:
        report_text = fh.read()
    if not any(ln.split()[:1] == ["0"] for ln in report_text.splitlines()):
        raise AssertionError(f"4n: the report has no device 0 row:\n{report_text[:2000]}")
    dev0 = analyzer.analyze(trace)["devices"]["0"]
    with open(art["p.ndjson"]) as fh:
        beats = [json.loads(ln) for ln in fh]
    hbm = [b["hbm_bytes_in_use"].get("0", 0) for b in beats]
    if not beats or max(hbm) <= 0 or beats[-1]["done"] is not True:
        raise AssertionError(f"4n: heartbeat {beats[-1:]} (card memory {hbm})")
    prof = _profiler_busy(art["xprof"], stats["total_s"])
    for label, names in (("observe", OBSERVE_KERNEL_NAMES), ("pack", PACK_KERNEL_NAMES)):
        if not any(k in n for n in prof["names"] for k in names):
            raise AssertionError(f"4n: the profiler trace names no {label} kernel: "
                                 f"{prof['names'][:30]}")
    res = {"stats": stats, "launches": launched, "report_device_0": dev0,
           "report_busy_frac": dev0["busy_frac"], "profiler": {
               k: prof[k] for k in ("device_events", "device_busy_s", "busy_share")},
           "heartbeat_lines": len(beats), "hbm_bytes_in_use_max": max(hbm),
           "timer_rows": text[text.index("Timings"):].split("\n\n")[0].splitlines()[3:]}
    shutil.rmtree(out)
    # the cost of recording: off and on in turns, reads/s of each run
    rates = {"off": [], "on": []}
    for turn in range(RECORDING_TURNS):
        for leg in ("off", "on"):
            _reset_telemetry()
            extra = flags if leg == "on" else ()
            for p in (art["m.json"], art["t.json"], art["r.txt"], art["p.ndjson"]):
                if os.path.exists(p):
                    os.unlink(p)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli(_transform_argv(sam, out, "cuda", extra=extra))
            if rc != 0:
                raise RuntimeError(f"4n {leg} run exited {rc}")
            st = json.loads(next(ln for ln in buf.getvalue().splitlines()
                                 if ln.startswith("{")))
            rates[leg].append(st["reads_per_s"])
            shutil.rmtree(out)
    _reset_telemetry()
    res["reads_per_s"] = rates
    res["median_reads_per_s"] = {k: sorted(v)[len(v) // 2] for k, v in rates.items()}
    return res


def killed_transform(sam: str, out_dir: str, device: str, extra: tuple, spec: str) -> dict:
    """The streamed transform through ``python -m adam_tpu_torch`` in a
    child process armed with the fault spec ``spec``
    (``ADAM_TPU_FAULTS``): it must die of SIGKILL -> its seconds and what
    it left published and journaled."""
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, ADAM_TPU_FAULTS=spec)
    t0 = time.monotonic()
    res = subprocess.run(
        [sys.executable, "-m", "adam_tpu_torch",
         *_transform_argv(sam, out_dir, device, extra=extra)],
        env=env, cwd=here, capture_output=True, text=True, timeout=900,
    )
    secs = time.monotonic() - t0
    if res.returncode != -signal.SIGKILL:
        raise AssertionError(f"the run armed with {spec!r} exited {res.returncode}, "
                             f"not by SIGKILL: {res.stderr[-3000:]}")
    rd = extra[extra.index("--run-dir") + 1]
    journal = os.path.join(rd, "JOURNAL.json")
    journaled = 0
    if os.path.isfile(journal):
        with open(journal) as fh:
            journaled = len(json.load(fh)["windows"])
    return {"spec": spec, "device": device, "killed_after_s": secs,
            "parts_left": len(_part_hashes(out_dir)) if os.path.isdir(out_dir) else 0,
            "journaled_parts": journaled,
            "table_journaled": os.path.isfile(os.path.join(rd, "table.npz"))}


def check_durable_run(work: str, sam: str, main_hashes: dict, n_win: int) -> dict:
    """Phase 4h: the main path's command with ``--run-dir`` (its parts
    those of phase 4, every part journaled, one observe sidecar per
    observed part, the table), then two SIGKILLed runs, each resumed in
    this process with ``--resume``: killed at the fifth pass-C submit
    (the table journaled: kernel 1 launched never, kernel 2 twice per
    fresh part, at least one part resumed; at an earlier submit the card's
    applies outrun the writer, and no part may be published yet), and at
    barrier 2's entry
    (nothing but the plan journaled: kernel 1 again for every window).
    Each resume's parts must be phase 4's."""
    from adam_tpu_torch.ops import kernels

    out, rd = os.path.join(work, "durable.adam"), os.path.join(work, "durable.rd")
    kernels.reset_launches()
    st = run_transform(sam, out, "cuda", extra=("--run-dir", rd))
    launched = kernels.launches()
    if _part_hashes(out) != main_hashes:
        raise AssertionError("4h: the journaled run's parts differ from phase 4's")
    with open(os.path.join(rd, "JOURNAL.json")) as fh:
        doc = json.load(fh)
    if doc["n_windows"] != n_win or sorted(doc["windows"].values()) != sorted(main_hashes):
        raise AssertionError(f"4h: the journal does not list every part: {doc}")
    obs = sorted(os.listdir(os.path.join(rd, "obs")))
    if obs != [f"window-{i:05d}.npz" for i in range(n_win + 1)]:
        raise AssertionError(f"4h: observe sidecars {obs} for {n_win} windows + 1 part")
    if not os.path.isfile(os.path.join(rd, "table.npz")):
        raise AssertionError("4h: no table.npz")
    if launched["pack_rows"] != 2 * (n_win + 1) or st["windows_resumed"] != 0:
        raise AssertionError(f"4h: journaled run launches {launched}, stats {st}")
    res = {"journaled": {"stats": st, "launches": launched, "obs_sidecars": len(obs),
                         "position": "4th streamed transform in the process"}}
    legs = (("pass_c", "proc.kill=kill,device=pass_c,after=4,times=1",
             "5th streamed transform in the process"),
            ("barrier2_entry", "proc.kill=kill,device=barrier2,after=0,times=1",
             "6th streamed transform in the process"))
    for leg, spec, pos in legs:
        shutil.rmtree(out)
        shutil.rmtree(rd)
        killed = killed_transform(sam, out, "cuda", ("--run-dir", rd), spec)
        kernels.reset_launches()
        st = run_transform(sam, out, "cuda", extra=("--run-dir", rd, "--resume"))
        launched = kernels.launches()
        if _part_hashes(out) != main_hashes:
            raise AssertionError(f"4h {leg}: the resumed parts differ from phase 4's")
        fresh = st["windows_fresh"]
        if st["resume.refused"] or st["windows_resumed"] + fresh != n_win + 1:
            raise AssertionError(f"4h {leg}: resume stats {st}")
        if launched["pack_rows"] != 2 * fresh or st["kernel_launches"] != launched:
            raise AssertionError(f"4h {leg}: launches {launched} for {fresh} fresh parts")
        if leg == "pass_c" and (st["windows_resumed"] < 1 or launched["observe_hist"] != 0
                                or not killed["table_journaled"]):
            raise AssertionError(f"4h {leg}: {killed}, launches {launched}, stats {st}")
        if leg == "barrier2_entry" and (launched["observe_hist"] < n_win + 1
                                        or killed["table_journaled"]):
            raise AssertionError(f"4h {leg}: {killed}, launches {launched}")
        res[leg] = {"killed": killed, "stats": st, "launches": launched, "position": pos}
    shutil.rmtree(out)
    shutil.rmtree(rd)
    return res


def check_cross_device_resume(work: str, sam: str) -> dict:
    """Phase 5's resume legs on the parity input, in windows of
    ``PARITY_RESUME_WINDOW`` reads: a journaled run killed on the card
    (at a late pass-C submit) and resumed on the CPU, and one killed on
    the CPU (after its second publish) and resumed on the card; each
    resumes (the fingerprint leaves the device out) and ends with the
    uninterrupted card run's parts."""
    from adam_tpu_torch.ops import kernels

    win = ("-window_reads", str(PARITY_RESUME_WINDOW))
    ref = os.path.join(work, "resume.ref.adam")
    run_transform(sam, ref, "cuda", extra=win)
    want = _part_hashes(ref)
    n_parts = len(want)
    res = {"parts": n_parts}
    for leg, kill_dev, spec, resume_dev in (
        ("card_to_cpu", "cuda", f"proc.kill=kill,device=pass_c,after={n_parts - 2},times=1",
         "cpu"),
        ("cpu_to_card", "cpu", "proc.kill=kill,device=write,after=1,times=1", "cuda"),
    ):
        out, rd = os.path.join(work, f"{leg}.adam"), os.path.join(work, f"{leg}.rd")
        extra = (*win, "--run-dir", rd)
        killed = killed_transform(sam, out, kill_dev, extra, spec)
        kernels.reset_launches()
        st = run_transform(sam, out, resume_dev, extra=(*extra, "--resume"))
        launched = kernels.launches()
        if _part_hashes(out) != want:
            raise AssertionError(f"{leg}: the resumed parts differ from the card run's")
        if st["windows_resumed"] < 1 or st["resume.refused"]:
            raise AssertionError(f"{leg}: did not resume: {killed}, {st}")
        if resume_dev == "cuda" and (launched["observe_hist"] != 0
                                     or launched["pack_rows"] != 2 * st["windows_fresh"]):
            raise AssertionError(f"{leg}: launches {launched}, stats {st}")
        res[leg] = {"killed": killed, "windows_resumed": st["windows_resumed"],
                    "windows_fresh": st["windows_fresh"], "total_s": st["total_s"],
                    "launches": launched}
    return res


def profile_transform(sam: str, out_dir: str) -> dict:
    """The main path once more under ``torch.profiler`` -> the device's
    busy share of the transform's own wall (``total_s``; the profiler's
    post-processing after the run is left out): the union of its kernel,
    copy and set intervals, and the names that took the most device time
    (cut to 100 characters).  None where the profiler saw no device
    activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stats = run_transform(sam, out_dir, "cuda")
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return {"busy_share": None, "note": "the profiler saw no device activity"}
    busy = 0.0
    end = spans[0][0]
    by_name: dict = {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name[:100]] = by_name.get(name[:100], 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "total_s": stats["total_s"], "reads_per_s": stats["reads_per_s"],
        "device_busy_s": busy / 1e6, "busy_share": busy / 1e6 / stats["total_s"],
        "device_top_ms": {name: us / 1e3 for name, us in top},
    }


def read_parts(out_dir: str) -> dict:
    """Row, duplicate and realigned (OC:Z:) counts over the parts."""
    import pyarrow.parquet as pq

    rows = dups = oc = parts = 0
    for f in sorted(os.listdir(out_dir)):
        if f.startswith("part-"):
            parts += 1
            tbl = pq.read_table(os.path.join(out_dir, f), columns=["flags", "attributes"])
            flags = tbl.column("flags").to_numpy()
            rows += len(flags)
            dups += int(((flags & 0x400) != 0).sum())
            oc += sum(1 for a in tbl.column("attributes").to_pylist() if a and "OC:Z:" in a)
    return {"parts": parts, "rows": rows, "duplicates": dups, "realigned_rows": oc}


def run_smithwaterman(sam: str, out_dir: str, device: str) -> tuple:
    """The smithwaterman consensus model through the library call ->
    (stats, the (B, lx, ly) of every sw_fill call it made)."""
    from adam_tpu_torch.ops import smith_waterman as sw
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    shapes = []
    fill = sw.sw_fill

    def logged(x_codes, *a, **k):
        shapes.append((int(x_codes.shape[0]), int(a[-2]), int(a[-1])))
        return fill(x_codes, *a, **k)

    sw.sw_fill = logged
    try:
        stats = transform_streamed(sam, out_dir, realign=True,
                                   consensus_model="smithwaterman",
                                   window_reads=WINDOW_READS, device=device)
    finally:
        sw.sw_fill = fill
    return stats, shapes


def observed_residues(csv_path: str) -> int:
    """The residues an observe counted: the sum of the dumped
    observation table's TotalCount column."""
    with open(csv_path) as fh:
        next(fh)
        return sum(int(line.split(",")[4]) for line in fh)


def run_solving(sam: str, out_dir: str, device: str, extra: tuple) -> tuple:
    """A run of the CLI that keeps the table the port solves at barrier 2
    -> (stats, table)."""
    from adam_tpu_torch.pipelines import bqsr

    solve = bqsr.solve_recalibration_table
    solved = []

    def keep(total, mism):
        solved.append(solve(total, mism))
        return solved[-1]

    bqsr.solve_recalibration_table = keep
    try:
        stats = run_transform(sam, out_dir, device, extra=extra)
    finally:
        bqsr.solve_recalibration_table = solve
    if len(solved) != 1:
        raise AssertionError(f"{len(solved)} solves in one run")
    return stats, solved[0]


def _stage_walls(stats: dict) -> str:
    keys = ("ingest_pass_s", "resolve_s", "split_s", "observe_s", "realign_s",
            "obs_merge_s", "solve_s", "apply_s", "write_wait_s", "total_s")
    return ", ".join(f"{k} {stats[k]:.3f}" for k in keys if k in stats)


def _check_part_launches(label: str, launched: dict, variants: dict, n_parts: int) -> None:
    """Kernel 1 once per observed part, kernel 2 once per part and encode."""
    if (launched["observe_hist"] != n_parts or launched["pack_rows"] != 2 * n_parts
            or variants.get("pack_rows:sanger") != n_parts
            or variants.get("pack_rows:base_decode") != n_parts
            or launched["sw_fill"] != 0):
        raise AssertionError(f"{label}: launches {launched} {variants} for {n_parts} parts")


def check_known_sites(work: str, sam: str, snps_vcf: str, indels_vcf: str,
                      device: str = "cuda") -> dict:
    """Phases 4c and 4d on ``sam`` (the main path's input) -> their record.

    4c: the CLI with ``-known_indels`` alone and with ``-known_snps
    -known_indels``, both dumping observations (the SNP mask must leave
    fewer observed residues), the table the second run solves saved as
    ``known_table.npz``.  4d: that table through
    ``-known_recalibration_table`` with both VCFs, fused and unfused; both
    legs must write 4c's parts, the fused leg fuse every observed part and
    the unfused leg none.  On the card each run must launch kernel 1 once
    per part and kernel 2 once per part and encode."""
    import numpy as np

    from adam_tpu_torch.ops import kernels

    def launches(label, n_parts):
        lv, vv = kernels.launches(), kernels.variant_launches()
        if device == "cuda":
            _check_part_launches(label, lv, vv, n_parts)
        return lv, vv

    out_dir = os.path.join(work, "known.adam")
    obs_csv = {k: os.path.join(work, f"obs.{k}.csv") for k in ("no_snps", "snps")}
    ref_stats = run_transform(sam, out_dir, device, extra=(
        "-known_indels", indels_vcf, "-dump_observations", obs_csv["no_snps"]))
    shutil.rmtree(out_dir)
    kernels.reset_launches()
    ks_stats, table = run_solving(sam, out_dir, device, (
        "-known_snps", snps_vcf, "-known_indels", indels_vcf,
        "-dump_observations", obs_csv["snps"]))
    n_parts = ks_stats["n_parts"]
    ks_launched, ks_variants = launches("known-sites path", n_parts)
    got = read_parts(out_dir)
    if (got["parts"] != n_parts or n_parts != ks_stats["n_windows"] + 1
            or got["rows"] != ks_stats["n_reads"] or got["realigned_rows"] == 0
            or ks_stats["n_realigned"] == 0):
        raise AssertionError(f"known-sites path: {got}, stats {ks_stats}")
    residues = {k: observed_residues(v) for k, v in obs_csv.items()}
    if not residues["snps"] < residues["no_snps"]:
        raise AssertionError(f"the SNP mask removed no residue: {residues}")
    _log("known-sites path stats: " + json.dumps(ks_stats, sort_keys=True))
    _log(f"known-sites path: {got}, {ks_stats['reads_per_s']:.0f} reads/s "
         f"(without the SNP VCF {ref_stats['reads_per_s']:.0f}); observe_s "
         f"{ks_stats['observe_s']:.3f} s with the SNP VCF, {ref_stats['observe_s']:.3f} s "
         f"without; observed residues {residues['snps']} vs {residues['no_snps']}; "
         f"launches {ks_launched} {ks_variants}")
    _log(f"known-sites stage walls: {_stage_walls(ks_stats)}")
    _log(f"without the SNP VCF, stage walls: {_stage_walls(ref_stats)}")
    table_npz = os.path.join(work, "known_table.npz")
    np.savez(table_npz, table=table, gl=np.int64((table.shape[2] - 1) // 2))

    legs = {}
    ks_hashes = _part_hashes(out_dir)
    for leg, flag in (("fused", "1"), ("unfused", "0")):
        d = os.path.join(work, f"table.{leg}.adam")
        os.environ["ADAM_TPU_FUSED_BC"] = flag
        kernels.reset_launches()
        try:
            st = run_transform(sam, d, device, extra=(
                "-known_snps", snps_vcf, "-known_indels", indels_vcf,
                "-known_recalibration_table", table_npz))
        finally:
            os.environ.pop("ADAM_TPU_FUSED_BC")
        lv, vv = launches(f"known table, {leg}", st["n_parts"])
        want_fused = st["n_parts"] if leg == "fused" else 0
        if st["fused_bc"] != (leg == "fused") or st["n_fused_windows"] != want_fused:
            raise AssertionError(f"known table, {leg}: fused_bc {st['fused_bc']}, "
                                 f"{st['n_fused_windows']} fused of {st['n_parts']} parts")
        if _part_hashes(d) != ks_hashes:
            raise AssertionError(f"known table, {leg}: parts differ from the known-sites run")
        shutil.rmtree(d)
        legs[leg] = {"stats": st, "launches": lv, "variant_launches": vv}
        _log(f"known table ({leg}, ADAM_TPU_FUSED_BC={flag}): "
             f"{st['reads_per_s']:.0f} reads/s, {st['n_fused_windows']} of "
             f"{st['n_parts']} parts fused, launches {lv} {vv}; stage walls: "
             f"{_stage_walls(st)}")
    shutil.rmtree(out_dir)
    return {"no_snps_stats": ref_stats, "stats": ks_stats, "observed_residues": residues,
            "launches": ks_launched, "variant_launches": ks_variants,
            "table_legs": legs, "table_npz": table_npz}


def _sorted_rows(d: str):
    """Every row of a part directory, sorted on all columns (a multiset
    of rows that does not depend on how the parts cut it)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    tbl = pa.concat_tables([
        pq.read_table(os.path.join(d, f)).replace_schema_metadata(None)
        for f in sorted(os.listdir(d)) if f.startswith("part-")])
    return tbl.sort_by([(c, "ascending") for c in tbl.column_names])


def check_bam(work: str, sam: str, main_adam: str, device: str = "cuda") -> dict:
    """Phase 4e on ``sam`` (the main path's input) -> its record.  The
    launch counts are checked on the card only (the CPU launches none)."""
    from adam_tpu_torch.io import sam as sam_io
    from adam_tpu_torch.ops import kernels

    bam = os.path.join(work, "wgs.bam")
    t0 = time.monotonic()
    batch, side, header = sam_io.read_sam(sam)
    read_sam_s = time.monotonic() - t0
    t0 = time.monotonic()
    sam_io.write_bam(bam, batch, side, header)
    write_bam_s = time.monotonic() - t0
    del batch, side
    t0 = time.monotonic()
    windows = [b.n_rows for b, _, _ in sam_io.iter_bam_batches(bam, batch_reads=WINDOW_READS)]
    iter_s = time.monotonic() - t0
    rec = {"bam_bytes": os.path.getsize(bam), "read_sam_s": read_sam_s,
           "write_bam_s": write_bam_s, "iter_bam_batches_s": iter_s,
           "window_reads": windows}
    _log(f"BAM: {rec['bam_bytes']} bytes; read_sam {read_sam_s:.3f} s, write_bam "
         f"{write_bam_s:.3f} s, iter_bam_batches {iter_s:.3f} s; windows {windows}")
    if sum(windows) != MAIN_READS:
        raise AssertionError(f"BAM windows {windows} hold {sum(windows)} reads")

    out_dir = os.path.join(work, "bam.adam")
    kernels.reset_launches()
    st = run_transform(bam, out_dir, device)
    lv, vv = kernels.launches(), kernels.variant_launches()
    got = read_parts(out_dir)
    n_parts = len(windows) + 1
    if (got["rows"] != MAIN_READS or st["n_reads"] != MAIN_READS
            or got["parts"] != n_parts or st["n_parts"] != n_parts
            or st["n_windows"] != len(windows) or got["realigned_rows"] == 0):
        raise AssertionError(f"BAM path: {got}, stats {st}, windows {windows}")
    if device == "cuda" and (
            lv["observe_hist"] < n_parts or lv["pack_rows"] != 2 * n_parts
            or vv.get("pack_rows:sanger") != n_parts
            or vv.get("pack_rows:base_decode") != n_parts or lv["sw_fill"] != 0):
        raise AssertionError(f"BAM path: launches {lv} {vv} for {n_parts} parts")
    t0 = time.monotonic()
    if not _sorted_rows(out_dir).equals(_sorted_rows(main_adam)):
        raise AssertionError("BAM path: rows differ from the SAM run's")
    rows_s = time.monotonic() - t0
    _log("BAM path stats: " + json.dumps(st, sort_keys=True))
    _log(f"BAM path: {got}, {st['reads_per_s']:.0f} reads/s, launches {lv} {vv} "
         f"({n_parts} parts); rows equal the SAM run's as a multiset (checked in "
         f"{rows_s:.1f} s); stage walls: {_stage_walls(st)}")
    shutil.rmtree(out_dir)

    kernels.reset_launches()
    md = run_transform(bam, out_dir, device, realign=False, recalibrate=False)
    md_lv = kernels.launches()
    got_md = read_parts(out_dir)
    if (got_md["rows"] != MAIN_READS or got_md["parts"] != len(windows)
            or got_md["duplicates"] == 0 or any(md_lv.values())):
        raise AssertionError(f"BAM markdup-only path: {got_md}, launches {md_lv}")
    _log(f"BAM markdup-only path: {got_md}, {md['reads_per_s']:.0f} reads/s, launches "
         f"{md_lv}; stage walls: {_stage_walls(md)}")
    shutil.rmtree(out_dir)
    # the BAM stays for 4k's bam2adam, which deletes it
    return {**rec, "bam_path": bam, "stats": st, "launches": lv, "variant_launches": vv,
            "rows_check_s": rows_s, "markdup_only_stats": md,
            "markdup_only_launches": md_lv}


def _timed_reps(fn, sync, reps: int = 5) -> list:
    """Seconds of ``reps`` calls of ``fn`` after one warm call, each
    ended by ``sync`` (the CUDA synchronise)."""
    fn()
    sync()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        out.append(time.perf_counter() - t0)
    return out


def check_kmers(work: str, main_adam: str, device: str = "cuda") -> dict:
    """Phase 4f on the main path's part directory -> its record."""
    import statistics

    import torch

    from adam_tpu_torch.cli.main import main as cli
    from adam_tpu_torch.device import resolve_device
    from adam_tpu_torch.io import context
    from adam_tpu_torch.ops import kmer

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    k = 21
    out_txt = os.path.join(work, "kmers.txt")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli(["count_kmers", main_adam, out_txt, str(k), "--device", device])
    if rc != 0:
        raise RuntimeError(f"count_kmers exited {rc}")
    cli_stats = json.loads(err.getvalue().strip().splitlines()[-1])
    with open(out_txt, "rb") as fh:
        n_lines = sum(1 for _ in fh)
    os.unlink(out_txt)
    if cli_stats["n_reads"] != MAIN_READS or n_lines != cli_stats["n_kmers"] or n_lines == 0:
        raise AssertionError(f"count_kmers: {cli_stats}, {n_lines} lines")
    _log(f"count_kmers {k} on the main path's parts: " + json.dumps(cli_stats, sort_keys=True))

    ds = context.load_alignments(main_adam, projection=["sequence", "qual"])
    b = ds.batch
    bases, quals, lengths, valid = (torch.from_numpy(getattr(b, f)).to(dev) for f in
                                    ("bases", "quals", "lengths", "valid"))
    L = int(bases.shape[1])
    nominal = int(valid.sum()) * (L - k + 1)
    windows = int((lengths.long() - (k - 1)).clamp(min=0)[valid].sum())
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    s, counts, head = kmer.device_kmer_histogram(bases, lengths, valid, k)
    sync()
    counted = int(counts[head].long().sum())
    peak_hist = torch.cuda.max_memory_allocated() if on_card else None
    if counted != windows or int(head.sum()) != n_lines:
        raise AssertionError(f"histogram counted {counted} of {windows} windows, "
                             f"{int(head.sum())} k-mers vs the CLI's {n_lines}")
    del s, counts, head
    keys, w = kmer.device_qmer_weights(bases, quals, lengths, valid, k)
    sync()
    vw = w[keys >= 0]
    # a phred-0 base has success probability 0, so 0 is a weight
    if int((keys >= 0).sum()) != windows or not bool(((vw >= 0) & (vw <= 1)).all()):
        raise AssertionError("q-mer weights: wrong count or outside [0, 1]")
    del keys, w, vw
    rec = {"k": k, "reads": MAIN_READS, "L": L, "kmers_nominal": nominal,
           "kmer_windows_valid": windows, "distinct_kmers": n_lines,
           "cli": cli_stats, "histogram_peak_bytes": peak_hist}
    for name, fn in (("device_kmer_histogram",
                      lambda: kmer.device_kmer_histogram(bases, lengths, valid, k)),
                     ("device_qmer_weights",
                      lambda: kmer.device_qmer_weights(bases, quals, lengths, valid, k))):
        secs = _timed_reps(fn, sync)
        rates = [nominal / t for t in secs]
        rec[name] = {"s": secs, "median_s": statistics.median(secs),
                     "kmers_per_s_median": statistics.median(rates),
                     "kmers_per_s_min": min(rates), "kmers_per_s_max": max(rates)}
        _log(f"{name} k={k} on {MAIN_READS} reads: median {statistics.median(secs):.5f} s, "
             f"{statistics.median(rates):.6g} k-mers/s (spread {min(rates):.6g}-"
             f"{max(rates):.6g}; {nominal} k-mers, bench.py's count)")
    return rec


DATASET_FLAGS = ("-mark_duplicate_reads", "-realign_indels",
                 "-recalibrate_base_qualities", "-sort_reads")
DATASET_STAGES = ["mark_duplicates", "realign_indels", "bqsr", "sort"]
# phase 5's dataset-level legs: (output name, flags)
TRIM_FLAGS = ("-trimReads", "-trimFromStart", "2", "-trimFromEnd", "1", "-qualityBasedTrim",
              *DATASET_FLAGS)
DATASET_PARITY_LEGS = (("trim.adam", TRIM_FLAGS), ("trim.sam", TRIM_FLAGS),
                       ("markdup.bam", ("-mark_duplicate_reads",)))


def _cli(argv) -> tuple:
    """The port's CLI in this process -> (stdout, stderr); raises on a
    non-zero exit."""
    from adam_tpu_torch.cli.main import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"{argv[0]} exited {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue()


def run_dataset_transform(src: str, out: str, device: str, flags=DATASET_FLAGS) -> dict:
    """``transform SRC OUT FLAGS`` without ``-streaming`` -> its stats line."""
    stdout, _ = _cli(["transform", src, out, *flags, "--device", device])
    return json.loads(stdout.strip().splitlines()[-1])


def run_flagstat(path: str, device: str) -> tuple:
    """``flagstat PATH`` -> (its report, its stats line, the call's seconds)."""
    t0 = time.monotonic()
    stdout, stderr = _cli(["flagstat", path, "--device", device])
    return stdout, json.loads(stderr.strip().splitlines()[-1]), time.monotonic() - t0


def _file_hash(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def check_sorted_output(path: str) -> dict:
    """A dataset-level ``.adam``: its rows, mapped rows in (contig name,
    start) order before every unmapped row, and its rows with OQ."""
    import numpy as np
    import pyarrow.parquet as pq

    tbl = pq.read_table(path, columns=["contig", "start", "flags", "origQual"])
    mapped = (tbl.column("flags").to_numpy() & 0x4) == 0
    k = int(mapped.sum())
    if not mapped[:k].all():
        raise AssertionError(f"{path}: an unmapped row sorts before a mapped one")
    contig = tbl.column("contig").slice(0, k).combine_chunks().dictionary_encode()
    names = contig.dictionary.to_pylist()
    rank = np.argsort(np.argsort(np.array(names, dtype=object), kind="stable"))
    keys = (rank[contig.indices.to_numpy()].astype(np.int64) << 40) | \
        tbl.column("start").slice(0, k).to_numpy()
    if not bool((np.diff(keys) >= 0).all()):
        raise AssertionError(f"{path}: mapped rows out of coordinate order")
    return {"rows": tbl.num_rows, "mapped_rows": k,
            "rows_with_oq": tbl.num_rows - tbl.column("origQual").null_count}


def _flagstat_counts(text: str) -> dict:
    """total and the duplicates (primary + secondary, QC passed + failed)
    of a flagstat report."""
    lines = [ln.split() for ln in text.splitlines()]

    def both(i):
        return int(lines[i][0]) + int(lines[i][2])

    return {"total": both(0), "duplicates": both(1) + both(5)}


def check_dataset_transform(work: str, sam: str, snps_vcf: str, main_dups: int) -> dict:
    """Phase 4g on the main path's SAM -> its record.  The run, its output
    checked, ``flagstat`` on it, then the checkpointed run, the restart
    after the bqsr store is dropped, and the known-SNP mask over the whole
    dataset timed on the host."""
    from adam_tpu_torch.api.datasets import GenotypeDataset
    from adam_tpu_torch.io.context import load_alignments
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.pipelines.bqsr import observe_residue_mask

    def launched(label, want_observe):
        lv = kernels.launches()
        if (lv["observe_hist"] != want_observe or lv["pack_rows"] != 0
                or lv["sw_fill"] != 0 or lv["sw_score"] != 0):
            raise AssertionError(f"{label}: launches {lv}")
        return lv

    out = os.path.join(work, "dataset.adam")
    kernels.reset_launches()
    st = run_dataset_transform(sam, out, "cuda")
    lv = launched("dataset transform", 1)
    if st["n_reads"] != MAIN_READS or st["stages_run"] != DATASET_STAGES:
        raise AssertionError(f"dataset transform: {st}")
    t0 = time.monotonic()
    rows = check_sorted_output(out)
    rows["check_s"] = time.monotonic() - t0
    if rows["rows"] != MAIN_READS or rows["rows_with_oq"] == 0:
        raise AssertionError(f"dataset transform output: {rows}")
    _log("dataset transform stats: " + json.dumps(st, sort_keys=True))
    _log(f"dataset transform: {MAIN_READS} reads in {st['total_s']:.3f} s, "
         f"{st['reads_per_s']:.0f} reads/s; load {st['load_s']:.3f}, markdup "
         f"{st['mark_duplicates_s']:.3f}, realign {st['realign_indels_s']:.3f}, BQSR "
         f"{st['bqsr_s']:.3f} (observe {st['bqsr_observe_s']:.3f}, solve "
         f"{st['bqsr_solve_s']:.3f}, apply {st['bqsr_apply_s']:.3f}), sort "
         f"{st['sort_s']:.3f}, save {st['save_s']:.3f} s; kernel 1 launches "
         f"{lv['observe_hist']}; output {rows}")

    kernels.reset_launches()
    text, fst, fs_s = run_flagstat(out, "cuda")
    launched("flagstat", 0)
    counts = _flagstat_counts(text)
    if counts != {"total": MAIN_READS, "duplicates": main_dups}:
        raise AssertionError(f"flagstat {counts}; the streamed main path marked "
                             f"{main_dups} duplicates of {MAIN_READS}")
    _log(f"flagstat on the dataset transform's output: {fs_s:.3f} s (load "
         f"{fst['load_s']:.3f}, count {fst['flagstat_s']:.4f}); {counts}, as the "
         "streamed main path")

    ck = os.path.join(work, "dataset.ck")
    flags = (*DATASET_FLAGS, "-checkpoint_dir", ck)
    want = _file_hash(out)
    kernels.reset_launches()
    ck_out = os.path.join(work, "dataset.ck1.adam")
    st_ck = run_dataset_transform(sam, ck_out, "cuda", flags)
    launched("checkpointed run", 1)
    if st_ck["stages_run"] != DATASET_STAGES or _file_hash(ck_out) != want:
        raise AssertionError(f"checkpointed run: {st_ck['stages_run']}, output "
                             "differs from the run without checkpoints")
    os.unlink(os.path.join(ck, "bqsr.adam"))
    manifest = os.path.join(ck, "MANIFEST.json")
    with open(manifest) as fh:
        doc = json.load(fh)
    doc["completed"].remove("bqsr")
    with open(manifest, "w") as fh:
        json.dump(doc, fh)
    kernels.reset_launches()
    re_out = os.path.join(work, "dataset.ck2.adam")
    st_re = run_dataset_transform(sam, re_out, "cuda", flags)
    lv_re = launched("restart", 1)
    if st_re["stages_run"] != ["bqsr", "sort"] or _file_hash(re_out) != want:
        raise AssertionError(f"restart: ran {st_re['stages_run']}, output "
                             f"{'differs' if _file_hash(re_out) != want else 'equal'}")
    _log(f"checkpointed run: {st_ck['total_s']:.3f} s; restart after dropping the "
         f"bqsr store: ran {st_re['stages_run']} in {st_re['total_s']:.3f} s (load "
         f"{st_re['load_s']:.3f}, BQSR {st_re['bqsr_s']:.3f}, sort {st_re['sort_s']:.3f},"
         f" save {st_re['save_s']:.3f}), kernel 1 once more, output byte-identical")
    for f in (out, ck_out, re_out):
        os.unlink(f)
    shutil.rmtree(ck)

    ds = load_alignments(sam)
    known = GenotypeDataset.load(snps_vcf, contig_names=ds.seq_dict.names).snp_table()
    b = ds.batch.to_numpy()
    mask_s = {}
    for label, table in (("no_snps", None), ("snps", known)):
        t0 = time.monotonic()
        observe_residue_mask(ds, b, table)
        mask_s[label] = time.monotonic() - t0
    _log(f"observe residue mask over the whole dataset ({MAIN_READS} x {b.lmax}): "
         f"{mask_s['snps']:.3f} s with the {len(known)} known SNPs, "
         f"{mask_s['no_snps']:.3f} s without")
    return {"stats": st, "output": rows, "launches": lv, "flagstat": counts,
            "flagstat_s": fs_s, "flagstat_stats": fst, "checkpointed_stats": st_ck,
            "restart_stats": st_re, "restart_launches": lv_re,
            "residue_mask_s": mask_s}


def run_sharded(sam: str, out_dir: str, device: str, n_shards: int) -> dict:
    """``transform SAM OUT -shards N`` with markdup, realign and BQSR ->
    its stats line."""
    stdout, _ = _cli(["transform", sam, out_dir, "-shards", str(n_shards),
                      "-mark_duplicate_reads", "-realign_indels",
                      "-recalibrate_base_qualities", "--device", device])
    return json.loads(stdout.strip().splitlines()[-1])


def check_sharded(work: str, sam: str, main_adam: str) -> dict:
    """Phase 4i on ``sam`` (the main path's input) -> its record."""
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.pipelines.bqsr import CHUNK_ROWS

    out_dir = os.path.join(work, "sharded.adam")
    kernels.reset_launches()
    st = run_sharded(sam, out_dir, "cuda", SHARDS)
    lv = kernels.launches()
    got = read_parts(out_dir)
    chunks = sum(-(-st["shard_rows"][si] // CHUNK_ROWS) for si in st["shards_observed"])
    if lv["observe_hist"] != chunks + 1 or st["n_observed"] != chunks + 1:
        raise AssertionError(f"4i: observe_hist launched {lv['observe_hist']} times "
                             f"({st['n_observed']} observes) for {chunks} shard chunks + 1")
    if lv["pack_rows"] != 0 or lv["sw_fill"] != 0 or lv["sw_score"] != 0:
        raise AssertionError(f"4i: launches {lv}: only observe_hist runs on this path")
    if (got["rows"] != MAIN_READS or st["n_reads"] != MAIN_READS
            or got["parts"] != st["n_parts"] or got["realigned_rows"] == 0):
        raise AssertionError(f"4i: {got}, stats {st}")
    t0 = time.monotonic()
    if not _sorted_rows(out_dir).equals(_sorted_rows(main_adam)):
        raise AssertionError("4i: the sharded rows differ from phase 4's streamed rows")
    rows_s = time.monotonic() - t0
    _log("4i sharded stats: " + json.dumps(st, sort_keys=True))
    _log(f"4i sharded ({SHARDS} shards, {st['n_shards']} shard files, rows "
         f"{st['shard_rows']}): {got}, total_s {st['total_s']:.3f}, "
         f"{st['reads_per_s']:.0f} reads/s, launches {lv}; rows equal phase 4's as a "
         f"multiset (checked in {rows_s:.1f} s); stage walls: {_stage_walls(st)}")
    shutil.rmtree(out_dir)
    return {"stats": st, "launches": lv, "parts": got, "rows_check_s": rows_s,
            "shard_chunks": chunks}


def check_depth_view(main_adam: str, snps_vcf: str, main_dups: int) -> dict:
    """Phase 4j on the main path's parts -> its record."""
    import hashlib as _h

    with open(snps_vcf) as fh:
        n_sites = sum(1 for ln in fh if ln.strip() and not ln.startswith("#"))
    rec = {"n_sites": n_sites}
    digests = {}
    for name, extra in (("broadcast", ()),
                        ("stream", ("-stream", "-bin_size", str(DEPTH_STREAM_BIN)))):
        t0 = time.monotonic()
        stdout, stderr = _cli(["depth", main_adam, snps_vcf, *extra, "--device", "cuda"])
        wall = time.monotonic() - t0
        lines = stdout.splitlines()
        depths = [int(ln.rsplit("\t", 1)[1]) for ln in lines[1:]]
        if len(depths) != n_sites or sum(depths) == 0:
            raise AssertionError(f"4j depth {name}: {len(depths)} sites for {n_sites}, "
                                 f"total depth {sum(depths)}")
        digests[name] = _h.sha256(stdout.encode()).hexdigest()
        rec[name] = {"wall_s": wall, **json.loads(stderr.strip().splitlines()[-1]),
                     "total_depth": sum(depths), "max_depth": max(depths)}
        _log(f"4j depth ({name}{' ' + ' '.join(extra) if extra else ''}): {wall:.3f} s "
             f"on the card, {n_sites} sites, total depth {sum(depths)}, walls "
             f"{json.dumps(rec[name], sort_keys=True)}")
    if digests["broadcast"] != digests["stream"]:
        raise AssertionError("4j: depth and depth -stream print different reports")
    t0 = time.monotonic()
    stdout, _ = _cli(["view", "-c", "-F", "1024", main_adam, "--device", "cuda"])
    rec["view_wall_s"] = time.monotonic() - t0
    rec["view_count"] = int(stdout.strip())
    if rec["view_count"] != MAIN_READS - main_dups:
        raise AssertionError(f"4j: view -c -F 1024 counted {rec['view_count']}, "
                             f"expected {MAIN_READS} - {main_dups} duplicates")
    _log(f"4j view -c -F 1024: {rec['view_count']} reads in {rec['view_wall_s']:.3f} s "
         f"on the card; depth reports byte-identical")
    return rec


def check_parity_sharded_depth_view(work: str, sam: str, parts: str, vcf: str) -> dict:
    """Phase 5's sharded, depth and view legs, card against CPU."""
    rec = {}
    hashes = {}
    for device in ("cuda", "cpu"):
        d = os.path.join(work, f"sharded.{device}.adam")
        run_sharded(sam, d, device, PARITY_SHARDS)
        hashes[device] = _part_hashes(d)
    if not hashes["cuda"] or hashes["cuda"] != hashes["cpu"]:
        raise AssertionError(f"-shards {PARITY_SHARDS}: card and CPU parts differ: {hashes}")
    rec["sharded_parts"] = len(hashes["cuda"])
    _log(f"card vs CPU (transform -shards {PARITY_SHARDS}): {rec['sharded_parts']} parts "
         f"byte-identical ({PARITY_READS} reads)")
    for name, argv in (("depth", ["depth", parts, vcf]),
                       ("depth_stream", ["depth", parts, vcf, "-stream", "-bin_size",
                                         str(DEPTH_STREAM_BIN)]),
                       ("view_sam", ["view", parts]),
                       ("view_count", ["view", "-c", "-F", "1024", parts])):
        outs = {device: _cli([*argv, "--device", device])[0] for device in ("cuda", "cpu")}
        if not outs["cuda"] or outs["cuda"] != outs["cpu"]:
            raise AssertionError(f"{name}: card and CPU standard output differ")
        rec[name] = outs["cuda"].count("\n")
        _log(f"card vs CPU ({name}): standard output byte-identical, {rec[name]} lines")
    return rec


# ---------------------------------------------------------------------------
# 4k: the other file formats
# ---------------------------------------------------------------------------
def make_fasta(path: str, lengths, seed: int, n_runs: int = 5) -> list:
    """A FASTA of random contigs (80-column lines), each with ``n_runs``
    runs of N (10 bp to 5 kb) -> the sequences."""
    import numpy as np

    rng = np.random.default_rng(seed)
    seqs = []
    with open(path, "w") as fh:
        for i, length in enumerate(lengths):
            s = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, length)].copy()
            for at in rng.integers(0, max(length - 5000, 1), n_runs):
                s[at: at + int(rng.integers(10, 5000))] = ord("N")
            seq = s.tobytes().decode()
            seqs.append(seq)
            fh.write(f">contig{i} synthetic, seed {seed}\n")
            fh.writelines(seq[j: j + 80] + "\n" for j in range(0, length, 80))
    return seqs


TRIO = ("NA12878", "NA12891", "NA12892")


def make_trio_vcf(path: str, n_sites: int, seed: int) -> None:
    """A trio VCF of ``n_sites`` bi-allelic sites (10% insertions) on 3
    contigs, FORMAT GT:AD:DP:GQ:PL, INFO with typed keys (DP, MQ, QD)
    beside an untyped one (AF): a call set whose VCF -> store -> VCF
    round trip returns the same records.  The columns are drawn at once."""
    import numpy as np

    rng = np.random.default_rng(seed)
    contigs = ("chr20", "chr21", "chr22")
    n, s = n_sites, len(TRIO)
    chrom = np.repeat(np.arange(len(contigs)), -(-n // len(contigs)))[:n]
    pos = np.empty(n, np.int64)
    for c in range(len(contigs)):
        at = chrom == c
        pos[at] = np.cumsum(rng.integers(1, 1200, int(at.sum()))) + 10_000
    bases = np.array(list("ACGT"))
    ref = rng.integers(0, 4, n)
    alt = bases[(ref + rng.integers(1, 4, n)) % 4]
    ref = bases[ref]
    ins = rng.random(n) < 0.1
    ins_len = rng.integers(1, 6, n)
    ins_bases = bases[rng.integers(0, 4, (n, 5))]
    alt = [r + "".join(b[:k]) if i else a
           for r, a, i, k, b in zip(ref, alt, ins, ins_len, ins_bases)]
    gt = np.sort(rng.integers(0, 2, (n, s, 2)), axis=2)
    ad = rng.integers(0, 40, (n, s, 2))
    gq = rng.integers(1, 99, (n, s))
    pl = rng.integers(0, 400, (n, s, 3))
    np.put_along_axis(pl, gt.sum(axis=2)[..., None], 0, axis=2)
    qual = rng.random(n) * 1000
    af, dp, mq = rng.random(n), rng.integers(10, 300, n), rng.integers(20, 61, n)
    qd = np.round(rng.random(n) * 30, 2)

    def calls(i):
        return "\t".join(
            f"{gt[i, j, 0]}/{gt[i, j, 1]}:{ad[i, j, 0]},{ad[i, j, 1]}:{ad[i, j].sum()}:"
            f"{gq[i, j]}:{pl[i, j, 0]},{pl[i, j, 1]},{pl[i, j, 2]}" for j in range(s))

    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.1\n")
        fh.writelines(f"##contig=<ID={c},length={60_000_000}>\n" for c in contigs)
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(TRIO) + "\n")
        for i in range(n):
            q = float(qd[i])  # the digits adam2vcf writes back
            q = str(int(q)) if q.is_integer() else repr(q)
            fh.write(f"{contigs[chrom[i]]}\t{pos[i]}\t{'rs%d' % i if i % 3 == 0 else '.'}\t"
                     f"{ref[i]}\t{alt[i]}\t{qual[i]:.2f}\t{'PASS' if i % 5 else 'LowQual'}\t"
                     f"AF={af[i]:.3f};DP={dp[i]};MQ={mq[i]};QD={q}\tGT:AD:DP:GQ:PL\t"
                     + calls(i) + "\n")


def make_gtf(path: str, n_genes: int, seed: int, n_tx: int = 2, n_exons: int = 5) -> int:
    """A GTF of ``n_genes`` genes, each with ``n_tx`` transcripts of
    ``n_exons`` exons, on 22 contigs -> its number of feature lines."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = 0
    with open(path, "w") as fh:
        fh.write("#!genome-build synthetic\n")
        for g in range(n_genes):
            chrom, strand = f"chr{1 + g % 22}", "+-"[g % 2]
            start = int(rng.integers(1, 200_000_000))
            exon_len = rng.integers(50, 400, n_exons)
            intron = rng.integers(100, 5000, n_exons)
            end = start + int((exon_len + intron).sum())
            gid = f"ENSG{g:011d}"
            fh.write(f'{chrom}\tsynthetic\tgene\t{start}\t{end}\t.\t{strand}\t.\t'
                     f'gene_id "{gid}"; gene_name "G{g}"; gene_biotype "protein_coding";\n')
            n += 1
            for t in range(n_tx):
                tid = f"ENST{g:09d}{t:02d}"
                fh.write(f'{chrom}\tsynthetic\ttranscript\t{start}\t{end}\t.\t{strand}\t.\t'
                         f'gene_id "{gid}"; transcript_id "{tid}";\n')
                n += 1
                s = start
                for e in range(n_exons):
                    e_end = s + int(exon_len[e]) - 1 - 10 * t
                    fh.write(f'{chrom}\tsynthetic\texon\t{s}\t{e_end}\t.\t{strand}\t.\t'
                             f'gene_id "{gid}"; transcript_id "{tid}"; '
                             f'exon_number "{e + 1}";\n')
                    n += 1
                    s += int(exon_len[e] + intron[e])
    return n


def _fastq_records(path: str) -> list:
    with open(path) as fh:
        lines = fh.read().split("\n")
    return ["\n".join(lines[i: i + 4]) for i in range(0, len(lines) - 1, 4)]


def interleave_mates(fq1: str, fq2: str, out: str) -> int:
    """Mate files -> one interleaved FASTQ, each first mate followed by
    the second of its name -> the pairs written."""
    second = {r[1: r.index("\n") - 2]: r for r in _fastq_records(fq2)}
    n = 0
    with open(out, "w") as fh:
        for r in _fastq_records(fq1):
            fh.write(r + "\n" + second.pop(r[1: r.index("\n") - 2]) + "\n")
            n += 1
    if second:
        raise AssertionError(f"{len(second)} second mates without a first")
    return n


_COMPLEMENT = str.maketrans("ACGTN", "TGCAN")


def _sequencer_rows(parts: str):
    """The reads of a part directory as FASTQ gives them back: (name,
    sequence, quality), reverse-strand reads reverse-complemented."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    tbl = pa.concat_tables([
        pq.read_table(os.path.join(parts, f), columns=["readName", "sequence", "qual", "flags"])
        for f in sorted(os.listdir(parts)) if f.startswith("part-")])
    seqs, quals = tbl.column("sequence").to_pylist(), tbl.column("qual").to_pylist()
    for i in (tbl.column("flags").to_numpy() & 0x10).nonzero()[0]:
        seqs[i] = seqs[i].translate(_COMPLEMENT)[::-1]
        quals[i] = quals[i][::-1]
    return pa.table({"readName": tbl.column("readName"), "sequence": pa.array(seqs),
                     "qual": pa.array(quals)})


def _rows_sorted(tbl):
    return tbl.sort_by([(c, "ascending") for c in tbl.column_names])


def _vcf_body(path: str, drop_ft: bool = False) -> list:
    """The data lines of a VCF; with ``drop_ft`` the FT key and each
    call's FT value (which ``adam2vcf`` writes, "." where the input had
    none) are cut off."""
    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh if not ln.startswith("#")]
    if not drop_ft:
        return lines
    out = []
    for ln in lines:
        cols = ln.split("\t")
        if cols[8].endswith(":FT"):
            cols[8] = cols[8][:-3]
            cols[9:] = [c.rsplit(":", 1)[0] for c in cols[9:]]
        out.append("\t".join(cols))
    return out


def _cli_timed(argv) -> tuple:
    """The port's CLI -> (stdout, the stderr JSON line or None, wall s)."""
    t0 = time.monotonic()
    out, err = _cli(argv)
    wall = time.monotonic() - t0
    last = err.strip().splitlines()[-1] if err.strip() else ""
    return out, (json.loads(last) if last.startswith("{") else None), wall


def check_other_formats(work: str, main_adam: str, bam: str) -> dict:
    """Phase 4k on the main path's parts and 4e's BAM -> its record."""
    import statistics

    import pyarrow.parquet as pq
    import torch

    from adam_tpu_torch.formats.fragments import flank_fragments
    from adam_tpu_torch.io import context
    from adam_tpu_torch.ops import kernels, kmer

    rec = {}
    kernels.reset_launches()
    # -- FASTQ: paired export, interleave, read back, sorted export --------
    fq1, fq2 = os.path.join(work, "m1.fq"), os.path.join(work, "m2.fq")
    _, st, wall = _cli_timed(["adam2fastq", main_adam, fq1, fq2, "--device", "cuda"])
    rec["adam2fastq_paired"] = {"wall_s": wall, **st, "bytes": os.path.getsize(fq1)
                                + os.path.getsize(fq2)}
    t0 = time.monotonic()
    ifq = os.path.join(work, "pairs.ifq")
    pairs = interleave_mates(fq1, fq2, ifq)
    rec["interleave_s"] = time.monotonic() - t0
    os.unlink(fq1)
    os.unlink(fq2)
    if 2 * pairs != MAIN_READS:
        raise AssertionError(f"4k: adam2fastq wrote {pairs} pairs for {MAIN_READS} reads")
    back = os.path.join(work, "from_ifq.adam")
    out, _, wall = _cli_timed(["transform", ifq, back, "-force_load_ifastq", "--device",
                               "cuda"])
    rec["transform_ifq"] = {"wall_s": wall, **json.loads(out.strip().splitlines()[-1])}
    os.unlink(ifq)
    t0 = time.monotonic()
    got = pq.read_table(back, columns=["readName", "sequence", "qual"]).replace_schema_metadata(
        None)
    if got.num_rows != MAIN_READS or not _rows_sorted(got).equals(
            _rows_sorted(_sequencer_rows(main_adam).cast(got.schema))):
        raise AssertionError("4k: the FASTQ round trip's reads differ from phase 4's")
    rec["round_trip_check_s"] = time.monotonic() - t0
    os.unlink(back)
    sorted_fq = os.path.join(work, "sorted.fq")
    out, _, wall = _cli_timed(["transform", main_adam, sorted_fq, "-sort_fastq_output",
                               "--device", "cuda"])
    rec["transform_sorted_fq"] = {"wall_s": wall, **json.loads(out.strip().splitlines()[-1])}
    with open(sorted_fq) as fh:  # sorted by name, the mates' /1 /2 aside
        names = [n[:-2] if n.endswith(("/1", "/2")) else n
                 for n in fh.read().split("\n")[:-1:4]]
    if len(names) != MAIN_READS or names != sorted(names):
        raise AssertionError("4k: -sort_fastq_output wrote unsorted or missing records")
    os.unlink(sorted_fq)
    _log(f"4k FASTQ: adam2fastq (paired) {rec['adam2fastq_paired']['wall_s']:.3f} s, "
         f"interleave {rec['interleave_s']:.3f} s, transform -force_load_ifastq "
         f"{rec['transform_ifq']['wall_s']:.3f} s (load {rec['transform_ifq']['load_s']:.3f} "
         f"s), reads equal phase 4's as a multiset of (name, sequence, quality) (checked in "
         f"{rec['round_trip_check_s']:.1f} s); transform -sort_fastq_output "
         f"{rec['transform_sorted_fq']['wall_s']:.3f} s")

    # -- FASTA, the fragment store and the contig k-mers -------------------
    fa, store = os.path.join(work, "ecoli.fa"), os.path.join(work, "ecoli.adam")
    seqs = make_fasta(fa, [ECOLI_BP], SEED)
    _, st, wall = _cli_timed(["fasta2adam", fa, store, "--device", "cuda"])
    rec["fasta2adam"] = {"wall_s": wall, **st}
    files = {}
    for src in (fa, store):
        txt = src + ".kmers.txt"
        _, st, wall = _cli_timed(["count_contig_kmers", src, txt, str(CONTIG_K),
                                  "--device", "cuda"])
        rec[f"count_contig_kmers_{os.path.splitext(src)[1][1:]}"] = {"wall_s": wall, **st}
        files[src] = _file_hash(txt)
        os.unlink(txt)
    windows = sum(max(len(s) - CONTIG_K + 1, 0) for s in seqs)
    if files[fa] != files[store] or st["n_kmers"] == 0:
        raise AssertionError("4k: count_contig_kmers on the FASTA and on the store differ")
    frags = flank_fragments(context.load_fasta(fa)[0], CONTIG_K - 1).to("cuda")
    s, counts, head = kmer.device_kmer_histogram(frags.bases, frags.lengths, frags.valid,
                                                 CONTIG_K)
    if int(counts[head].long().sum()) != windows or int(head.sum()) != st["n_kmers"]:
        raise AssertionError(f"4k: the contig histogram counted {int(counts[head].sum())} "
                             f"of {windows} windows")
    del s, counts, head
    secs = _timed_reps(lambda: kmer.device_kmer_histogram(
        frags.bases, frags.lengths, frags.valid, CONTIG_K), torch.cuda.synchronize)
    hist_ms = _time_ms(lambda: kmer.device_kmer_histogram(
        frags.bases, frags.lengths, frags.valid, CONTIG_K), iters=10, warm=1)
    nominal = frags.n_rows * (frags.fmax - CONTIG_K + 1)
    rec["contig_histogram"] = {
        "k": CONTIG_K, "contig_bp": ECOLI_BP, "fragments": frags.n_rows,
        "width": frags.fmax, "kmer_windows": windows, "windows_nominal": nominal,
        "distinct_kmers": st["n_kmers"], "s": secs, "median_s": statistics.median(secs),
        "device_ms": hist_ms, "kmers_per_s": windows / (hist_ms / 1e3),
        "kmers_per_s_wall_median": windows / statistics.median(secs)}
    del frags
    h = rec["contig_histogram"]
    _log(f"4k contigs: {ECOLI_BP} bp, {h['fragments']} fragments of width {h['width']}; "
         f"fasta2adam {rec['fasta2adam']['wall_s']:.3f} s; count_contig_kmers {CONTIG_K} "
         f"on the FASTA / the store: "
         + " / ".join(f"wall {rec[k]['wall_s']:.3f} s (load {rec[k]['load_s']:.3f}, count "
                      f"{rec[k]['count_s']:.3f}, write {rec[k]['write_s']:.3f})"
                      for k in ("count_contig_kmers_fa", "count_contig_kmers_adam"))
         + f"; files byte-identical, {st['n_kmers']} distinct k-mers; histogram "
         f"{hist_ms:.4f} ms on the card (CUDA events) = {h['kmers_per_s']:.6g} k-mers/s "
         f"over {windows} windows ({nominal} with padding), wall median "
         f"{h['median_s']:.5f} s")

    # -- VCF: vcf2adam, adam2vcf, the same records back --------------------
    vcf, gstore, vcf_back = (os.path.join(work, n) for n in ("trio.vcf", "trio.adam",
                                                             "trio.back.vcf"))
    t0 = time.monotonic()
    make_trio_vcf(vcf, TRIO_SITES, SEED)
    rec["make_trio_vcf_s"] = time.monotonic() - t0
    _, st, wall = _cli_timed(["vcf2adam", vcf, gstore, "--device", "cuda"])
    rec["vcf2adam"] = {"wall_s": wall, **st}
    _, st, wall = _cli_timed(["adam2vcf", gstore, vcf_back, "--device", "cuda"])
    rec["adam2vcf"] = {"wall_s": wall, **st}
    t0 = time.monotonic()
    if (st["n_variants"] != TRIO_SITES or st["n_genotypes"] != 3 * TRIO_SITES
            or _vcf_body(vcf) != _vcf_body(vcf_back, drop_ft=True)):
        raise AssertionError("4k: vcf2adam + adam2vcf changed the records")
    rec["vcf_check_s"] = time.monotonic() - t0
    _log(f"4k VCF ({TRIO_SITES} sites x {len(TRIO)} samples): vcf2adam "
         f"{rec['vcf2adam']['wall_s']:.3f} s (read {rec['vcf2adam']['load_s']:.3f}, save "
         f"{rec['vcf2adam']['save_s']:.3f}), adam2vcf {rec['adam2vcf']['wall_s']:.3f} s "
         f"(load {rec['adam2vcf']['load_s']:.3f}, write {rec['adam2vcf']['save_s']:.3f}); "
         f"the same records back")

    # -- GTF: features2adam ------------------------------------------------
    gtf, fstore = os.path.join(work, "genes.gtf"), os.path.join(work, "genes.adam")
    n_lines = make_gtf(gtf, GTF_GENES, SEED)
    _, st, wall = _cli_timed(["features2adam", gtf, fstore, "--device", "cuda"])
    rec["features2adam"] = {"wall_s": wall, **st}
    types = pq.read_table(fstore, columns=["featureType"]).column("featureType")
    if st["n_features"] != n_lines or len(types) != n_lines:
        raise AssertionError(f"4k: features2adam stored {st['n_features']} of {n_lines}")
    _log(f"4k GTF ({GTF_GENES} genes x 2 transcripts x 5 exons, {n_lines} features): "
         f"features2adam {wall:.3f} s (parse {st['load_s']:.3f}, save {st['save_s']:.3f})")

    # -- bam2adam of 4e's BAM ----------------------------------------------
    bstore = os.path.join(work, "bam2adam.adam")
    out, st, wall = _cli_timed(["bam2adam", bam, bstore, "--device", "cuda"])
    rec["bam2adam"] = {"wall_s": wall, **st}
    if out.strip() != f"bam2adam: streamed {MAIN_READS} reads" or \
            pq.read_metadata(bstore).num_rows != MAIN_READS:
        raise AssertionError(f"4k: bam2adam: {out!r}")
    _log(f"4k bam2adam: {MAIN_READS} reads streamed in {wall:.3f} s")
    lv = kernels.launches()
    if any(lv.values()):
        raise AssertionError(f"4k: launches {lv}: no hand kernel runs on these paths")
    rec["launches"] = lv
    for p in (fa, store, vcf, gstore, vcf_back, gtf, fstore, bstore, bam):
        if os.path.isdir(p):
            shutil.rmtree(p)
        else:
            os.unlink(p)
    return rec


def check_parity_other_formats(work: str, sam: str, parts: str) -> dict:
    """Phase 5's legs of 4k, card against CPU: ``count_contig_kmers`` on a
    FASTA and its store, ``adam2fastq`` single and paired, and
    ``transform`` with FASTQ out (markdup, sorted by name) and FASTQ in
    (interleaved)."""
    rec = {}
    fa, store = os.path.join(work, "parity.fa"), os.path.join(work, "parity.fa.adam")
    make_fasta(fa, PARITY_CONTIGS, SEED + 1)
    _cli(["fasta2adam", fa, store, "--device", "cpu"])
    legs = {  # name -> the argv writing to the path o
        "count_contig_kmers_fa": lambda o: ["count_contig_kmers", fa, o, str(CONTIG_K)],
        "count_contig_kmers_store": lambda o: ["count_contig_kmers", store, o, str(CONTIG_K)],
        "adam2fastq": lambda o: ["adam2fastq", parts, o],
        "adam2fastq_paired": lambda o: ["adam2fastq", parts, o, o + ".2.fq"],
        "transform_fq_out": lambda o: ["transform", sam, o + ".fq", "-mark_duplicate_reads",
                                       "-sort_fastq_output"],
    }
    for name, argv_of in legs.items():
        digests = {}
        for device in ("cuda", "cpu"):
            o = os.path.join(work, f"{name}.{device}")
            _cli(argv_of(o) + ["--device", device])
            outs = [p for p in (o, o + ".2.fq", o + ".fq") if os.path.exists(p)]
            digests[device] = [_file_hash(p) for p in outs]
        if not digests["cuda"] or digests["cuda"] != digests["cpu"]:
            raise AssertionError(f"{name}: card and CPU output files differ: {digests}")
        rec[name] = len(digests["cuda"])
        _log(f"card vs CPU ({name}): {rec[name]} output file(s) byte-identical")
    ifq = os.path.join(work, "parity.ifq")
    interleave_mates(os.path.join(work, "adam2fastq_paired.cuda"),
                     os.path.join(work, "adam2fastq_paired.cuda.2.fq"), ifq)
    digests = {}
    for device in ("cuda", "cpu"):
        o = os.path.join(work, f"ifq.{device}.adam")
        _cli(["transform", ifq, o, "-force_load_ifastq", "--device", device])
        digests[device] = _file_hash(o)
    if digests["cuda"] != digests["cpu"]:
        raise AssertionError("transform -force_load_ifastq: card and CPU outputs differ")
    rec["transform_ifq_in"] = 1
    _log("card vs CPU (transform -force_load_ifastq): output byte-identical")
    return rec


# ---------------------------------------------------------------------------
# 4l: the Spark embedding executor; 4m: transform_step
# ---------------------------------------------------------------------------
SPARK_PARTITIONS = 8   # 4l: the main path's SAM cut in file order (131,072 reads each)
PARITY_SPARK_PARTITIONS = 4  # phase 5's executor leg
SPARK_FLAGS = ("-mark_duplicate_reads", "-realign_indels", "-recalibrate_base_qualities")
STEP_SHAPES = ((256, 100), (WINDOW_READS, 100))  # 4m: the graft entry's, and a window's
STEP_N_RG = 2  # the graft entry's read-group bins

#: phase 5's plugin and access control, written beside the parity parts and
#: imported by the ``plugin`` verb from there
SMOKE_PLUGIN = '''
import numpy as np
import torch

from adam_tpu_torch.plugins import AccessControl, AdamPlugin


class FirstHighMapq(AdamPlugin):
    projection = ["readName", "flags", "mapq", "start", "contig"]

    def predicate(self, batch):
        return np.asarray(batch.mapq) >= 30

    def run(self, ds, args):
        n = int(args[0]) if args else 10
        b = ds.batch.to_numpy()
        return [f"{name}\\t{int(f)}\\t{int(s)}" for name, f, s in
                zip(list(ds.sidecar.names)[:n], b.flags[:n], b.start[:n])]


class NoDuplicates(AccessControl):
    def predicate(self, batch):
        return (torch.from_numpy(np.asarray(batch.flags)) & 0x400) == 0
'''


def write_partition_stream(ds, path: str, n_parts: int) -> list:
    """``ds`` cut in file order into ``n_parts`` contiguous partitions, as
    Spark's input splits hand a BAM's slices to executors, written as one
    Arrow IPC stream at ``path`` (the port's ``to_arrow_alignments``) ->
    the partitions' row counts."""
    import numpy as np
    import pyarrow as pa

    edges = np.linspace(0, ds.batch.n_rows, n_parts + 1).astype(np.int64)
    rows = []
    writer = None
    with pa.OSFile(path, "wb") as sink:
        for a, b in zip(edges[:-1], edges[1:]):
            rb = ds.take_rows(np.arange(a, b)).to_arrow().combine_chunks().to_batches()[0]
            if writer is None:
                writer = pa.ipc.new_stream(sink, rb.schema)
            writer.write_batch(rb)
            rows.append(rb.num_rows)
        writer.close()
    return rows


def run_spark_executor(stream: str, out: str, device: str, extra: tuple = ()) -> tuple:
    """``python -m adam_tpu_torch transform - - -backend spark`` with the
    three stage flags in a child process, standard input from ``stream``
    and standard output into ``out`` -> (its stderr stats line, the output
    batches, the wall including the interpreter's start)."""
    import pyarrow as pa

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    with open(stream, "rb") as fin, open(out, "wb") as fout:
        res = subprocess.run(
            [sys.executable, "-m", "adam_tpu_torch", "transform", "-", "-", "-backend",
             "spark", *SPARK_FLAGS, *extra, "--device", device],
            stdin=fin, stdout=fout, stderr=subprocess.PIPE, cwd=here, timeout=900)
    wall = time.monotonic() - t0
    err = res.stderr.decode(errors="replace")
    if res.returncode != 0:
        raise RuntimeError(f"transform -backend spark ({device}) exited "
                           f"{res.returncode}: {err[-3000:]}")
    stats = json.loads(err.strip().splitlines()[-1])
    with pa.memory_map(out) as src:
        batches = list(pa.ipc.open_stream(src))
    return stats, batches, wall


def check_spark_executor(work: str, sam: str, snps_vcf: str) -> dict:
    """4l: the main path's SAM in 8 partitions through the executor on the
    card, with its known-SNP VCF -> its record.  8 batches back, each with
    its partition's rows, kernel 1 once per partition (the dataset-level
    BQSR of each), no other hand kernel."""
    from adam_tpu_torch.io.context import load_alignments

    t0 = time.monotonic()
    ds = load_alignments(sam)
    stream = os.path.join(work, "parts.arrows")
    rows_in = write_partition_stream(ds, stream, SPARK_PARTITIONS)
    del ds
    prep_s = time.monotonic() - t0
    out = os.path.join(work, "parts.out.arrows")
    stats, batches, wall = run_spark_executor(stream, out, "cuda",
                                              ("-known_snps", snps_vcf))
    rows_out = [b.num_rows for b in batches]
    lv = stats["kernel_launches"]
    stream_bytes, out_bytes = os.path.getsize(stream), os.path.getsize(out)
    del batches
    os.unlink(stream)
    os.unlink(out)
    if rows_out != rows_in or stats["n_partitions"] != SPARK_PARTITIONS:
        raise AssertionError(f"4l: {len(rows_out)} batches of {rows_out} rows for "
                             f"{SPARK_PARTITIONS} partitions of {rows_in}: {stats}")
    if (lv["observe_hist"] != SPARK_PARTITIONS or lv["pack_rows"] != 0
            or lv["sw_fill"] != 0 or lv["sw_score"] != 0):
        raise AssertionError(f"4l: launches {lv} for {SPARK_PARTITIONS} partitions")
    _log("4l spark executor stats: " + json.dumps(stats, sort_keys=True))
    _log(f"4l spark executor: {SPARK_PARTITIONS} partitions of {rows_in[0]} reads in "
         f"{stats['total_s']:.3f} s served ({stats['reads_per_s']:.0f} reads/s), "
         f"{wall:.3f} s with the interpreter's start; read {stats['read_s']:.3f}, markdup "
         f"{stats['mark_duplicates_s']:.3f}, realign {stats['realign_indels_s']:.3f}, "
         f"BQSR {stats['bqsr_s']:.3f}, write {stats['write_s']:.3f} s; stream "
         f"{stream_bytes} bytes in, {out_bytes} out (built in {prep_s:.3f} s); kernel 1 "
         f"launches {lv['observe_hist']}; card {_smi()}")
    return {"stats": stats, "wall_s": wall, "prep_s": prep_s, "rows": rows_in,
            "stream_bytes": stream_bytes, "out_bytes": out_bytes, "launches": lv}


def check_transform_step(dev) -> dict:
    """4m: ``transform_step`` at the graft entry's shape and at a window's,
    on the card: one kernel-1 launch per call, every output equal to the
    CPU run with the plain version, the card's call timed (CUDA events
    around whole calls, its two host syncs included)."""
    import torch

    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.pipelines.transform_step import (
        synthetic_batch,
        synthetic_masks,
        transform_step,
    )

    out = {}
    for n, lmax in STEP_SHAPES:
        b = synthetic_batch(n, lmax)
        res, mm = synthetic_masks(b)
        kernels.reset_launches()
        gout, gaux = transform_step(b, res, mm, STEP_N_RG, lmax, device="cuda")
        torch.cuda.synchronize()
        lv = kernels.launches()
        if lv["observe_hist"] != 1 or lv["pack_rows"] != 0:
            raise AssertionError(f"4m at {n} x {lmax}: launches {lv}")
        cout, caux = transform_step(b, res, mm, STEP_N_RG, lmax, device="cpu")
        keys = ("five_prime", "dup_score", "obs_total", "obs_mism")
        equal = (torch.equal(gout.quals.cpu(), cout.quals)
                 and all(torch.equal(gaux[k].cpu(), caux[k]) for k in keys)
                 and gaux["flagstat"] == caux["flagstat"])
        if not equal:
            raise AssertionError(f"4m at {n} x {lmax}: the card's outputs differ from "
                                 "the CPU's")
        bt = b.to(dev)
        rt, mt = torch.from_numpy(res).to(dev), torch.from_numpy(mm).to(dev)
        ms = _time_ms(lambda: transform_step(bt, rt, mt, STEP_N_RG, lmax, device="cuda"),
                      iters=10, warm=2)
        out[str(n)] = {"shape": [n, lmax, STEP_N_RG], "launches": lv["observe_hist"],
                       "equal": equal, "ms": ms,
                       "residues_observed": int(caux["obs_total"].sum())}
        _log(f"4m transform_step at {n} x {lmax} (n_rg {STEP_N_RG}): {ms:.4f} ms on the "
             f"card, kernel 1 launched once, quals, observe totals, 5' positions, dup "
             f"scores and flagstat equal to the CPU run ({out[str(n)]['residues_observed']}"
             " residues observed)")
        del bt, rt, mt, gout, gaux
        torch.cuda.empty_cache()
    return out


def check_parity_spark(work: str, sam: str, vcf: str) -> dict:
    """Phase 5: the parity SAM in 4 partitions through the executor on the
    card and on the CPU, with the known SNPs: every output batch equal."""
    from adam_tpu_torch.io.context import load_alignments

    stream = os.path.join(work, "parity.arrows")
    rows = write_partition_stream(load_alignments(sam), stream, PARITY_SPARK_PARTITIONS)
    got = {}
    for device in ("cuda", "cpu"):
        got[device] = run_spark_executor(stream, os.path.join(work, f"spark.{device}.arrows"),
                                         device, ("-known_snps", vcf))
    (st, card, _), (_, cpu, _) = got["cuda"], got["cpu"]
    if (len(card) != PARITY_SPARK_PARTITIONS or len(cpu) != len(card)
            or not all(a.equals(b) for a, b in zip(card, cpu))
            or [b.num_rows for b in card] != rows):
        raise AssertionError("spark executor: card and CPU batches differ")
    if st["kernel_launches"]["observe_hist"] != PARITY_SPARK_PARTITIONS:
        raise AssertionError(f"spark executor parity: launches {st['kernel_launches']}")
    _log(f"card vs CPU (transform -backend spark, {PARITY_SPARK_PARTITIONS} partitions of "
         f"{rows[0]} reads, known SNPs): every output batch equal")
    return {"partitions": len(card), "rows": rows}


def check_parity_plugin(work: str, parts: str) -> dict:
    """Phase 5: ``plugin`` with the plugin and access control of
    :data:`SMOKE_PLUGIN` on the parity parts, on the card and on the CPU:
    the same lines."""
    with open(os.path.join(work, "smoke_plugin.py"), "w") as fh:
        fh.write(SMOKE_PLUGIN)
    sys.path.insert(0, work)
    try:
        got = {dev: _cli(["plugin", "smoke_plugin.FirstHighMapq", parts, "-access_control",
                          "smoke_plugin.NoDuplicates", "-plugin_args", "200",
                          "--device", dev])[0]
               for dev in ("cuda", "cpu")}
    finally:
        sys.path.remove(work)
    n = got["cuda"].count("\n")
    if got["cuda"] != got["cpu"] or n != 200:
        raise AssertionError(f"plugin: card and CPU lines differ or are not 200 ({n})")
    _log(f"card vs CPU (plugin with a projection, a predicate and an access control): "
         f"the same {n} lines")
    return {"lines": n}


# ---------------------------------------------------------------------------
# 4o. multi-device execution: the device pool, the mesh, their fault paths
# and the distributed collectives, over two slots of the one card
# ---------------------------------------------------------------------------
POOL_SLOTS = ("cuda:0", "cuda:0")  # 4o / 5: two slots (two streams) on one card
COLLECTIVE_READS = 65_536          # 4o (vi): the dist.py functions' batch
PARITY_POOL_WINDOW = 16_384        # phase 5's pool and mesh legs: 4 windows + 1


def _pool(devices=None):
    from adam_tpu_torch.parallel import device_pool as dp

    return dp.DevicePool(dp.make_slots(list(devices or POOL_SLOTS)))


def _leg(name: str, sam: str, out_dir: str, main_hashes: dict, spec: str | None = None,
         env: dict | None = None, **kw) -> dict:
    """One 4o leg: the streamed transform through the library call with
    ``kw`` (a device pool, a partitioner), under fault spec ``spec`` and
    ``env``, recording on; its parts must be phase 4's bytes.  -> its wall,
    stats, launches per kernel, per device and per slot, prewarm launches
    and the run's counters and per-slot span counts."""
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.parallel import device_pool as dp
    from adam_tpu_torch.pipelines.streamed import transform_streamed
    from adam_tpu_torch.utils import faults
    from adam_tpu_torch.utils import telemetry as tele

    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    dp.reset_prewarm_cache()
    _reset_telemetry()
    tele.TRACE.recording = True
    kernels.reset_launches()
    if spec:
        faults.install(spec)
    t0 = time.monotonic()
    try:
        stats = transform_streamed(sam, out_dir, window_reads=WINDOW_READS, **kw)
        wall = time.monotonic() - t0
        snap = tele.TRACE.snapshot()
    finally:
        faults.clear()
        tele.TRACE.recording = False
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = {
        "wall_s": wall, "stats": stats, "launches": kernels.launches(),
        "device_launches": kernels.device_launches(),
        "slot_launches": {k: {str(s): n for s, n in v.items()}
                          for k, v in kernels.slot_launches().items()},
        "prewarm_launches": kernels.prewarm_launches(),
        "counters": snap["counters"],
        "device_spans": {name: {k: v["count"] for k, v in per.items()}
                         for name, per in snap["device_spans"].items()
                         if name in (tele.SPAN_POOL_PREWARM_COMPILE, tele.SPAN_POOL_REPLAY,
                                     tele.SPAN_AUDIT_CHECK, tele.SPAN_APPLY_DISPATCH)},
        "spans": {name: snap["spans"][name]["count"] for name in (
            tele.SPAN_POOL_PREWARM, tele.SPAN_POOL_PREWARM_C, tele.SPAN_POOL_REPLAY,
            tele.SPAN_AUDIT_CHECK) if name in snap["spans"]},
        "hashes": _part_hashes(out_dir),
    }
    _reset_telemetry()
    if out["hashes"] != main_hashes:
        raise AssertionError(f"4o ({name}): the parts differ from phase 4's")
    _log(f"4o ({name}): {out['wall_s']:.3f} s, {stats['reads_per_s']:.0f} reads/s, "
         f"partitioner {stats['partitioner']}, launches {out['launches']} per slot "
         f"{out['slot_launches']} per device {out['device_launches']} (prewarm "
         f"{out['prewarm_launches']}); spans {out['spans']}; parts byte-identical to "
         f"phase 4's: {sorted(out['hashes'].values())[:2]}...")
    shutil.rmtree(out_dir)
    return out


def check_multi_device(work: str, sam: str, main_hashes: dict, n_win: int) -> dict:
    """Phase 4o (i)-(v): the main path over two slots of the card as a pool
    and as a mesh, then slot 1's eviction and replay, the mesh's degrade to
    the pool and the SDC audit catching a corrupted fetch: every leg's
    parts phase 4's bytes."""
    from adam_tpu_torch.utils import health as health_mod
    from adam_tpu_torch.utils import telemetry as tele

    out_dir = os.path.join(work, "multi.adam")
    parts = n_win + 1
    res = {}
    # (i) the pool: each window on one slot, its prewarm on both
    leg = res["pool"] = _leg("pool", sam, out_dir, main_hashes, device_pool=_pool())
    k1, k2 = leg["slot_launches"]["observe_hist"], leg["slot_launches"]["pack_rows"]
    if (leg["launches"]["observe_hist"] != parts or leg["launches"]["pack_rows"] != 2 * parts
            or set(k1) != {"0", "1"} or set(k2) != {"0", "1"}):
        raise AssertionError(f"4o (pool): launches {leg['launches']} per slot "
                             f"{leg['slot_launches']} for {parts} parts")
    pw = leg["device_spans"].get(tele.SPAN_POOL_PREWARM_COMPILE, {})
    if set(pw) != {"0", "1"} or len(set(pw.values())) != 1:
        raise AssertionError(f"4o (pool): prewarm spans per slot {pw}")
    if leg["counters"].get(tele.C_COMPILE_IN_WINDOW, 0) != 0:
        raise AssertionError(f"4o (pool): first launches inside a window: {leg['counters']}")
    # (ii) the mesh: every window's rows split over the two slots
    shards = len(POOL_SLOTS)
    expect_k1 = shards * parts
    _log(f"4o (mesh): expecting kernel 1 launched shards x windows = {shards} x {parts} "
         f"= {expect_k1} times, kernel 2 {2 * expect_k1}")
    leg = res["mesh"] = _leg("mesh", sam, out_dir, main_hashes, device_pool=_pool(),
                             partitioner="mesh")
    if (leg["counters"].get(tele.C_MESH_DISPATCHED, 0) <= 0
            or leg["stats"]["partitioner"] != "mesh"
            or leg["launches"]["observe_hist"] != expect_k1
            or leg["launches"]["pack_rows"] != 2 * expect_k1):
        raise AssertionError(f"4o (mesh): {leg['counters']}, launches {leg['launches']}")
    res["mesh"]["expected_observe_hist"] = expect_k1
    # (iii) slot 1's dispatch fails for good: evicted, its window replayed
    spec = "device.dispatch=permanent,device=1,times=1"
    leg = res["evict"] = _leg("evict", sam, out_dir, main_hashes, spec=spec,
                              device_pool=_pool())
    if (leg["counters"].get(tele.C_DEVICE_EVICTED) != 1
            or not leg["spans"].get(tele.SPAN_POOL_REPLAY)):
        raise AssertionError(f"4o (evict): {leg['counters']}, spans {leg['spans']}")
    res["evict"]["spec"] = spec
    # (iv) a mesh dispatch fails for good mid-run: the pool takes over
    spec = "device.dispatch=permanent,device=mesh,after=6,times=1"
    leg = res["degrade"] = _leg("degrade", sam, out_dir, main_hashes, spec=spec,
                                device_pool=_pool(), partitioner="mesh")
    if (leg["counters"].get(tele.C_MESH_DEGRADED) != 1
            or leg["stats"]["partitioner"] != "pool"):
        raise AssertionError(f"4o (degrade): {leg['counters']}, {leg['stats']['partitioner']}")
    res["degrade"]["spec"] = spec
    # (v) the SDC audit: every window checked against the CPU, one fetched
    # column corrupted -> its slot on probation, the window replayed
    spec = "device.fetch=corrupt,pass=apply,times=1,seed=3"
    leg = res["audit"] = _leg("audit", sam, out_dir, main_hashes, spec=spec,
                              env={"ADAM_TPU_AUDIT_RATE": "1"}, device_pool=_pool())
    c = leg["counters"]
    if (c.get(tele.C_AUDIT_MISMATCH) != 1 or c.get(tele.C_HEALTH_PROBATION) != 1
            or not leg["spans"].get(tele.SPAN_AUDIT_CHECK)
            or not leg["spans"].get(tele.SPAN_POOL_REPLAY)):
        raise AssertionError(f"4o (audit): {c}, spans {leg['spans']}")
    res["audit"]["spec"] = spec
    health_mod.reset_board()
    return res


def _one_device_slot():
    from adam_tpu_torch.parallel import device_pool as dp

    return dp.make_slots(["cuda:0"])


def check_collectives(work: str) -> dict:
    """Phase 4o (vi): each ``parallel/dist.py`` function over a two-slot
    ``LocalMesh`` on the card, on 65,536 reads, equal to its one-slot
    result; then ``distributed_observe`` over a one-rank NCCL
    ``ProcessMesh`` (its i64 all-reduce), equal to the local one."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    from adam_tpu_torch.io import context
    from adam_tpu_torch.ops.mdtag import batch_md_arrays
    from adam_tpu_torch.parallel import dist as d
    from adam_tpu_torch.parallel.mesh import LocalMesh, ProcessMesh, initialize_distributed
    from adam_tpu_torch.pipelines import bqsr
    from make_wgs_sam import make_wgs

    sam = os.path.join(work, "collectives.sam")
    make_wgs(sam, COLLECTIVE_READS, 100, seed=SEED + 2)
    ds = context.load_alignments(sam)
    b = ds.batch.to_numpy()
    is_mm, _, has_md = batch_md_arrays(b, ds.sidecar, need_ref_codes=False)
    read_ok = bqsr.observe_read_mask(b, has_md)
    res_ok = bqsr.observe_residue_mask(ds, b)
    n_rg = len(ds.read_groups) + 1
    rng = np.random.default_rng(SEED)
    keys = rng.integers(0, 2**40, 2 * (COLLECTIVE_READS // 2)).astype(np.int64)
    payload = {"row": np.arange(keys.size, dtype=np.int64)}
    chunks = np.asarray(b.bases[:2, :64])
    two, one = LocalMesh(_pool().devices), LocalMesh(_one_device_slot())

    def sorted_rows(k, rows, v):
        return k[v], rows["row"][v]

    def real(keys_out):
        flat = keys_out.ravel()
        return flat[flat != np.iinfo(np.int64).max]

    def equal(a, b):
        if isinstance(a, tuple):
            return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
        if isinstance(a, np.ndarray):
            return bool(np.array_equal(a, b))
        return a == b

    calls = {
        "flagstat": lambda m: tuple(str(x) for x in d.distributed_flagstat(ds.batch, m)),
        "count_kmers": lambda m: d.distributed_count_kmers(ds.batch, 21, m),
        "markdup": lambda m: np.asarray(d.distributed_markdup(ds, m).batch.to_numpy().flags),
        "observe": lambda m: d.distributed_observe(ds.batch, res_ok, is_mm, read_ok, n_rg, m),
        "sort_keys": lambda m: real(d.distributed_sort_keys(keys, m)),
        "sort_rows": lambda m: sorted_rows(*d.distributed_sort_rows(keys, payload, m)),
    }
    out = {}
    for name, fn in calls.items():
        t0 = time.monotonic()
        got = fn(two)
        wall = time.monotonic() - t0
        if not equal(got, fn(one)):
            raise AssertionError(f"4o (vi) {name}: two slots and one slot differ")
        out[name] = {"wall_s": wall, "equal": True}
    t0 = time.monotonic()
    halo = d.halo_exchange_right(chunks, two, 8)
    out["halo"] = {"wall_s": time.monotonic() - t0,
                   "equal": bool(np.array_equal(halo[0, 64:], chunks[1, :8])
                                 and np.array_equal(halo[:, :64], chunks))}
    if not out["halo"]["equal"]:
        raise AssertionError("4o (vi) halo: shard 0 did not get shard 1's head")
    t_one, m_one = calls["observe"](one)
    if t_one.dtype != np.int64 or int(t_one.sum()) <= 0:
        raise AssertionError(f"4o (vi) observe: {t_one.dtype} {t_one.sum()}")
    # one NCCL rank: the all-reduce of the observe histograms in i64 (a
    # file store in the work directory: no port to pick)
    initialize_distributed(f"file://{os.path.join(work, 'nccl.store')}", world_size=1,
                           rank=0, backend="nccl")
    try:
        torch.cuda.set_device(0)
        t0 = time.monotonic()
        t_p, m_p = d.distributed_observe(ds.batch, res_ok, is_mm, read_ok, n_rg,
                                         ProcessMesh())
        out["observe_nccl"] = {"wall_s": time.monotonic() - t0, "backend": "nccl",
                               "equal": bool(np.array_equal(t_p, t_one)
                                             and np.array_equal(m_p, m_one))}
    finally:
        tdist.destroy_process_group()
    if not out["observe_nccl"]["equal"]:
        raise AssertionError("4o (vi) observe over one NCCL rank differs from the local one")
    os.unlink(sam)
    _log("4o (vi) collectives over two slots of the card equal to one slot "
         f"({COLLECTIVE_READS} reads): " + ", ".join(
             f"{k} {v['wall_s']:.3f} s" for k, v in out.items()))
    return out


def check_parity_pool_mesh(work: str, sam: str) -> dict:
    """Phase 5's pool and mesh legs: two slots on the card against two CPU
    slots, 65,536 reads in windows of 16,384, each equal to the one-device
    CPU run."""
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    ref_dir = os.path.join(work, "pm.one.cpu")
    transform_streamed(sam, ref_dir, window_reads=PARITY_POOL_WINDOW, device="cpu")
    ref = _part_hashes(ref_dir)
    shutil.rmtree(ref_dir)
    out = {}
    for mode in ("pool", "mesh"):
        for dev, slots in (("cuda", POOL_SLOTS), ("cpu", ("cpu", "cpu"))):
            d = os.path.join(work, f"pm.{mode}.{dev}")
            st = transform_streamed(sam, d, window_reads=PARITY_POOL_WINDOW,
                                    partitioner=mode, device_pool=_pool(slots))
            got = _part_hashes(d)
            shutil.rmtree(d)
            if not got or got != ref or st["partitioner"] != mode:
                raise AssertionError(f"phase 5 {mode} on {dev}: parts differ from the "
                                     f"one-device CPU run ({st['partitioner']})")
        out[mode] = len(ref)
        _log(f"card vs CPU ({mode}, two slots each): {len(ref)} parts byte-identical, "
             f"and to the one-device CPU run ({PARITY_READS} reads)")
    return out


# ---------------------------------------------------------------------------
# 4p. the transform service on the card: four jobs of two tenants through
# the scheduler, the coalescer and the gateway
# ---------------------------------------------------------------------------
SERVICE_READS = 262_144     # per job: four jobs hold the main path's 1,048,576
SERVICE_WINDOW = 65_536
SERVICE_JOBS = (("A1", "A", 2.0, 11), ("A2", "A", 2.0, 12),
                ("B1", "B", 1.0, 13), ("B2", "B", 1.0, 14))
SERVICE_LANES = 6           # read groups: six lanes of two libraries
PARITY_SERVICE_READS = 16_384
PARITY_SERVICE_WINDOW = 4_096


def rewrite_read_groups(path: str, lanes: int = SERVICE_LANES) -> None:
    """Put a SAM's reads onto ``lanes`` read groups, as a multi-lane
    sample has them: lanes 1-3 of library lib1, 4-6 of lib2, each read
    (both mates, by its name's CRC) on one lane."""
    import zlib

    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    head, body = [], []
    for ln in lines:
        if not ln:
            continue
        if ln.startswith(b"@"):
            if not ln.startswith(b"@RG"):
                head.append(ln)
            continue
        f = ln.split(b"\t")
        lane = zlib.crc32(f[0]) % lanes + 1
        body.append(b"\t".join([x for x in f if not x.startswith(b"RG:Z:")]
                               + [b"RG:Z:lane%d" % lane]))
    head += [b"@RG\tID:lane%d\tSM:sample\tLB:lib%d\tPL:ILLUMINA" % (k, 1 + (k - 1) * 2 // lanes)
             for k in range(1, lanes + 1)]
    with open(path, "wb") as fh:
        fh.write(b"\n".join(head + body) + b"\n")


def make_service_sam(path: str, n_reads: int, seed: int) -> str:
    """One service job's input (a worker process's task): ``make_wgs`` at
    ``seed``, then six read groups."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tools"))
    from make_wgs_sam import make_wgs

    make_wgs(path, n_reads, 100, seed=seed)
    rewrite_read_groups(path)
    return path


def start_service_inputs(work: str):
    """Start the 4p and phase-5 service inputs in four worker processes
    -> (executor, {job: future}) for :func:`service_inputs`."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    ex = ProcessPoolExecutor(max_workers=4, mp_context=multiprocessing.get_context("spawn"))
    futs = {jid: ex.submit(make_service_sam, os.path.join(work, f"svc.{jid}.sam"),
                           SERVICE_READS, seed) for jid, _t, _w, seed in SERVICE_JOBS}
    for jid, seed in (("P1", 15), ("P2", 16)):
        futs[jid] = ex.submit(make_service_sam, os.path.join(work, f"svc.{jid}.sam"),
                              PARITY_SERVICE_READS, seed)
    return ex, futs


def service_inputs(started) -> dict:
    """Wait for the inputs; stop the worker processes."""
    ex, futs = started
    try:
        return {jid: f.result(timeout=600) for jid, f in futs.items()}
    finally:
        ex.shutdown(wait=True)


def _specs(JobSpec, sams: dict, out: str, jobs=SERVICE_JOBS, window=SERVICE_WINDOW) -> list:
    return [JobSpec(job_id=jid, input=sams[jid], output=os.path.join(out, jid),
                    tenant=tenant, weight=weight, window_reads=window)
            for jid, tenant, weight, _seed in jobs]


def _wait_first_part(out: str, jobs, timeout_s: float = 300.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        for jid, *_ in jobs:
            d = os.path.join(out, jid)
            if os.path.isdir(d) and any(f.startswith("part-") for f in os.listdir(d)):
                return
        time.sleep(0.005)
    raise AssertionError("4p (iv): no part was published")


def _gateway_leg(svc, specs: list, solo: dict, out: str) -> dict:
    """4p (iii): each job submitted twice with one key by its own client
    thread (the same reply), its event stream followed to the end, its
    parts fetched over HTTP; job A1's first part is resumed by Range from
    its first half, as a killed client leaves it."""
    import threading

    from adam_tpu_torch.gateway import GatewayClient, GatewayServer

    gw = GatewayServer(svc, "127.0.0.1", 0)
    gw.start()
    got, errors = {}, []

    def one(spec):
        try:
            c = GatewayClient(gw.url)
            doc = {k: v for k, v in spec.to_doc().items() if k != "trace_id"}
            first = c.submit_with_retry(spec.job_id, doc, deadline_s=300)
            again = c.submit(spec.job_id, doc)
            if (again.get("trace_id") != first.get("trace_id")
                    or again.get("job_id") != first.get("job_id") or not again.get("duplicate")):
                raise AssertionError(f"resubmission of {spec.job_id}: {first} then {again}")
            lines = 0
            final = None
            for _cur, line in c.events(spec.job_id):
                lines += 1
                final = line
            if not (final and final.get("done") and final.get("ok")):
                raise AssertionError(f"{spec.job_id}'s event stream ended with {final}")
            dest = os.path.join(out, f"fetched.{spec.job_id}")
            resumed = 0
            if spec.job_id == "A1":
                name = sorted(solo[spec.job_id])[0]
                os.makedirs(dest, exist_ok=True)
                with open(os.path.join(spec.output, name), "rb") as fh:
                    data = fh.read()
                resumed = len(data) // 2
                with open(os.path.join(dest, name + ".fetch-tmp"), "wb") as fh:
                    fh.write(data[:resumed])
            fetched = c.fetch(spec.job_id, dest)
            got[spec.job_id] = {"events": lines, "resumed_from": resumed,
                                "fetched": {n: _file_hash(p) for n, p in fetched.items()}}
        except Exception as e:  # raised below
            errors.append((spec.job_id, e))

    threads = [threading.Thread(target=one, args=(s,)) for s in specs]
    try:
        for t in threads:
            t.start()
    finally:
        for t in threads:
            t.join(600)
        gw.close()
    if any(t.is_alive() for t in threads) or errors:
        raise AssertionError(f"4p (iii): {errors or 'a client thread hung'}")
    for jid, g in got.items():
        if g["fetched"] != solo[jid]:
            raise AssertionError(f"4p (iii): {jid}'s fetched parts differ from its solo run")
    return got


def check_service(work: str, sams: dict, smi: str) -> dict:
    """Phase 4p: each job's solo run, then the five service legs, each
    with its counts reset; every job's parts must be its solo run's."""
    from adam_tpu_torch.api.transform_service import TransformService
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.pipelines.streamed import transform_streamed
    from adam_tpu_torch.serve import JobSpec
    from adam_tpu_torch.utils import compile_ledger, faults
    from adam_tpu_torch.utils import telemetry as tele

    n_reads = SERVICE_READS * len(SERVICE_JOBS)
    solo, solo_s = {}, {}
    for jid, *_ in SERVICE_JOBS:
        d = os.path.join(work, f"svc.solo.{jid}")
        st = transform_streamed(sams[jid], d, window_reads=SERVICE_WINDOW, device="cuda")
        solo[jid] = _part_hashes(d)
        solo_s[jid] = st["total_s"]
        shutil.rmtree(d)
    _log(f"4p solo runs ({SERVICE_READS} reads each, windows of {SERVICE_WINDOW}, "
         f"{SERVICE_LANES} read groups): total_s {solo_s}")
    out = {"solo_total_s": solo_s}

    def leg(name, batching, run, spec=None):
        root = os.path.join(work, f"svc.{name}")
        _reset_telemetry()
        kernels.reset_launches()
        compile_ledger.reset()
        if spec:
            faults.install(spec)
        svc = TransformService(root, max_jobs=4, batching=batching, device="cuda")
        t0 = time.monotonic()
        try:
            extra = run(svc, root) or {}
            wall = time.monotonic() - t0
            states = extra.pop("final_states", None) or {
                j: v["state"] for j, v in svc.status()["jobs"].items()}
            coal = svc.scheduler._coalescer
            groups = (coal.largest_groups() if coal is not None
                      else extra.pop("largest_group", {}))
        finally:
            faults.clear()
            svc.close()
        c = dict(tele.TRACE.counters_and_gauges()[0])
        rec = {
            "wall_s": wall, "reads_per_s": n_reads / wall, "states": states,
            "launches": kernels.launches(), "prewarm_launches": kernels.prewarm_launches(),
            "variant_launches": kernels.variant_launches(),
            "batch": {k: c.get(f"sched.batch.{k}", 0)
                      for k in ("dispatches", "windows", "fallbacks")},
            "largest_group": groups,
            "compile_in_window": c.get("device.compile.in_window", 0), **extra,
        }
        _reset_telemetry()
        for jid, *_ in SERVICE_JOBS:
            got = _part_hashes(os.path.join(root, "out", jid))
            if got != solo[jid]:
                raise AssertionError(f"4p ({name}): {jid}'s parts differ from its solo run")
        if set(states.values()) != {"done"}:
            raise AssertionError(f"4p ({name}): job states {states}")
        _log(f"4p ({name}): {wall:.3f} s, {rec['reads_per_s']:.0f} reads/s ({smi}); "
             f"launches observe_hist {rec['launches']['observe_hist']} pack_rows "
             f"{rec['launches']['pack_rows']} (prewarm {rec['prewarm_launches']}); "
             f"sched.batch {rec['batch']}; largest fused groups {groups}; "
             f"device.compile.in_window {rec['compile_in_window']}"
             + (f"; {extra}" if extra else "") + "; every job's parts are its solo run's")
        shutil.rmtree(root)
        return rec

    def submit_all(svc, root):
        for spec in _specs(JobSpec, sams, os.path.join(root, "out")):
            got = svc.submit(spec)
            if type(got).__name__ != "Admitted":
                raise AssertionError(f"4p: {spec.job_id} refused: {got}")
        if not svc.wait(timeout=900):
            raise AssertionError("4p: the jobs did not finish")

    def through_gateway(svc, root):
        specs = _specs(JobSpec, sams, os.path.join(root, "out"))
        got = _gateway_leg(svc, specs, solo, root)
        if not svc.wait(timeout=900):
            raise AssertionError("4p (iii): the jobs did not finish")
        return {"clients": {j: {k: v for k, v in g.items() if k != "fetched"}
                            for j, g in got.items()}}

    def drain_then_recover(svc, root):
        specs = _specs(JobSpec, sams, os.path.join(root, "out"))
        for spec in specs:
            svc.submit(spec)
        _wait_first_part(os.path.join(root, "out"), SERVICE_JOBS)
        if not svc.drain(timeout=900):
            raise AssertionError("4p (iv): the drain did not settle")
        drained = {j: v["state"] for j, v in svc.status()["jobs"].items()}
        groups = svc.scheduler._coalescer.largest_groups()
        svc.close()
        again = TransformService(root, max_jobs=4, batching=True, device="cuda")
        try:
            resumed = again.recover()
            if not again.wait(timeout=900):
                raise AssertionError("4p (iv): the recovered jobs did not finish")
            after = {j: v["state"] for j, v in again.status()["jobs"].items()}
        finally:
            again.close()
        if set(after.values()) != {"done"} or "interrupted" not in drained.values():
            raise AssertionError(f"4p (iv): drained {drained}, after recovery {after}")
        return {"drained_states": drained, "resumed": sorted(resumed), "final_states": after,
                "largest_group": groups}

    out["unbatched"] = leg("i.unbatched", False, submit_all)
    out["batched"] = leg("ii.batched", True, submit_all)
    out["gateway"] = leg("iii.gateway", True, through_gateway)
    out["drain_recover"] = leg("iv.drain_recover", True, drain_then_recover)
    out["batch_fault"] = leg("v.batch_fault", True, submit_all, spec="sched.batch=transient,times=1")
    for name in ("batched", "gateway"):
        if out[name]["batch"]["fallbacks"] != 0 or out[name]["batch"]["dispatches"] == 0:
            raise AssertionError(f"4p ({name}): sched.batch {out[name]['batch']}")
    if out["batch_fault"]["batch"]["fallbacks"] < 1:
        raise AssertionError(f"4p (v): no fallback: {out['batch_fault']['batch']}")
    k1 = {n: out[n]["launches"]["observe_hist"] for n in ("unbatched", "batched")}
    if not k1["batched"] < k1["unbatched"]:
        raise AssertionError(f"4p: batching launched kernel 1 {k1['batched']} times, "
                             f"unbatched {k1['unbatched']}")
    # the drain leg's count covers the jobs' first attempts and the recovery
    for name in ("unbatched", "batched", "gateway", "batch_fault"):
        if out[name]["launches"]["observe_hist"] < 1 or out[name]["launches"]["pack_rows"] < 2:
            raise AssertionError(f"4p ({name}): launches {out[name]['launches']}")
    return out


def check_parity_service(sams: dict, work: str) -> dict:
    """Phase 5's service leg: two jobs of 16,384 reads in windows of 4,096
    through the scheduler, batched and unbatched, on the card and on the
    CPU: every job's parts byte-identical across the four runs."""
    from adam_tpu_torch.api.transform_service import TransformService
    from adam_tpu_torch.serve import JobSpec

    jobs = (("P1", "A", 2.0, 15), ("P2", "B", 1.0, 16))
    hashes = {}
    for device in ("cuda", "cpu"):
        for batching in (False, True):
            root = os.path.join(work, f"psvc.{device}.{int(batching)}")
            svc = TransformService(root, max_jobs=2, batching=batching, device=device)
            try:
                for spec in _specs(JobSpec, sams, os.path.join(root, "out"), jobs,
                                   PARITY_SERVICE_WINDOW):
                    svc.submit(spec)
                if not svc.wait(timeout=600):
                    raise AssertionError("phase 5 service leg: the jobs did not finish")
            finally:
                svc.close()
            hashes[(device, batching)] = {j: _part_hashes(os.path.join(root, "out", j))
                                          for j, *_ in jobs}
            shutil.rmtree(root)
    ref = hashes[("cuda", False)]
    if not all(ref[j] for j in ref) or any(h != ref for h in hashes.values()):
        raise AssertionError("phase 5 service leg: parts differ across device and batching")
    n = sum(len(v) for v in ref.values())
    _log(f"card vs CPU (service, 2 jobs of {PARITY_SERVICE_READS} reads, batched and "
         f"unbatched): {n} parts byte-identical across the four runs")
    return {"parts": n}


def _part_hashes(d: str) -> dict:
    out = {}
    for f in sorted(os.listdir(d)):
        if f.startswith("part-"):
            with open(os.path.join(d, f), "rb") as fh:
                out[f] = hashlib.sha256(fh.read()).hexdigest()
    return out


def main() -> int:
    import torch


    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    sys.path.insert(0, os.path.join(here, "tools"))
    from make_known_indels_vcf import make_known_indels_vcf
    from make_wgs_sam import make_wgs

    from adam_tpu_torch import native
    from adam_tpu_torch.device import resolve_device
    from adam_tpu_torch.ops import kernels
    from adam_tpu_torch.utils import compile_ledger

    # ---- 1. the card ----------------------------------------------------
    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = _smi()
    _log(f"device: {kind} (count {torch.cuda.device_count()})")
    _log(f"nvidia-smi: {smi}")
    rate = issue_rate()
    _log(f"issue rate: {rate['sms']} SMs x {LANES_PER_SM} lanes x "
         f"{rate['sm_clock_max_mhz']} MHz (clocks.max.sm) = {rate['ops_per_s']:.6g} ops/s")

    # ---- 2. build -------------------------------------------------------
    t0 = time.monotonic()
    secs = kernels.build()
    _log(f"kernels built in {time.monotonic() - t0:.2f} s (per source: "
         + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()) + ")")
    t0 = time.monotonic()
    native.lib()
    _log(f"native codecs built in {time.monotonic() - t0:.2f} s")

    # ---- 3. kernels vs plain versions -----------------------------------
    kern = check_kernels(dev) + check_sw_score(dev, rate=rate)
    # kernel 1 once more at the dataset-level transform's shape: the whole
    # 1,048,576-read dataset in one launch (g = grid_rows(N))
    t, g, gl = _kernel_inputs(dev, MAIN_READS)
    in_memory = check_observe(t, g, gl)
    del t
    torch.cuda.empty_cache()
    in_memory["x_bound"] = in_memory["ms"] / in_memory["bound_ms"]
    _log(f"kernel observe_hist at the in-memory shape {in_memory['shape']}: equal="
         f"{in_memory['equal']} {in_memory['ms']:.4f} ms (plain {in_memory['plain_ms']:.4f}"
         f" ms, library {in_memory['library_ms']:.4f} ms, bound {in_memory['bound_ms']:.4f}"
         f" ms by bytes, {in_memory['residues_counted']} residues)")
    if not in_memory["equal"]:
        raise AssertionError(f"observe_hist disagrees with its plain version at "
                             f"{in_memory['shape']}: {in_memory}")
    kern[0]["in_memory"] = {k: in_memory[k] for k in (
        "shape", "equal", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by", "x_bound", "residues_counted")}
    # kernel 1 at the service's fused shape (4p): 8 windows of 65,536 rows
    # of jobs with 7 read-group bins each, n_rg = 56 (5,264 slabs: past
    # kGroup, so the kernel's grouped route)
    import numpy as np

    t, g, gl = _kernel_inputs(dev, 8 * SERVICE_WINDOW)
    t["rg"] = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        -1, 55, g).astype(np.int32)).to(dev)
    fused = check_observe(t, g, gl, n_rg=8 * (SERVICE_LANES + 1))
    del t
    torch.cuda.empty_cache()
    fused["x_bound"] = fused["ms"] / fused["bound_ms"]
    _log(f"kernel observe_hist at the service's fused shape {fused['shape']}: equal="
         f"{fused['equal']} {fused['ms']:.4f} ms (plain {fused['plain_ms']:.4f} ms, library "
         f"{fused['library_ms']:.4f} ms, bound {fused['bound_ms']:.4f} ms by bytes, "
         f"{fused['residues_counted']} residues)")
    if not fused["equal"]:
        raise AssertionError(f"observe_hist disagrees with its plain version at "
                             f"{fused['shape']}: {fused}")
    kern[0]["fused"] = {k: fused[k] for k in (
        "shape", "equal", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by", "x_bound", "residues_counted")}
    for k in kern:
        _log(f"kernel {k['name']}: equal={k['equal']} {k['ms']:.4f} ms "
             f"(plain {k['plain_ms']:.4f} ms, library {k['library_ms']}, "
             f"bound {k['bound_ms']:.4f} ms by {k['bound_by']})"
             + (f", {k['gcups']:.2f} GCUPS (benchmark_gcups {k['benchmark_gcups']:.2f}, "
                f"{k['launches']} launches)" if "gcups" in k else "")
             + (f", unfused sanger_body + pack {k['unfused_ms']:.4f} ms"
                if "unfused_ms" in k else ""))
    for k in kern:
        if not k["equal"]:
            raise AssertionError(f"kernel {k['name']} disagrees with its plain version: {k}")

    work = tempfile.mkdtemp(prefix="adam_tpu_torch_smoke_")
    try:
        # ---- 4. main path: markdup + realign + BQSR ------------------------
        sam = os.path.join(work, "wgs.sam")
        snps_vcf = os.path.join(work, "wgs.snps.vcf")
        t0 = time.monotonic()
        # the known-sites VCF is written beside the SAM; the SAM does not
        # depend on it, and only phases 4c-4d read it
        make_wgs(sam, MAIN_READS, 100, seed=SEED, known_sites_out=snps_vcf)
        _log(f"generated {MAIN_READS} reads in {time.monotonic() - t0:.1f} s")
        out_dir = os.path.join(work, "wgs.adam")
        kernels.reset_launches()
        stats = run_transform(sam, out_dir, "cuda")
        launched = kernels.launches()
        variants = kernels.variant_launches()
        _log("main path stats: " + json.dumps(stats, sort_keys=True))
        n_win = stats["n_windows"]
        got = read_parts(out_dir)
        if stats["n_parts"] != n_win + 1 or got["parts"] != n_win + 1:
            raise AssertionError(f"{got['parts']} parts ({stats['n_parts']} in the stats) "
                                 f"for {n_win} windows plus the realigned part")
        if got["rows"] != MAIN_READS or stats["n_reads"] != MAIN_READS:
            raise AssertionError(f"wrote {got['rows']} rows for {MAIN_READS} input reads")
        if got["duplicates"] == 0 or got["realigned_rows"] == 0:
            raise AssertionError(f"no duplicate or no realigned row: {got}")
        if launched["observe_hist"] < n_win + 1 or launched["pack_rows"] != 2 * (n_win + 1):
            raise AssertionError(f"launches {launched} for {n_win} windows + 1 part")
        if (variants.get("pack_rows:sanger") != n_win + 1
                or variants.get("pack_rows:base_decode") != n_win + 1):
            raise AssertionError(f"pack_rows encode launches {variants}")
        if launched["sw_fill"] != 0:
            raise AssertionError("sw_fill ran on the reads-model path")
        _log(f"main path: {got}, {stats['reads_per_s']:.0f} reads/s, launches {launched}")
        _log(f"main path writer pool: write_wait_s {stats['write_wait_s']:.3f}, "
             f"{stats['writer_shards']} write shards, final admission bound "
             f"{stats['writer_inflight_bound']}")
        main_dups = got["duplicates"]
        by_name = {k["name"]: k for k in kern}
        for name in ("observe_hist", "pack_rows"):  # pack_rows: both encodes
            by_name[name]["launches"] = launched[name]
        by_name["pack_rows_sanger"]["launches"] = variants["pack_rows:sanger"]
        # the main path's parts stay for 4e's row check and 4f's k-mers
        main_adam = os.path.join(work, "main.adam")
        os.rename(out_dir, main_adam)
        main_hashes = _part_hashes(main_adam)
        prof = profile_transform(sam, out_dir)
        _log("main path under the profiler: " + json.dumps(prof, sort_keys=True))
        shutil.rmtree(out_dir)

        # the markdup + BQSR path without realignment, same input
        kernels.reset_launches()
        plain_stats = run_transform(sam, out_dir, "cuda", realign=False)
        plain_launched = kernels.launches()
        got = read_parts(out_dir)
        if (got["rows"] != MAIN_READS or got["parts"] != plain_stats["n_windows"]
                or plain_launched["pack_rows"] != 2 * plain_stats["n_windows"]):
            raise AssertionError(f"no-realign path: {got}, launches {plain_launched}")
        _log(f"no-realign path: {got}, {plain_stats['reads_per_s']:.0f} reads/s, "
             f"launches {plain_launched}")
        shutil.rmtree(out_dir)

        # ---- 4h. the durable run: the journal, kill and resume -------------
        durable = check_durable_run(work, sam, main_hashes, n_win)
        _log(f"4h journaled run ({durable['journaled']['position']}): total_s "
             f"{durable['journaled']['stats']['total_s']:.3f} against phase 4's first run "
             f"{stats['total_s']:.3f} (1st) and its profiled rerun {prof.get('total_s')} "
             f"(2nd); {durable['journaled']['obs_sidecars']} observe sidecars, "
             f"launches {durable['journaled']['launches']}")
        for leg in ("pass_c", "barrier2_entry"):
            d = durable[leg]
            _log(f"4h kill at {leg} ({d['killed']['spec']}): killed after "
                 f"{d['killed']['killed_after_s']:.3f} s with {d['killed']['parts_left']} "
                 f"parts published, {d['killed']['journaled_parts']} journaled; resume "
                 f"({d['position']}) total_s {d['stats']['total_s']:.3f} against the "
                 f"uninterrupted {stats['total_s']:.3f} and journaled "
                 f"{durable['journaled']['stats']['total_s']:.3f}; "
                 f"{d['stats']['windows_resumed']} parts resumed, "
                 f"{d['stats']['windows_fresh']} fresh, launches {d['launches']}; "
                 f"parts byte-identical to phase 4's")
        for name in ("observe_hist", "pack_rows"):
            by_name[name]["launches_journaled"] = durable["journaled"]["launches"][name]
            by_name[name]["launches_resume"] = {
                leg: durable[leg]["launches"][name] for leg in ("pass_c", "barrier2_entry")}

        # ---- 4n. telemetry and the observability flags ---------------------
        t0 = time.monotonic()
        observ = check_observability(work, sam, main_hashes, launched)
        observ["phase_s"] = time.monotonic() - t0
        _log(f"4n: every flag on: parts byte-identical to phase 4's, launches "
             f"{observ['launches']}, {observ['stats']['reads_per_s']:.0f} reads/s (profiled); "
             f"stats line == streamed_stats_view(--metrics-json); report device 0 busy_frac "
             f"{observ['report_busy_frac']} (host intervals of device-attributed spans) "
             f"against the profiler's device busy share "
             f"{observ['profiler']['busy_share']:.6f} ({observ['profiler']['device_events']} "
             f"kernel/copy/set intervals, {observ['profiler']['device_busy_s']:.4f} s of "
             f"{observ['stats']['total_s']:.3f} s); heartbeat {observ['heartbeat_lines']} "
             f"lines, card memory up to {observ['hbm_bytes_in_use_max']} B")
        _log("4n timer table: " + " | ".join(r.strip() for r in observ["timer_rows"]))
        med = observ["median_reads_per_s"]
        _log(f"4n recording cost ({smi}): median of {RECORDING_TURNS} in turns, "
             f"off {med['off']:.1f} reads/s, on (every flag but --xprof-dir) "
             f"{med['on']:.1f} reads/s; runs off {observ['reads_per_s']['off']}, on "
             f"{observ['reads_per_s']['on']}; {observ['phase_s']:.1f} s in all")
        for name in ("observe_hist", "pack_rows"):
            by_name[name]["launches_observability"] = observ["launches"][name]

        # ---- 4o. multi-device: pool, mesh, eviction, degrade, audit --------
        t0 = time.monotonic()
        multi = check_multi_device(work, sam, main_hashes, n_win)
        multi["collectives"] = check_collectives(work)
        multi["phase_s"] = time.monotonic() - t0
        main_rate = stats["reads_per_s"]
        _log(f"4o: {multi['phase_s']:.1f} s in all ({smi}); reads/s pool "
             f"{multi['pool']['stats']['reads_per_s']:.0f}, mesh "
             f"{multi['mesh']['stats']['reads_per_s']:.0f}, beside phase 4's one device "
             f"{main_rate:.0f} (its first run) and 4h's journaled run "
             f"{durable['journaled']['stats']['reads_per_s']:.0f}; two slots share one "
             f"card, so this is no measure of scaling across cards")
        for name in ("observe_hist", "pack_rows"):
            for leg in ("pool", "mesh", "evict", "degrade", "audit"):
                by_name[name][f"launches_{leg}"] = multi[leg]["launches"][name]

        # ---- 4p. the transform service: scheduler, coalescer, gateway ------
        # its inputs and phase 5's, made by four worker processes here, so
        # that no measured phase shares the host with them
        t0 = time.monotonic()
        svc_sams = service_inputs(start_service_inputs(work))
        _log(f"generated the service inputs ({len(SERVICE_JOBS)} x {SERVICE_READS} reads and "
             f"2 x {PARITY_SERVICE_READS}, {SERVICE_LANES} read groups) in "
             f"{time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        service = check_service(work, svc_sams, smi)
        service["phase_s"] = time.monotonic() - t0
        _log(f"4p: {service['phase_s']:.1f} s in all ({smi})")
        legs = ("unbatched", "batched", "gateway", "drain_recover", "batch_fault")
        for name in ("observe_hist", "pack_rows"):
            by_name[name]["launches_service"] = {
                leg: service[leg]["launches"][name] for leg in legs}
        by_name["pack_rows_sanger"]["launches_service"] = {
            leg: service[leg]["variant_launches"].get("pack_rows:sanger", 0) for leg in legs}
        kern[0]["fused"]["launches_service"] = by_name["observe_hist"]["launches_service"]
        for jid, *_ in SERVICE_JOBS:
            os.unlink(svc_sams[jid])

        # ---- 4b. the smithwaterman consensus model ------------------------
        sw_sam = sam
        if SW_READS != MAIN_READS:
            sw_sam = os.path.join(work, "sw.sam")
            make_wgs(sw_sam, SW_READS, 100, seed=SEED)
        kernels.reset_launches()
        sw_stats, shapes = run_smithwaterman(sw_sam, out_dir, "cuda")
        sw_launched = kernels.launches()
        sw_routes = {k: v for k, v in kernels.variant_launches().items()
                     if k.startswith("sw_fill:")}
        _log("smithwaterman stats: " + json.dumps(sw_stats, sort_keys=True))
        got = read_parts(out_dir)
        if (sw_launched["sw_fill"] < 1 or sw_launched["sw_fill"] != len(shapes)
                or sum(sw_routes.values()) != len(shapes)):
            raise AssertionError(f"sw_fill launches {sw_launched} ({sw_routes}) "
                                 f"vs {len(shapes)} calls")
        if got["rows"] != SW_READS or got["parts"] != sw_stats["n_windows"] + 1:
            raise AssertionError(f"smithwaterman path: {got}")
        _log(f"smithwaterman path: {got}, {sw_stats['reads_per_s']:.0f} reads/s, "
             f"launches {sw_launched} (routes {sw_routes}); sw_fill (B, lx, ly) per "
             f"launch: {shapes}")
        shutil.rmtree(out_dir)
        if sw_sam != sam:
            os.unlink(sw_sam)
        median = sorted(shapes, key=lambda t: t[0] * (t[1] + t[2] + 1) * (t[1] + 1))[
            len(shapes) // 2]
        fill = check_sw_fill(dev, median, sw_launched["sw_fill"], rate=rate,
                             block_shape=SW_BLOCK_SHAPE)
        _log(f"kernel sw_fill at the median launch {median}: equal={fill['equal']} "
             f"{fill['ms']:.4f} ms on the {fill['fill_route']} route (plain "
             f"{fill['plain_ms']:.4f} ms, bound {fill['bound_ms']:.4f} ms by "
             f"{fill['bound_by']}); block route at {SW_BLOCK_SHAPE}: "
             f"{fill['block_route_ms']:.4f} ms; moves.cpu() {fill['moves_cpu_ms']:.4f} ms")
        if not fill["equal"]:
            raise AssertionError(f"kernel sw_fill disagrees with its plain version: {fill}")
        kern.insert(3, fill)

        # ---- 4c-4d. the known-sites path, then its known table -------------
        indels_vcf = os.path.join(work, "wgs.indels.vcf")
        t0 = time.monotonic()
        n_indels = make_known_indels_vcf(sam, indels_vcf)
        _log(f"known indels: {n_indels} (make_known_indels_vcf, "
             f"{time.monotonic() - t0:.1f} s)")
        known = check_known_sites(work, sam, snps_vcf, indels_vcf, "cuda")
        known["known_indels"] = n_indels
        for name in ("observe_hist", "pack_rows"):
            by_name[name]["launches_known_sites"] = known["launches"][name]
            by_name[name]["launches_known_table"] = {
                leg: v["launches"][name] for leg, v in known["table_legs"].items()}
        by_name["pack_rows_sanger"]["launches_known_sites"] = \
            known["variant_launches"]["pack_rows:sanger"]
        table_npz = known.pop("table_npz")

        # ---- 4e. BAM ingest ------------------------------------------------
        bam = check_bam(work, sam, main_adam, "cuda")

        # ---- 4g. the dataset-level transform, flagstat, the restart --------
        dataset = check_dataset_transform(work, sam, snps_vcf, main_dups)
        kern[0]["in_memory"]["launches"] = dataset["launches"]["observe_hist"]
        kern[0]["launches_dataset_restart"] = dataset["restart_launches"]["observe_hist"]

        # ---- 4i. the sharded, out-of-core transform ------------------------
        sharded = check_sharded(work, sam, main_adam)
        for name in ("observe_hist", "pack_rows"):
            by_name[name]["launches_sharded"] = sharded["launches"][name]
        # kernel 1 once more at the sharded path's shape: the largest
        # shard's grid (g = grid_rows of its rows)
        from adam_tpu_torch.formats.batch import grid_rows

        t, g, gl = _kernel_inputs(dev, grid_rows(max(sharded["stats"]["shard_rows"])))
        at_shard = check_observe(t, g, gl)
        del t
        torch.cuda.empty_cache()
        at_shard["x_bound"] = at_shard["ms"] / at_shard["bound_ms"]
        _log(f"kernel observe_hist at the sharded shape {at_shard['shape']}: equal="
             f"{at_shard['equal']} {at_shard['ms']:.4f} ms (plain {at_shard['plain_ms']:.4f}"
             f" ms, library {at_shard['library_ms']:.4f} ms, bound {at_shard['bound_ms']:.4f}"
             f" ms by {at_shard['bound_by']}), {sharded['launches']['observe_hist']} "
             f"launches on 4i")
        if not at_shard["equal"]:
            raise AssertionError(f"observe_hist disagrees with its plain version at "
                                 f"{at_shard['shape']}: {at_shard}")
        kern[0]["sharded"] = {k: at_shard[k] for k in (
            "shape", "equal", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "x_bound", "residues_counted")}
        kern[0]["sharded"]["launches"] = sharded["launches"]["observe_hist"]

        # ---- 4l. the Spark executor on the main path's SAM -----------------
        kernels.reset_launches()
        spark = check_spark_executor(work, sam, snps_vcf)
        kern[0]["launches_spark"] = spark["launches"]["observe_hist"]
        os.unlink(sam)

        # ---- 4m. transform_step on the card --------------------------------
        tstep = check_transform_step(dev)
        kern[0]["launches_transform_step"] = {k: v["launches"] for k, v in tstep.items()}
        for name in ("observe_hist", "pack_rows"):
            by_name[name]["launches_bam"] = bam["launches"][name]
        by_name["pack_rows_sanger"]["launches_bam"] = bam["variant_launches"]["pack_rows:sanger"]

        # ---- 4f. k-mers on the main path's parts ---------------------------
        kmers = check_kmers(work, main_adam, "cuda")

        # ---- 4j. depth and view on the main path's parts -------------------
        depth_view = check_depth_view(main_adam, snps_vcf, main_dups)

        # ---- 4k. the other file formats ------------------------------------
        t0 = time.monotonic()
        other = check_other_formats(work, main_adam, bam["bam_path"])
        other["phase_s"] = time.monotonic() - t0
        _log(f"4k: {other['phase_s']:.1f} s in all; launches {other['launches']}")
        shutil.rmtree(main_adam)

        # ---- 5. card vs CPU ------------------------------------------------
        sam = os.path.join(work, "parity.sam")
        p_snps = os.path.join(work, "parity.snps.vcf")
        p_indels = os.path.join(work, "parity.indels.vcf")
        make_wgs(sam, PARITY_READS, 100, seed=SEED + 1, known_sites_out=p_snps)
        make_known_indels_vcf(sam, p_indels)
        from adam_tpu_torch.io import sam as sam_io

        p_bam = os.path.join(work, "parity.bam")
        sam_io.write_bam(p_bam, *sam_io.read_sam(sam))
        parity = {}
        metrics = {}
        for model in ("reads", "smithwaterman", "known_sites", "bam"):
            hashes = {}
            for device in ("cuda", "cpu"):
                d = os.path.join(work, f"{model}.{device}.adam")
                if model == "reads":
                    m_json = os.path.join(work, f"metrics.{device}.json")
                    _reset_telemetry()
                    # each run's first launches are its own (the ledger is
                    # process-wide, and 4p launched at this grid too)
                    compile_ledger.reset()
                    run_transform(sam, d, device, extra=("--metrics-json", m_json))
                    _reset_telemetry()
                    with open(m_json) as fh:
                        metrics[device] = json.load(fh)["counters"]
                elif model == "bam":
                    run_transform(p_bam, d, device)
                elif model == "smithwaterman":
                    run_smithwaterman(sam, d, device)
                else:
                    st = run_transform(sam, d, device, extra=(
                        "-known_snps", p_snps, "-known_indels", p_indels,
                        "-known_recalibration_table", table_npz))
                    if not st["fused_bc"] or st["n_fused_windows"] != st["n_parts"]:
                        raise AssertionError(f"known-sites parity run ({device}) did not "
                                             f"fuse every part: {st}")
                hashes[device] = _part_hashes(d)
            if not hashes["cuda"] or hashes["cuda"] != hashes["cpu"]:
                raise AssertionError(f"{model}: card and CPU parts differ: {hashes}")
            parity[model] = len(hashes["cuda"])
            _log(f"card vs CPU ({model}): {parity[model]} parts byte-identical "
                 f"({PARITY_READS} reads)")
        counted = ("reads.ingested", "windows.ingested", "parquet.parts.written",
                   "parquet.bytes.written")
        if (metrics["cuda"] != metrics["cpu"]
                or any(not metrics["cuda"].get(k) for k in counted)):
            raise AssertionError(f"card and CPU --metrics-json counters differ: {metrics}")
        parity["metrics_counters"] = metrics["cuda"]
        _log(f"card vs CPU --metrics-json counters equal: {metrics['cuda']}")
        resumes = check_cross_device_resume(work, sam)
        for leg in ("card_to_cpu", "cpu_to_card"):
            r = resumes[leg]
            _log(f"card vs CPU resume ({leg}, {resumes['parts']} parts of "
                 f"{PARITY_RESUME_WINDOW} reads): {r['killed']}; "
                 f"{r['windows_resumed']} resumed, {r['windows_fresh']} fresh, "
                 f"launches {r['launches']}; parts byte-identical to the card run")
        parity["resume"] = resumes
        for name, flags in DATASET_PARITY_LEGS:
            got = {}
            for device in ("cuda", "cpu"):
                path = os.path.join(work, f"dataset.{device}.{name}")
                st = run_dataset_transform(sam, path, device, flags)
                text = run_flagstat(path, device)[0]
                got[device] = (_file_hash(path), text, st["n_rows_out"])
            if got["cuda"] != got["cpu"]:
                raise AssertionError(f"dataset transform to {name}: card and CPU "
                                     f"outputs or flagstat reports differ: {got}")
            parity[f"dataset_{name}"] = got["cuda"][2]
            _log(f"card vs CPU (dataset transform {' '.join(flags)} -> {name}): output "
                 f"and flagstat byte-identical ({got['cuda'][2]} rows)")
        parity.update(check_parity_sharded_depth_view(
            work, sam, os.path.join(work, "reads.cuda.adam"), p_snps))
        t0 = time.monotonic()
        parity["other_formats"] = check_parity_other_formats(
            work, sam, os.path.join(work, "reads.cuda.adam"))
        parity["other_formats"]["phase_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        parity["spark_executor"] = check_parity_spark(work, sam, p_snps)
        parity["plugin"] = check_parity_plugin(work, os.path.join(work, "reads.cuda.adam"))
        parity["pool_mesh"] = check_parity_pool_mesh(work, sam)
        parity["service"] = check_parity_service(svc_sams, work)
        _log("buildinfo: " + " | ".join(_cli(["buildinfo"])[0].splitlines()))
        parity["spark_plugin_buildinfo_s"] = time.monotonic() - t0
        _log(f"card vs CPU executor, plugin and buildinfo legs: "
             f"{parity['spark_plugin_buildinfo_s']:.1f} s")
        from adam_tpu_torch.cli.main import main as cli

        for what, flags in (("count_kmers", ()), ("count_qmers", ("-countQmers",))):
            hashes = {}
            for device in ("cuda", "cpu"):
                out_txt = os.path.join(work, f"{what}.{device}.txt")
                with contextlib.redirect_stderr(io.StringIO()):
                    rc = cli(["count_kmers", os.path.join(work, "bam.cuda.adam"), out_txt,
                              "21", *flags, "--device", device])
                if rc != 0:
                    raise RuntimeError(f"count_kmers {flags} exited {rc}")
                with open(out_txt, "rb") as fh:
                    data = fh.read()
                hashes[device] = (hashlib.sha256(data).hexdigest(), data.count(b"\n"))
            if hashes["cuda"] != hashes["cpu"] or hashes["cuda"][1] == 0:
                raise AssertionError(f"{what}: card and CPU output files differ: {hashes}")
            parity[what] = hashes["cuda"][1]
            _log(f"card vs CPU ({what} k=21): output files byte-identical, "
                 f"{parity[what]} lines ({PARITY_READS} reads)")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    for k in kern:
        k["kernel_ms"] = k["ms"]
        k["x_bound"] = k["ms"] / k["bound_ms"]
    _log("smoke: done")
    print(json.dumps({"main_path": {
        "reads": MAIN_READS, "window_reads": WINDOW_READS, "stats": stats,
        "profile": prof, "no_realign_stats": plain_stats,
        "smithwaterman": {"reads": SW_READS, "stats": sw_stats,
                          "sw_fill_launch_shapes": shapes, "sw_fill_routes": sw_routes},
        "known_sites": known,
        "bam": bam,
        "kmers": kmers,
        "dataset_transform": dataset,
        "durable": durable,
        "sharded": sharded,
        "depth_view": depth_view,
        "other_formats": other,
        "spark_executor": spark,
        "transform_step": tstep,
        "observability": observ,
        "multi_device": multi,
        "service": service,
        "issue_rate": rate,
        "card_vs_cpu_parts": parity,
    }}), flush=True)
    print(json.dumps({"kernels": kern}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
