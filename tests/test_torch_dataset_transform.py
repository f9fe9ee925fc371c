"""The dataset-level (non-streaming) transform of the port against the JAX
package, on the CPU: each dataset method (markdup, BQSR with and without
known SNPs, the coordinate sort, the fixed and the quality-based trim),
``save`` to ``.adam``, ``.sam`` and ``.bam``, the README's library chain,
and the CLI's ``transform`` without ``-streaming`` under several flag
sets, with its refusals.  Outputs are held byte-identical; the quality
profile's f64 sums, which the port adds up in another order than JAX's
scatter-add, are held at rtol 1e-12 and the trims they give exactly."""

import contextlib
import io
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

N_READS = 4500
PROFILE_RTOL = 1e-12


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A WGS-shaped SAM with its known-SNP VCF, a known-indel VCF derived
    from it, and the same reads as a BAM."""
    from make_known_indels_vcf import make_known_indels_vcf
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.io import sam as sam_io

    d = tmp_path_factory.mktemp("dataset_transform")
    sam = str(d / "in.sam")
    make_wgs(sam, N_READS, 100, n_contigs=2, contig_len=30_000,
             known_sites_out=str(d / "snps.vcf"))
    assert make_known_indels_vcf(sam, str(d / "indels.vcf")) > 5
    sam_io.write_bam(str(d / "in.bam"), *sam_io.read_sam(sam))
    return d


def _load(d, name="in.sam"):
    """(port dataset, JAX dataset) of one input file."""
    from adam_tpu.io.context import load_alignments as jax_load

    from adam_tpu_torch.io.context import load_alignments

    return load_alignments(str(d / name)), jax_load(str(d / name))


def _snp_tables(d):
    from adam_tpu.api.datasets import GenotypeDataset as JG

    from adam_tpu_torch.api.datasets import GenotypeDataset as TG
    from adam_tpu_torch.io.sam import peek_sam_header

    names = peek_sam_header(str(d / "in.sam")).seq_dict.names
    vcf = str(d / "snps.vcf")
    return (TG.load(vcf, contig_names=names).snp_table(),
            JG.load(vcf, contig_names=names).snp_table())


def _assert_batches_equal(got, want):
    g, w = got.to_numpy(), want.to_numpy()
    for name, arr in g.arrays().items():
        np.testing.assert_array_equal(np.asarray(arr), np.asarray(getattr(w, name)),
                                      err_msg=name)


def _assert_datasets_equal(got, want):
    _assert_batches_equal(got.batch, want.batch)
    for col in ("names", "attrs", "md", "orig_quals"):
        assert list(getattr(got.sidecar, col)) == list(getattr(want.sidecar, col)), col
    for col in ("trimmed_from_start", "trimmed_from_end"):
        np.testing.assert_array_equal(np.asarray(getattr(got.sidecar, col)),
                                      np.asarray(getattr(want.sidecar, col)), err_msg=col)


# ------------------------------------------------------------ the methods


def test_mark_duplicates_equals_jax(inputs):
    ds, jds = _load(inputs)
    got = ds.mark_duplicates(device="cpu")
    want = jds.mark_duplicates()
    np.testing.assert_array_equal(got.batch.flags, np.asarray(want.batch.flags))
    assert int((np.asarray(got.batch.flags) & 0x400 != 0).sum()) > 100


@pytest.mark.parametrize("case", ["plain", "known_snps", "chunked"])
def test_bqsr_equals_jax(inputs, tmp_path, monkeypatch, case):
    """Quals, OQ and the observation CSV; "chunked" observes and applies in
    row chunks of 1,000 (at the whole dataset's lane grid)."""
    from adam_tpu.pipelines.bqsr import recalibrate_base_qualities as jax_bqsr

    from adam_tpu_torch.pipelines import bqsr

    ds, jds = _load(inputs)
    ds, jds = ds.mark_duplicates(device="cpu"), jds.mark_duplicates()
    known, jknown = _snp_tables(inputs) if case == "known_snps" else (None, None)
    if case == "chunked":
        monkeypatch.setattr(bqsr, "CHUNK_ROWS", 1000)
        assert len(bqsr._row_chunks(ds)) == 5
    stats = {}
    got = ds.recalibrate_base_qualities(
        known_snps=known, dump_observation_table=str(tmp_path / "t.csv"),
        device="cpu", stats=stats)
    want = jax_bqsr(jds, known_snps=jknown, dump_observation_table=str(tmp_path / "j.csv"))
    _assert_datasets_equal(got, want)
    assert sum(1 for q in got.sidecar.orig_quals if q) == N_READS
    csv = (tmp_path / "t.csv").read_text()
    assert csv == (tmp_path / "j.csv").read_text()
    assert len(csv.splitlines()) > 1000
    assert set(stats) == {"bqsr_observe_s", "bqsr_solve_s", "bqsr_apply_s"}


def test_sort_equals_jax(inputs):
    from adam_tpu.pipelines.sort import sort_keys as jax_sort_keys

    from adam_tpu_torch.pipelines.sort import sort_keys

    ds, jds = _load(inputs)
    # placed-unmapped reads (FLAG 0x4 with a position) must sort last too
    flags = np.asarray(ds.batch.flags).copy()
    flags[::97] |= 0x4
    ds = ds.with_batch(ds.batch.replace(flags=flags))
    jds = jds.with_batch(jds.batch.replace(flags=flags))
    order = sort_keys(ds)
    np.testing.assert_array_equal(order, jax_sort_keys(jds))
    unmapped = (flags[order] & 0x4) != 0
    assert unmapped.sum() > 40 and not unmapped[: -int(unmapped.sum())].any()
    _assert_datasets_equal(ds.sort_by_reference_position(), jds.sort_by_reference_position())


@pytest.mark.parametrize("ts,te,rg", [(2, 1, None), (5, 0, "rg2"), (0, 7, None)])
def test_trim_reads_equals_jax(inputs, ts, te, rg):
    """Columns, CIGAR, start/end, MD and the trimmed-from counters."""
    from adam_tpu.pipelines.trim import trim_reads as jax_trim

    from adam_tpu_torch.pipelines.trim import trim_reads

    ds, jds = _load(inputs)
    rg_idx = None if rg is None else ds.read_groups.names.index(rg)
    got = trim_reads(ds, ts, te, rg_idx=rg_idx)
    want = jax_trim(jds, ts, te, rg_idx=rg_idx)
    _assert_datasets_equal(got, want)
    moved = np.asarray(got.batch.start) != np.asarray(ds.batch.start)
    assert moved.any() == (ts > 0)


@pytest.mark.parametrize("cigar,md,ts,te", [
    ("2H3M2D5M1S", "3^AC5", 4, 2),
    ("1S4M1I3M2N4M", "4A2^T0C3", 3, 5),
    ("3M1P2M1D4M3H", "1A3^G0G3", 2, 2),
    ("10M", "0A9", 1, 0),
])
def test_cigar_and_md_trims_equal_jax(cigar, md, ts, te):
    from adam_tpu.pipelines import trim as jtrim

    from adam_tpu_torch.formats import schema
    from adam_tpu_torch.pipelines import trim

    ops, lens, n = schema.encode_cigar(cigar, 8)
    got = trim.trim_cigar(ops, lens, n, ts, te, 100, 130)
    assert got == jtrim.trim_cigar(ops, lens, n, ts, te, 100, 130)
    assert trim.trim_md_tag(md, ts, te) == jtrim.trim_md_tag(md, ts, te)


def test_quality_profile_equals_jax(inputs):
    """The profile's sums at rtol 1e-12, its counts, means and the trim
    lengths at several thresholds exactly."""
    from adam_tpu.pipelines import trim as jtrim

    from adam_tpu_torch.pipelines import trim

    ds, jds = _load(inputs)
    n_rg = len(ds.read_groups.names)
    sums, counts = trim.quality_profile(ds.batch, n_rg, device="cpu")
    jsums, jcounts = jtrim.quality_profile_kernel(jds.batch.to_device(), n_rg)
    np.testing.assert_array_equal(counts, np.asarray(jcounts))
    np.testing.assert_allclose(sums, np.asarray(jsums), rtol=PROFILE_RTOL, atol=0)
    means, _ = trim.mean_quality_profile(ds.batch, n_rg, device="cpu")
    jmeans, _ = jtrim.mean_quality_profile(jds.batch, n_rg)
    np.testing.assert_array_equal(means, jmeans)
    for threshold in (20, 30, 35, 60):
        for rg in range(n_rg + 1):
            assert (trim.trim_lengths(means[rg], counts[rg], threshold)
                    == jtrim.trim_lengths(jmeans[rg], np.asarray(jcounts)[rg], threshold))


@pytest.mark.parametrize("threshold", [20, 33])
def test_quality_trim_equals_jax(inputs, threshold):
    ds, jds = _load(inputs)
    got = ds.trim_low_quality_read_groups(threshold, device="cpu")
    _assert_datasets_equal(got, jds.trim_low_quality_read_groups(threshold))


def test_compact_and_arrow_equal_jax(inputs):
    ds, jds = _load(inputs)
    valid = np.ones(N_READS, bool)
    valid[::5] = False
    ds = ds.with_batch(ds.batch.replace(valid=valid))
    jds = jds.with_batch(jds.batch.replace(valid=valid))
    got, want = ds.compact(), jds.compact()
    _assert_datasets_equal(got, want)
    assert len(got) == got.batch.n_rows == N_READS - N_READS // 5
    table = got.to_arrow()
    assert table.equals(want.to_arrow())
    assert table.schema.metadata == want.to_arrow().schema.metadata
    back = type(got).from_arrow(table.to_batches())
    _assert_datasets_equal(back, type(jds).from_arrow(table.to_batches()))


@pytest.mark.parametrize("ext", [".adam", ".sam", ".bam"])
def test_save_byte_identical_to_jax(inputs, tmp_path, ext):
    """A dataset with duplicate flags and OQ tags, saved by extension."""
    from adam_tpu.pipelines.bqsr import recalibrate_base_qualities as jax_bqsr

    ds, jds = _load(inputs)
    ds = ds.mark_duplicates(device="cpu").recalibrate_base_qualities(device="cpu")
    jds = jax_bqsr(jds.mark_duplicates())
    ds.save(str(tmp_path / f"t{ext}"))
    jds.save(str(tmp_path / f"j{ext}"))
    got = (tmp_path / f"t{ext}").read_bytes()
    assert got == (tmp_path / f"j{ext}").read_bytes()
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"j{ext}", f"t{ext}"]
    if ext == ".sam":
        from adam_tpu_torch.io.sam import format_sam_records

        lines = got.decode().splitlines()
        records = [ln for ln in lines if not ln.startswith("@")]
        assert records == list(format_sam_records(ds.batch, ds.sidecar, ds.header))
        assert sum("OQ:Z:" in r for r in records) == N_READS


def test_save_round_trips_through_load(inputs, tmp_path):
    """What a checkpoint store holds: a saved ``.adam`` loads back equal."""
    from adam_tpu_torch.api.datasets import AlignmentDataset

    ds, _ = _load(inputs)
    ds = ds.mark_duplicates(device="cpu").recalibrate_base_qualities(device="cpu")
    ds = ds.trim_reads(1, 2)
    ds.save(str(tmp_path / "x.adam"))
    back = AlignmentDataset.load(str(tmp_path / "x.adam"))
    want = ds.to_arrow()
    assert back.to_arrow().equals(want)
    assert back.to_arrow().schema.metadata == want.schema.metadata


def test_save_fastq_names_the_queue(inputs, tmp_path):
    """FASTQ output, once refused naming its queue item, writes the JAX
    package's bytes."""
    ds, jds = _load(inputs)
    ds.save(str(tmp_path / "out.fq"))
    jds.save(str(tmp_path / "jax.fq"))
    got = (tmp_path / "out.fq").read_bytes()
    assert got == (tmp_path / "jax.fq").read_bytes() and got.count(b"\n") == 4 * N_READS


def test_readme_chain(inputs, tmp_path):
    """``ds.mark_duplicates().realign_indels().recalibrate_base_qualities();
    ds.save("out.adam")``, with ``device=`` added."""
    from adam_tpu.io.context import load_alignments as jax_load

    from adam_tpu_torch.io.context import load_alignments

    ds = load_alignments(str(inputs / "in.sam"))
    ds = (ds.mark_duplicates(device="cpu").realign_indels(device="cpu")
          .recalibrate_base_qualities(device="cpu"))
    ds.save(str(tmp_path / "t.adam"))
    jds = jax_load(str(inputs / "in.sam"))
    jds = jds.mark_duplicates().realign_indels().recalibrate_base_qualities()
    jds.save(str(tmp_path / "j.adam"))
    assert (tmp_path / "t.adam").read_bytes() == (tmp_path / "j.adam").read_bytes()


def test_dataset_methods_default_to_the_card(inputs):
    import inspect

    import torch

    from adam_tpu_torch.api.datasets import AlignmentDataset

    for name in ("mark_duplicates", "recalibrate_base_qualities",
                 "trim_low_quality_read_groups", "flagstat"):
        sig = inspect.signature(getattr(AlignmentDataset, name))
        assert sig.parameters["device"].default == "cuda", name
    if not torch.cuda.is_available():
        ds, _ = _load(inputs)
        for call in (ds.mark_duplicates, ds.recalibrate_base_qualities,
                     ds.trim_low_quality_read_groups, ds.flagstat):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


# ----------------------------------------------------------------- the CLI


def _run_cli(main, argv) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


CLI_CASES = {
    "full.adam": ("in.sam", ["-mark_duplicate_reads", "-realign_indels",
                             "-recalibrate_base_qualities", "-sort_reads"]),
    "trim.sam": ("in.sam", ["-trimReads", "-trimFromStart", "2", "-trimFromEnd", "1",
                            "-qualityBasedTrim", "-mark_duplicate_reads", "-realign_indels",
                            "-recalibrate_base_qualities", "-sort_reads"]),
    "markdup.bam": ("in.sam", ["-mark_duplicate_reads"]),
    "knowns.adam": ("in.sam", ["-realign_indels", "-known_indels", "indels.vcf",
                               "-recalibrate_base_qualities", "-known_snps", "snps.vcf",
                               "-dump_observations", "{out}.csv"]),
    "qtrim_first.adam": ("in.sam", ["-qualityBasedTrim", "-qualityThreshold", "30",
                                    "-trimBeforeBQSR", "-recalibrate_base_qualities"]),
    "rg_trim.sam": ("in.sam", ["-trimReads", "-trimFromStart", "3", "-trimReadGroup", "rg2",
                               "-sort_reads", "-repartition", "4"]),
    "bam_input.adam": ("in.bam", ["-force_load_bam", "-mark_duplicate_reads", "-sort_reads"]),
    "parquet_input.bam": ("saved.adam", ["-force_load_parquet",
                                         "-recalibrate_base_qualities", "-sort_reads"]),
    "checkpoint.adam": ("in.sam", ["-mark_duplicate_reads", "-realign_indels",
                                   "-recalibrate_base_qualities", "-sort_reads",
                                   "-checkpoint_dir", "{out}.ck"]),
    "tuned.adam": ("in.sam", ["-realign_indels", "-max_consensus_number", "2",
                              "-log_odds_threshold", "2.5", "-parquet_compression_codec",
                              "snappy"]),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_transform_equals_jax(inputs, tmp_path, case):
    """``transform IN OUT`` without ``-streaming``: the output file (and the
    observation CSV, the checkpoint manifest and stores) byte-identical to
    ``python -m adam_tpu.cli.main transform`` with the same flags."""
    import json

    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    src, flags = CLI_CASES[case]
    if src == "saved.adam" and not (inputs / src).exists():
        _load(inputs)[1].save(str(inputs / src))
    ext = case[case.index("."):]
    outs = {}
    for who, fn, extra in (("jax", jax_main, []), ("torch", main, ["--device", "cpu"])):
        out = str(tmp_path / f"{who}{ext}")
        argv = ["transform", str(inputs / src), out]
        argv += [f.format(out=out) if "{out}" in f
                 else str(inputs / f) if f.endswith(".vcf") else f for f in flags]
        rc, stdout, _ = _run_cli(fn, argv + extra)
        assert rc == 0, who
        outs[who] = out
        if who == "torch":
            stats = json.loads(stdout.strip().splitlines()[-1])
    assert pathlib.Path(outs["torch"]).read_bytes() == pathlib.Path(outs["jax"]).read_bytes()
    assert stats["device"] == "cpu" and stats["n_reads"] == N_READS
    assert all(n == 0 for n in stats["kernel_launches"].values())
    if "-dump_observations" in flags:
        assert (pathlib.Path(outs["torch"] + ".csv").read_text()
                == pathlib.Path(outs["jax"] + ".csv").read_text())
    if "-checkpoint_dir" in flags:
        ck_t, ck_j = pathlib.Path(outs["torch"] + ".ck"), pathlib.Path(outs["jax"] + ".ck")
        assert sorted(p.name for p in ck_t.iterdir()) == sorted(p.name for p in ck_j.iterdir())
        for p in ck_j.iterdir():
            assert (ck_t / p.name).read_bytes() == p.read_bytes(), p.name
        assert stats["stages_run"] == ["mark_duplicates", "realign_indels", "bqsr", "sort"]


REFUSALS = {
    "window_reads": ["-window_reads", "0", "-mark_duplicate_reads"],
    "streaming_sort": ["-streaming", "-mark_duplicate_reads", "-sort_reads"],
    "streaming_trim": ["-streaming", "-trimReads", "-trimFromStart", "2"],
    "streaming_quality_trim": ["-streaming", "-qualityBasedTrim"],
    "streaming_parquet": ["-streaming", "-force_load_parquet"],
    "streaming_adam_input": ["-streaming", "-mark_duplicate_reads", "@x.adam"],
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_cli_refusals_equal_jax(inputs, tmp_path, case):
    """The flag combinations the JAX CLI refuses: the same exit code and
    the same message."""
    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    flags = [f for f in REFUSALS[case] if not f.startswith("@")]
    src = next((f[1:] for f in REFUSALS[case] if f.startswith("@")), "in.sam")
    argv = ["transform", str(inputs / src), str(tmp_path / "o.adam"), *flags]
    jrc, _, jerr = _run_cli(jax_main, argv)
    rc, _, err = _run_cli(main, argv + ["--device", "cpu"])
    assert jrc == rc == 2
    assert err == jerr and err.strip()
    assert not (tmp_path / "o.adam").exists()


@pytest.mark.parametrize("flag", ["-force_load_fastq", "-force_load_ifastq", "out.fq"])
def test_cli_refuses_fastq_naming_the_queue(inputs, tmp_path, flag):
    """The FASTQ flags and output, once refused naming their queue item,
    run as the JAX CLI runs them: the same exit code and the same bytes
    (a SAM forced through a FASTQ loader holds no FASTQ record)."""
    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    ext = ".fq" if flag.endswith(".fq") else ".adam"
    for who, fn, extra in (("jax", jax_main, []), ("torch", main, ["--device", "cpu"])):
        argv = ["transform", str(inputs / "in.sam"), str(tmp_path / f"{who}{ext}"),
                "-mark_duplicate_reads"] + ([] if flag.endswith(".fq") else [flag])
        rc, _, err = _run_cli(fn, argv + extra)
        assert rc == 0, err
        assert "queue 1 item 7" not in err
    got = (tmp_path / f"torch{ext}").read_bytes()
    assert got == (tmp_path / f"jax{ext}").read_bytes()