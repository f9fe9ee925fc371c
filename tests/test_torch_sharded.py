"""The sharded, out-of-core transform of the port against the JAX
package's, on the CPU: the raw Arrow IPC shard spill (round trip, the
same bytes as JAX's, and a shard of either package read by the other),
the genome-bin shuffle (the same shard files), ``transform_sharded``
byte for byte against JAX's on a WGS-shaped SAM in 4 shards (with and
without known sites, with the one-shard cache, with Parquet shards), JAX's
constructed case of duplicate mates in different bins and an indel target
on a bin edge, the command line's ``-shards`` run against JAX's command
line, and its refusals (exit code 2, JAX's messages)."""

import contextlib
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

READS = 3000
SHARD_READS = 1024  # ingest windows of the shuffle


def _files(d) -> dict:
    return {f: (pathlib.Path(d) / f).read_bytes()
            for f in sorted(os.listdir(d)) if not f.startswith("_")}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from make_wgs_sam import make_wgs

    d = tmp_path_factory.mktemp("sharded")
    sam = str(d / "in.sam")
    make_wgs(sam, READS, 100, n_contigs=2, contig_len=30_000,
             known_sites_out=str(d / "snps.vcf"))
    subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve().parent.parent
                                        / "tools" / "make_known_indels_vcf.py"),
                    sam, str(d / "indels.vcf")], check=True, capture_output=True)
    return d


def _batch(inputs):
    from adam_tpu_torch.io import sam as tsam

    return tsam.read_sam(str(inputs / "in.sam"))


# ------------------------------------------------------------ raw spill

def _append_two(writer, b, side, header):
    """Two record batches: the first 1,000 rows, then the rest widened by
    8 lanes (the reader pads the narrower chunk)."""
    n = b.n_rows
    first, rest = np.arange(1000), np.arange(1000, n)
    writer.append(b.take(first), side.take(first), header)
    writer.append(b.take(rest).widen(b.lmax + 8, b.cmax + 8), side.take(rest), header)
    writer.close()


def test_raw_spill_round_trip_and_bytes(inputs, tmp_path):
    """Valid rows only, every column back exactly (and writable); the
    port's file is JAX's byte for byte; each package reads the other's."""
    from adam_tpu.io.sam import read_sam as jread_sam
    from adam_tpu.parallel import spill as jspill

    from adam_tpu_torch.parallel import spill

    b, side, header = _batch(inputs)
    valid = np.ones(b.n_rows, bool)
    valid[::7] = False
    jb, jside, jheader = jread_sam(str(inputs / "in.sam"))
    paths = {"torch": str(tmp_path / "torch.arrows"), "jax": str(tmp_path / "jax.arrows")}
    _append_two(spill.RawShardWriter(paths["torch"]), b.replace(valid=valid), side, header)
    _append_two(jspill.RawShardWriter(paths["jax"]), jb.replace(valid=valid), jside, jheader)
    assert pathlib.Path(paths["torch"]).read_bytes() == pathlib.Path(paths["jax"]).read_bytes()

    keep = np.flatnonzero(valid)
    want, want_side = b.take(keep), side.take(keep)
    for path in paths.values():
        got, got_side, got_header = spill.read_raw_shard(path)
        jgot, jgot_side, _ = jspill.read_raw_shard(path)
        assert got.n_rows == len(keep)
        for name, arr in got.arrays().items():
            assert arr.flags.writeable, name
            np.testing.assert_array_equal(arr, np.asarray(getattr(jgot, name)), err_msg=name)
            ref = np.asarray(getattr(want, name))
            if arr.ndim == 2:  # the wider second chunk pads the first
                arr = arr[:, : ref.shape[1]]
            np.testing.assert_array_equal(arr, ref, err_msg=name)
        for f in ("names", "attrs", "md", "orig_quals"):
            assert getattr(got_side, f).to_list() == getattr(want_side, f).to_list(), f
            assert getattr(jgot_side, f).to_list() == getattr(want_side, f).to_list(), f
        assert got_header.seq_dict.names == header.seq_dict.names
        assert got_header.read_groups.names == header.read_groups.names


@pytest.mark.parametrize("fmt", ["raw", "parquet"])
def test_shuffle_writes_jax_shards(inputs, tmp_path, fmt):
    from adam_tpu.io.sam import iter_sam_batches as jiter
    from adam_tpu.parallel import host_shuffle as jhs

    from adam_tpu_torch.io.sam import iter_sam_batches
    from adam_tpu_torch.parallel import host_shuffle

    sam = str(inputs / "in.sam")
    got = host_shuffle.shuffle_alignments_to_shards(
        iter_sam_batches(sam, batch_reads=SHARD_READS), 4, str(tmp_path / "t"),
        fmt=fmt, device="cpu")
    want = jhs.shuffle_alignments_to_shards(
        jiter(sam, batch_reads=SHARD_READS), 4, str(tmp_path / "j"), fmt=fmt)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    n = sum(b.n_rows for b, _, _ in host_shuffle.iter_shards(got))
    assert n == READS


def test_five_prime_key_equals_jax(inputs):
    from adam_tpu.ops.cigar import five_prime_position_np

    from adam_tpu_torch.parallel.host_shuffle import five_prime_positions

    b, _, _ = _batch(inputs)
    np.testing.assert_array_equal(
        five_prime_positions(b, "cpu"),
        five_prime_position_np(b.start, b.end, b.flags, b.cigar_ops, b.cigar_lens,
                               b.cigar_n))


# ------------------------------------------------------- the transform

CONFIGS = {
    "full": {},
    "known_sites": {"known": True},
    "no_realign_cache0": {"realign": False, "cache_bytes": 0},
    "markdup_parquet_shards": {"recalibrate": False, "realign": False,
                               "shard_fmt": "parquet"},
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_transform_sharded_writes_the_jax_parts(inputs, tmp_path, config):
    from adam_tpu.api.datasets import GenotypeDataset as JGD
    from adam_tpu.parallel.sharded import transform_sharded as jax_sharded

    from adam_tpu_torch.api.datasets import GenotypeDataset
    from adam_tpu_torch.parallel.sharded import transform_sharded

    kw = dict(CONFIGS[config])
    known = kw.pop("known", False)
    sam = str(inputs / "in.sam")
    tkw, jkw = dict(kw), dict(kw)
    if known:
        from adam_tpu_torch.io.context import load_header

        names = load_header(sam).seq_dict.names
        tkw["known_snps"] = GenotypeDataset.load(
            str(inputs / "snps.vcf"), contig_names=names).snp_table()
        tkw["known_indels"] = GenotypeDataset.load(
            str(inputs / "indels.vcf"), contig_names=names).indel_table()
        jkw["known_snps"] = JGD.load(str(inputs / "snps.vcf"), contig_names=names).snp_table()
        jkw["known_indels"] = JGD.load(str(inputs / "indels.vcf"),
                                       contig_names=names).indel_table()
    stats = transform_sharded(sam, str(tmp_path / "t.adam"), 4, batch_reads=SHARD_READS,
                              dump_observations=str(tmp_path / "t.csv"), device="cpu",
                              **tkw)
    jstats = jax_sharded(sam, str(tmp_path / "j.adam"), 4, batch_reads=SHARD_READS,
                         dump_observations=str(tmp_path / "j.csv"), **jkw)
    got, want = _files(tmp_path / "t.adam"), _files(tmp_path / "j.adam")
    assert got == want and len(got) >= 4
    assert stats["n_reads"] == jstats["n_reads"] == READS
    assert stats["n_parts"] == len(got)
    assert not (tmp_path / "t.adam" / "_temporary").exists()
    for key in jstats:
        assert key in stats, key
    if kw.get("recalibrate", True):
        assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
        # one observe per observed shard (one chunk each here), one for
        # the realigned part
        assert stats["n_observed"] == stats["n_shards"] + (kw.get("realign", True))
    else:
        assert stats["n_observed"] == 0


def test_shards_observe_in_row_chunks(inputs, tmp_path, monkeypatch):
    """A shard above the row chunk observes in several kernel-1 launches
    (one per chunk, all at the shard's lane grid) and still writes JAX's
    parts."""
    from adam_tpu.parallel.sharded import transform_sharded as jax_sharded

    from adam_tpu_torch.parallel.sharded import transform_sharded
    from adam_tpu_torch.pipelines import bqsr

    monkeypatch.setattr(bqsr, "CHUNK_ROWS", 300)
    sam = str(inputs / "in.sam")
    stats = transform_sharded(sam, str(tmp_path / "t.adam"), 4, batch_reads=SHARD_READS,
                              device="cpu")
    jax_sharded(sam, str(tmp_path / "j.adam"), 4, batch_reads=SHARD_READS)
    assert _files(tmp_path / "t.adam") == _files(tmp_path / "j.adam")
    assert stats["n_observed"] > 2 * stats["n_shards"]


def test_cross_bin_duplicates_and_edge_target(tmp_path):
    """JAX's constructed case (``tests/test_sharded.py``): duplicate pairs
    whose mates land in different bins, and an indel target on a bin
    edge, in 3 shards with windows of 8 reads: the port writes JAX's
    parts, with 5 of 6 duplicate pairs marked and the best pair kept."""
    from adam_tpu.formats.batch import pack_reads
    from adam_tpu.io.sam import SamHeader, write_sam
    from adam_tpu.models.dictionaries import (
        RecordGroup,
        RecordGroupDictionary,
        SequenceDictionary,
        SequenceRecord,
    )
    from adam_tpu.parallel.sharded import transform_sharded as jax_sharded

    from adam_tpu_torch.formats import schema
    from adam_tpu_torch.io.context import load_alignments
    from adam_tpu_torch.parallel.sharded import transform_sharded

    sd = SequenceDictionary((SequenceRecord("chr1", 90_000),))
    rgd = RecordGroupDictionary((RecordGroup("rg1", library="lib1"),))
    recs = []

    def pair(name, s1, s2, phred):
        tl = s2 + 20 - s1
        common = dict(name=name, contig_idx=0, mapq=60, cigar="20M", seq="A" * 20,
                      qual=chr(33 + phred) * 20, read_group_idx=0, mate_contig_idx=0,
                      attrs="MD:Z:20")
        return [dict(common, flags=0x1 | 0x20 | 0x40 | 0x2, start=s1, mate_start=s2,
                     tlen=tl),
                dict(common, flags=0x1 | 0x10 | 0x80 | 0x2, start=s2, mate_start=s1,
                     tlen=-tl)]

    for i in range(6):
        recs += pair(f"dup{i}", 1_000, 61_000, 30 if i == 4 else 20)
    recs.append(dict(name="indel", flags=0, contig_idx=0, start=29_995, mapq=60,
                     cigar="10M2I8M", seq="AAAAAAAAAACCAAAAAAAA", qual="I" * 20,
                     read_group_idx=0, attrs="MD:Z:18"))
    for i in range(8):
        recs.append(dict(name=f"cover{i}", flags=0, contig_idx=0, start=29_990 + i,
                         mapq=60, cigar="20M", seq="A" * 20, qual="I" * 20,
                         read_group_idx=0, attrs="MD:Z:20"))
    batch, side = pack_reads(recs)
    path = str(tmp_path / "in.sam")
    write_sam(path, batch, side, SamHeader(seq_dict=sd, read_groups=rgd))

    stats = transform_sharded(path, str(tmp_path / "t.adam"), 3, batch_reads=8,
                              device="cpu")
    jax_sharded(path, str(tmp_path / "j.adam"), 3, batch_reads=8)
    assert _files(tmp_path / "t.adam") == _files(tmp_path / "j.adam")
    assert stats["n_shards"] == 2 and stats["n_parts"] == 3  # 2 shards + realigned

    b = load_alignments(str(tmp_path / "t.adam")).compact()
    bb = b.batch.to_numpy()
    dup = (np.asarray(bb.flags) & schema.FLAG_DUPLICATE) != 0
    marks = {}
    for i in range(bb.n_rows):
        marks.setdefault(b.sidecar.names[i], []).append(bool(dup[i]))
    assert marks["dup4"] == [False, False]
    assert sum(all(v) for k, v in marks.items() if k.startswith("dup")) == 5


# --------------------------------------------------------- command line

def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_cli_shards_writes_the_jax_cli_parts(inputs, tmp_path):
    import json

    from adam_tpu.cli.main import main as jax_cli

    from adam_tpu_torch.cli.main import main as cli

    sam = str(inputs / "in.sam")
    flags = ["-shards", "4", "-mark_duplicate_reads", "-realign_indels",
             "-recalibrate_base_qualities", "-known_snps", str(inputs / "snps.vcf")]
    rc, out, _ = _cli(cli, ["transform", sam, str(tmp_path / "t.adam"), *flags,
                            "--device", "cpu"])
    assert rc == 0
    stats = json.loads(out.strip().splitlines()[-1])
    assert stats["n_reads"] == READS and stats["device"] == "cpu"
    assert _cli(jax_cli, ["transform", sam, str(tmp_path / "j.adam"), *flags])[0] == 0
    assert _files(tmp_path / "t.adam") == _files(tmp_path / "j.adam")


@pytest.mark.parametrize("extra,input_name", [
    (["-shards", "-2"], "in.sam"),
    (["-shards", "2", "-streaming"], "in.sam"),
    (["-shards", "2", "-sort_reads"], "in.sam"),
    (["-shards", "2", "-trimReads"], "in.sam"),
    (["-shards", "2", "-qualityBasedTrim"], "in.sam"),
    (["-shards", "2"], "in.adam"),
    (["-shards", "2", "-force_load_parquet"], "in.sam"),
    (["-shards", "2", "--run-dir", "rd"], "in.sam"),
])
def test_cli_shards_refusals(inputs, tmp_path, extra, input_name):
    from adam_tpu.cli.main import main as jax_cli

    from adam_tpu_torch.cli.main import main as cli

    argv = ["transform", str(inputs / input_name), str(tmp_path / "out"),
            "-mark_duplicate_reads"]
    extra = [str(tmp_path / x) if x == "rd" else x for x in extra]
    got = _cli(cli, argv + extra + ["--device", "cpu"])
    want = _cli(jax_cli, argv + extra)
    assert got[0] == want[0] == 2
    assert got[2].strip() and got[2].strip() == want[2].strip()
    assert not (tmp_path / "out").exists()
