"""The plain reference against the port's CPU run at a tiny size, and
the comparison's power to see a single wrong answer."""

from __future__ import annotations

import contextlib
import io

import numpy as np
import pytest

from perfbench.reference import compare, kmers, transform
from perfbench.traffic import bam, wgs

TINY = dict(reads=6000, read_len=101, contigs=2, contig_len=40_000)


@pytest.fixture(scope="module", params=[True, False], ids=["dbsnp", "nosites"])
def published(request, tmp_path_factory):
    from adam_tpu_torch.cli.main import main as cli

    d = tmp_path_factory.mktemp("flagship")
    reads = wgs.make_reads(TINY, 3_000_000_401)
    bam.write_bam(str(d / "in.bam"), reads)
    wgs.write_vcf(str(d / "snps.vcf"), reads)
    argv = ["transform", str(d / "in.bam"), str(d / "out.adam"), "-streaming",
            "-mark_duplicate_reads", "-realign_indels", "-recalibrate_base_qualities",
            "-window_reads", "2048", "--device", "cpu"]
    if request.param:
        argv += ["-known_snps", str(d / "snps.vcf")]
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli(argv) == 0
    return reads, request.param, compare.read_transform_output(str(d / "out.adam"))


def _counts(checks):
    return {name: v for name, v, _ in checks}


def test_reference_equals_the_ports_cpu_run(published):
    reads, sites, got = published
    ref = transform.expected(reads, sites)
    assert ref["n_moved"] > 0 and ref["dup"].any()
    assert all(v == 0 for v in _counts(compare.compare_transform(ref, got)).values())


def test_the_reference_answers_digest_is_the_sound_outputs(published):
    reads, sites, got = published
    ref = transform.expected(reads, sites)
    assert compare.digest(compare.as_published(ref)) == compare.digest(got)
    data = got["qual"][0].copy()
    data[5] += 1
    assert compare.digest(compare.as_published(ref)) != compare.digest({**got, "qual": (data, got["qual"][1])})


@pytest.mark.parametrize("fault", ["flip_dup", "other_flag", "change_rg", "change_base",
                                   "change_qual", "move_read", "drop_row"])
def test_one_wrong_answer_is_seen(published, fault):
    reads, sites, got = published
    ref = transform.expected(reads, sites)
    got = {k: (tuple(x.copy() for x in v) if isinstance(v, tuple) else v.copy())
           for k, v in got.items()}
    if fault == "flip_dup":
        got["flags"][7] ^= 0x400
        name = "dup_flags_differ"
    elif fault == "other_flag":
        got["flags"][9] ^= 0x200
        name = "other_flags_differ"
    elif fault == "change_rg":
        got["rg"][13] = "rg2" if got["rg"][13] == "rg1" else "rg1"
        name = "read_groups_differ"
    elif fault == "change_base":
        got["bases"][0][321] = ord("C") if got["bases"][0][321] == ord("A") else ord("A")
        name = "bases_differ"
    elif fault == "change_qual":
        got["qual"][0][123] += 1
        name = "quals_differ"
    elif fault == "move_read":
        got["start"][11] += 1
        name = "alignments_differ"
    else:
        got = {k: ((v[0], v[1][:-1]) if isinstance(v, tuple) else v[:-1]) for k, v in got.items()}
        name = "rows_missing_or_extra"
    assert _counts(compare.compare_transform(ref, got))[name] > 0


def test_the_control_of_the_flagship_is_not_correct():
    reads = wgs.make_reads(dict(reads=100_000, contigs=2, contig_len=400_000), 3_000_000_403)
    ref = transform.expected(reads, True)
    ctl = transform.expected(reads, True, control=True)
    assert _counts(compare.compare_transform(ref, compare.as_published(ctl)))["quals_differ"] > 0


def test_kmer_reference_equals_the_ports_cpu_count_and_sees_a_dropped_kmer(tmp_path):
    from adam_tpu_torch.io import context

    reads = wgs.make_reads(TINY, 3_000_000_405)
    bam.write_bam(str(tmp_path / "in.bam"), reads)
    counts = context.load_alignments(str(tmp_path / "in.bam")).count_kmers(21, device="cpu")
    ref = kmers.counts(reads, 21)
    assert all(v == 0 for v in _counts(compare.compare_kmers(ref, compare.kmer_arrays(counts, 21))).values())
    assert sum(ref[1]) == kmers.n_kmers(reads, 21)
    counts.pop(next(iter(counts)))
    assert _counts(compare.compare_kmers(ref, compare.kmer_arrays(counts, 21)))["kmers_missing_or_extra"] == 1


def test_the_control_of_the_kmer_table_is_not_correct():
    reads = wgs.make_reads(dict(reads=40_000, contigs=2, contig_len=200_000), 3_000_000_407)
    checks = _counts(compare.compare_kmers(kmers.counts(reads, 21), kmers.control_counts(reads, 21)))
    assert checks["kmers_missing_or_extra"] > 0


def test_the_same_seed_makes_the_same_input_and_another_seed_another():
    a = wgs.make_reads(TINY, 2**31 + 11)
    b = wgs.make_reads(TINY, 2**31 + 11)
    c = wgs.make_reads(TINY, 2**31 + 12)
    assert np.array_equal(a.bases, b.bases) and a.md == b.md
    assert not np.array_equal(a.bases, c.bases)
