"""The port's interval engine against the JAX package's, element for
element and in order: ``ops/intervals.py`` (torch on the CPU here),
``pipelines/region_join.py``, ``parallel/sharded_join.py`` and the host
genome binning of ``parallel/partitioner.py``.  The inputs are seeded
random intervals plus crafted rows: adjacent intervals, an interval inside
another, intervals overhanging their contig's end, a zero-length contig,
contigs outside the dictionary (-1 and past the last), and empty sides.
Every value is an integer, so the tolerance is exact."""

import numpy as np
import pytest
import torch

from adam_tpu.models.dictionaries import SequenceDictionary as JSeqDict
from adam_tpu.models.dictionaries import SequenceRecord as JSeqRec
from adam_tpu.ops import intervals as jiv
from adam_tpu.parallel import partitioner as jpart
from adam_tpu.parallel import sharded_join as jsj
from adam_tpu.pipelines import region_join as jrj

from adam_tpu_torch.models.dictionaries import SequenceDictionary, SequenceRecord
from adam_tpu_torch.ops import intervals as iv
from adam_tpu_torch.parallel import partitioner as part
from adam_tpu_torch.parallel import sharded_join as sj
from adam_tpu_torch.pipelines import region_join as rj

LENGTHS = (5_000, 0, 3_000)  # the middle contig has length 0


def _dicts():
    recs = [(f"chr{i + 1}", n) for i, n in enumerate(LENGTHS)]
    return (SequenceDictionary(tuple(SequenceRecord(a, n) for a, n in recs)),
            JSeqDict(tuple(JSeqRec(a, n) for a, n in recs)))


def _crafted():
    rows = [
        (0, 100, 200), (0, 200, 300),      # adjacent
        (0, 1_000, 2_000), (0, 1_200, 1_300),  # contained
        (0, 4_900, 5_300),                 # overhangs chr1's end
        (1, 0, 50), (1, 40, 90),           # on the zero-length contig
        (2, 2_990, 3_100), (2, 0, 1),      # overhang, one base
        (0, 1_000, 2_000),                 # an exact duplicate
    ]
    return np.array(rows, np.int64).T


def _outside():
    return np.array([(-1, 10, 20), (3, 0, 100), (5, 50, 60)], np.int64).T


def _intervals(case: str, side: int):
    """(contig, start, end) i64 columns for a case; ``side`` 0 = left,
    1 = right."""
    if case == "empty_left" and side == 0 or case == "empty_right" and side == 1:
        return np.zeros((3, 0), np.int64)
    seed = {"random0": 0, "random1": 1, "crafted": 2, "outside": 3,
            "empty_left": 4, "empty_right": 5}[case] * 2 + side
    rng = np.random.default_rng(seed)
    n = 50 if case == "random1" else 300
    contig = rng.integers(0, len(LENGTHS), n)
    span = np.maximum(np.array(LENGTHS)[contig], 400)
    start = rng.integers(0, span)
    end = start + rng.integers(1, 250, n)
    cols = np.stack([contig, start, end]).astype(np.int64)
    if case in ("crafted", "outside"):
        cols = np.concatenate([cols, _crafted()], axis=1)
    if case == "outside":
        cols = np.concatenate([cols, _outside()], axis=1)
    return cols


CASES = ["random0", "random1", "crafted", "outside", "empty_left", "empty_right"]


def _eq(port, ref):
    """A port tensor (or tuple of them) equals a JAX numpy array (or
    tuple), element for element and in order."""
    if isinstance(ref, tuple):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _eq(p, r)
        return
    assert isinstance(port, torch.Tensor) and port.dtype in (torch.int64, torch.bool)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert port.numpy().shape == np.asarray(ref).shape


def _both(case, side, device="cpu"):
    c, s, e = _intervals(case, side)
    return rj.IntervalArrays.of(c, s, e, device=device), jrj.IntervalArrays.of(c, s, e)


@pytest.mark.parametrize("case", CASES)
def test_interval_functions(case):
    lc, ls, le = _intervals(case, 0)
    rc, rs, re = _intervals(case, 1)
    t = [torch.from_numpy(x) for x in (lc, ls, le, rc, rs, re)]
    _eq(iv.sort_intervals(*t[:3]), jiv.sort_intervals(lc, ls, le))
    for adjacent in (True, False):
        _eq(iv.merge_intervals(*t[:3], adjacent=adjacent),
            jiv.merge_intervals(lc, ls, le, adjacent=adjacent))
    m = jiv.merge_intervals(lc, ls, le)
    mt = iv.merge_intervals(*t[:3])
    if len(ls):
        _eq(iv.overlap_group_ranges(*mt[:3], *t[3:]),
            jiv.overlap_group_ranges(*m[:3], rc, rs, re))
        lo, hi = jiv.overlap_group_ranges(*m[:3], rc, rs, re)
        _eq(iv.expand_ranges(torch.from_numpy(lo), torch.from_numpy(hi)),
            jiv.expand_ranges(lo, hi))
    _eq(iv.point_depth(*t[:3], t[3], t[4]), jiv.point_depth(lc, ls, le, rc, rs))
    _eq(iv.overlap_join(*t), jiv.overlap_join(lc, ls, le, rc, rs, re))
    _eq(iv.overlap_join(*t[3:], *t[:3]), jiv.overlap_join(rc, rs, re, lc, ls, le))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("bin_size", [1_000, 64])
def test_region_joins(case, bin_size):
    (left, jleft), (right, jright) = _both(case, 0), _both(case, 1)
    sd, jsd = _dicts()
    _eq(rj.broadcast_region_join(left, right), jrj.broadcast_region_join(jleft, jright))
    _eq(rj.shuffle_region_join(left, right, sd, bin_size),
        jrj.shuffle_region_join(jleft, jright, jsd, bin_size))
    cov, jcov = rj.find_coverage_regions(left), jrj.find_coverage_regions(jleft)
    _eq((cov.contig, cov.start, cov.end), (jcov.contig, jcov.start, jcov.end))
    _eq(rj.depth_at(right, left), jrj.depth_at(jright, jleft))
    if len(left):
        idx, jidx = rj.NonoverlappingRegions(left), jrj.NonoverlappingRegions(jleft)
        assert len(idx) == len(jidx)
        _eq(idx.regions_for(right), jidx.regions_for(jright))
        _eq(idx.has_regions_for(right), jidx.has_regions_for(jright))
    else:
        with pytest.raises(ValueError, match="non-empty"):
            rj.NonoverlappingRegions(left)


class _Batch:
    """The coordinate columns the interval spill reads, for both packages."""

    def __init__(self, contig, start, end, flags, valid):
        self.contig_idx, self.start, self.end = contig, start, end
        self.flags, self.valid = flags, valid
        self.n_rows = len(contig)

    @property
    def is_mapped(self):
        return (self.flags & 0x4) == 0


def _batches(case):
    c, s, e = _intervals(case, 0)
    n = len(c)
    rng = np.random.default_rng(99)
    flags = np.where(rng.random(n) < 0.1, 0x4, 0).astype(np.int32)
    valid = rng.random(n) > 0.05
    if n:
        s = s.copy()
        s[0] = -1  # a mapped record with POS=0 (start -1): never spilled
    cuts = [0, n // 3, n // 2, n]
    return [(_Batch(c[a:b].astype(np.int32), s[a:b], e[a:b], flags[a:b], valid[a:b]),
             None, None) for a, b in zip(cuts[:-1], cuts[1:])]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("bin_size", [1_000, 64])
def test_sharded_join(case, bin_size, tmp_path):
    sd, jsd = _dicts()
    right, jright = _both(case, 1)
    sites = rj.IntervalArrays.of(right.contig, right.start, right.start + 1, device="cpu")
    jsites = jrj.IntervalArrays.of(jright.contig, jright.start, jright.start + 1)
    _eq(sj.streamed_depth(_batches(case), sites, sd, bin_size, str(tmp_path / "t")),
        jsj.streamed_depth(_batches(case), jsites, jsd, bin_size, str(tmp_path / "j")))
    got = list(sj.streamed_overlap_join(_batches(case), right, sd, bin_size))
    ref = list(jsj.streamed_overlap_join(_batches(case), jright, jsd, bin_size))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _eq(g, r)
    # the spill files themselves: the same bytes, bin for bin, and stale
    # files of an earlier run purged at open
    spills = []
    for mod, bins, d in ((sj, part.GenomeBins(bin_size, sd), tmp_path / "ts"),
                         (jsj, jpart.GenomeBins(bin_size, jsd), tmp_path / "js")):
        d.mkdir()
        (d / "bin-000042.i64").write_bytes(b"\x01" * 32)
        sp, n = mod._spill_batches(_batches(case), bins, str(d))
        spills.append((n, sp.touched_bins(),
                       {f: (d / f).read_bytes() for f in sorted(p.name for p in d.iterdir())}))
        sp.cleanup()
        assert not any(d.iterdir())
    assert spills[0] == spills[1]
    if spills[0][1]:
        assert min(spills[0][1]) >= 0


@pytest.mark.parametrize("bin_size", [1, 64, 1_000, 10_000])
def test_genome_bins_and_partitions(bin_size):
    sd, jsd = _dicts()
    bins, jbins = part.GenomeBins(bin_size, sd), jpart.GenomeBins(bin_size, jsd)
    np.testing.assert_array_equal(bins.bins_per_contig, jbins.bins_per_contig)
    np.testing.assert_array_equal(bins.bin_offsets, jbins.bin_offsets)
    assert bins.num_bins == jbins.num_bins
    rng = np.random.default_rng(bin_size)
    contig = rng.integers(0, 3, 500)
    pos = rng.integers(0, 6_000, 500)
    end = pos + rng.integers(0, 300, 500)
    np.testing.assert_array_equal(bins.start_bin(contig, pos), jbins.start_bin(contig, pos))
    np.testing.assert_array_equal(bins.end_bin(contig, end), jbins.end_bin(contig, end))
    for b in sorted({0, bins.num_bins - 1, bins.num_bins // 2,
                     int(bins.bin_offsets[1]), int(bins.bin_offsets[2]) - 1}):
        assert bins.invert(b) == jbins.invert(b)
        assert bins.dedupe_region(b) == jbins.dedupe_region(b)
    contig = np.where(rng.random(500) < 0.1, -1, contig)
    for n in (1, 3, 8):
        np.testing.assert_array_equal(part.position_partition(sd, contig, pos, n),
                                      jpart.position_partition(jsd, contig, pos, n))
        for a, b in zip(part.shard_rows_by_position(sd, contig, pos, n),
                        jpart.shard_rows_by_position(jsd, contig, pos, n)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(part.region_partition(sd, contig, pos, bin_size),
                                  jpart.region_partition(jsd, contig, pos, bin_size))


@pytest.mark.parametrize("values", [[], [3], [1, 2, 5, 9, 11], [4, 4, 7]])
@pytest.mark.parametrize("width", [1, 2, 3])
def test_pairing(values, width):
    v = np.array(values, np.int64)
    t = torch.from_numpy(v)
    np.testing.assert_array_equal(rj.sliding(t, width).numpy(), jrj.sliding(v, width))
    for a, b in zip(rj.pair(t), jrj.pair(v)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert rj.pair_with_ends(t) == jrj.pair_with_ends(v)


def test_interval_arrays_default_to_the_card():
    import inspect

    assert inspect.signature(rj.IntervalArrays.of).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rj.IntervalArrays.of([0], [1], [2])
