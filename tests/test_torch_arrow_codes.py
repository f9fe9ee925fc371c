"""The Parquet load's base and quality matrices (``native.arrow_codes``,
``native/arrowcols.cpp``): the port's ``from_arrow_alignments`` against
the JAX package's numpy code, every batch field with exact dtype and
values, on crafted Arrow tables, each once on one thread and once split
over four (every table but the empty one holds at least 8,192 rows, so the
split engages); the binding refuses parts it cannot take; and one load
records one ``Arrow Codes (native)`` span inside ``parquet.from_arrow``."""

import dataclasses

import numpy as np
import pytest

ROWS = 8192
_ACGT = np.frombuffer(b"ACGT", np.uint8)


def _seqs(rng, lens, alphabet=_ACGT):
    return [alphabet[rng.integers(0, len(alphabet), int(n))].tobytes().decode()
            for n in lens]


def _quals(rng, lens, lo=35, hi=74):
    return [bytes(rng.integers(lo, hi, int(n), dtype=np.uint8)).decode() for n in lens]


def _table(seqs=None, quals=None, chunks=1):
    """An Arrow table of the given ``sequence`` and ``qual`` columns (a
    column left None is not in the table), with a CIGAR of the sequence's
    length, a start and a flag word, each column in ``chunks`` chunks."""
    import pyarrow as pa

    n = len(seqs if seqs is not None else quals)
    cols = {}
    if seqs is not None:
        cols["sequence"] = seqs
    if quals is not None:
        cols["qual"] = quals
    lens = [len(s) if s else 1 for s in (seqs or ["A"] * n)]
    cols["cigar"] = [f"{m}M" for m in lens]
    cols["start"] = list(range(0, 7 * n, 7))
    cols["flags"] = [0] * n
    types = {"start": pa.int64(), "flags": pa.int32()}
    cuts = np.linspace(0, n, chunks + 1).astype(int)
    return pa.table({
        k: pa.chunked_array([pa.array(v[a:z], types.get(k, pa.string()))
                             for a, z in zip(cuts[:-1], cuts[1:])])
        for k, v in cols.items()})


def _ragged(rng, n=ROWS):
    """The benchmark's mix: 88% of reads 100 bp, the rest 60-99 bp."""
    lens = np.where(rng.random(n) < 0.88, 100, rng.integers(60, 100, n))
    return _seqs(rng, lens), _quals(rng, lens)


def _with_every(values, step, value, first=0):
    return [value if i % step == first else v for i, v in enumerate(values)]


def _case(name):
    """(table, round_rows_to) of a case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    seqs, quals = _ragged(rng)
    uniform = _seqs(rng, [100] * ROWS), _quals(rng, [100] * ROWS)
    if name == "ragged":
        return _table(seqs, quals), 1
    if name == "uniform_contiguous":
        return _table(*uniform), 1
    if name == "uniform_null_rows":
        s = _with_every(uniform[0], 7, None)
        return _table(s, _with_every(_with_every(uniform[1], 7, None), 11, None, 3)), 1
    if name == "empty_sequence":
        return _table(_with_every(seqs, 5, ""), _with_every(quals, 10, "")), 1
    if name == "qual_star":
        return _table(seqs, _with_every(quals, 3, "*")), 1
    if name == "null_qual":
        return _table(seqs, _with_every(quals, 4, None)), 1
    if name == "qual_shorter_and_longer":
        q = [q[: len(q) // 2] if i % 3 == 0 else q + "I" * (7 + i % 40) if i % 3 == 1 else q
             for i, q in enumerate(quals)]
        return _table(seqs, q), 1
    if name == "no_qual_column":
        return _table(seqs, None), 1
    if name == "no_sequence_column":
        return _table(None, quals), 1
    if name == "lower_case_and_iupac":
        lens = rng.integers(1, 120, ROWS)
        return _table(_seqs(rng, lens, np.frombuffer(b"ACGTNacgtnRYKMSWBDHVryk*.=-", np.uint8)),
                      _quals(rng, lens)), 1
    if name == "qual_bytes_below_bang":
        lens = np.where(rng.random(ROWS) < 0.88, 100, rng.integers(60, 100, ROWS))
        return _table(_seqs(rng, lens), _quals(rng, lens, lo=1, hi=60)), 1
    if name == "zero_rows":
        return _table([], []), 1
    if name == "four_chunks":
        return _table(_with_every(seqs, 9, None), _with_every(quals, 6, "*"), chunks=4), 1
    if name == "sliced_at_an_offset":
        return _table(seqs + uniform[0], quals + uniform[1], chunks=3).slice(1234, ROWS + 77), 1
    if name == "round_rows_to_1024":
        return _table(seqs + uniform[0][:100], quals + uniform[1][:100]), 1024
    raise KeyError(name)


CASES = ["ragged", "uniform_contiguous", "uniform_null_rows", "empty_sequence", "qual_star",
         "null_qual", "qual_shorter_and_longer", "no_qual_column", "no_sequence_column",
         "lower_case_and_iupac", "qual_bytes_below_bang", "zero_rows", "four_chunks",
         "sliced_at_an_offset", "round_rows_to_1024"]


@pytest.mark.parametrize("threads", ["1", "4"])
@pytest.mark.parametrize("case", CASES)
def test_from_arrow_alignments_equals_jax(case, threads, monkeypatch):
    from adam_tpu.io import parquet as jparquet

    from adam_tpu_torch.io import parquet as tparquet

    monkeypatch.setenv("ADAM_TPU_NATIVE_THREADS", threads)
    table, round_rows_to = _case(case)
    assert table.num_rows >= ROWS or case == "zero_rows"
    want = jparquet.from_arrow_alignments(table, round_rows_to=round_rows_to)[0].to_numpy()
    got = tparquet.from_arrow_alignments(table, round_rows_to=round_rows_to)[0]
    for f in dataclasses.fields(got):
        a, b = np.asarray(getattr(want, f.name)), np.asarray(getattr(got, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    if case == "zero_rows":
        assert got.bases.shape == got.quals.shape == (0, 1)


def _parts():
    buf = np.frombuffer(b"ACGTACGTAC", np.uint8).copy()
    return dict(buf=buf, offsets=np.array([0, 4, 4, 10], np.int64),
                valid=np.array([True, False, True]))


BAD_PARTS = {
    "buf_int8": ("buf", lambda p: p["buf"].view(np.int8)),
    "offsets_int32": ("offsets", lambda p: p["offsets"].astype(np.int32)),
    "valid_uint8": ("valid", lambda p: p["valid"].astype(np.uint8)),
    "offsets_past_the_buffer": ("offsets", lambda p: np.array([0, 4, 4, 11], np.int64)),
    "offsets_before_the_buffer": ("offsets", lambda p: np.array([-1, 4, 4, 10], np.int64)),
    "offsets_backwards": ("offsets", lambda p: np.array([0, 6, 4, 10], np.int64)),
    "offsets_of_another_row_count": ("offsets", lambda p: np.array([0, 4, 10], np.int64)),
    "buf_two_dimensional": ("buf", lambda p: p["buf"].reshape(2, 5)),
}


@pytest.mark.parametrize("column", ["sequence", "qual"])
@pytest.mark.parametrize("bad", sorted(BAD_PARTS))
def test_arrow_codes_raises_on_parts_it_cannot_take(bad, column):
    from adam_tpu_torch import native

    seq, qual = _parts(), _parts()
    part, make = BAD_PARTS[bad]
    target = seq if column == "sequence" else qual
    target[part] = make(target)
    with pytest.raises(ValueError, match="arrow_codes"):
        native.arrow_codes(seq["buf"], seq["offsets"], seq["valid"],
                           qual["buf"], qual["offsets"], qual["valid"])


def test_arrow_codes_raises_on_columns_of_different_lengths():
    from adam_tpu_torch import native

    seq, qual = _parts(), _parts()
    with pytest.raises(ValueError, match="3 sequences beside 2 quals"):
        native.arrow_codes(seq["buf"], seq["offsets"], seq["valid"],
                           qual["buf"], qual["offsets"][:3], qual["valid"][:2])


def test_one_load_records_one_arrow_codes_span_inside_from_arrow(tmp_path):
    import pyarrow.parquet as pq

    from adam_tpu_torch.io import parquet as tparquet
    from adam_tpu_torch.utils import instrumentation as ins
    from adam_tpu_torch.utils import telemetry as tele

    path = str(tmp_path / "part-r-00000.parquet")
    pq.write_table(_case("ragged")[0], path)
    tele.TRACE.reset()
    tele.TRACE.recording = True
    try:
        batch = tparquet.load_alignments(path)[0]
        spans = tele.TRACE.snapshot()["spans"]
        evs = [e for e in tele.TRACE.to_chrome_trace()["traceEvents"] if e.get("ph") == "X"]
    finally:
        tele.TRACE.recording = False
        tele.TRACE.reset()
        ins.TIMERS.reset()
    assert batch.n_rows == ROWS
    assert spans[tele.SPAN_ARROW_CODES]["count"] == spans["parquet.from_arrow"]["count"] == 1
    (codes,) = [e for e in evs if e["name"] == tele.SPAN_ARROW_CODES]
    (outer,) = [e for e in evs if e["name"] == "parquet.from_arrow"]
    assert codes["tid"] == outer["tid"]
    assert outer["ts"] <= codes["ts"] and codes["ts"] + codes["dur"] <= outer["ts"] + outer["dur"]
