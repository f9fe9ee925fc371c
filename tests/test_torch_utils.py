"""The port's host utilities against the JAX package's: the ``.2bit``
reader on files the test writes itself (both byte orders, N and mask
blocks), SAM attribute parsing, the interval_list reader, the DNA prefix
trie (its 31-base depth cap included), and ``flatten``, whose Parquet
file must be byte-identical to the JAX verb's."""

import contextlib
import io
import struct

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

_BASE_CODE = {"T": 0, "C": 1, "A": 2, "G": 3}


def _write_2bit(path, seqs: dict, n_blocks: dict, mask_blocks: dict, order: str):
    """A UCSC .2bit file (``order`` "<" or ">") of ``seqs`` with the given
    N and soft-mask blocks (0-based (start, end) pairs)."""
    u = lambda *v: struct.pack(order + "I" * len(v), *v)  # noqa: E731
    names = list(seqs)
    index_len = sum(1 + len(n) + 4 for n in names)
    records, offsets = [], []
    off = 16 + index_len
    for name in names:
        s = seqs[name]
        nb, mb = n_blocks.get(name, []), mask_blocks.get(name, [])
        codes = [_BASE_CODE.get(c.upper(), 0) for c in s]
        codes += [0] * (-len(codes) % 4)
        packed = bytes((a << 6) | (b << 4) | (c << 2) | d
                       for a, b, c, d in zip(*[iter(codes)] * 4))
        rec = (u(len(s), len(nb)) + u(*[a for a, _ in nb]) + u(*[b - a for a, b in nb])
               + u(len(mb)) + u(*[a for a, _ in mb]) + u(*[b - a for a, b in mb])
               + u(0) + packed)
        offsets.append(off)
        records.append(rec)
        off += len(rec)
    head = u(0x1A412743, 0, len(names), 0)
    index = b"".join(bytes([len(n)]) + n.encode() + u(o) for n, o in zip(names, offsets))
    with open(path, "wb") as fh:
        fh.write(head + index + b"".join(records))


@pytest.fixture(scope="module")
def two_bit_files(tmp_path_factory):
    rng = np.random.default_rng(8)
    seqs = {"chrM": "".join(rng.choice(list("ACGT"), 16_571)),
            "chrQ": "".join(rng.choice(list("ACGT"), 1_003)),
            "c": "ACG"}
    n_blocks = {"chrM": [(0, 7), (500, 530), (16_560, 16_571)], "chrQ": [(999, 1003)]}
    mask_blocks = {"chrM": [(100, 260), (515, 600)], "chrQ": [(0, 1)]}
    d = tmp_path_factory.mktemp("twobit")
    for order, name in (("<", "le.2bit"), (">", "be.2bit")):
        _write_2bit(d / name, seqs, n_blocks, mask_blocks, order)
    return d, seqs


@pytest.mark.parametrize("name", ["le.2bit", "be.2bit"])
def test_two_bit_equals_jax(two_bit_files, name):
    from adam_tpu.utils.two_bit import TwoBitFile as JT

    from adam_tpu_torch.utils.two_bit import TwoBitFile

    d, seqs = two_bit_files
    got, want = TwoBitFile(str(d / name)), JT(str(d / name))
    assert got.num_seq == want.num_seq == 3
    assert got.seq_lengths() == want.seq_lengths() == {k: len(v) for k, v in seqs.items()}
    rng = np.random.default_rng(1)
    for contig, s in seqs.items():
        regions = [(0, len(s)), (0, 0), (len(s) - 1, len(s))]
        regions += [tuple(sorted(rng.integers(0, len(s) + 1, 2))) for _ in range(40)]
        for a, b in regions:
            for masks in (False, True):
                assert got.extract(contig, int(a), int(b), apply_masks=masks) == \
                    want.extract(contig, int(a), int(b), apply_masks=masks)
    assert got.extract("chrM", 8, 20) == seqs["chrM"][8:20]
    assert got.extract("chrM", 495, 535) == seqs["chrM"][495:500] + "N" * 30 + \
        seqs["chrM"][530:535]
    assert got.extract("chrM", 98, 102, apply_masks=True) == \
        seqs["chrM"][98:100] + seqs["chrM"][100:102].lower()
    with pytest.raises(ValueError):
        got.extract("chrM", 0, len(seqs["chrM"]) + 1)
    with pytest.raises(ValueError):
        TwoBitFile(b"\x00" * 32)


def test_fragment_reference_file_equals_jax(tmp_path):
    from adam_tpu.io import context as jctx
    from adam_tpu.utils.two_bit import FragmentReferenceFile as JF

    from adam_tpu_torch.io import context as tctx
    from adam_tpu_torch.utils.two_bit import FragmentReferenceFile

    rng = np.random.default_rng(2)
    fa = tmp_path / "ref.fa"
    fa.write_text(">a\n" + "".join(rng.choice(list("ACGTN"), 2_500)) + "\n>b\nACGTACGT\n")
    got, want = (FragmentReferenceFile(*tctx.load_fasta(str(fa), 700)[:2]),
                 JF(*jctx.load_fasta(str(fa), 700)[:2]))
    for contig, a, b in (("a", 0, 2500), ("a", 650, 1450), ("b", 2, 6), ("a", 699, 701)):
        assert got.extract(contig, a, b) == want.extract(contig, a, b)


@pytest.mark.parametrize("text", [
    "XT:i:3\tXU:Z:foo,bar", "", "XX:Z:a:b:c:d", "XB:B:i,1,2,3\tXF:f:1.5\tXA:A:c",
    "XH:H:1AE301\tXB:B:f,1.5,2.25", "NM:i:-4\t\tMD:Z:10A5",
])
def test_attributes_equal_jax(text):
    from adam_tpu.utils import attributes as ja

    from adam_tpu_torch.utils import attributes as ta

    got, want = ta.parse_attributes(text), ja.parse_attributes(text)
    assert [(a.tag, a.tag_type.value, a.value, str(a)) for a in got] == \
        [(a.tag, a.tag_type.value, a.value, str(a)) for a in want]


@pytest.mark.parametrize("bad", ["XT:i", "X:i:3", "XT:Q:3", "XA:A:cd"])
def test_malformed_attributes_raise_as_jax(bad):
    from adam_tpu.utils import attributes as ja

    from adam_tpu_torch.utils import attributes as ta

    with pytest.raises(ValueError) as want:
        ja.parse_attribute(bad)
    with pytest.raises(ValueError) as got:
        ta.parse_attribute(bad)
    assert str(got.value) == str(want.value)


def test_interval_list_equals_jax(tmp_path):
    from adam_tpu.utils.interval_list import IntervalListReader as JR

    from adam_tpu_torch.utils.interval_list import IntervalListReader

    path = tmp_path / "x.interval_list"
    path.write_text(
        "@HD\tVN:1.0\tSO:coordinate\n"
        "@SQ\tSN:1\tLN:249250621\tM5:1b22b98cdeb4a9304cb5d48026a85128\tUR:file:/ref.fa\n"
        "@SQ\tSN:2\tLN:243199373\n"
        "1\t30366\t30503\t+\ttarget_1\n1\t69089\t70010\t+\ttarget_2\n"
        "\n2\t367657\t368599\t-\ttarget_3\n2\t5\t5\t+\n")
    got, want = IntervalListReader(str(path)), JR(str(path))
    assert [(r.referenceName, r.start, r.end, n) for r, n in got] == \
        [(r.referenceName, r.start, r.end, n) for r, n in want]
    assert [(r.name, r.length, r.md5, r.url) for r in got.sequence_dictionary.records] == \
        [(r.name, r.length, r.md5, r.url) for r in want.sequence_dictionary.records]
    assert got.sequence_dictionary["2"].length == 243199373
    assert [(r.start, r.end) for r in got.regions()][0] == (30365, 30503)


SAMPLE = {"AACACT": 1, "AACACC": 4, "ATGGTC": 2, "CACTGC": 5,
          "CCTCGA": 4, "GGCGTC": 6, "TCCTCG": 4, "TTCTTC": 2}


def _random_trie_keys(seed: int, k: int, n: int = 300) -> dict:
    rng = np.random.default_rng(seed)
    keys = {"".join(rng.choice(list("ACGT"), k)): int(v) for v in range(n)}
    keys["".join(rng.choice(list("ACGT"), k - 1)) + "N"] = -1  # dropped at build
    return keys


@pytest.mark.parametrize("seed,k", [(0, 6), (1, 11), (2, 31)])
def test_prefix_trie_equals_jax(seed, k):
    from adam_tpu.ops.prefix_trie import DNAPrefixTrie as JT

    from adam_tpu_torch.ops.prefix_trie import DNAPrefixTrie

    for init in (SAMPLE, _random_trie_keys(seed, k)) if k == 6 else (_random_trie_keys(seed, k),):
        got, want = DNAPrefixTrie(init), JT(init)
        assert got.size == want.size and len(got) == len(want)
        keys = list(init)
        depth = got.depth
        queries = keys[:20] + ["A" * depth, "N" * depth, "*" * depth, keys[0][:-1] + "N"]
        for q in queries:
            assert got.contains(q) == want.contains(q)
            assert got.get_or_else(q, "z") == want.get_or_else(q, "z")
            assert got.get_if_exists(q) == want.get_if_exists(q)
            assert got.search(q) == want.search(q)
        for p in ("", "A", "AC", keys[1][:3], "N", "AN", keys[2]):
            assert got.prefix_search(p) == want.prefix_search(p)
            assert got.suffix_search(p) == want.suffix_search(p)
    assert DNAPrefixTrie(SAMPLE).search("A****C") == {"AACACC": 4, "ATGGTC": 2}
    assert DNAPrefixTrie(SAMPLE).suffix_search("TC") == {"ATGGTC": 2, "GGCGTC": 6,
                                                         "TTCTTC": 2}


@pytest.mark.parametrize("init,err", [({}, AssertionError), ({"ACTCGA": 1, "ACTCA": 2},
                                                             AssertionError),
                                      ({"ATMGC": 0}, ValueError),
                                      ({"A" * 32: 1}, ValueError)])
def test_prefix_trie_refuses_as_jax(init, err):
    from adam_tpu.ops.prefix_trie import DNAPrefixTrie as JT

    from adam_tpu_torch.ops.prefix_trie import DNAPrefixTrie

    with pytest.raises(err) as want:
        JT(init)
    with pytest.raises(err) as got:
        DNAPrefixTrie(init)
    assert str(got.value) == str(want.value)
    with pytest.raises(KeyError):
        DNAPrefixTrie({"AC": 1}).get("GT")


def _nested_table(seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    n = 50
    inner = pa.StructArray.from_arrays(
        [pa.array(rng.integers(0, 9, n)), pa.array([f"s{i}" for i in range(n)])],
        names=["x", "y"])
    outer = pa.StructArray.from_arrays(
        [inner, pa.array(rng.random(n))], names=["inner", "w"])
    lists = pa.array([None if i % 7 == 0 else list(map(int, rng.integers(0, 5, i % 4)))
                      for i in range(n)], pa.list_(pa.int64()))
    t = pa.table({"id": pa.array(np.arange(n)), "outer": outer, "tags": lists,
                  "name.with.dots": pa.array([f"n{i}" for i in range(n)])})
    return t.replace_schema_metadata({b"origin": b"test"})


@pytest.mark.parametrize("src", ["nested", "reads"])
@pytest.mark.parametrize("codec", [None, "snappy", "gzip"])
def test_flatten_is_byte_identical_to_jax(tmp_path, src, codec):
    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main
    from adam_tpu_torch.utils.flattener import flatten_table

    if src == "nested":
        inp = tmp_path / "in.parquet"
        pq.write_table(_nested_table(3), inp)
    else:
        import pathlib
        import sys

        sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))
        from make_synth_sam import make_sam

        from adam_tpu_torch.io import context

        make_sam(str(tmp_path / "in.sam"), 300, 50, seed=2)
        ds = context.load_alignments(str(tmp_path / "in.sam"))
        inp = tmp_path / "in.adam"
        ds.save(str(inp))
    extra = ["-parquet_compression_codec", codec] if codec else []
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_main(["flatten", str(inp), str(tmp_path / "j.parquet"), *extra]) == 0
        assert main(["flatten", str(inp), str(tmp_path / "t.parquet"), *extra,
                     "--device", "cpu"]) == 0
    assert (tmp_path / "t.parquet").read_bytes() == (tmp_path / "j.parquet").read_bytes()
    flat = pq.read_table(tmp_path / "t.parquet")
    assert not any(pa.types.is_struct(f.type) or pa.types.is_list(f.type)
                   for f in flat.schema)
    if src == "nested":
        assert flat.column_names == ["id", "outer__inner__x", "outer__inner__y",
                                     "outer__w", "tags", "name.with.dots"]
        assert flat.schema.metadata == {b"origin": b"test"}
        clash = pa.table({"a": pa.StructArray.from_arrays([pa.array([1])], names=["b"]),
                          "a__b": pa.array([2])})
        with pytest.raises(ValueError, match="collides"):
            flatten_table(clash)
