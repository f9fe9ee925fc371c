"""The Spark embedding executor against the JAX package's
(``adam_tpu/api/spark_executor.py``): the same Arrow IPC stream of
partitions through JAX's ``serve`` and the port's ``serve(...,
StageConfig(device="cpu"))``, in-process over ``BytesIO``; every output
batch must be ``equals`` (exact: the Arrow values and the schema).

The partitions are contiguous slices of a WGS-shaped SAM (duplicates,
indels, soft clips, two read groups), as Spark's input splits hand them
to executors, plus hand-made ones: an all-unmapped partition, and one
with a duplicate pair placed across two partitions, which each package
leaves unresolved (``mapPartitions`` semantics).  One subprocess run of
``python -m adam_tpu_torch transform -backend spark - - --device cpu``
checks the CLI wiring and that standard output carries nothing but the
stream."""

import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

N_READS = 2400
N_PARTS = 4


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from make_known_indels_vcf import make_known_indels_vcf
    from make_wgs_sam import make_wgs

    from adam_tpu.io import context

    d = tmp_path_factory.mktemp("spark")
    sam = str(d / "in.sam")
    make_wgs(sam, N_READS, 100, seed=21, n_contigs=2, contig_len=30_000,
             known_sites_out=str(d / "snps.vcf"))
    make_known_indels_vcf(sam, str(d / "indels.vcf"))
    ds = context.load_alignments(sam)
    return d, ds


def _slices(ds, n_parts: int = N_PARTS) -> list:
    """The dataset cut in file order into ``n_parts`` contiguous slices."""
    edges = np.linspace(0, ds.batch.n_rows, n_parts + 1).astype(int)
    return [ds.take_rows(np.arange(a, b)) for a, b in zip(edges[:-1], edges[1:])]


def _unmapped(ds, n: int = 30):
    """A partition of reads with the unmapped flag and no placement (the
    JAX package's records, as a SAM with '*' RNAME would give them)."""
    from adam_tpu.formats import schema
    from adam_tpu.formats.batch import pack_reads

    b = ds.batch.to_numpy()
    recs = []
    for i in range(n):
        L = int(b.lengths[i])
        recs.append(dict(
            name=f"u{i}", flags=schema.FLAG_UNMAPPED, contig_idx=-1, start=-1,
            mapq=0, cigar="*", seq=schema.decode_bases(b.bases[i], L),
            qual="".join(chr(33 + int(q)) for q in b.quals[i][:L]),
            read_group_idx=0, attrs=""))
    batch, side = pack_reads(recs)
    return type(ds)(batch, side, ds.header)


def _stream(parts) -> bytes:
    """One Arrow IPC stream, one batch per partition (the JAX package's
    ``to_arrow``, as a driver would build it)."""
    buf = io.BytesIO()
    writer = None
    for p in parts:
        t = p.to_arrow().combine_chunks()
        rb = (t.to_batches()[0] if t.num_rows else
              pa.record_batch([c.combine_chunks() for c in t.columns], schema=t.schema))
        if writer is None:
            writer = pa.ipc.new_stream(buf, rb.schema)
        writer.write_batch(rb)
    if writer is not None:
        writer.close()
    return buf.getvalue()


def _known(d, which):
    if which is None:
        return None, None
    from adam_tpu.api.datasets import GenotypeDataset as JGD

    from adam_tpu_torch.api.datasets import GenotypeDataset

    path = str(d / f"{which}.vcf")
    if which == "snps":
        return JGD.load(path).snp_table(), GenotypeDataset.load(path).snp_table()
    return JGD.load(path).indel_table(), GenotypeDataset.load(path).indel_table()


def _serve_both(payload: bytes, stages: dict, known=None, d=None):
    """-> (JAX batches, port batches, JAX served, port served, port stats)."""
    from adam_tpu.api import spark_executor as jse

    from adam_tpu_torch.api import spark_executor as tse

    jcfg = jse.StageConfig(**stages)
    tcfg = tse.StageConfig(**stages, device="cpu")
    if known is not None:
        jk, tk = _known(d, known)
        setattr(jcfg, "known_" + known, jk)
        setattr(tcfg, "known_" + known, tk)
    jout, tout = io.BytesIO(), io.BytesIO()
    jserved = jse.serve(jcfg, io.BytesIO(payload), jout)
    stats = {}
    tserved = tse.serve(tcfg, io.BytesIO(payload), tout, stats=stats)
    jb = pa.ipc.open_stream(io.BytesIO(jout.getvalue()))
    tb = pa.ipc.open_stream(io.BytesIO(tout.getvalue()))
    assert tb.schema.equals(jb.schema)
    return list(jb), list(tb), jserved, tserved, stats


STAGE_SETS = {
    "markdup": dict(mark_duplicates=True),
    "bqsr": dict(recalibrate=True),
    "markdup_bqsr": dict(mark_duplicates=True, recalibrate=True),
    "realign": dict(realign=True),
    "all": dict(mark_duplicates=True, realign=True, recalibrate=True),
}


@pytest.mark.parametrize("stages", list(STAGE_SETS))
def test_serve_equals_jax(data, stages):
    d, ds = data
    parts = _slices(ds)
    jb, tb, js, ts, stats = _serve_both(_stream(parts), STAGE_SETS[stages])
    assert js == ts == len(tb) == len(jb) == N_PARTS
    for want, got in zip(jb, tb):
        assert got.equals(want)
    assert [b.num_rows for b in tb] == [len(p) for p in parts]
    assert stats["n_partitions"] == N_PARTS and stats["n_reads"] == ds.batch.n_rows
    assert stats["n_rows_out"] == sum(b.num_rows for b in tb)
    if "markdup" in stages:
        flags = np.concatenate([b.column("flags").to_numpy() for b in tb])
        assert ((flags & 0x400) != 0).sum() > 0
    if stages in ("bqsr", "all"):
        inp = pa.Table.from_batches(list(pa.ipc.open_stream(_stream(parts))))
        out = pa.Table.from_batches(tb)
        assert out.column("qual").to_pylist() != inp.column("qual").to_pylist()


@pytest.mark.parametrize("known,stages", [
    ("snps", dict(recalibrate=True)),
    ("snps", dict(mark_duplicates=True, realign=True, recalibrate=True)),
    ("indels", dict(realign=True)),
    ("indels", dict(mark_duplicates=True, realign=True, recalibrate=True)),
])
def test_serve_with_known_sites_equals_jax(data, known, stages):
    d, ds = data
    jb, tb, js, ts, _ = _serve_both(_stream(_slices(ds)), stages, known=known, d=d)
    assert js == ts == N_PARTS
    for want, got in zip(jb, tb):
        assert got.equals(want)


def test_zero_partitions_give_a_valid_empty_stream(data):
    from adam_tpu_torch.formats.batch import ReadBatch, ReadSidecar
    from adam_tpu_torch.io.parquet import to_arrow_alignments
    from adam_tpu_torch.io.sam import SamHeader

    _, ds = data
    schema = ds.to_arrow().schema
    buf = io.BytesIO()
    pa.ipc.new_stream(buf, schema).close()
    jb, tb, js, ts, stats = _serve_both(buf.getvalue(), STAGE_SETS["all"])
    assert js == ts == 0 and jb == tb == []
    from adam_tpu_torch.api import spark_executor as tse

    out = io.BytesIO()
    tse.serve(tse.StageConfig(device="cpu"), io.BytesIO(buf.getvalue()), out)
    reader = pa.ipc.open_stream(io.BytesIO(out.getvalue()))
    assert reader.schema.equals(
        to_arrow_alignments(ReadBatch.empty(), ReadSidecar(), SamHeader()).schema)
    assert stats["n_partitions"] == 0 and stats["n_reads"] == 0


@pytest.mark.parametrize("stages", ["markdup", "all"])
def test_all_unmapped_and_empty_partitions_equal_jax(data, stages):
    _, ds = data
    empty = ds.take_rows(np.zeros(0, np.int64))
    parts = [_unmapped(ds), _slices(ds)[0], empty, _unmapped(ds, 1)]
    jb, tb, js, ts, _ = _serve_both(_stream(parts), STAGE_SETS[stages])
    assert js == ts == 4
    for want, got in zip(jb, tb):
        assert got.equals(want)
    assert [b.num_rows for b in tb] == [30, len(parts[1]), 0, 1]


def test_the_same_partition_twice_gives_the_same_batch(data):
    """Nothing carries from one partition to the next: the SNP mask,
    the targets, the solved table and the kernel scratch are rebuilt."""
    d, ds = data
    a, b = _slices(ds, 2)
    jb, tb, *_ = _serve_both(_stream([a, b, a]), STAGE_SETS["all"], known="snps", d=d)
    assert tb[0].equals(tb[2]) and not tb[0].equals(tb[1])
    for want, got in zip(jb, tb):
        assert got.equals(want)


def _reads(ds, names, start: int = 5000):
    """Unpaired forward reads at one start (duplicates of each other),
    MD present, in ``ds``'s header."""
    from adam_tpu.formats.batch import pack_reads

    recs = [dict(name=n, flags=0, contig_idx=0, start=start, mapq=60, cigar="20M",
                 seq="ACGTACGTACGTACGTACGT", qual=chr(33 + 20 + k) * 20,
                 read_group_idx=0, attrs="", md="20")
            for k, n in enumerate(names)]
    batch, side = pack_reads(recs)
    return type(ds)(batch, side, ds.header)


def test_a_duplicate_pair_across_partitions_stays_unresolved(data):
    """Per-partition markdup: a read and its duplicate in two partitions
    are both kept, exactly as in the JAX package; in one partition the
    lower-scoring one is marked."""
    _, ds = data
    cfg = dict(mark_duplicates=True)
    jb, split, *_ = _serve_both(_stream([_reads(ds, ["a"]), _reads(ds, ["b"])]), cfg)
    for want, got in zip(jb, split):
        assert got.equals(want)
    assert [int(x.column("flags")[0].as_py()) & 0x400 for x in split] == [0, 0]
    jb, together, *_ = _serve_both(_stream([_reads(ds, ["a", "b"])]), cfg)
    assert together[0].equals(jb[0])
    assert (together[0].column("flags").to_numpy() & 0x400).tolist() == [0x400, 0]


def test_cli_backend_spark_subprocess(data):
    d, ds = data
    parts = _slices(ds, 3)
    payload = _stream(parts)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "adam_tpu_torch", "transform", "-", "-", "-backend",
         "spark", "-mark_duplicate_reads", "-recalibrate_base_qualities",
         "-known_snps", str(d / "snps.vcf"), "-log_level", "info", "--device", "cpu"],
        input=payload, capture_output=True, timeout=600, cwd=str(REPO), env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = list(pa.ipc.open_stream(io.BytesIO(proc.stdout)))
    jb, _tb, *_ = _serve_both(payload, STAGE_SETS["markdup_bqsr"], known="snps", d=d)
    assert len(got) == 3
    for want, g in zip(jb, got):
        assert g.equals(want)
    # the stream is all of standard output: its IPC bytes end it exactly
    sink = pa.BufferOutputStream()
    w = pa.ipc.new_stream(sink, got[0].schema)
    for g in got:
        w.write_batch(g)
    w.close()
    assert len(proc.stdout) == len(sink.getvalue().to_pybytes())
    stats = json.loads(proc.stderr.decode().strip().splitlines()[-1])
    assert stats["n_partitions"] == 3 and stats["n_reads"] == ds.batch.n_rows
    assert stats["device"] == "cpu" and stats["kernel_launches"]["observe_hist"] == 0
    assert {"read_s", "write_s", "mark_duplicates_s", "bqsr_s", "total_s",
            "reads_per_s"} <= set(stats)
