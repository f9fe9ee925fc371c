"""Duplicate-marking parity: on a WGS-shaped input (read groups, PCR
duplicates, soft clips, unmapped pairs) cut into several windows, the
port's ingest, per-window reductions (5' key, score) and global resolve
give exactly the JAX package's columns and duplicate flags.  The port's
device lexsort (a cascade of stable torch sorts) is ``np.lexsort``'s
permutation, ties included."""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

WINDOW = 1024


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    """(JAX datasets, port datasets) of one input, window by window."""
    from make_wgs_sam import make_wgs

    from adam_tpu.api.datasets import AlignmentDataset as JaxDataset
    from adam_tpu.io.sam import iter_sam_batches as jax_iter

    from adam_tpu_torch.api.datasets import AlignmentDataset
    from adam_tpu_torch.io.sam import iter_sam_batches

    path = str(tmp_path_factory.mktemp("markdup") / "in.sam")
    make_wgs(path, 3000, 100, n_contigs=2, contig_len=20_000, seed=11)
    jax_ds = [JaxDataset(b.to_numpy(), s, h) for b, s, h in jax_iter(path, WINDOW)]
    port_ds = [AlignmentDataset(b, s, h) for b, s, h in iter_sam_batches(path, WINDOW)]
    assert len(jax_ds) == len(port_ds) == 3
    return jax_ds, port_ds


def _fields(batch) -> dict:
    return {f.name: np.asarray(getattr(batch, f.name))
            for f in dataclasses.fields(batch)}


def test_ingest_equals_jax(windows):
    from adam_tpu_torch.convert import batch_from_numpy

    for jd, pd in zip(*windows):
        want = batch_from_numpy(_fields(jd.batch))
        for name, col in _fields(pd.batch).items():
            np.testing.assert_array_equal(col, getattr(want, name), err_msg=name)
        assert pd.sidecar.names.to_list() == jd.sidecar.names.to_list()
        assert pd.sidecar.md.to_list() == jd.sidecar.md.to_list()
        assert pd.header.read_groups.names == jd.header.read_groups.names


def _port_columns(jd):
    """The port's pass-A reductions on the JAX batch's fields, padded to
    the window grid as the streamed pass places them."""
    from adam_tpu_torch.convert import batch_from_numpy
    from adam_tpu_torch.parallel.device_pool import ResidentWindow
    from adam_tpu_torch.pipelines.markdup import markdup_columns

    b = batch_from_numpy(_fields(jd.batch))
    five, score = markdup_columns(b, ResidentWindow.place(b, torch.device("cpu")))
    return five.numpy(), score.numpy()


def _jax_columns(jd):
    import jax.numpy as jnp

    from adam_tpu.pipelines.markdup import markdup_columns_local

    b = jd.batch
    five, score = markdup_columns_local(*(jnp.asarray(x) for x in (
        b.start, b.end, b.flags, b.cigar_ops, b.cigar_lens, b.cigar_n,
        b.quals, b.lengths)))
    return np.asarray(five), np.asarray(score)


def test_markdup_columns_equal_jax(windows):
    for jd in windows[0]:
        five, score = _port_columns(jd)
        want_five, want_score = _jax_columns(jd)
        assert five.dtype == np.int64 and score.dtype == np.int32
        np.testing.assert_array_equal(five, want_five)
        np.testing.assert_array_equal(score, want_score)


def test_duplicate_flags_equal_jax(windows):
    from adam_tpu.pipelines import markdup as jax_md

    from adam_tpu_torch.pipelines import markdup as md

    jax_parts, port_parts = [], []
    for jd, pd in zip(*windows):
        five, score = _jax_columns(jd)
        jax_parts.append(jax_md.row_summary(jd, jd.batch, five_prime=five, score=score))
        pfive, pscore = _port_columns(jd)
        port_parts.append(md.row_summary(pd, five_prime=pfive, score=pscore))
    want = jax_md.resolve_duplicates(jax_md.concat_summaries(jax_parts))
    got = md.resolve_duplicates(md.concat_summaries(port_parts), sort_device="cpu")
    np.testing.assert_array_equal(got, want)
    assert 0 < int(got.sum()) < len(got)
    flags = np.concatenate([np.asarray(pd.batch.flags) for pd in windows[1]])
    np.testing.assert_array_equal(md.apply_duplicate_flags(flags, got),
                                  jax_md.apply_duplicate_flags(flags, want))


@pytest.mark.parametrize("seed,n,hi", [(0, 1, 3), (1, 500, 4), (2, 4000, 50),
                                       (3, 4000, 1 << 40)])
def test_device_lexsort_equals_np_lexsort(seed, n, hi):
    from adam_tpu_torch.pipelines.markdup import device_lexsort

    rng = np.random.default_rng(seed)
    keys = tuple(rng.integers(-hi, hi, n, dtype=np.int64) for _ in range(5))
    np.testing.assert_array_equal(device_lexsort(keys, "cpu"), np.lexsort(keys))


def test_convert_refuses_what_it_cannot_carry(windows):
    from adam_tpu_torch.convert import batch_from_numpy, table_from_numpy

    fields = _fields(windows[0][0].batch)
    with pytest.raises(ValueError, match="missing"):
        batch_from_numpy({k: v for k, v in fields.items() if k != "flags"})
    with pytest.raises(ValueError, match="start"):
        batch_from_numpy({**fields, "start": fields["start"].astype(np.int32)})
    table = np.arange(3 * 94 * 17 * 17).reshape(3, 94, 17, 17) % 60
    # any stored dtype is cast to u8 and any cycle width is carried, as
    # the JAX package applies them; the quality and dinucleotide axes
    # are checked
    for t in (table.astype(np.uint8), table.astype(np.int32), table[:, :, 3:-2]):
        got = table_from_numpy(t)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), t.astype(np.uint8))
    with pytest.raises(ValueError):
        table_from_numpy(table[:, :93])
    with pytest.raises(ValueError):
        table_from_numpy(table[..., :16])
