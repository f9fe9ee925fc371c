"""Whole rehearsal runs, on the CPU at a tiny size, with the timed path
broken underneath: each fault a cell can have must turn ``correct``
false.  One card, so no exchange between chips is left out."""

from __future__ import annotations

import pytest

from perfbench.tests._helpers import rehearse


def test_a_sound_rehearsal_is_correct_in_every_cell():
    for cell in ("transform.chr20_30x_dbsnp", "kmers.chrom11_lowcov_k21"):
        out = rehearse(cell)
        assert out["correct"] is True, out["checks"]
        assert out["attempted"] >= 1 and out["failed"] == 0


def _break_transform(monkeypatch, fault):
    from adam_tpu_torch.io import parquet
    from adam_tpu_torch.pipelines import bqsr, markdup

    if fault == "state_unchanged":  # the recalibration returns the quals it got
        monkeypatch.setattr(bqsr, "apply_table_body", lambda bases, quals, *a, **k: quals)
    elif fault == "half_the_batch":  # each part written with half its rows
        orig = parquet.write_part
        monkeypatch.setattr(parquet, "write_part",
                            lambda table, path, c: orig(table.slice(0, table.num_rows // 2), path, c))
    elif fault == "base_altered":  # one base changed where kernel 2 packs the bases
        orig = bqsr.pack_rows

        def altered(mat, lens, size, encode="none"):
            out = orig(mat, lens, size, encode=encode)
            if encode == "base_decode" and size:
                out = out.clone()
                i = size // 3
                out[i] = ord("C") if int(out[i]) == ord("A") else ord("A")
            return out
        monkeypatch.setattr(bqsr, "pack_rows", altered)
    elif fault == "answer_altered":  # one duplicate flag flipped where it is resolved
        orig = markdup.resolve_duplicates

        def flipped(*a, **k):
            dup = orig(*a, **k).copy()
            dup[len(dup) // 3] = ~dup[len(dup) // 3]
            return dup
        monkeypatch.setattr(markdup, "resolve_duplicates", flipped)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "base_altered",
                                   "answer_altered"])
def test_a_broken_transform_is_not_correct(monkeypatch, fault):
    _break_transform(monkeypatch, fault)
    out = rehearse("transform.chr20_30x_nosites")
    assert out["correct"] is False


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "answer_altered"])
def test_a_broken_kmer_count_is_not_correct(monkeypatch, fault):
    from adam_tpu_torch.ops import kmer

    orig = kmer.count_kmers

    def broken(batch, k, device="cuda"):
        if fault == "state_unchanged":  # the table it started from: empty
            return {}
        if fault == "half_the_batch":
            return orig(batch.take_rows(list(range(batch.n_rows // 2)))
                        if hasattr(batch, "take_rows") else _half(batch), k, device)
        out = dict(orig(batch, k, device))
        key = next(iter(out))
        out[key] += 1
        return out
    monkeypatch.setattr(kmer, "count_kmers", broken)
    out = rehearse("kmers.chrom11_lowcov_k21")
    assert out["correct"] is False


def _half(batch):
    import dataclasses

    import numpy as np

    valid = np.array(batch.valid, copy=True)
    valid[len(valid) // 2:] = False
    return dataclasses.replace(batch, valid=valid)
