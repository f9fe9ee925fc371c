"""The port's per-kernel microbench (``adam_tpu_torch/utils/kernelbench``)
against the JAX package's: the same synthetic window from the same seed,
the same outputs from every kernel's thunk, the same document keys apart
from the backend and device ones, and the port's perf ledger flattening
the rows as JAX's does.  On the CPU only the ``plain`` rows run; the
``cuda`` rows run in the one card-only case.

JAX is imported inside the tests that compare with it, so the card-only
case runs where JAX is not installed."""

import json

import numpy as np
import pytest
import torch

from adam_tpu_torch.utils import kernelbench as kb

CPU = torch.device("cpu")


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def test_synth_equals_jax():
    from adam_tpu.utils import kernelbench as jkb

    got, want = kb._synth(48, 40, 3), jkb._synth(48, 40, 3)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kernel", kb.KERNELS)
def test_thunks_equal_jax_and_each_other(kernel):
    """Each kernel's ``plain`` thunk equals JAX's ``xla`` thunk bit for
    bit, and the ``cuda`` thunk's bodies (on CPU tensors: their plain
    paths) equal both — the twins kernelbench composes are the bodies."""
    from adam_tpu.ops.kernel_backend import backend_scope
    from adam_tpu.utils import kernelbench as jkb

    with backend_scope("xla"):
        want = _tuple(jkb._build(kernel, 32, 32, 3)())
    plain = _tuple(kb._build(kernel, "plain", 32, 32, 3, CPU)())
    bodies = _tuple(kb._build(kernel, "cuda", 32, 32, 3, CPU)())
    assert len(want) == len(plain) == len(bodies)
    for w, p, b in zip(want, plain, bodies):
        np.testing.assert_array_equal(np.asarray(w), p.numpy())
        assert torch.equal(p, b)


def test_document_keys_equal_jax_but_backend_and_device():
    from adam_tpu.utils import kernelbench as jkb

    jdoc = jkb.run_kernelbench(grids=((32, 32),), iters=1, backends=("xla",))
    doc = kb.run_kernelbench(grids=((32, 32),), iters=1, device="cpu")
    assert doc["schema"] == jkb.SCHEMA == kb.SCHEMA == "adam_tpu.kernelbench/1"
    assert set(doc) - {"device"} == set(jdoc) - {"jax_backend"}
    assert doc["device"] == "cpu"
    # JAX's fused_bc row has no counterpart: the port runs pass B and C apart
    assert [set(r) for r in doc["rows"]] == [
        set(r) for r in jdoc["rows"] if r["kernel"] != "fused_bc"]
    assert kb.KERNELS == tuple(k for k in jkb.KERNELS if k != "fused_bc")
    assert len(kb.BACKENDS) == len(jkb.BACKENDS) == 2


def test_cpu_runs_plain_rows_only():
    doc = kb.run_kernelbench(grids=((32, 32), (16, 24)), iters=2, device="cpu")
    rows = doc["rows"]
    assert len(rows) == len(kb.KERNELS) * 2
    assert not [r for r in rows if "error" in r]
    assert {(r["backend"], r["mode"]) for r in rows} == {("plain", "plain")}
    assert {r["kernel"] for r in rows} == set(kb.KERNELS)
    for r in rows:
        assert r["mean_s"] >= r["best_s"] > 0 and r["iters"] == 2, r


@pytest.mark.parametrize("backends", [("cuda",), ("cuda", "plain"), ("nope",)])
def test_cuda_rows_raise_on_the_cpu(backends):
    """No quiet plain row under a cuda name: the sweep refuses to start."""
    with pytest.raises(ValueError):
        kb.run_kernelbench(grids=((32, 32),), iters=1, backends=backends,
                           device="cpu")


def test_perfledger_flattens_the_rows():
    from adam_tpu.utils import perfledger as jax_ledger

    from adam_tpu_torch.utils import perfledger

    doc = kb.run_kernelbench(grids=((32, 32),), iters=1, device="cpu")
    doc["rows"].append({"kernel": "pack", "backend": "cuda", "mode": "cuda",
                        "g": 32, "gl": 32, "iters": 1, "error": "RuntimeError: x"})
    keys = perfledger.snapshot_keys({"kernels": doc})
    want = {f"kernels.{k}.plain.g32x32.{s}" for k in kb.KERNELS
            for s in ("mean_s", "best_s")}
    assert set(keys) == want  # the error row books nothing
    assert {d for _v, d in keys.values()} == {"lower"}
    assert keys == jax_ledger.snapshot_keys({"kernels": doc})


def test_an_error_row_keeps_the_document_and_fails_the_cli(monkeypatch, capsys):
    real = kb._build

    def broken(kernel, *a):
        if kernel == "apply":
            raise RuntimeError("nvcc apply.cu failed")
        return real(kernel, *a)

    assert kb.main(["--device", "cpu", "--grids", "16x24", "--iters", "1"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert len(doc["rows"]) == len(kb.KERNELS) == 3 and doc["device"] == "cpu"
    monkeypatch.setattr(kb, "_build", broken)
    assert kb.main(["--device", "cpu", "--grids", "16x24", "--iters", "1",
                    "--kernels", "apply,pack"]) == 1
    rows = json.loads(capsys.readouterr().out)["rows"]
    assert [("error" in r, r["kernel"]) for r in rows] == [(True, "apply"),
                                                           (False, "pack")]
    assert rows[0]["error"] == "RuntimeError: nvcc apply.cu failed"
    with pytest.raises(SystemExit):
        kb.main(["--device", "cpu", "--kernels", "observe,nope"])


#: kernel -> launches of (observe_hist, pack_rows) per call of its thunk
LAUNCHES_PER_CALL = {"observe": (1, 0), "pack": (0, 1), "apply": (0, 2)}


@pytest.mark.cuda
def test_cuda_rows_on_the_card():
    """Both backends on the card: no error row, the cuda thunks launch
    kernels 1 and 2 as many times per call as the table says and equal
    the plain thunks bit for bit, the plain thunks launch nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from adam_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    doc = kb.run_kernelbench(grids=((256, 128),), iters=2)
    assert doc["device"] == "cuda:0"
    assert not [r for r in doc["rows"] if "error" in r], doc["rows"]
    assert {(r["kernel"], r["backend"]) for r in doc["rows"]} == {
        (k, b) for k in kb.KERNELS for b in kb.BACKENDS}
    for kernel, (k1, k2) in LAUNCHES_PER_CALL.items():
        kernels.reset_launches()
        got = _tuple(kb._build(kernel, "cuda", 256, 128, 3, dev)())
        torch.cuda.synchronize(dev)
        n = kernels.launches()
        assert (n["observe_hist"], n["pack_rows"]) == (k1, k2), kernel
        want = _tuple(kb._build(kernel, "plain", 256, 128, 3, dev)())
        assert kernels.launches() == n, kernel
        for a, b in zip(got, want):
            assert torch.equal(a, b), kernel
