"""k-mer and q-mer counting of the port (``ops/kmer.py``) against the JAX
package's, on the CPU, with exact equality: the packed keys and window
masks, the sorted histogram and the q-mer weights array for array (k of
1, 5 and 21, and k past the read length, with N bases in the reads), the
count dictionaries bit for bit and in the same order, and the
``count_kmers`` command line's output file and ``-printHistogram``
output byte for byte against ``python -m adam_tpu.cli.main count_kmers``
on a SAM, a BAM and a part directory the port wrote."""

import contextlib
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))


def _random_batch(seed=0, n=600, L=40):
    """Reads of random lengths with N bases (code 4), QUAL_PAD past each
    read, some rows invalid."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 5, (n, L)).astype(np.uint8)
    lengths = rng.integers(10, L + 1, n).astype(np.int32)
    past = np.arange(L)[None, :] >= lengths[:, None]
    bases[past] = 5
    quals = rng.integers(2, 41, (n, L)).astype(np.uint8)
    quals[past] = 255
    valid = rng.random(n) < 0.95
    return dict(bases=bases, quals=quals, lengths=lengths, valid=valid)


@pytest.mark.parametrize("k,L", [(1, 40), (5, 40), (21, 40), (21, 15)])
def test_device_bodies_equal_jax(k, L):
    import jax.numpy as jnp

    from adam_tpu.ops import kmer as jk

    from adam_tpu_torch.ops import kmer as tk

    a = _random_batch(k + L, L=L)
    assert (a["bases"] == 4).sum() > 0
    j = {n: jnp.asarray(v) for n, v in a.items()}
    t = {n: torch.from_numpy(v) for n, v in a.items()}
    args = ("bases", "lengths", "valid")
    qargs = ("bases", "quals", "lengths", "valid")
    for name, jargs in (("extract_kmers", args), ("device_kmer_histogram", args),
                        ("device_qmer_weights", qargs)):
        want = getattr(jk, name)(*(j[n] for n in jargs), k)
        got = getattr(tk, name)(*(t[n] for n in jargs), k)
        assert len(got) == len(want)
        for w, g in zip(want, got):
            w = np.asarray(w)
            assert w.dtype == g.numpy().dtype, name
            np.testing.assert_array_equal(w, g.numpy(), err_msg=name)
    if k > L:  # one window a read, none of them valid
        assert not tk.extract_kmers(t["bases"], t["lengths"], t["valid"], k)[1].any()


def test_k_past_the_packed_maximum_raises():
    from adam_tpu_torch.ops import kmer as tk

    t = {n: torch.from_numpy(v) for n, v in _random_batch().items()}
    with pytest.raises(ValueError, match="exceeds packed maximum 21"):
        tk.extract_kmers(t["bases"], t["lengths"], t["valid"], 22)


@pytest.mark.parametrize("s", ["A", "ACGTN", "NNNNNNNNNNNNNNNNNNNNN", "TTGCAACGTAGGCTANNACGT"])
def test_pack_and_unpack_equal_jax(s):
    from adam_tpu.ops import kmer as jk

    from adam_tpu_torch.ops import kmer as tk

    v = tk.pack_kmer_string(s)
    assert v == jk.pack_kmer_string(s)
    assert tk.unpack_kmer(v, len(s)) == jk.unpack_kmer(v, len(s)) == s
    assert tk._unpack_kmers(np.array([v]), len(s)) == [s]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A WGS-shaped SAM, its BAM (the port's writer) and the port's part
    directory of it."""
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.io import sam as tsam
    from adam_tpu_torch.pipelines.streamed import transform_streamed

    d = tmp_path_factory.mktemp("kmer")
    make_wgs(str(d / "in.sam"), 3000, 100, n_contigs=2, contig_len=30_000)
    tsam.write_bam(str(d / "in.bam"), *tsam.read_sam(str(d / "in.sam")))
    transform_streamed(str(d / "in.sam"), str(d / "in.adam"), window_reads=1024,
                       device="cpu")
    return d


@pytest.mark.parametrize("what", ["kmers", "qmers"])
@pytest.mark.parametrize("k", [1, 5, 11, 21])
def test_counts_equal_jax(inputs, what, k):
    from adam_tpu.io import sam as jsam
    from adam_tpu.ops import kmer as jk

    from adam_tpu_torch.io import sam as tsam
    from adam_tpu_torch.ops import kmer as tk

    want = getattr(jk, f"count_{what}")(jsam.read_sam(str(inputs / "in.sam"))[0], k)
    got = getattr(tk, f"count_{what}")(tsam.read_sam(str(inputs / "in.sam"))[0], k,
                                       device="cpu")
    assert len(got) > (1000 if k > 1 else 3)
    assert list(got.items()) == list(want.items())  # same keys, order and values
    assert all(type(v) is (int if what == "kmers" else float) for v in got.values())


def test_empty_batch_counts_nothing():
    from adam_tpu_torch.formats.batch import ReadBatch
    from adam_tpu_torch.ops import kmer as tk

    assert tk.count_kmers(ReadBatch.empty(), 21, device="cpu") == {}
    assert tk.count_qmers(ReadBatch.empty(), 21, device="cpu") == {}


def test_counts_default_to_the_card(inputs):
    import inspect

    from adam_tpu_torch.io import sam as tsam
    from adam_tpu_torch.ops import kmer as tk

    for fn in (tk.count_kmers, tk.count_qmers):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        batch = tsam.read_sam(str(inputs / "in.sam"))[0]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tk.count_kmers(batch, 21)


@pytest.mark.parametrize("qmers", [False, True])
@pytest.mark.parametrize("name", ["in.sam", "in.bam", "in.adam"])
def test_cli_output_byte_identical_to_jax(inputs, tmp_path, name, qmers):
    from adam_tpu_torch.cli.main import main

    flags = ["-printHistogram"] + (["-countQmers"] if qmers else [])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    want = subprocess.run(
        [sys.executable, "-m", "adam_tpu.cli.main", "count_kmers", str(inputs / name),
         str(tmp_path / "jax.txt"), "21", *flags],
        env=env, capture_output=True, text=True, timeout=300)
    assert want.returncode == 0, want.stderr
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["count_kmers", str(inputs / name), str(tmp_path / "torch.txt"), "21",
                   *flags, "--device", "cpu"])
    assert rc == 0
    got = (tmp_path / "torch.txt").read_bytes()
    assert got == (tmp_path / "jax.txt").read_bytes()
    assert len(got.splitlines()) > 1000
    assert out.getvalue() == want.stdout and want.stdout.startswith("(")
    assert '"n_reads": 3000' in err.getvalue()
