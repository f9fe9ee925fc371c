"""The plugin API against the JAX package's (``adam_tpu/plugins.py``): a
Take-N plugin with a projection and a predicate, and an access control,
written once per package, give the same rows on the same input, through
the library (``execute_plugin``) and through each package's ``plugin``
verb; ``load_plugin`` raises JAX's errors."""

import contextlib
import io
import pathlib
import sys

import numpy as np
import pytest
import torch

from adam_tpu import plugins as JP
from adam_tpu_torch import plugins as TP

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

HERE = __name__  # the dotted module path the loaders import


class JaxTakeN(JP.AdamPlugin):
    projection = ["readName", "sequence", "flags", "mapq"]

    def predicate(self, batch):
        return np.asarray(batch.mapq) >= 30

    def run(self, ds, args):
        n = int(args[0]) if args else 5
        b = ds.batch.to_numpy()
        return [f"{name}\t{int(f)}\t{int(q)}" for name, f, q in
                zip(list(ds.sidecar.names)[:n], b.flags[:n], b.mapq[:n])]


class JaxFirstOfPair(JP.AccessControl):
    def predicate(self, batch):
        return (np.asarray(batch.flags) & 0x40) != 0


class PortTakeN(TP.AdamPlugin):
    projection = ["readName", "sequence", "flags", "mapq"]

    def predicate(self, batch):  # a CPU tensor mask
        return torch.from_numpy(np.asarray(batch.mapq)) >= 30

    def run(self, ds, args):
        n = int(args[0]) if args else 5
        b = ds.batch.to_numpy()
        return [f"{name}\t{int(f)}\t{int(q)}" for name, f, q in
                zip(list(ds.sidecar.names)[:n], b.flags[:n], b.mapq[:n])]


class PortFirstOfPair(TP.AccessControl):
    def predicate(self, batch):  # a numpy mask
        return (np.asarray(batch.flags) & 0x40) != 0


class PortAll(TP.AdamPlugin):
    def run(self, ds, args):
        return [len(ds), ds.batch.lmax]


class JaxAll(JP.AdamPlugin):
    def run(self, ds, args):
        return [len(ds), ds.batch.lmax]


def not_a_plugin():
    return None


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.io import context, parquet

    d = tmp_path_factory.mktemp("plugins")
    make_wgs(str(d / "in.sam"), 1200, 100, seed=4, n_contigs=2, contig_len=30_000)
    ds = context.load_alignments(str(d / "in.sam"))
    parquet.save_alignments(str(d / "in.adam"), ds.batch, ds.sidecar, ds.header)
    return d


@pytest.mark.parametrize("src", ["in.sam", "in.adam"])
@pytest.mark.parametrize("plugin,ac,args", [
    ("TakeN", None, ()), ("TakeN", "FirstOfPair", ("40",)), ("All", None, ()),
    ("All", "FirstOfPair", ()),
])
def test_execute_plugin_equals_jax(inputs, src, plugin, ac, args):
    path = str(inputs / src)
    want = JP.execute_plugin(globals()["Jax" + plugin](), path, args,
                             globals()["Jax" + ac]() if ac else None)
    got = TP.execute_plugin(globals()["Port" + plugin](), path, args,
                            globals()["Port" + ac]() if ac else None, device="cpu")
    assert got == want
    assert len(got) > 1


def test_projection_is_pushed_down(inputs):
    """A projected Parquet read carries only the projected columns: the
    plugin sees no MD tags."""
    class Quals(TP.AdamPlugin):
        projection = ["readName", "sequence"]

        def run(self, ds, args):
            return [any(m is not None for m in ds.sidecar.md)]

    assert TP.execute_plugin(Quals(), str(inputs / "in.adam"), device="cpu") == [False]
    assert TP.execute_plugin(Quals(), str(inputs / "in.sam"), device="cpu") == [True]


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("extra", [(), ("-access_control", "{pkg}FirstOfPair"),
                                   ("-plugin_args", "25", "-access_control",
                                    "{pkg}FirstOfPair")])
def test_plugin_verb_equals_jax(inputs, extra):
    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    path = str(inputs / "in.adam")
    jx = [e.format(pkg=f"{HERE}.Jax") for e in extra]
    pt = [e.format(pkg=f"{HERE}.Port") for e in extra]
    jrc, jout = _cli(jax_main, ["plugin", f"{HERE}.JaxTakeN", path, *jx])
    rc, out = _cli(main, ["plugin", f"{HERE}.PortTakeN", path, *pt, "--device", "cpu"])
    assert rc == jrc == 0
    assert out == jout and out.count("\n") >= 5


@pytest.mark.parametrize("port_name,jax_name,base,err", [
    ("NoDot", "NoDot", "AdamPlugin", ValueError),
    (f"{HERE}.not_a_plugin", f"{HERE}.not_a_plugin", "AdamPlugin", TypeError),
    (f"{HERE}.JaxTakeN", f"{HERE}.PortTakeN", "AdamPlugin", TypeError),  # the other package's
    (f"{HERE}.PortTakeN", f"{HERE}.JaxTakeN", "AccessControl", TypeError),
])
def test_load_plugin_raises_jax_errors(port_name, jax_name, base, err):
    with pytest.raises(err) as want:
        JP.load_plugin(jax_name, base=getattr(JP, base))
    with pytest.raises(err) as got:
        TP.load_plugin(port_name, base=getattr(TP, base))
    assert str(got.value) == str(want.value).replace(jax_name, port_name)
    assert isinstance(TP.load_plugin(f"{HERE}.PortTakeN"), PortTakeN)
