"""The port's ``depth`` and ``view`` verbs against the JAX package's
command line (``python -m adam_tpu.cli.main``), in-process on the CPU:
standard output byte for byte.  ``depth`` on a SAM and on a Parquet part
directory (projected), by the broadcast join and by ``-stream`` at two
bin widths, with a VCF that carries named sites, a site on a contig the
reads lack and a site past its contig's end; ``view`` with each of
``-f/-F/-g/-G`` (the 0x8 quirk among them), ``-c``, SAM text, and ``-o``
to a SAM file."""

import contextlib
import io
import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from make_wgs_sam import make_wgs

    from adam_tpu_torch.pipelines.streamed import transform_streamed

    d = tmp_path_factory.mktemp("depth_view")
    make_wgs(str(d / "in.sam"), 2500, 100, n_contigs=2, contig_len=30_000,
             known_sites_out=str(d / "snps.vcf"))
    text = (d / "snps.vcf").read_text().splitlines()
    body = [ln for ln in text if not ln.startswith("#")]
    # named sites, a site on a contig the reads lack, one past the end of
    # its contig, and the body out of coordinate order
    extra = ["chr17\t100\trs1\tA\tC\t50\tPASS\t.",
             "chrZ\t500\trsZ\tG\tT\t50\tPASS\t.",
             "chr18\t29990\t.\tC\tA\t50\tPASS\t.",
             "chr18\t31000\t.\tC\tA\t50\tPASS\t."]
    head = [ln for ln in text if ln.startswith("#")]
    (d / "sites.vcf").write_text("\n".join(head + body[::-1] + extra) + "\n")
    transform_streamed(str(d / "in.sam"), str(d / "out.adam"), realign=False,
                       window_reads=1024, device="cpu")
    return d


def _stdout(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    assert rc == 0, argv
    return out.getvalue()


def _both(argv, port_extra=("--device", "cpu")):
    from adam_tpu.cli.main import main as jax_cli

    from adam_tpu_torch.cli.main import main as cli

    return _stdout(cli, [*argv, *port_extra]), _stdout(jax_cli, argv)


@pytest.mark.parametrize("reads", ["in.sam", "out.adam"])
@pytest.mark.parametrize("mode", [(), ("-stream",), ("-stream", "-bin_size", "7000"),
                                  ("-cartesian",)])
def test_depth_stdout_equals_jax(inputs, reads, mode):
    got, want = _both(["depth", str(inputs / reads), str(inputs / "sites.vcf"), *mode])
    assert got == want
    lines = got.splitlines()
    assert lines[0] == "location\tname\tdepth"
    assert len(lines) == 1 + len((inputs / "snps.vcf").read_text().splitlines()) - 4 + 4
    assert any(int(ln.split("\t")[-1]) > 0 for ln in lines[1:])


def test_depth_forms_agree(inputs):
    """The broadcast join and the bin spill give the same report."""
    from adam_tpu_torch.cli.main import main as cli

    vcf = str(inputs / "sites.vcf")
    ref = _stdout(cli, ["depth", str(inputs / "out.adam"), vcf, "--device", "cpu"])
    for bins in ("1000", "30000", "1000000"):
        assert _stdout(cli, ["depth", str(inputs / "out.adam"), vcf, "-stream",
                             "-bin_size", bins, "--device", "cpu"]) == ref


@pytest.mark.parametrize("flags", [
    ("-c",), ("-c", "-F", "1024"), ("-c", "-f", "8"), ("-c", "-F", "8"),
    ("-c", "-g", "24"), ("-c", "-G", "3"), ("-c", "-f", "1", "-F", "1040", "-g", "96"),
    ("-f", "16", "-G", "1024"), (),
])
@pytest.mark.parametrize("reads", ["in.sam", "out.adam"])
def test_view_stdout_equals_jax(inputs, flags, reads):
    got, want = _both(["view", str(inputs / reads), *flags])
    assert got == want and got


def test_view_output_file_equals_jax(inputs, tmp_path):
    from adam_tpu.cli.main import main as jax_cli

    from adam_tpu_torch.cli.main import main as cli

    args = ["view", str(inputs / "out.adam"), "-F", "1024"]
    assert _stdout(cli, [*args, "-o", str(tmp_path / "t.sam"), "--device", "cpu"]) == ""
    _stdout(jax_cli, [*args, str(tmp_path / "j.sam")])
    assert (tmp_path / "t.sam").read_bytes() == (tmp_path / "j.sam").read_bytes()


def test_view_and_depth_default_to_the_card(inputs):
    import torch

    from adam_tpu_torch.cli.main import parser_for

    for argv in (["view", "x"], ["depth", "a", "b"]):
        assert parser_for(argv[0]).parse_args(argv[1:]).device == "cuda"
    if not torch.cuda.is_available():
        from adam_tpu_torch.cli.main import main as cli

        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli(["view", "-c", str(inputs / "in.sam")])
