"""The PRINT verbs against the JAX CLI's on the same inputs, standard
output (and ``-o``/``allelecount`` files) byte for byte: ``print``
(plain, ``-pretty``, ``-projection``, ``-o``, several files),
``print_genes`` on a GTF the test writes, ``print_tags`` (``-list``,
``-count``), ``listdict``, ``allelecount`` on a VCF the test writes and on
its genotype store; ``buildinfo`` by the shape of its lines.  Reads come
from ``tools/make_synth_sam.py``."""

import contextlib
import io
import pathlib
import re
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))


def _gtf(path, n_genes: int = 12, seed: int = 3) -> None:
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        fh.write("#!genome-build test\n")
        for g in range(n_genes):
            chrom, strand = f"chr{1 + g % 3}", "+-"[g % 2]
            start = int(rng.integers(1, 1_000_000))
            end = start + 5000
            gid = f"ENSG{g:05d}"
            fh.write(f'{chrom}\ttest\tgene\t{start}\t{end}\t.\t{strand}\t.\t'
                     f'gene_id "{gid}"; gene_name "G{g}";\n')
            for t in range(1 + g % 3):
                tid = f"ENST{g:05d}{t}"
                fh.write(f'{chrom}\ttest\ttranscript\t{start}\t{end - t}\t.\t{strand}\t.\t'
                         f'gene_id "{gid}"; transcript_id "{tid}";\n')
                for e in range(1 + t):
                    s = start + 1000 * e
                    fh.write(f'{chrom}\ttest\texon\t{s}\t{s + 200}\t.\t{strand}\t.\t'
                             f'gene_id "{gid}"; transcript_id "{tid}"; '
                             f'exon_number "{e + 1}";\n')


def _vcf(path, n: int = 60, seed: int = 4) -> None:
    rng = np.random.default_rng(seed)
    samples = ("NA1", "NA2", "NA3")
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.1\n##contig=<ID=chr20,length=1000000>\n"
                 "##contig=<ID=chr21,length=1000000>\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(samples) + "\n")
        pos = np.cumsum(rng.integers(1, 5000, n)) + 100
        for i in range(n):
            ref = "ACGT"[rng.integers(0, 4)]
            alt = "ACGT"[(("ACGT".index(ref)) + 1 + rng.integers(0, 3)) % 4]
            if i % 7 == 0:
                alt = ref + "TT"
            gts = ["./." if rng.random() < 0.1 else
                   f"{rng.integers(0, 2)}{'|' if i % 2 else '/'}{rng.integers(0, 2)}"
                   for _ in samples]
            fh.write(f"chr{20 + i % 2}\t{pos[i]}\t.\t{ref}\t{alt}\t50\tPASS\t.\tGT\t"
                     + "\t".join(gts) + "\n")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from make_synth_sam import make_sam

    from adam_tpu_torch.io import context

    d = tmp_path_factory.mktemp("printers")
    make_sam(str(d / "in.sam"), 400, 50, seed=6)
    # tags a count can find, on some reads; one QC-failed read drops out
    lines = (d / "in.sam").read_text().splitlines()
    out, k = [], 0
    for ln in lines:
        if not ln.startswith("@"):
            f = ln.split("\t")
            if k % 5 == 0:
                f.append(f"XT:A:{'UMR'[k % 3]}")
            if k % 3 == 0:
                f.append(f"NM:i:{k % 4}")
            if k == 7:
                f[1] = str(int(f[1]) | 0x200)
            ln = "\t".join(f)
            k += 1
        out.append(ln)
    (d / "in.sam").write_text("\n".join(out) + "\n")
    context.load_alignments(str(d / "in.sam")).save(str(d / "in.adam"))
    context.load_alignments(str(d / "in.sam")).save(str(d / "in2.adam"))
    _gtf(d / "genes.gtf")
    _vcf(d / "calls.vcf")
    return d


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    assert rc == 0, argv
    return out.getvalue()


def _both(argv, tmp_path=None, files=()):
    """-> (port stdout, JAX stdout), with each run's named output files
    compared byte for byte."""
    from adam_tpu.cli.main import main as jax_main

    from adam_tpu_torch.cli.main import main

    want = _run(jax_main, argv)
    wfiles = {f: (tmp_path / f).read_bytes() for f in files}
    for f in files:
        (tmp_path / f).unlink()
    got = _run(main, [*argv, "--device", "cpu"])
    for f in files:
        assert (tmp_path / f).read_bytes() == wfiles[f], f
    return got, want


@pytest.mark.parametrize("flags", [(), ("-pretty",), ("-projection", "readName,flags,start"),
                                   ("-projection", " mapq , cigar", "-pretty")])
def test_print_equals_jax(inputs, flags):
    got, want = _both(["print", str(inputs / "in.adam"), *flags])
    assert got == want and got.count("readName" if "mapq" not in str(flags) else "cigar") > 0


def test_print_to_a_file_and_several_files_equals_jax(inputs, tmp_path):
    got, want = _both(["print", str(inputs / "in.adam"), str(inputs / "in2.adam"),
                       "-o", str(tmp_path / "out.json")], tmp_path, ["out.json"])
    assert got == want == ""
    assert (tmp_path / "out.json").read_text().count("\n") == 800


def test_print_genes_equals_jax(inputs):
    got, want = _both(["print_genes", str(inputs / "genes.gtf")])
    assert got == want
    assert got.count("Gene ENSG") == 12 and "\tTranscript ENST" in got


@pytest.mark.parametrize("flags", [(), ("-list", "5"), ("-count", "XT,NM"),
                                   ("-list", "3", "-count", "RG,XT,ZZ")])
@pytest.mark.parametrize("src", ["in.sam", "in.adam"])
def test_print_tags_equals_jax(inputs, src, flags):
    got, want = _both(["print_tags", str(inputs / src), *flags])
    assert got == want
    assert got.splitlines()[-1] == "Total: 399"


@pytest.mark.parametrize("src", ["in.sam", "in.adam"])
def test_listdict_equals_jax(inputs, src):
    got, want = _both(["listdict", str(inputs / src)])
    assert got == want and got.startswith("chr")


def test_allelecount_equals_jax(inputs, tmp_path):
    from adam_tpu_torch.cli.main import main

    _run(main, ["vcf2adam", str(inputs / "calls.vcf"), str(tmp_path / "calls.gt"),
                "--device", "cpu"])
    for src in (str(inputs / "calls.vcf"), str(tmp_path / "calls.gt")):
        got, want = _both(["allelecount", src, str(tmp_path / "ac.txt")], tmp_path,
                          ["ac.txt"])
        assert got == want == ""
    rows = (tmp_path / "ac.txt").read_text().splitlines()
    assert len(rows) > 60 and all(len(r.split("\t")) == 4 for r in rows)


def test_buildinfo_has_its_lines_shape():
    import torch

    from adam_tpu_torch.cli.main import main

    lines = _run(main, ["buildinfo"]).splitlines()
    keys = [ln.split(": ", 1)[0] for ln in lines]
    assert keys == ["adam_tpu_torch version", "torch version", "cuda", "python", "device"]
    values = dict(ln.split(": ", 1) for ln in lines)
    assert re.fullmatch(r"\d+\.\d+\.\d+", values["adam_tpu_torch version"])
    assert values["torch version"] == torch.__version__
    assert values["cuda"] == str(torch.version.cuda)
    assert re.fullmatch(r"3\.\d+\.\d+", values["python"])
    assert values["device"] == (torch.cuda.get_device_name() if torch.cuda.is_available()
                                else "cpu")
    # JAX's has the same shape with its own keys (version, backend, python)
    from adam_tpu.cli.main import main as jax_main

    jlines = _run(jax_main, ["buildinfo"]).splitlines()
    assert [ln.split(": ", 1)[0] for ln in jlines] == ["adam-tpu version", "jax version",
                                                       "python", "backend"]
    assert values["python"] == dict(ln.split(": ", 1) for ln in jlines)["python"]


@pytest.mark.parametrize("argv", [["flagstat", "{d}/in.sam"], ["flagstat", "{d}/in.adam"],
                                  ["view", "{d}/in.adam", "-c", "-F", "512"]])
def test_flagstat_and_view_sit_in_the_print_group(inputs, argv):
    from adam_tpu_torch.cli import printers

    assert {"flagstat", "view"} <= {c.name for c in printers.COMMANDS}
    got, want = _both([a.format(d=inputs) for a in argv])
    assert got == want
