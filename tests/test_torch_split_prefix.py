"""`--split-prefix` in the port (the per-part dump of `cli.map_all` and
`cli._split_merge`) in both map modes: the minimap2 goldens of a
two-part index, byte for byte, and the JAX package's `--split-prefix`
on a seeded genome whose index comes in three parts. The temporary
files of the parts are gone afterwards."""
import numpy as np
import pytest

from mm2tpu.cli import main as jax_main
from mm2tpu_torch import cli as port_cli
from mm2tpu_torch.cli import main as port_main
from test_torch_pipeline import REPO, load_make_workload
from test_torch_stream import no_pg, rebuild_mt

GOLDEN = REPO / "tests" / "golden"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The rebuilt MT-human.fa, and the 0.3 Mb workload's genome cut into
    three contigs of 100 kb with its 12 reads."""
    d = tmp_path_factory.mktemp("split")
    _, human = rebuild_mt(d)
    ref, reads = load_make_workload().make(str(d), genome_mb=0.3,
                                           n_reads=12, mean_len=2500,
                                           seed=3)
    seq = "".join(ln.strip() for ln in open(ref) if not ln.startswith(">"))
    ref3 = d / "ref3.fa"
    ref3.write_text("".join(">c%d\n%s\n" % (i, seq[i * 100000:
                                                    (i + 1) * 100000])
                            for i in range(3)))
    return {"human": human, "ref3": str(ref3), "reads": reads, "dir": d}


def run(main, args, d, tag):
    prefix = d / ("sp_" + tag)
    out = d / ("out_" + tag)
    assert main(["--split-prefix", str(prefix), *args, "-o", str(out)]) == 0
    assert not list(d.glob("sp_%s.*.tmp" % tag))
    return out.read_text()


@pytest.mark.parametrize("mode", ["batch", "stream"])
@pytest.mark.parametrize("golden,args,query", [
    ("twopart_split.paf", (), "sr_reads_1.fq"),
    ("twopart_split.sam", ("-a",), "sr_reads_1.fq"),
    ("twopart_split_c.paf", ("-c",), "human"),
])
def test_split_prefix_reproduces_goldens(inputs, tmp_path, mode, golden,
                                         args, query):
    q = inputs["human"] if query == "human" else str(GOLDEN / query)
    got = run(port_main, ["--map-mode", mode, "--device", "cpu", *args,
                          str(GOLDEN / "twopart_MT.mmi"), q], tmp_path,
              "port")
    assert no_pg(got) == no_pg((GOLDEN / golden).read_text())


@pytest.mark.parametrize("mode", ["batch", "stream"])
@pytest.mark.parametrize("args", [(), ("-a",)], ids=["paf", "sam"])
def test_split_prefix_matches_jax_on_three_parts(inputs, tmp_path,
                                                 monkeypatch, mode, args):
    """-I 50k puts each of the three 100 kb contigs in a part of its own
    (a part takes contigs until it holds more than -I bases)."""
    parts = []
    merge = port_cli._split_merge
    monkeypatch.setattr(port_cli, "_split_merge", lambda q, mo, n, rg, out: (
        parts.append(n), merge(q, mo, n, rg, out)))
    common = ["-x", "map-ont", "-I", "50k", *args, inputs["ref3"],
              inputs["reads"]]
    got = run(port_main, ["--map-mode", mode, "--device", "cpu", *common],
              tmp_path, "port")
    assert parts == [3]
    want = run(jax_main, common, tmp_path, "jax")
    assert no_pg(got) == no_pg(want)
    body = [ln for ln in got.splitlines() if not ln.startswith("@")]
    assert len({ln.split("\t", 1)[0] for ln in body}) >= 11
    assert {ln.split("\t")[5 if not args else 2] for ln in body} >= \
        {"c0", "c1", "c2"}
