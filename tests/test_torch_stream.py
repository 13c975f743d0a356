"""The port's stream mode (`mm2tpu_torch.cli --map-mode stream`:
`mapping/pipeline.py::map_frag`, each chaining task placed by
`mapping/chain.py::chain_dp`) against the JAX package's stream mode,
its default: read by read under each forced route, and through the CLI
at the default route on a seeded workload and on the MT goldens. With
`--device cpu` the device route runs the plain versions of K1, K2, K3
and K4; the JAX package's `tpu` route runs its Pallas kernels in
interpret mode. Both CLIs run in this process."""
import functools
import io

import numpy as np
import pytest

from mm2tpu import cli as jcli
from mm2tpu.io.bseq import read_fastx as jax_read_fastx
from mm2tpu.mapping.pipeline import map_frag as jax_map_frag
from mm2tpu.options import mapopt_update as jax_mapopt_update
from mm2tpu.options import set_opt as jax_set_opt
from mm2tpu_torch import cli as tcli
from mm2tpu_torch.index.mmi import read_mmi_parts
from mm2tpu_torch.io.bseq import read_fastx as port_read_fastx
from mm2tpu_torch.mapping.pipeline import map_frag as port_map_frag
from mm2tpu_torch.ops import chain_v2, chain_v3, ksw2_extd2, ksw2_exts2
from mm2tpu_torch.options import mapopt_update as port_mapopt_update
from mm2tpu_torch.options import set_opt as port_set_opt
from mm2tpu_torch.utils import profiling
from test_torch_cli_sr_splice import load_chip_smoke
from test_torch_pipeline import REPO, load_make_workload

GOLDEN = REPO / "tests" / "golden"


def rebuild_mt(d):
    """The MT pair from the repository's goldens: MT_orang from
    tests/golden/twopart_MT.mmi, MT_human from the primary record of
    tests/golden/mapont_MT_a.sam (which keeps its one lowercase base)."""
    orang = d / "MT-orang.fa"
    for mi in read_mmi_parts(str(GOLDEN / "twopart_MT.mmi")):
        rid = mi.name2id("MT_orang")
        if rid >= 0:
            codes = mi.getseq_fast(rid, 0, mi.seq[rid].length)
            orang.write_text(">MT_orang\n%s\n" % "".join(
                np.array(list("ACGTN"))[np.minimum(codes, 4)]))
    human = d / "MT-human.fa"
    for ln in (GOLDEN / "mapont_MT_a.sam").read_text().splitlines():
        f = ln.split("\t")
        if not ln.startswith("@") and int(f[1]) & 0x900 == 0:
            human.write_text(">%s\n%s\n" % (f[0], f[9]))
            break
    return str(orang), str(human)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The 0.3 Mb workload (12 reads, seed 3), 6 read pairs and 2 spliced
    reads (3-4 exons, introns of 100-400 bp) on its genome, and the MT
    pair."""
    d = tmp_path_factory.mktemp("stream")
    ref, reads = load_make_workload().make(str(d), genome_mb=0.3,
                                           n_reads=12, mean_len=2500,
                                           seed=3)
    cs = load_chip_smoke()
    pairs = cs.make_sr_pairs(ref, str(d / "sr"), 6, seed=5)
    spliced = cs.make_spliced_reads(ref, str(d / "tx.fa"), 2, seed=6,
                                    exons=(3, 4), intron_len=(100, 400))
    head = d / "reads2.fa"
    head.write_text("".join(open(reads).readlines()[:4]))
    return {"ref": ref, "reads": reads, "reads2": str(head),
            "pairs": list(pairs), "spliced": spliced,
            "mt": rebuild_mt(d), "dir": d}


def port_run(args, out):
    rc = tcli.main([*args, "--device", "cpu", "-o", str(out)])
    assert rc == 0
    return out.read_text()


@functools.lru_cache(maxsize=None)
def jax_run(args, out):
    assert jcli.main([*args, "-o", out]) == 0
    with open(out) as fh:
        return fh.read()


def no_pg(text):
    return "".join(ln for ln in text.splitlines(True)
                   if not ln.startswith("@PG"))


def _fragments(read_fastx, path, n):
    return [[r] for r in read_fastx(path)][:n]


@functools.lru_cache(maxsize=None)
def _indexes(ref):
    jio, jmo = jax_set_opt("map-ont")
    tio, tmo = port_set_opt("map-ont")
    jmi = next(jcli.index_parts(ref, jio))
    tmi = next(tcli.index_parts(ref, tio))
    return jmi, tmi


@pytest.mark.parametrize("route,n_reads", [("native", 12), ("python", 12),
                                           ("gpu", 3)])
def test_map_frag_matches_jax(inputs, route, n_reads):
    """`map_frag` of the port against the JAX package's, read by read,
    under a forced route ("gpu" against the JAX package's "tpu"): the
    emitted PAF lines of each read are identical."""
    jmi, tmi = _indexes(inputs["ref"])
    _, jmo = jax_set_opt("map-ont")
    _, tmo = port_set_opt("map-ont")
    jax_mapopt_update(jmo, jmi)
    port_mapopt_update(tmo, tmi)
    jmo.chain_backend = {"gpu": "tpu"}.get(route, route)
    tmo.chain_backend = route
    calls = chain_v3.reference_calls
    for jf, tf in zip(_fragments(jax_read_fastx, inputs["reads"], n_reads),
                      _fragments(port_read_fastx, inputs["reads"], n_reads)):
        jres = jax_map_frag(jmi, [jf[0].seq], jmo, jf[0].name)
        tres = port_map_frag(tmi, [tf[0].seq], tmo, tf[0].name, "cpu")
        want, got = io.StringIO(), io.StringIO()
        jcli.emit(jmi, jmo, jf, jres, want)
        tcli.emit(tmi, tmo, tf, tres, got)
        assert got.getvalue() == want.getvalue(), jf[0].name
        assert got.getvalue()
    assert (chain_v3.reference_calls > calls) == (route == "gpu")


@pytest.mark.parametrize("threads", ["1", "4"])
def test_stream_cli_matches_jax_default(inputs, tmp_path, threads):
    """`--map-mode stream` at the default route (the committed H100
    constants; a --device cpu run places every task on the host) against
    the JAX package at its default (stream mode), byte for byte."""
    args = ("-x", "map-ont", "-t", threads, inputs["ref"], inputs["reads"])
    got = port_run(("--map-mode", "stream", *args), tmp_path / "p.paf")
    assert got == jax_run(args, str(tmp_path / "j.paf"))
    assert len(got.splitlines()) >= 12


@pytest.mark.parametrize("golden,args", [
    ("mapont_MT.paf", ("-x", "map-ont")),
    ("mapont_MT_c.paf", ("-x", "map-ont", "-c")),
    ("mapont_MT_a.sam", ("-x", "map-ont", "-a")),
    ("sr_pe_MT.paf", ("-x", "sr")),
])
def test_stream_reproduces_mt_goldens(inputs, tmp_path, golden, args):
    orang, human = inputs["mt"]
    queries = [str(GOLDEN / "sr_reads_1.fq"), str(GOLDEN / "sr_reads_2.fq")] \
        if golden.startswith("sr_") else [human]
    got = port_run(("--map-mode", "stream", *args, orang, *queries),
                   tmp_path / "out")
    assert no_pg(got) == no_pg((GOLDEN / golden).read_text())


@pytest.mark.parametrize("preset", ["sr", "splice"])
def test_gpu_route_matches_jax_tpu_route(inputs, tmp_path, preset):
    """Read pairs (K2, two segments) and spliced reads (K2, cDNA) with
    every task on the device route: the port's --chain-backend gpu (the
    plain K2 on the CPU) against the JAX package's --chain-backend tpu
    (its v2 kernel in interpret mode)."""
    queries = inputs["pairs"] if preset == "sr" else [inputs["spliced"]]
    args = ("-x", preset, inputs["ref"], *queries)
    calls = chain_v2.reference_calls
    got = port_run(("--map-mode", "stream", "--chain-backend", "gpu",
                    "-t", "4", *args), tmp_path / "p.paf")
    assert chain_v2.reference_calls > calls
    want = jax_run(("--chain-backend", "tpu", *args),
                   str(tmp_path / "j.paf"))
    assert got == want and len(got.splitlines()) >= 2


@pytest.mark.parametrize("preset,reads,module", [
    ("map-ont", "reads2", ksw2_extd2), ("splice", "spliced", ksw2_exts2)])
def test_stream_device_fills_equal_host(inputs, tmp_path, preset, reads,
                                        module):
    """`-a --align-backend gpu --align-tpu-min-mat 1` in stream mode: with
    no batcher, every fill runs alone through the plain extd2 (map-ont)
    or exts2 (splice), none on the host, and the SAM equals
    `--align-backend host`'s."""
    args = ["--map-mode", "stream", "-x", preset, "-a", "-t", "2",
            inputs["ref"], inputs[reads]]
    calls = module.reference_calls
    got = port_run(["--align-backend", "gpu", "--align-tpu-min-mat", "1",
                    "--profile", *args], tmp_path / "gpu.sam")
    c = dict(profiling.counters)
    profiling.disable()
    assert module.reference_calls - calls == c["ext.fills"] == \
        c["ext.dispatches"] > 0
    assert c.get("ext.host_fills", 0) == 0
    want = port_run(["--align-backend", "host", *args],
                    tmp_path / "host.sam")
    assert no_pg(got) == no_pg(want)
    assert sum(not ln.startswith("@") for ln in got.splitlines()) >= 2


def test_jax_stream_tpu_equals_jax_batch(inputs, tmp_path):
    """The JAX package's `--map-mode stream --chain-backend tpu` PAF
    equals its `--map-mode batch` PAF on the seeded workload (both chain
    every task under the device contract), and so does the port's
    `--map-mode stream --chain-backend gpu`: on the card, the stream PAF
    of `--chain-backend gpu` is held against the batch PAF."""
    args = ("-x", "map-ont", inputs["ref"], inputs["reads"])
    stream = jax_run(("--map-mode", "stream", "--chain-backend", "tpu",
                      *args), str(tmp_path / "s.paf"))
    batch = jax_run(("--map-mode", "batch", *args), str(tmp_path / "b.paf"))
    assert stream == batch
    got = port_run(("--map-mode", "stream", "--chain-backend", "gpu", "-t",
                    "4", *args), tmp_path / "p.paf")
    assert got == stream and len(got.splitlines()) >= 12


def test_seed_backend_gpu_is_batch_only(inputs, tmp_path, capsys):
    out = tmp_path / "out.paf"
    rc = tcli.main(["--map-mode", "stream", "--seed-backend", "gpu",
                    "--device", "cpu", "-o", str(out), inputs["ref"],
                    inputs["reads"]])
    assert rc != 0 and "batch" in capsys.readouterr().err
