"""`python -m mm2tpu_torch.cli --seed-backend gpu --device cpu` (device
seeding through the plain versions of the index probe, the anchor build
and K1) against `mm2tpu --map-mode batch --seed-backend tpu` (the JAX
package's device seeding, its K1 in interpret mode) and against the
port's own host seeding, byte for byte; and three minimap2 goldens through
it, on the MT pair rebuilt from the repository's goldens by the port's
own modules. Read pairs and spliced reads lie outside device seeding's
coverage: they seed on the host, and `seed.host_frags` counts every one.

Both CLIs run in this process (the JAX package's compiled programs are
shared by its runs)."""
import functools

import numpy as np
import pytest
import torch

from mm2tpu.cli import main as jax_main
from mm2tpu_torch.cli import main as port_main
from mm2tpu_torch.index.mmi import read_mmi_parts
from mm2tpu_torch.ops import seed_device as sd
from mm2tpu_torch.utils import profiling
from test_torch_cli_sr_splice import load_chip_smoke
from test_torch_pipeline import REPO, load_make_workload

GOLDEN = REPO / "tests" / "golden"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The 0.3 Mb workload (12 reads, seed 3), 20 read pairs and 6 spliced
    reads on its genome, an asm20 case (a 60 kb genome and 2 contigs of it
    with 2% substitutions, drawn as tests/test_seed_device.py draws its
    own), and the MT pair: MT_orang from tests/golden/twopart_MT.mmi,
    MT_human from the primary record of tests/golden/mapont_MT_a.sam (which
    keeps its one lowercase base)."""
    d = tmp_path_factory.mktemp("seed_gpu")
    ref, reads = load_make_workload().make(str(d), genome_mb=0.3,
                                           n_reads=12, mean_len=2500,
                                           seed=3)
    cs = load_chip_smoke()
    pairs = cs.make_sr_pairs(ref, str(d / "sr"), 20, seed=5)
    spliced = cs.make_spliced_reads(ref, str(d / "tx.fa"), 6, seed=6)
    rng = np.random.default_rng(7)
    bases = np.array(list("ACGT"))
    genome = "".join(bases[rng.integers(0, 4, 60_000)])
    asm_ref = d / "asm_ref.fa"
    asm_ref.write_text(">c0\n%s\n" % genome)
    asm_reads = d / "contigs.fa"
    with open(asm_reads, "w") as fh:
        for i in range(2):
            st = int(rng.integers(0, 30_000))
            s = np.array(list(genome[st:st + int(rng.integers(8_000,
                                                              15_000))]))
            mut = rng.random(len(s)) < 0.02
            s[mut] = bases[rng.integers(0, 4, int(mut.sum()))]
            fh.write(">ctg%d\n%s\n" % (i, "".join(s)))
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
    return {"wl": (ref, [reads]), "sr": (ref, list(pairs)),
            "splice": (ref, [spliced]),
            "asm": (str(asm_ref), [str(asm_reads)]),
            "mt": (str(orang), [str(human)]),
            "mt_sr": (str(orang), [str(GOLDEN / "sr_reads_1.fq")]),
            "dir": d}


def run_port(inputs, name, args, seed_gpu, **kw):
    """The port's PAF and its --profile counters."""
    ref, queries = inputs[name]
    out = inputs["dir"] / "port.paf"
    extra = ["--seed-backend", "gpu"] if seed_gpu else []
    rc = port_main([*args, *extra, "--device", "cpu", "--profile", "-o",
                    str(out), ref, *queries], **kw)
    counters = dict(profiling.counters)
    profiling.disable()
    assert rc == 0
    return out.read_text(), counters


@functools.lru_cache(maxsize=None)
def run_jax(ref, queries, args):
    out = "%s.jax.paf" % queries[0]
    assert jax_main([*args, "--map-mode", "batch", "--seed-backend", "tpu",
                     "-o", out, ref, *queries]) == 0
    with open(out) as fh:
        return fh.read()


@pytest.mark.parametrize("flags", [(), ("-r", "500"), ("-H",)],
                         ids=["plain", "r500", "hpc"])
def test_device_seeding_matches_jax_and_host_seeding(inputs, flags):
    """-x map-ont -c (and with -r 500, and -H) on the seeded workload: every
    read seeds on the device, and the PAF equals the JAX package's device
    seeding and the port's host seeding."""
    args = ("-x", "map-ont", "-c", *flags)
    calls = sd.reference_calls["build"]
    got, c = run_port(inputs, "wl", args, True)
    assert sd.reference_calls["build"] > calls
    assert c["seed.launches"] > 0 and c.get("seed.host_frags", 0) == 0
    assert 0 < c["seed.anchors"] <= c["chain.anchors"]
    assert c["seed.minimizers"] > 0 and c["seed.bytes_down"] > 0
    host, hc = run_port(inputs, "wl", args, False)
    assert "seed.launches" not in hc
    assert got == host
    assert got == run_jax(inputs["wl"][0], tuple(inputs["wl"][1]), args)
    assert len({ln.split("\t", 1)[0] for ln in got.splitlines()}) >= 11


def test_device_seeding_asm20_matches_jax(inputs):
    got, c = run_port(inputs, "asm", ("-x", "asm20", "-c"), True)
    assert c["seed.launches"] > 0 and c.get("seed.host_frags", 0) == 0
    assert got == run_jax(inputs["asm"][0], tuple(inputs["asm"][1]),
                          ("-x", "asm20", "-c"))
    assert got == run_port(inputs, "asm", ("-x", "asm20", "-c"), False)[0]
    assert len(got.splitlines()) >= 2


@pytest.mark.parametrize("name,preset,n_frags", [("sr", "sr", 20),
                                                 ("splice", "splice", 6)])
def test_pairs_and_spliced_reads_seed_on_the_host(inputs, name, preset,
                                                  n_frags):
    """Read pairs (two segments) and spliced reads are outside the
    contract: every fragment (a pair counts once) seeds on the host, no
    seeding kernel runs, and the PAF is host seeding's."""
    got, c = run_port(inputs, name, ("-x", preset), True)
    assert c["seed.host_frags"] == n_frags
    assert "seed.launches" not in c
    assert got == run_port(inputs, name, ("-x", preset), False)[0]
    assert len(got.splitlines()) >= n_frags // 2


@pytest.mark.parametrize("golden,name,args", [
    ("mapont_MT_c.paf", "mt", ("-x", "map-ont", "-c")),
    ("asm20_MT_c.paf", "mt", ("-x", "asm20", "-c")),
    ("sr_se_MT.paf", "mt_sr", ("-x", "sr")),
])
def test_goldens_through_device_seeding(inputs, golden, name, args):
    """minimap2's own output, byte for byte, with every read seeded on the
    device (single-end short reads are within the contract)."""
    got, c = run_port(inputs, name, args, True)
    assert c["seed.launches"] > 0 and c.get("seed.host_frags", 0) == 0
    assert got == (GOLDEN / golden).read_text()


def test_seed_fn_replaces_the_device_seeding(inputs):
    """`main(..., seed_fn=)` sends every bucket of device seeding through
    the given function; the plain versions give the default's PAF."""
    seen = []

    def plain(index, q, *args, **kw):
        seen.append(tuple(q.shape))
        return sd.seed_chain_plain(index, q, *args, **kw)

    args = ("-x", "map-ont")
    want, _ = run_port(inputs, "wl", args, True)
    got, c = run_port(inputs, "wl", args, True, seed_fn=plain)
    assert got == want and len(seen) == c["chain.launches"] > 0
    assert all(B % 8 == 0 and M in (512, 2048, 8192) for B, M in seen)


def test_device_seeding_without_a_card_fails_loudly(inputs, capsys):
    """`--seed-backend gpu` on `--device cuda` without a card exits
    non-zero and writes nothing: it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ref, queries = inputs["wl"]
    out = inputs["dir"] / "nocard.paf"
    assert port_main(["-x", "map-ont", "--seed-backend", "gpu", "--device",
                      "cuda", "-o", str(out), ref, *queries]) != 0
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert not out.exists()
