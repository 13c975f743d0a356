"""The minimap2 goldens of the MT pair through the port's CLI, on the pair
rebuilt from the repository by `test_torch_stream.rebuild_mt`, in the
default map mode (stream) and in `--map-mode batch`, byte for byte (SAM
without @PG); `mapont_MT_a.sam` and `sr_pe_MT.sam` also with every
extension fill on the device path (`--align-backend gpu
--align-tpu-min-mat 1`: the plain extd2 on the CPU). Then the JAX
package's mapeval end to end (`tests/test_mapeval_e2e.py`) on the
rebuilt pair: pbsim-named reads simulated from MT_orang, mapped by the
port and scored by the port's `paftools mapeval`, byte-identical to the
JAX mapper scored by the JAX tools, and accurate.

`q2t2_*` and `qinv_*` stay out: `t2.fa` and `t-inv.fa` are not in the
repository."""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

from mm2tpu import cli as jcli
from mm2tpu.tools.paftools import main as jax_pt_main
from mm2tpu_torch import cli as tcli
from mm2tpu_torch.ops import ksw2_extd2
from mm2tpu_torch.tools.paftools import main as port_pt_main
from test_mapeval_e2e import RC, _mutate
from test_torch_stream import GOLDEN, no_pg, rebuild_mt

SR = ("sr_reads_1.fq", "sr_reads_2.fq")
# golden, arguments, target ("orang", "ava" or a golden index), queries
# ("human", "ava" or golden files)
CASES = [
    ("mapont_MT.paf", ("-x", "map-ont"), "orang", ("human",)),
    ("mapont_MT_cs.paf", ("-x", "map-ont", "-c", "--cs"), "orang",
     ("human",)),
    ("mappb_MT.paf", ("-x", "map-pb"), "orang", ("human",)),
    ("asm5_MT.paf", ("-x", "asm5"), "orang", ("human",)),
    ("asm20_MT.paf", ("-x", "asm20"), "orang", ("human",)),
    ("default_MT.paf", (), "orang", ("human",)),
    ("mapont_MT_a.sam", ("-x", "map-ont", "-a"), "orang", ("human",)),
    ("mapont_MT_md.sam", ("-x", "map-ont", "-a", "--MD"), "orang",
     ("human",)),
    ("mapont_MT_eqx.sam", ("-x", "map-ont", "-a", "--eqx"), "orang",
     ("human",)),
    ("sr_pe_MT.paf", ("-x", "sr"), "orang", SR),
    ("sr_pe_MT.sam", ("-x", "sr", "-a"), "orang", SR),
    # the reference's own .mmi index of MT_orang
    ("mapont_MT.paf", ("-x", "map-ont"), "mapont_MTorang.mmi", ("human",)),
    # a two-part index, each part's hits emitted on its own
    ("twopart_nosplit.paf", (), "twopart_MT.mmi",
     ("sr_reads_1.fq", "human")),
    ("avaont_MT.paf", ("-x", "ava-ont"), "ava", ("ava",)),
]
MODES = {"default": (), "batch": ("--map-mode", "batch")}


@pytest.fixture(scope="module")
def mt(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden_mt")
    orang, human = rebuild_mt(d)
    ava = d / "ava.fa"   # as tests/test_e2e_paf.py builds it
    ava.write_text(open(human).read() + open(orang).read())
    return {"orang": orang, "human": human, "ava": str(ava), "dir": d}


def _path(mt, name):
    return mt[name] if name in mt else str(GOLDEN / name)


def port_cli(mt, args, out):
    assert tcli.main([*args, "--device", "cpu", "-o", str(out)]) == 0
    return out.read_text()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("golden,args,target,queries", CASES,
                         ids=["%s-%s" % (c[0], c[2]) for c in CASES])
def test_port_reproduces_golden(mt, tmp_path, mode, golden, args, target,
                                queries):
    got = port_cli(mt, [*MODES[mode], *args, _path(mt, target),
                        *(_path(mt, q) for q in queries)],
                   tmp_path / "out")
    assert no_pg(got) == no_pg((GOLDEN / golden).read_text())


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("golden,args,queries", [
    ("mapont_MT_a.sam", ("-x", "map-ont", "-a"), ("human",)),
    ("sr_pe_MT.sam", ("-x", "sr", "-a"), SR),
])
def test_device_fills_reproduce_golden(mt, tmp_path, mode, golden, args,
                                       queries):
    calls = ksw2_extd2.reference_calls
    got = port_cli(mt, [*MODES[mode], *args, "--align-backend", "gpu",
                        "--align-tpu-min-mat", "1", mt["orang"],
                        *(_path(mt, q) for q in queries)], tmp_path / "out")
    assert ksw2_extd2.reference_calls > calls
    assert no_pg(got) == no_pg((GOLDEN / golden).read_text())


def _mapeval(main, paf):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert main(["mapeval", str(paf)]) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def sim(mt):
    """60 reads of 1500 bp from MT_orang, 5% substitutions and 2% indels,
    on either strand, named read!chr!st!en!strand (pbsim's names, which
    mapeval reads), from the JAX test's seed and mutator; mapped by the
    port (default mode, --device cpu) and by the JAX package (default
    mode)."""
    d = mt["dir"]
    lines = open(mt["orang"]).read().splitlines()
    name, ref = lines[0][1:].split()[0], "".join(lines[1:])
    rng = np.random.default_rng(7)
    reads = d / "sim.fa"
    n_reads, rlen = 60, 1500
    with open(reads, "w") as f:
        for i in range(n_reads):
            st = int(rng.integers(0, len(ref) - rlen))
            seq = _mutate(rng, ref[st:st + rlen])
            strand = "+-"[int(rng.integers(2))]
            if strand == "-":
                seq = seq.translate(RC)[::-1]
            f.write(f">S1_{i}!{name}!{st}!{st + rlen}!{strand}\n{seq}\n")
    port = d / "port.paf"
    port_cli(mt, ["-x", "map-ont", mt["orang"], str(reads)], port)
    jax = d / "jax.paf"
    assert jcli.main(["-x", "map-ont", "-o", str(jax), mt["orang"],
                      str(reads)]) == 0
    return port, jax, n_reads


def test_mapeval_matches_jax_and_is_accurate(sim):
    port, jax, n_reads = sim
    assert port.read_text() == jax.read_text()
    got = _mapeval(port_pt_main, port)
    assert got == _mapeval(jax_pt_main, jax)
    rows = [ln.split("\t") for ln in got.splitlines() if ln.startswith("Q")]
    assert rows, "no reads evaluated"
    assert sum(int(r[2]) for r in rows) >= n_reads * 0.95
    assert float(rows[-1][4]) <= 0.02
    assert int(rows[0][1]) == 60 and int(rows[0][3]) == 0


def test_mapeval_catches_shuffled_truth(sim, tmp_path):
    """The negative control of the JAX test: truth coordinates shifted by
    8 kb must show up as errors, in both packages' tools alike."""
    port, _, _ = sim
    bad = []
    for ln in port.read_text().splitlines():
        t = ln.split("\t")
        parts = t[0].split("!")
        parts[2] = str(int(parts[2]) + 8000)
        parts[3] = str(int(parts[3]) + 8000)
        t[0] = "!".join(parts)
        bad.append("\t".join(t))
    p2 = tmp_path / "bad.paf"
    p2.write_text("\n".join(bad) + "\n")
    got = _mapeval(port_pt_main, p2)
    assert got == _mapeval(jax_pt_main, p2)
    rows = [ln.split("\t") for ln in got.splitlines() if ln.startswith("Q")]
    assert sum(int(r[3]) for r in rows) > 0
