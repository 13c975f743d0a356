"""The port's paired short-read (`-x sr`) and spliced-read (`-x splice`)
paths against `mm2tpu --map-mode batch`, byte for byte (SAM without @PG).

Both packages run as CLIs on the same files: seeded read pairs and
spliced reads from a seeded 0.3 Mb genome (the generators of
chip_smoke.py), and the repository's real short-read pairs
(tests/golden/sr_reads_{1,2}.fq) against MT_orang, written to a FASTA from
tests/golden/twopart_MT.mmi by the JAX package's own .mmi reader. The
port chains every pair and every spliced read with its v2-contract plain
version on the CPU, the JAX package with its Pallas v2 kernel in
interpret mode."""
import functools
import importlib.util
import subprocess
import sys

import numpy as np
import pytest

from test_torch_pipeline import REPO, load_make_workload


def load_chip_smoke():
    """chip_smoke.py as a module (it lies at the repository root)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(ref, [r1, r2]) for 40 seeded read pairs, (ref, [reads]) for 12
    seeded spliced reads, and (MT_orang FASTA, [golden r1, r2])."""
    from mm2tpu.index.mmi import read_mmi_parts
    d = tmp_path_factory.mktemp("sr_splice")
    ref, _ = load_make_workload().make(str(d), genome_mb=0.3, n_reads=12,
                                       mean_len=2500, seed=3)
    cs = load_chip_smoke()
    pairs = cs.make_sr_pairs(ref, str(d / "sr"), 40, seed=11)
    spliced = cs.make_spliced_reads(ref, str(d / "tx.fa"), 12, seed=12)
    mt = d / "MT_orang.fa"
    for mi in read_mmi_parts(str(REPO / "tests/golden/twopart_MT.mmi")):
        rid = mi.name2id("MT_orang")
        if rid >= 0:
            codes = mi.getseq_fast(rid, 0, mi.seq[rid].length)
            mt.write_text(">MT_orang\n%s\n" % "".join(
                np.array(list("ACGTN"))[np.minimum(codes, 4)]))
    golden = [str(REPO / "tests" / "golden" / ("sr_reads_%d.fq" % k))
              for k in (1, 2)]
    return {"sr": (ref, pairs), "splice": (ref, [spliced]),
            "mt": (str(mt), golden)}


def strip_pg(text):
    return "".join(ln for ln in text.splitlines(True)
                   if not ln.startswith("@PG"))


@functools.lru_cache(maxsize=None)
def run_cli(module, args):
    """stdout of `python -m module args` (cached: the JAX package's runs
    are shared by several comparisons)."""
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=str(REPO),
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return strip_pg(r.stdout)


def port(preset, extra, inputs, workload):
    ref, queries = inputs[workload]
    return run_cli("mm2tpu_torch.cli", ("-x", preset, "--device", "cpu",
                                        *extra, ref, *queries))


def jax(preset, extra, inputs, workload):
    ref, queries = inputs[workload]
    return run_cli("mm2tpu.cli", ("-x", preset, "--map-mode", "batch",
                                  *extra, ref, *queries))


def records(text):
    return [ln for ln in text.splitlines() if not ln.startswith("@")]


@pytest.mark.parametrize("workload,n_reads", [("sr", 80), ("mt", 60)])
@pytest.mark.parametrize("extra", [(), ("-a",)], ids=["paf", "sam"])
def test_read_pairs_match_jax(inputs, workload, n_reads, extra):
    got = port("sr", extra, inputs, workload)
    assert got == jax("sr", extra, inputs, workload)
    names = {ln.split("\t", 1)[0] for ln in records(got)}
    assert len(names) >= n_reads // 2 * 0.9   # pairs share one name


def test_read_pairs_gpu_extension_matches_jax_host(inputs):
    """Every extension fill of the pairs through the port's batcher and
    its extd2 (the plain version here) gives the JAX package's SAM."""
    got = port("sr", ("-a", "--align-backend", "gpu",
                      "--align-tpu-min-mat", "1"), inputs, "sr")
    assert got == jax("sr", ("-a",), inputs, "sr")
    assert len(records(got)) == 80


@pytest.mark.parametrize("extra", [(), ("-a",)], ids=["paf", "sam"])
def test_spliced_reads_match_jax(inputs, extra):
    got = port("splice", extra, inputs, "splice")
    assert got == jax("splice", extra, inputs, "splice")
    body = records(got)
    assert len({ln.split("\t", 1)[0] for ln in body}) >= 11
    if extra:   # spliced alignments: introns in the CIGARs
        assert sum("N" in ln.split("\t")[5] for ln in body) >= 10
