"""The port's batch mapping path against mm2tpu's --map-mode batch.

Same reads, same index, same options: the PAF written by the port must be
byte-identical to the JAX package's (whose v3 kernel runs in interpret
mode on the CPU), through map_frags_batched and through the two CLIs."""
import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import mm2tpu.index.build as jax_build
import mm2tpu.io.format as jax_format
import mm2tpu.options as jax_options
import mm2tpu_torch.index.build as port_build
import mm2tpu_torch.io.format as port_format
import mm2tpu_torch.options as port_options
from mm2tpu.mapping.pipeline import map_frags_batched as jax_map_batched
from mm2tpu_torch.mapping.pipeline import map_frags_batched
from mm2tpu_torch.ops import chain_v3

REPO = pathlib.Path(__file__).resolve().parent.parent


def load_make_workload():
    spec = importlib.util.spec_from_file_location(
        "make_workload", REPO / "scripts" / "make_workload.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def index_and_options(pkg_build, pkg_options, genome):
    """One package's own index of `genome` and its map-ont options: each
    package maps with its own objects."""
    mi = pkg_build.build_index(["c0"], [genome], w=10, k=15)
    _, mo = pkg_options.set_opt("map-ont")
    pkg_options.mapopt_update(mo, mi)
    return mi, mo


@pytest.fixture(scope="module")
def small_genome():
    """A 60 kb seeded genome and 10 uneven reads with 5% substitutions,
    with the port's index and options, then the JAX package's."""
    grng = np.random.default_rng(7)
    genome = "".join(np.array(list("ACGT"))[grng.integers(0, 4, 60000)])
    mi, mo = index_and_options(port_build, port_options, genome)
    frags, names = [], []
    for i in range(10):
        L = int(grng.integers(300, 3000))
        st = int(grng.integers(0, len(genome) - L))
        s = list(genome[st:st + L])
        for _ in range(L // 20):
            s[int(grng.integers(0, L))] = "ACGT"[grng.integers(0, 4)]
        frags.append(["".join(s)])
        names.append("r%d" % i)
    return mi, mo, frags, names, index_and_options(jax_build, jax_options,
                                                   genome)


def paf(mi, mo, names, frags, res, write_paf=port_format.write_paf):
    lines = []
    for name, fr, frag in zip(names, res, frags):
        regs = fr.regs[0]
        if not regs:
            lines.append(write_paf(mi, name, len(frag[0]), None, mo.flag,
                                   fr.rep_len))
        for r in regs:
            lines.append(write_paf(mi, name, len(frag[0]), r, mo.flag,
                                   fr.rep_len, qseq=frag[0]))
    return "\n".join(lines)


def test_map_frags_batched_matches_jax(small_genome):
    mi, mo, frags, names, (jmi, jmo) = small_genome
    calls = chain_v3.reference_calls
    res = map_frags_batched(mi, frags, mo, names, "cpu")
    assert chain_v3.reference_calls > calls
    res_jax = jax_map_batched(jmi, frags, jmo, names, mesh=None)
    assert paf(mi, mo, names, frags, res) == \
        paf(jmi, jmo, names, frags, res_jax, jax_format.write_paf)
    assert sum(1 for fr in res if fr.regs[0]) >= 8


def test_map_frags_batched_rejects_unported_backends(small_genome):
    mi, mo, frags, names, _ = small_genome
    for field, item in (("seed_backend", "seed-backend gpu"),
                        ("align_backend", "align-backend gpu")):
        old = getattr(mo, field)
        setattr(mo, field, "tpu")
        try:
            with pytest.raises(NotImplementedError, match=item):
                map_frags_batched(mi, frags, mo, names, "cpu")
        finally:
            setattr(mo, field, old)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("wl")
    return load_make_workload().make(str(d), genome_mb=0.3, n_reads=12,
                                     mean_len=2500, seed=3)


def run_cli(module, args, out):
    r = subprocess.run([sys.executable, "-m", module, *args, "-o", str(out)],
                       cwd=str(REPO), capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return out.read_text()


@pytest.mark.parametrize("extra", [[], ["-a"]], ids=["paf", "sam"])
def test_cli_matches_jax_batch_mode(workload, tmp_path, extra):
    ref, reads = workload
    port = run_cli("mm2tpu_torch.cli",
                   ["-x", "map-ont", "--device", "cpu", *extra, ref, reads],
                   tmp_path / "port.out")
    jax = run_cli("mm2tpu.cli",
                  ["-x", "map-ont", "--map-mode", "batch", *extra, ref,
                   reads], tmp_path / "jax.out")
    if extra:   # SAM: the @PG line embeds the command string
        port, jax = ("".join(ln for ln in s.splitlines(True)
                             if not ln.startswith("@PG")) for s in (port, jax))
    assert port == jax
    assert sum(1 for ln in port.splitlines() if not ln.startswith("@")) >= 12


def test_cli_chain_fn_replaces_the_chaining(workload, tmp_path):
    """`main(..., chain_fn=...)` sends every batch through the given
    chaining function, and the plain versions give the default's PAF."""
    from mm2tpu_torch.cli import main
    from mm2tpu_torch.ops.chain_packed import chain_scores_plain
    ref, reads = workload
    seen = []

    def plain(*args, **kw):
        seen.append(args[0].shape)
        return chain_scores_plain(*args, **kw)

    outs = []
    for fn in (None, plain):
        out = tmp_path / ("%s.paf" % len(outs))
        assert main(["-x", "map-ont", "--device", "cpu", "-o", str(out), ref,
                     reads], chain_fn=fn) == 0
        outs.append(out.read_text())
    assert seen and outs[0] == outs[1]
    assert len(outs[0].splitlines()) >= 12


@pytest.mark.gpu
def test_cuda_path_matches_cpu_path(small_genome):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mi, mo, frags, names, _ = small_genome
    launches = chain_v3.launches
    res_gpu = map_frags_batched(mi, frags, mo, names, "cuda")
    assert chain_v3.launches > launches
    res_cpu = map_frags_batched(mi, frags, mo, names, "cpu")
    assert paf(mi, mo, names, frags, res_gpu) == \
        paf(mi, mo, names, frags, res_cpu)
