"""Spliced reads with base-level alignment through the port's splice
extension: `mm2tpu_torch.cli -x splice -a|-c --align-backend gpu
--align-tpu-min-mat 1 --device cpu` against `mm2tpu.cli -x splice -a|-c
--map-mode batch`, byte for byte (SAM without @PG).

Every splice fill goes through the port's `TorchExtBatcher` to its exts2
(here the plain PyTorch version, as the tensors lie on the CPU); the JAX
package runs the same fills on its host splice extension. The 12 reads
come from chip_smoke.make_spliced_reads with 3-5 exons and introns of
100-1000 bp on a seeded 0.3 Mb genome, so that the plain version stays
quick on the CPU.
The --junc-bed case is in tests/test_torch_cli_splice_junc.py."""
import subprocess
import sys

import pytest

from mm2tpu_torch.cli import main
from mm2tpu_torch.ops import ksw2_exts2 as S
from mm2tpu_torch.utils import profiling
from test_torch_cli_sr_splice import load_chip_smoke, strip_pg
from test_torch_pipeline import REPO, load_make_workload

N_READS = 12


def make_inputs(d):
    """(ref, spliced reads) in the directory `d`."""
    ref, _ = load_make_workload().make(str(d), genome_mb=0.3, n_reads=12,
                                       mean_len=2500, seed=3)
    reads = load_chip_smoke().make_spliced_reads(
        ref, str(d / "tx.fa"), N_READS, seed=12, exons=(3, 5),
        intron_len=(100, 1000))
    return ref, reads


def run_port(args, out):
    """The port's CLI in this process with --profile: (output text,
    counters, plain-exts2 calls, K4 launches)."""
    calls, launches = S.reference_calls, S.launches
    try:
        rc = main(["-x", "splice", *args, "--align-backend", "gpu",
                   "--align-tpu-min-mat", "1", "--device", "cpu",
                   "--profile", "-o", str(out)])
        counters = dict(profiling.counters)
    finally:
        profiling.disable()
    assert rc == 0
    return (out.read_text(), counters, S.reference_calls - calls,
            S.launches - launches)


def run_jax(args, out):
    r = subprocess.run(
        [sys.executable, "-m", "mm2tpu.cli", "-x", "splice", "--map-mode",
         "batch", *args, "-o", str(out)], cwd=str(REPO),
        capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return out.read_text()


def check_counters(counters, calls, launches):
    """Every splice fill went through the batcher's plain exts2: none
    left on the host's native extension, no kernel launched."""
    assert counters.get("ext.fills", 0) > 0
    assert counters.get("ext.host_fills", 0) == 0
    assert calls == counters["ext.dispatches"] <= counters["ext.fills"]
    assert launches == 0


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(tmp_path_factory.mktemp("splice_gpu"))


@pytest.mark.parametrize("mode", ["-a", "-c"])
def test_splice_gpu_extension_matches_jax_host(inputs, tmp_path, mode):
    ref, reads = inputs
    got, counters, calls, launches = run_port([mode, ref, reads],
                                              tmp_path / "port.out")
    check_counters(counters, calls, launches)
    want = run_jax([mode, ref, reads], tmp_path / "jax.out")
    assert strip_pg(got) == strip_pg(want)
    body = [ln.split("\t") for ln in got.splitlines()
            if ln and not ln.startswith("@")]
    assert len({c[0] for c in body}) == N_READS
    if mode == "-a":   # spliced alignments: introns in the CIGARs
        assert sum("N" in c[5] for c in body) >= N_READS - 1
    else:
        assert all(any(f.startswith("cg:Z:") for f in c[12:]) for c in body)
        assert sum(any(f.startswith("cg:Z:") and "N" in f for f in c[12:])
                   for c in body) >= N_READS - 1
