"""mm2tpu_torch never imports jax, and `--device cuda` without a card fails
loudly instead of falling back to the CPU."""
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

# refuses every import of jax (or a submodule) in the child interpreter
BLOCK_JAX = """
import sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax."):
            raise ImportError("jax is blocked in this process")
        return None
sys.meta_path.insert(0, _NoJax())
"""


def run_python(code, timeout=600):
    return subprocess.run([sys.executable, "-c", BLOCK_JAX + code],
                          cwd=str(REPO), capture_output=True, text=True,
                          timeout=timeout)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_workload", REPO / "scripts" / "make_workload.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make(str(tmp_path_factory.mktemp("wl")), genome_mb=0.3,
                    n_reads=12, mean_len=2500, seed=3)


def test_every_module_imports_and_cli_runs_without_jax(workload, tmp_path):
    ref, reads = workload
    out, sam = tmp_path / "out.paf", tmp_path / "out.sam"
    r = run_python(f"""
import importlib, pkgutil
import mm2tpu_torch
mods = [m.name for m in pkgutil.walk_packages(mm2tpu_torch.__path__,
                                              "mm2tpu_torch.")]
assert len(mods) >= 8, mods
for m in mods:
    importlib.import_module(m)
from mm2tpu_torch.cli import main
rc = main(["-x", "map-ont", "--device", "cpu", "-o", {str(out)!r},
           {ref!r}, {reads!r}])
assert rc == 0, rc
# SAM with every extension fill through the port's batcher and extd2
rc = main(["-x", "map-ont", "-a", "--align-backend", "gpu",
           "--align-tpu-min-mat", "1", "--device", "cpu", "-o", {str(sam)!r},
           {ref!r}, {reads!r}])
assert rc == 0, rc
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
""")
    assert r.returncode == 0, r.stderr[-3000:]
    assert len(out.read_text().splitlines()) >= 12
    assert sum(1 for ln in sam.read_text().splitlines()
               if not ln.startswith("@")) >= 12


def test_blocker_really_blocks_jax():
    r = run_python("import jax\n", timeout=120)
    assert r.returncode != 0 and "jax is blocked" in r.stderr


def test_device_cuda_without_a_card_fails_loudly(workload, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ref, reads = workload
    out = tmp_path / "out.paf"
    r = subprocess.run(
        [sys.executable, "-m", "mm2tpu_torch.cli", "-x", "map-ont",
         "--device", "cuda", "-o", str(out), ref, reads],
        cwd=str(REPO), capture_output=True, text=True, timeout=600)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert not out.exists()


def test_resolve_device_is_explicit():
    from mm2tpu_torch.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("auto")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")


@pytest.mark.parametrize("flags,item,n_queries", [
    (["--mesh", "2"], "M8", 1),
    (["--hosts", "2"], "M9", 1),
    (["--seed-backend", "tpu"], "M7", 1),
    (["--align-backend", "tpu"], "--align-backend gpu", 1),
    (["--chain-backend", "native"], "M3", 1),
    (["--split-prefix", "x"], "M1", 1),
    (["-x", "splice"], "M4", 1),
    (["--map-mode", "stream"], "M3", 1),
    (["--profile-trace", "tr"], "M10", 1),
    (["-x", "sr"], "M4", 2),   # paired-end fragments
    (["-x", "sr"], "M4", 1),   # one interleaved file, grouped by name
])
def test_cli_rejects_unported_modes(workload, tmp_path, capsys, flags, item,
                                    n_queries):
    from mm2tpu_torch.cli import main
    ref, reads = workload
    out = tmp_path / "out.paf"
    rc = main(["-x", "map-ont", *flags, "--device", "cpu", "-o", str(out),
               ref, *[reads] * n_queries])
    assert rc != 0
    assert item in capsys.readouterr().err
    assert not out.exists()
