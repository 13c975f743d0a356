"""mm2tpu_torch imports neither jax nor the JAX package `mm2tpu`, builds
and loads its own native library, and `--device cuda` without a card
fails loudly instead of falling back to the CPU."""
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

# refuses every import of jax and of the JAX package mm2tpu (or of a
# submodule of either) in the child interpreter; mm2tpu_torch is allowed
BLOCK_JAX = """
import sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "mm2tpu"):
            raise ImportError("%s is blocked in this process" % name)
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


@pytest.fixture(scope="module")
def pairs_and_spliced(workload, tmp_path_factory):
    """20 read pairs (two FASTQ files) and 6 spliced reads from the
    workload's genome."""
    from test_torch_cli_sr_splice import load_chip_smoke
    chip_smoke = load_chip_smoke()
    ref, _ = workload
    d = tmp_path_factory.mktemp("sr_splice")
    return (chip_smoke.make_sr_pairs(ref, str(d / "sr"), 20, seed=5),
            chip_smoke.make_spliced_reads(ref, str(d / "tx.fa"), 6, seed=6))


def test_every_module_imports_and_cli_runs_without_jax(workload,
                                                       pairs_and_spliced,
                                                       tmp_path):
    ref, reads = workload
    (r1, r2), spliced = pairs_and_spliced
    out = {k: tmp_path / k for k in ("paf", "sam", "sr.sam", "tx.paf",
                                     "dev.paf")}
    r = run_python(f"""
import importlib, pkgutil
import mm2tpu_torch
mods = [m.name for m in pkgutil.walk_packages(mm2tpu_torch.__path__,
                                              "mm2tpu_torch.")]
assert len(mods) >= 30, mods
for m in mods:
    importlib.import_module(m)
from mm2tpu_torch.cli import main
rc = main(["-x", "map-ont", "--device", "cpu", "-o", {str(out["paf"])!r},
           {ref!r}, {reads!r}])
assert rc == 0, rc
# SAM with every extension fill through the port's batcher and extd2
rc = main(["-x", "map-ont", "-a", "--align-backend", "gpu",
           "--align-tpu-min-mat", "1", "--device", "cpu", "-o",
           {str(out["sam"])!r}, {ref!r}, {reads!r}])
assert rc == 0, rc
# read pairs (K2, two segments) with their fills on the port's extd2
rc = main(["-x", "sr", "-a", "--align-backend", "gpu", "--device", "cpu",
           "-o", {str(out["sr.sam"])!r}, {ref!r}, {r1!r}, {r2!r}])
assert rc == 0, rc
# spliced reads (K2, cDNA scoring)
rc = main(["-x", "splice", "--device", "cpu", "-o", {str(out["tx.paf"])!r},
           {ref!r}, {spliced!r}])
assert rc == 0, rc
# device seeding: the index probe, the anchor build and K1
from mm2tpu_torch.ops import seed_device
rc = main(["-x", "map-ont", "--seed-backend", "gpu", "--device", "cpu",
           "-o", {str(out["dev.paf"])!r}, {ref!r}, {reads!r}])
assert rc == 0, rc
assert all(seed_device.reference_calls.values()), seed_device.reference_calls
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "mm2tpu")]
assert not bad, bad
""")
    assert r.returncode == 0, r.stderr[-3000:]
    assert len(out["paf"].read_text().splitlines()) >= 12
    assert out["dev.paf"].read_text() == out["paf"].read_text()
    for k, n in (("sam", 12), ("sr.sam", 40)):
        assert sum(1 for ln in out[k].read_text().splitlines()
                   if not ln.startswith("@")) >= n
    assert len(out["tx.paf"].read_text().splitlines()) >= 5


@pytest.fixture(scope="module")
def short_spliced(workload, tmp_path_factory):
    """4 spliced reads with introns of 100-600 bp (quick through the plain
    exts2 on the CPU)."""
    from test_torch_cli_sr_splice import load_chip_smoke
    ref, _ = workload
    return load_chip_smoke().make_spliced_reads(
        ref, str(tmp_path_factory.mktemp("tx") / "tx.fa"), 4, seed=7,
        intron_len=(100, 600))


@pytest.mark.parametrize("mode", ["-a", "-c"])
def test_splice_gpu_extension_runs_without_jax(workload, short_spliced,
                                               tmp_path, mode):
    """-x splice with every splice fill through the port's batcher and its
    exts2, in a process that refuses jax and mm2tpu: no fill stays on
    the host, and the CIGARs carry introns."""
    ref, _ = workload
    out = tmp_path / "out"
    r = run_python(f"""
from mm2tpu_torch.cli import main
from mm2tpu_torch.ops import ksw2_exts2
from mm2tpu_torch.utils import profiling
rc = main(["-x", "splice", {mode!r}, "--align-backend", "gpu",
           "--align-tpu-min-mat", "1", "--device", "cpu", "--profile",
           "-o", {str(out)!r}, {ref!r}, {short_spliced!r}])
assert rc == 0, rc
c = profiling.counters
assert c.get("ext.fills", 0) > 0 and c.get("ext.host_fills", 0) == 0, c
assert ksw2_exts2.reference_calls == c["ext.dispatches"], c
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "mm2tpu")]
assert not bad, bad
""")
    assert r.returncode == 0, r.stderr[-3000:]
    body = [ln.split("\t") for ln in out.read_text().splitlines()
            if ln and not ln.startswith("@")]
    assert len({c[0] for c in body}) == 4
    cigars = [c[5] for c in body] if mode == "-a" else \
        [f for c in body for f in c[12:] if f.startswith("cg:Z:")]
    assert len(cigars) == len(body) and any("N" in x for x in cigars)


def test_stream_mode_and_split_prefix_run_without_jax(workload, tmp_path):
    """--map-mode stream (the default route, and every task on the device
    route through the plain K1) and --split-prefix, in a process that
    refuses jax and mm2tpu."""
    ref, reads = workload
    out = {k: tmp_path / k for k in ("auto.paf", "gpu.paf", "split.paf")}
    r = run_python(f"""
from mm2tpu_torch.cli import main
from mm2tpu_torch.ops import chain_v3
rc = main(["-x", "map-ont", "--map-mode", "stream", "-t", "2", "--device",
           "cpu", "-o", {str(out["auto.paf"])!r}, {ref!r}, {reads!r}])
assert rc == 0, rc
calls = chain_v3.reference_calls
rc = main(["-x", "map-ont", "--map-mode", "stream", "--chain-backend", "gpu",
           "-t", "4", "--device", "cpu", "-o", {str(out["gpu.paf"])!r},
           {ref!r}, {reads!r}])
assert rc == 0, rc
assert chain_v3.reference_calls - calls >= 12, chain_v3.reference_calls
rc = main(["-x", "map-ont", "--split-prefix", {str(tmp_path / "sp")!r},
           "--device", "cpu", "-o", {str(out["split.paf"])!r}, {ref!r},
           {reads!r}])
assert rc == 0, rc
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "mm2tpu")]
assert not bad, bad
""")
    assert r.returncode == 0, r.stderr[-3000:]
    for k in out:
        assert len(out[k].read_text().splitlines()) >= 12, k
    assert out["gpu.paf"].read_text() == out["auto.paf"].read_text()
    assert not list(tmp_path.glob("sp.*.tmp"))


def test_blocker_really_blocks_jax():
    r = run_python("import jax\n", timeout=120)
    assert r.returncode != 0 and "jax is blocked" in r.stderr


def test_blocker_really_blocks_the_jax_package():
    r = run_python("import mm2tpu.options\n", timeout=120)
    assert r.returncode != 0 and "mm2tpu is blocked" in r.stderr


def test_native_library_is_the_ports_own_build():
    """The port's binding compiles native/mm2tpu_native.cpp into its
    build directory and loads that library, never native/libmm2tpu.so."""
    r = run_python("""
from mm2tpu_torch.native import lib
assert lib.available()
print(lib.loaded_from)
print(lib.BUILD_DIR)
""", timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    loaded, build_dir = map(pathlib.Path, r.stdout.split())
    assert loaded.parent == build_dir == REPO / "build" / "mm2tpu_torch"
    assert loaded.name.startswith("libmm2tpu_host_") and loaded.is_file()
    maps = pathlib.Path("/proc/self/maps")
    if maps.exists():
        r = run_python(f"""
from mm2tpu_torch.native import lib
assert lib.available()
maps = open("/proc/self/maps").read()
assert {str(loaded)!r} in maps
assert "libmm2tpu.so" not in maps
""", timeout=900)
        assert r.returncode == 0, r.stderr[-3000:]


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
    # the JAX package's device seeding, refused naming the port's; the id
    # is the one this case had when it expected the M7 refusal
    pytest.param(["--seed-backend", "tpu"], "--seed-backend gpu", 1,
                 id="flags2-M7-1"),
    (["--align-backend", "tpu"], "--align-backend gpu", 1),
    # the JAX package's chaining route, refused naming the port's, and the
    # JAX package's batch-only device seeding asked for in stream mode
    pytest.param(["--chain-backend", "tpu"], "--chain-backend gpu", 1,
                 id="chain-backend-tpu"),
    pytest.param(["--map-mode", "stream", "--seed-backend", "gpu"],
                 "--map-mode batch only", 1, id="stream-seed-backend-gpu"),
    (["--profile-trace", "tr"], "M10", 1),
    pytest.param(["-x", "sr", "--map-mode", "stream", "--chain-backend",
                  "tpu"], "--chain-backend gpu", 2,
                 id="sr-stream-chain-backend-tpu"),
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
