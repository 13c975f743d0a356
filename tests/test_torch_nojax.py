"""mm2tpu_torch imports neither jax nor the JAX package `mm2tpu`, builds
and loads its own native library, and `--device cuda` without a card
fails loudly instead of falling back to the CPU. The child interpreter
that refuses jax and mm2tpu imports every module of the port (the
entry points and paftools among them) and runs its paths, one of them
under `--profile-trace`."""
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
                                     "dev.paf", "trace.paf", "trace")}
    r = run_python(f"""
import importlib, pkgutil
import mm2tpu_torch
mods = [m.name for m in pkgutil.walk_packages(mm2tpu_torch.__path__,
                                              "mm2tpu_torch.")]
assert len(mods) >= 30, mods
assert {{"mm2tpu_torch.mappy", "mm2tpu_torch.parallel.multihost",
        "mm2tpu_torch.entry", "mm2tpu_torch.tools.paftools",
        "mm2tpu_torch.tools.paftools_asm"}} <= set(mods), mods
for m in mods:
    importlib.import_module(m)
from mm2tpu_torch.cli import main
rc = main(["-x", "map-ont", "--map-mode", "batch", "--device", "cpu", "-o",
           {str(out["paf"])!r}, {ref!r}, {reads!r}])
assert rc == 0, rc
# SAM with every extension fill through the port's batcher and extd2
rc = main(["-x", "map-ont", "--map-mode", "batch", "-a", "--align-backend",
           "gpu", "--align-tpu-min-mat", "1", "--device", "cpu", "-o",
           {str(out["sam"])!r}, {ref!r}, {reads!r}])
assert rc == 0, rc
# read pairs (K2, two segments) with their fills on the port's extd2
rc = main(["-x", "sr", "--map-mode", "batch", "-a", "--align-backend", "gpu",
           "--device", "cpu", "-o", {str(out["sr.sam"])!r}, {ref!r}, {r1!r},
           {r2!r}])
assert rc == 0, rc
# spliced reads (K2, cDNA scoring)
rc = main(["-x", "splice", "--map-mode", "batch", "--device", "cpu", "-o",
           {str(out["tx.paf"])!r}, {ref!r}, {spliced!r}])
assert rc == 0, rc
# device seeding: the index probe, the anchor build and K1
from mm2tpu_torch.ops import seed_device
rc = main(["-x", "map-ont", "--map-mode", "batch", "--seed-backend", "gpu",
           "--device", "cpu", "-o", {str(out["dev.paf"])!r}, {ref!r},
           {reads!r}])
assert rc == 0, rc
assert all(seed_device.reference_calls.values()), seed_device.reference_calls
# the default map mode (stream) on a pool of two, under a torch.profiler
# trace, and paftools on the SAM
rc = main(["-x", "map-ont", "-t", "2", "--device", "cpu", "--profile-trace",
           {str(out["trace"])!r}, "-o", {str(out["trace.paf"])!r}, {ref!r},
           {reads!r}])
assert rc == 0, rc
from mm2tpu_torch.tools import paftools
assert paftools.main(["stat", {str(out["sam"])!r}]) == 0
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "mm2tpu")]
assert not bad, bad
""")
    assert r.returncode == 0, r.stderr[-3000:]
    assert len(out["paf"].read_text().splitlines()) >= 12
    assert out["dev.paf"].read_text() == out["paf"].read_text()
    assert out["trace.paf"].read_text() == out["paf"].read_text()
    assert len(list(out["trace"].glob("*.pt.trace.json"))) == 1
    assert "Number of mapped sequences: 12" in r.stdout
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


def test_mesh_cli_and_dryrun_run_without_jax(workload, tmp_path):
    """`--device cpu --mesh 2` and `python -m mm2tpu_torch.parallel.dryrun`
    in a process that refuses jax and mm2tpu: the mesh PAF equals the
    single-device PAF, and the dry run passes its three checks."""
    ref, reads = workload
    out = {k: tmp_path / k for k in ("one.paf", "mesh.paf")}
    r = run_python(f"""
import runpy
from mm2tpu_torch.cli import main
from mm2tpu_torch.utils import profiling
rc = main(["-x", "map-ont", "--map-mode", "batch", "--device", "cpu", "-o",
           {str(out["one.paf"])!r}, {ref!r}, {reads!r}])
assert rc == 0, rc
rc = main(["-x", "map-ont", "--map-mode", "batch", "--device", "cpu",
           "--mesh", "2", "--profile", "-o", {str(out["mesh.paf"])!r},
           {ref!r}, {reads!r}])
assert rc == 0, rc
assert profiling.counters["mesh.shards"] == 2 * \
    profiling.counters["chain.launches"], profiling.counters
sys.argv = ["dryrun", "--device", "cpu", "--shards", "2"]
try:
    runpy.run_module("mm2tpu_torch.parallel.dryrun", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "mm2tpu")]
assert not bad, bad
""")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "dryrun_multichip OK" in r.stdout
    one = out["one.paf"].read_text()
    assert len(one.splitlines()) >= 12
    assert out["mesh.paf"].read_text() == one


def test_mappy_and_multihost_run_without_jax(workload, tmp_path):
    """`mm2tpu_torch.mappy` and `mm2tpu_torch.parallel.multihost` in a
    process that refuses jax and mm2tpu: the API's primary hits are the
    CLI's `-c` primary lines, and three threads as hosts meet at a store
    barrier and count out."""
    ref, reads = workload
    paf = tmp_path / "c.paf"
    r = run_python(f"""
import socket, threading
from mm2tpu_torch import mappy
from mm2tpu_torch.cli import main
from mm2tpu_torch.parallel import multihost as mh
a = mappy.Aligner({ref!r}, preset="map-ont", device="cpu")
hits = []
for name, seq, _ in mappy.fastx_read({reads!r}):
    hits += ["%s\\t%d\\t%d\\t%s\\t%d\\t%d\\t%s" % (
        name, h.q_st, h.q_en, h.ctg, h.r_st, h.r_en, h.cigar_str)
        for h in a.map(seq) if h.is_primary]
assert main(["-x", "map-ont", "-c", "--device", "cpu", "-o", {str(paf)!r},
             {ref!r}, {reads!r}]) == 0
want = []
for ln in open({str(paf)!r}):
    c = ln.rstrip("\\n").split("\\t")
    if "tp:A:P" in c:
        want.append("\\t".join(c[i] for i in (0, 2, 3, 5, 7, 8)) + "\\t" +
                    [t[5:] for t in c if t.startswith("cg:Z:")][0])
assert hits == want and len(hits) >= 12, (hits, want)
s = socket.socket(); s.bind(("127.0.0.1", 0))
coord = "127.0.0.1:%d" % s.getsockname()[1]; s.close()
done = []
def host(h):
    c = mh.Coordinator(mh.open_store(mh.HostConfig(3, h, coord, 30)), 3, h,
                       30)
    c.barrier("x")
    c.finish()
    done.append(h)
ts = [threading.Thread(target=host, args=(h,)) for h in range(3)]
[t.start() for t in ts]
[t.join(60) for t in ts]
assert sorted(done) == [0, 1, 2], done
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "mm2tpu")]
assert not bad, bad
""")
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.mark.parametrize("argv", [
    ["-m", "mm2tpu_torch.cli", "-x", "map-ont", "--device", "cuda",
     "--mesh", "2"],
    ["-m", "mm2tpu_torch.parallel.dryrun", "--device", "cuda", "--shards",
     "2"]], ids=["cli", "dryrun"])
def test_mesh_on_cuda_without_enough_cards_fails(workload, tmp_path, argv):
    """A mesh of 2 CUDA shards with fewer than 2 visible cards exits
    non-zero and names the count; nothing runs on the CPU instead."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("this machine has 2 CUDA cards: the mesh would run")
    ref, reads = workload
    out = tmp_path / "out.paf"
    extra = ["-o", str(out), ref, reads] if argv[1].endswith("cli") else []
    r = subprocess.run([sys.executable, *argv, *extra], cwd=str(REPO),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode != 0
    assert "needs 2 devices; %d CUDA devices visible" % \
        torch.cuda.device_count() in r.stderr
    assert not out.exists()


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


# the ids are the ones the cases had while `--mesh` was refused too (it
# runs now: test_mesh_cli_and_dryrun_run_without_jax)
@pytest.mark.parametrize("flags,item,n_queries", [
    # --hosts runs now (tests/test_torch_multihost.py); without
    # --coordinator it is refused by mm2tpu.cli's validation, in its words
    pytest.param(["--hosts", "2"], "--hosts needs --coordinator", 1,
                 id="flags1-M9-1"),
    # the JAX package's device seeding, refused naming the port's; the id
    # is the one this case had when it expected the M7 refusal
    pytest.param(["--seed-backend", "tpu"], "--seed-backend gpu", 1,
                 id="flags2-M7-1"),
    pytest.param(["--align-backend", "tpu"], "--align-backend gpu", 1,
                 id="flags3---align-backend gpu-1"),
    # the JAX package's chaining route, refused naming the port's, and the
    # JAX package's batch-only device seeding asked for in stream mode
    pytest.param(["--chain-backend", "tpu"], "--chain-backend gpu", 1,
                 id="chain-backend-tpu"),
    pytest.param(["--map-mode", "stream", "--seed-backend", "gpu"],
                 "--map-mode batch only", 1, id="stream-seed-backend-gpu"),
    # --profile-trace runs now (tests/test_torch_profile_trace.py); the id
    # is the one this case had when it expected the M10 refusal. Device
    # seeding in the default map mode, stream, is refused naming the mode
    pytest.param(["--profile-trace", "tr", "--seed-backend", "gpu"],
                 "add --map-mode batch", 1, id="flags6-M10-1"),
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
