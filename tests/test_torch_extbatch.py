"""The port's cross-read extension batcher and its `--align-backend gpu`
path against the JAX package.

`TorchExtBatcher` groups the fills of concurrently aligned reads and runs
each group through the port's extd2 (here on the CPU, i.e. its plain
PyTorch version). Through the CLI, `-a`/`-c --align-backend gpu
--align-tpu-min-mat 1 --device cpu` must give output byte-identical to
`mm2tpu.cli --map-mode batch` with the host extension."""
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mm2tpu.ops import ksw2_ref as K
from mm2tpu_torch.cli import main
from mm2tpu_torch.mapping.extbatch import TorchExtBatcher, worker_scope
from mm2tpu_torch.ops import ksw2_extd2 as X
from mm2tpu_torch.utils import profiling
from test_ksw2_pallas import FIELDS
from test_torch_pipeline import REPO, load_make_workload

MAT = np.asarray(K.gen_simple_mat(2, 4, 1), np.int8)


def fills(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t8 = rng.integers(0, 4, 80 + 10 * i).astype(np.uint8)
        q8 = t8.copy()
        q8[::7] = (q8[::7] + 1) % 4
        out.append((q8, t8))
    return out


def submit_all(bat, tasks, flags):
    """Every task from its own worker thread, all posted before the first
    flush can run (the workers wait at a barrier inside worker_scope)."""
    gate = threading.Barrier(len(tasks))

    def run_one(args):
        (q8, t8), flag = args
        with worker_scope(bat):
            gate.wait(timeout=60)
            return bat.submit(q8, t8, MAT, 4, 2, 24, 1, 151, 400, -1, flag)

    with ThreadPoolExecutor(len(tasks)) as ex:
        return list(ex.map(run_one, zip(tasks, flags)))


def test_batcher_groups_and_flushes():
    tasks = fills(6)
    flags = [0, 0, 0, K.KSW_EZ_RIGHT, K.KSW_EZ_RIGHT, 0]
    bat = TorchExtBatcher("cpu", max_batch=8, min_cells=0)
    calls = X.reference_calls
    results = submit_all(bat, tasks, flags)
    assert bat.n_batched == len(tasks)
    # one group per parameter set at least, fewer flushes than fills
    assert 2 <= bat.n_dispatches < len(tasks)
    assert X.reference_calls - calls == bat.n_dispatches
    for (q8, t8), flag, rz in zip(tasks, flags, results):
        exp = K.ksw_extd2(len(q8), q8, len(t8), t8, MAT, 4, 2, 24, 1,
                          151, 400, -1, flag)
        for f in FIELDS:
            assert getattr(rz, f) == getattr(exp, f), f


def test_batcher_stress_many_workers():
    """More workers than cores, each posting several fills of two
    parameter sets, with a short thread switch interval: every fill comes
    back once and right, and no flush exceeds max_batch."""
    rng = np.random.default_rng(3)
    n_workers, per_worker = 24, 3
    work = []
    for w in range(n_workers):
        items = []
        for k in range(per_worker):
            t8 = rng.integers(0, 4, int(rng.integers(20, 40))).astype(
                np.uint8)
            q8 = t8.copy()
            q8[::5] = (q8[::5] + 1) % 4
            items.append(((q8, t8), K.KSW_EZ_RIGHT if (w + k) % 2 else 0))
        work.append(items)
    bat = TorchExtBatcher("cpu", max_batch=4, min_cells=0)
    sizes = []
    run_group = bat._run_group

    def counting(key, group):
        sizes.append(len(group))
        run_group(key, group)
    bat._run_group = counting

    def run_worker(items):
        with worker_scope(bat):
            return [bat.submit(q8, t8, MAT, 4, 2, 24, 1, 151, 400, -1, flag)
                    for (q8, t8), flag in items]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(n_workers) as ex:
            futs = [ex.submit(run_worker, items) for items in work]
            results = [f.result(timeout=300) for f in futs]
    finally:
        sys.setswitchinterval(old)
    assert bat.n_batched == sum(sizes) == n_workers * per_worker
    assert max(sizes) <= 4 and bat.n_dispatches == len(sizes)
    for items, res in zip(work, results):
        for ((q8, t8), flag), rz in zip(items, res):
            exp = K.ksw_extd2(len(q8), q8, len(t8), t8, MAT, 4, 2, 24, 1,
                              151, 400, -1, flag)
            assert rz.score == exp.score and rz.cigar == exp.cigar


def test_failed_flush_raises_in_every_waiter():
    """A flush that fails raises in each of its waiters; nothing falls
    back to the host extension."""
    def broken(*args, **kw):
        raise RuntimeError("launch failed")

    bat = TorchExtBatcher("cpu", max_batch=8, min_cells=0, ext_fn=broken)
    tasks = fills(3)
    gate = threading.Barrier(len(tasks))

    def run_one(task):
        with worker_scope(bat):
            gate.wait(timeout=60)
            with pytest.raises(RuntimeError, match="launch failed"):
                bat.submit(*task, MAT, 4, 2, 24, 1, 151, 400, -1, 0)
            return True

    with ThreadPoolExecutor(len(tasks)) as ex:
        assert all(ex.map(run_one, tasks))
    assert bat.n_batched == len(tasks)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("wl")
    return load_make_workload().make(str(d), genome_mb=0.3, n_reads=12,
                                     mean_len=2500, seed=3)


def strip_pg(text):
    return "".join(ln for ln in text.splitlines(True)
                   if not ln.startswith("@PG"))


@pytest.mark.parametrize("mode", ["-a", "-c"])
def test_cli_gpu_backend_matches_host_extension(workload, tmp_path, mode):
    ref, reads = workload
    out = tmp_path / "port.out"
    calls, launches = X.reference_calls, X.launches
    try:
        rc = main(["-x", "map-ont", "--map-mode", "batch", mode,
                   "--align-backend", "gpu", "--align-tpu-min-mat", "1",
                   "--device", "cpu",
                   "--profile", "-o", str(out), ref, reads])
        counters = dict(profiling.counters)
    finally:
        profiling.disable()
    assert rc == 0
    assert counters.get("ext.fills", 0) > 0
    assert counters.get("ext.host_fills", 0) == 0
    assert counters["ext.dispatches"] <= counters["ext.fills"]
    assert X.reference_calls - calls == counters["ext.dispatches"]
    assert X.launches == launches
    jax_out = tmp_path / "jax.out"
    r = subprocess.run(
        [sys.executable, "-m", "mm2tpu.cli", "-x", "map-ont", mode,
         "--map-mode", "batch", "-o", str(jax_out), ref, reads],
        cwd=str(REPO), capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    port = strip_pg(out.read_text())
    assert port == strip_pg(jax_out.read_text())
    body = [ln for ln in port.splitlines() if not ln.startswith("@")]
    assert len(body) >= 12
    if mode == "-c":
        assert all("cg:Z:" in ln for ln in body)


def test_cli_default_threshold_keeps_small_fills_on_host(workload, tmp_path):
    """At the default --align-tpu-min-mat (1M cells) the fills of 2.5 kb
    reads stay on the host's native extension, and the counters say so."""
    ref, reads = workload
    try:
        rc = main(["-x", "map-ont", "--map-mode", "batch", "-a",
                   "--align-backend", "gpu", "--device", "cpu", "--profile",
                   "-o",
                   str(tmp_path / "out.sam"), ref, reads])
        counters = dict(profiling.counters)
    finally:
        profiling.disable()
    assert rc == 0
    assert counters.get("ext.fills", 0) == 0
    assert counters["ext.host_fills"] > 0


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    tasks = []
    for _ in range(8):
        t8 = rng.integers(0, 4, int(rng.integers(300, 1000))).astype(
            np.uint8)
        q8 = t8.copy()
        q8[::9] = (q8[::9] + 1) % 4
        tasks.append((q8, t8))
    for flag in (0, K.KSW_EZ_APPROX_MAX,
                 K.KSW_EZ_EXTZ_ONLY | K.KSW_EZ_RIGHT | K.KSW_EZ_REV_CIGAR):
        launches = X.launches
        kern = X.extd2_batch(tasks, MAT, 4, 2, 24, 1, 500, 400, 10, flag,
                             device="cuda")
        assert X.launches == launches + 1
        plain = X.extd2_batch(tasks, MAT, 4, 2, 24, 1, 500, 400, 10, flag,
                              device="cuda", fn=X.extd2_traced_reference)
        for a, b in zip(kern, plain):
            for f in FIELDS:
                assert getattr(a, f) == getattr(b, f), f
