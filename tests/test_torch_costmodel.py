"""The port's cost model and router (`mm2tpu_torch/mapping/costmodel.py`,
`ChainRouter` of `mm2tpu_torch/mapping/chain.py`) against the JAX
package's (`mm2tpu/mapping/costmodel.py`, `mm2tpu/mapping/chain.py`) on
the same seeded inputs, the committed H100 constants, and the backend
probe on `torch.cuda`. Counterpart of tests/test_costmodel.py."""
import builtins
import json
import pathlib

import numpy as np
import pytest

from mm2tpu.mapping import chain as jchain
from mm2tpu.mapping import costmodel as jcm
from mm2tpu_torch.mapping import chain as tchain
from mm2tpu_torch.mapping import costmodel as tcm
from mm2tpu_torch.ops import _build

REPO = pathlib.Path(__file__).resolve().parent.parent
DATA = REPO / "mm2tpu_torch" / "data"


def _task(n, density, seed):
    """x-sorted anchors shaped like scripts/train_router_torch.py's."""
    rng = np.random.default_rng(seed)
    lo = np.sort(rng.integers(0, int(n / density), n)).astype(np.uint64)
    qi = np.clip(lo.astype(np.int64) + rng.integers(-400, 400, n), 0,
                 None).astype(np.uint64)
    a = np.zeros((n, 2), np.uint64)
    a[:, 0] = lo
    a[:, 1] = (np.uint64(15) << np.uint64(32)) | qi
    return a


def _rows(seed):
    """Seeded (n, subparts, trips, dev_ms, host_ms) rows with noise."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(30):
        n = int(rng.integers(256, 65536))
        sub = n * float(rng.uniform(1, 8))
        trip = n * float(rng.uniform(10, 1000))
        rows.append((n, sub, trip,
                     0.3 + 5.5e-4 * n + 1e-6 * sub + rng.normal(0, 0.05),
                     0.05 + 1.5e-6 * trip + rng.normal(0, 0.02)))
    return rows


@pytest.mark.parametrize("scipy", [True, False], ids=["scipy", "active-set"])
@pytest.mark.parametrize("seed,floor", [(1, None), (2, 0.25), (3, 5.0)])
def test_fit_matches_jax(monkeypatch, scipy, seed, floor):
    """`fit_cost_model` and `_bounded_lstsq` give the JAX package's
    constants from the same rows, with scipy's lsq_linear and with the
    active-set fallback (a floor of 5 ms clamps c_dev)."""
    if not scipy:
        real_import = builtins.__import__

        def no_scipy(name, *a, **k):
            if name.startswith("scipy"):
                raise ImportError("scipy unavailable")
            return real_import(name, *a, **k)

        monkeypatch.setattr(builtins, "__import__", no_scipy)
    rows = _rows(seed)
    want = jcm.fit_cost_model(rows, floor_dev_ms=floor)
    got = tcm.fit_cost_model(rows, floor_dev_ms=floor)
    for k in ("k1_dev", "k2_dev", "c_dev", "k_host", "c_host"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), rel=1e-9,
                                                abs=1e-15), k
    A = np.stack([np.arange(12.0) * 97, np.arange(12.0) * 791,
                  np.ones(12)], 1)
    y = A @ np.array([2.5e-3, 0.0, 60.0]) + \
        np.random.default_rng(seed).normal(0, 0.3, 12)
    lo = np.array([0.0, 0.0, 55.0])
    np.testing.assert_allclose(tcm._bounded_lstsq(A, y, lo),
                               jcm._bounded_lstsq(A, y, lo), rtol=1e-9)


def test_device_queue_matches_jax_under_a_fake_clock():
    clock = [0.0]
    jq = jcm.DeviceQueue(clock=lambda: clock[0])
    tq = tcm.DeviceQueue(clock=lambda: clock[0])
    rng = np.random.default_rng(4)
    answers = []
    for _ in range(300):
        t_dev, t_host = float(rng.uniform(0.1, 20)), \
            float(rng.uniform(0.1, 40))
        got, want = tq.admit(t_dev, t_host), jq.admit(t_dev, t_host)
        assert got == want
        assert tq.wait_ms() == pytest.approx(jq.wait_ms())
        answers.append(got)
        clock[0] += float(rng.uniform(0, 0.01))
    assert any(answers) and not all(answers)


MODELS = {
    "device-wins-big": (0.0, 0.0, 0.5, 1e-3, 0.0),
    "h100-like": (5.5e-4, 1e-7, 0.3, 1.5e-6, 0.05),
    "floorless": (1e-4, 0.0, 0.0, 1e-6, 0.0),
}
TASKS = [(n, d, s) for s, (n, d) in enumerate(
    [(64, 0.001), (512, 0.05), (1024, 0.3), (3000, 1.0), (4096, 1.0),
     (8192, 0.3), (20000, 2.0), (300, 1.0)])]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_router_picks_as_jax(model):
    """`ChainRouter.pick` with an explicit model gives the JAX package's
    answer on every seeded task ("gpu" where it says "tpu"), first with
    an empty queue, then with the queue saturated."""
    m = MODELS[model]
    clock = [0.0]
    jr = jchain.ChainRouter("auto", cost_model=jcm.CostModel(*m),
                            queue=jcm.DeviceQueue(clock=lambda: clock[0]))
    tr = tchain.ChainRouter("auto", cost_model=tcm.CostModel(*m),
                            queue=tcm.DeviceQueue(clock=lambda: clock[0]),
                            device="cpu")
    assert tr._n_min_dev == jr._n_min_dev
    picks = []
    for n, d, s in TASKS:
        a = _task(n, d, s)
        want = jr.pick(n, a=a, max_dist_x=5000)
        got = tr.pick(n, a=a, max_dist_x=5000)
        assert got == {"tpu": "gpu"}.get(want, want), (n, d)
        picks.append(got)
    for q in (jr.queue, tr.queue):
        for _ in range(3):
            q.admit(1e7, 1e9)
    for n, d, s in TASKS:
        a = _task(n, d, s)
        assert tr.pick(n, a=a) == jr.pick(n, a=a) == "native"
    if model == "device-wins-big":
        assert "gpu" in picks and "native" in picks


@pytest.mark.parametrize("ready", [False, True])
def test_router_threshold_without_model_as_jax(monkeypatch, ready):
    """No model: the size threshold, gated on the backend being up."""
    monkeypatch.setattr(jcm, "backend_ready", lambda: ready)
    monkeypatch.setattr(tcm, "backend_ready", lambda: ready)
    jr = jchain.ChainRouter("auto", tpu_min_anchors=1000)
    tr = tchain.ChainRouter("auto", tpu_min_anchors=1000, device="cpu")
    jr.cost_model = tr.cost_model = None
    for n in (10, 999, 1000, 2000):
        want = jr.pick(n)
        assert tr.pick(n) == {"tpu": "gpu"}.get(want, want)
    assert tr.pick(2000) == ("gpu" if ready else "native")


@pytest.mark.parametrize("backend", ["native", "python", "gpu"])
def test_forced_backends(backend):
    r = tchain.ChainRouter(backend, device="cpu")
    assert r.pick(5, a=_task(5, 1.0, 0)) == backend


@pytest.mark.parametrize("name", ["router_params_h100.json",
                                  "router_params_h100_asm20.json"])
def test_committed_h100_constants(name):
    """The committed constants load, are physical (slopes >= 0, a
    dispatch floor c_dev > 0) and name the card and its power limit they
    were fitted on."""
    path = DATA / name
    m = tcm.CostModel.load(str(path))
    assert m.k1_dev >= 0 and m.k2_dev >= 0 and m.k_host > 0
    assert m.c_dev > 0
    d = json.loads(path.read_text())
    assert "H100" in d["device"]
    assert d["power_limit"].endswith("W")


def test_default_models_are_the_ports_own(monkeypatch):
    """get_default_model reads mm2tpu_torch/data (never mm2tpu/data), one
    file a regime, and a router on them never routes to the device of a
    --device cpu run."""
    monkeypatch.setattr(tcm, "_DEFAULT_MODELS", {})
    monkeypatch.setattr(tcm, "_FORCED", False)
    monkeypatch.setattr(tcm, "_FORCED_MODEL", None)
    monkeypatch.setattr(tcm, "_PROBE_STARTED", False)
    assert all("h100" in f and "v5e" not in f
               for f in tcm._REGIME_FILES.values())
    m = tcm.get_default_model("map-ont")
    assert m == tcm.CostModel.load(str(DATA / "router_params_h100.json"))
    assert tcm.get_default_model("asm20") == tcm.CostModel.load(
        str(DATA / "router_params_h100_asm20.json"))
    r = tchain.ChainRouter("auto", device="cpu")
    assert r._default_model
    huge = _task(200000, 1.0, seed=7)
    assert r.pick(len(huge), a=huge, max_dist_x=5000) == "native"
    assert not tcm._PROBE_STARTED  # nothing started for a CPU run


def test_device_ready_is_false_for_cpu(monkeypatch):
    assert not tcm.device_ready("cpu")
    assert not tcm.device_ready(None)
    # even with the backend up, a --device cpu run is never device-ready
    monkeypatch.setattr(tcm, "backend_ready", lambda: True)
    assert not tcm.device_ready("cpu")
    assert tcm.device_ready("cuda")
    import torch
    assert tcm.device_ready(torch.device("cuda", 0))
    assert not tcm.device_ready(torch.device("cpu"))


def test_backend_ready_checks_without_starting():
    import torch
    if not torch.cuda.is_available():
        assert not tcm.backend_ready()
    if not _build.loaded():
        assert not tcm.backend_ready()


def test_warm_up_exception_reaches_the_caller(monkeypatch):
    """A failed build in the warm-up thread is raised on the mapping
    thread at the next `auto` pick on a CUDA device and at the end of the
    run, never turned into host placement. Where the card does not
    matter (a forced route, a CPU run) the pick goes on."""
    def broken():
        raise RuntimeError("nvcc failed (rc=1): stand-in")

    monkeypatch.setattr(_build, "load", broken)
    monkeypatch.setattr(tcm, "_PROBE_STARTED", False)
    monkeypatch.setattr(tcm, "_PROBE_THREAD", None)
    monkeypatch.setattr(tcm, "_PROBE_ERROR", None)
    tcm.ensure_backend_async("cuda")
    assert tcm.join_backend_probe(60.0)
    with pytest.raises(RuntimeError, match="stand-in"):
        tcm.raise_probe_error()
    r = tchain.ChainRouter("auto", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA backend failed"):
        r.pick(10, a=_task(10, 1.0, 0))
    assert tchain.ChainRouter("native", device="cuda").pick(
        10, a=_task(10, 1.0, 0)) == "native"
    assert tchain.ChainRouter("auto", device="cpu").pick(
        10, a=_task(10, 1.0, 0)) == "native"


def test_failed_warm_up_ends_with_its_run(monkeypatch, tmp_path):
    """A warm-up that failed is forgotten when the CLI run ends: the next
    run in the process maps (here on the CPU) and would probe afresh."""
    from mm2tpu_torch.cli import main

    def broken():
        raise RuntimeError("nvcc failed (rc=1): stand-in")

    monkeypatch.setattr(_build, "load", broken)
    monkeypatch.setattr(tcm, "_PROBE_STARTED", False)
    monkeypatch.setattr(tcm, "_PROBE_THREAD", None)
    monkeypatch.setattr(tcm, "_PROBE_ERROR", None)
    tcm.ensure_backend_async("cuda")
    assert tcm.join_backend_probe(60.0) and tcm._PROBE_ERROR is not None
    ref = tmp_path / "ref.fa"
    rng = np.random.default_rng(1)
    g = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 20000)])
    ref.write_text(">r\n%s\n" % g)
    reads = tmp_path / "q.fa"
    reads.write_text(">q\n%s\n" % g[2000:6000])
    out = tmp_path / "out.paf"
    assert main(["--map-mode", "stream", "--chain-backend", "native",
                 "--device", "cpu", "-o", str(out), str(ref),
                 str(reads)]) == 0
    assert out.read_text().startswith("q\t")
    assert not tcm._PROBE_STARTED and tcm._PROBE_THREAD is None
    assert tcm._PROBE_ERROR is None
    tcm.raise_probe_error()


def test_router_params_do_not_outlive_the_run(tmp_path):
    """--router-params forces a model for the run only."""
    from mm2tpu_torch.cli import main
    params = tmp_path / "p.json"
    tcm.CostModel(1e-4, 0.0, 0.3, 1e-6, 0.0).save(str(params))
    ref = tmp_path / "ref.fa"
    rng = np.random.default_rng(0)
    g = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 20000)])
    ref.write_text(">r\n%s\n" % g)
    reads = tmp_path / "q.fa"
    reads.write_text(">q\n%s\n" % g[5000:8000])
    out = tmp_path / "out.paf"
    assert main(["--map-mode", "stream", "--router-params", str(params),
                 "--device", "cpu", "-o", str(out), str(ref),
                 str(reads)]) == 0
    assert out.read_text().startswith("q\t")
    assert not tcm._FORCED and tcm._FORCED_MODEL is None


def test_build_and_counters_under_threads(monkeypatch):
    """The stream mode's threads share the kernels' build and counters:
    threads that reach ops._build.load() together build once, and the
    plain version's call counter loses no update."""
    import sys
    import threading
    import time

    import torch

    from mm2tpu_torch.ops import chain_v3

    builds = []

    def fake_build():
        builds.append(1)
        time.sleep(0.05)
        return "lib"

    monkeypatch.setattr(_build, "_build_and_load", fake_build)
    monkeypatch.setattr(_build, "_LIB", None)
    z = torch.zeros((1, 1), dtype=torch.int32)
    avg = torch.zeros((1, 1), dtype=torch.float32)
    libs = []

    def work():
        libs.append(_build.load())
        for _ in range(100):
            chain_v3.chain_scores_v3_reference(
                z, z, z, z, z, avg, max_dist_x=5000, max_dist_y=5000,
                bw=500, iter_cap=1024, gap_scale=1.0)

    calls = chain_v3.reference_calls
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert builds == [1] and libs == ["lib"] * 16 and _build.loaded()
    assert chain_v3.reference_calls - calls == 1600
