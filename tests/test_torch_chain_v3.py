"""The port's chaining (mm2tpu_torch.ops.chain_v3) against the JAX package.

The plain PyTorch version must equal the Pallas v3 kernel (run in
interpret mode, as the JAX package's own tests run it on the CPU) and the
NumPy window oracle exactly: the DP is integer, so the tolerance is 0 on
the full (B, N) f and p. The same NumPy-seeded planes go to both."""
import numpy as np
import pytest
import torch

from mm2tpu.ops.chain_pallas import pack_anchors
from mm2tpu.ops.chain_pallas_v3 import chain_scores_device_v3
from mm2tpu.ops.chain_ref import avg_qspan_scaled, chain_scores_window
from mm2tpu_torch.ops import chain_v3
from test_chain_pallas import synth_anchors

B, N = 8, 2048

CONFIGS = [
    dict(max_dist_x=5000, max_dist_y=5000, bw=500, iter_cap=1024,
         gap_scale=1.0),
    dict(max_dist_x=5000, max_dist_y=5000, bw=500, iter_cap=500,
         gap_scale=1.0),
    dict(max_dist_x=5000, max_dist_y=5000, bw=500, iter_cap=1024,
         gap_scale=0.8),
    # max_dist_x > max_dist_y: the general gates of _pair_key
    dict(max_dist_x=5000, max_dist_y=800, bw=500, iter_cap=1024,
         gap_scale=1.0),
]


def make_batch(B, N, seed=0):
    """B task rows: multi-rid reverse-strand, dense (windows hit the 1024
    cap), tie-heavy and sparse rows, with uneven n and padding."""
    kinds = [dict(n_rids=3, rev_frac=0.4), dict(scale=2),
             dict(scale=1, span=19), dict(scale=200, n_rids=2, rev_frac=1.0)]
    tasks = []
    for b in range(B):
        n = N - 17 * b - (0 if b % 3 else 300)
        tasks.append(synth_anchors(n, seed=seed + b, **kinds[b % 4]))
    planes = [np.stack(x) for x in zip(*(pack_anchors(a, N) for a in tasks))]
    hi, lo, qi, span, _sid = planes
    n = np.array([[len(a)] for a in tasks], np.int32)
    avg = np.array([[avg_qspan_scaled(a)] for a in tasks], np.float32)
    return tasks, (hi, lo, qi, span, n, avg)


def to_torch(arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


@pytest.fixture(scope="module")
def batch():
    return make_batch(B, N, seed=50)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "cap%d_gs%g_mdy%d" % (
    c["iter_cap"], c["gap_scale"], c["max_dist_y"]))
def test_plain_matches_pallas_v3_interpret(batch, cfg):
    _, arrays = batch
    f_ref, p_ref = chain_scores_device_v3(*arrays, interpret=True, **cfg)
    f, p = chain_v3.chain_scores_v3_reference(*to_torch(arrays), **cfg)
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_ref))
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "cap%d_gs%g_mdy%d" % (
    c["iter_cap"], c["gap_scale"], c["max_dist_y"]))
def test_plain_matches_window_oracle(batch, cfg):
    tasks, arrays = batch
    f, p = chain_v3.chain_scores_v3_reference(*to_torch(arrays), **cfg)
    f, p = f.numpy(), p.numpy()
    for b, a in enumerate(tasks):
        n = len(a)
        fo, po, _ = chain_scores_window(
            a, cfg["max_dist_x"], cfg["max_dist_y"], cfg["bw"],
            cfg["iter_cap"], cfg["gap_scale"], False, 1)
        np.testing.assert_array_equal(f[b, :n], fo)
        np.testing.assert_array_equal(p[b, :n], po)
        assert (f[b, n:] == 0).all() and (p[b, n:] == -1).all()


def test_cpu_tensors_route_to_plain_version(batch):
    _, arrays = batch
    cfg = CONFIGS[0]
    t = to_torch(arrays)
    launches, calls = chain_v3.launches, chain_v3.reference_calls
    f, p = chain_v3.chain_scores_v3(*t, **cfg)
    assert chain_v3.reference_calls == calls + 1
    assert chain_v3.launches == launches
    f2, p2 = chain_v3.chain_scores_v3_reference(*t, **cfg)
    assert torch.equal(f, f2) and torch.equal(p, p2)


def test_wrapper_rejects_other_devices(batch):
    _, arrays = batch
    t = [x.to("meta") for x in to_torch(arrays)]
    with pytest.raises(ValueError, match="unsupported device"):
        chain_v3.chain_scores_v3(*t, **CONFIGS[0])


@pytest.mark.parametrize("bad", ["ragged_n", "int64", "strided", "avg_f64",
                                 "n_shape", "n_int64", "n_device"])
def test_kernel_input_checks(batch, bad):
    """What the kernel cannot take raises before any launch, the n plane
    (which the kernel reads to stop each row) included."""
    _, arrays = batch
    hi, lo, qi, span, n, avg = to_torch(arrays)
    chain_v3._check_inputs(hi, lo, qi, span, n, avg)
    if bad == "ragged_n":
        hi, lo, qi, span = (x[:, :1500].contiguous()
                            for x in (hi, lo, qi, span))
    elif bad == "int64":
        lo = lo.to(torch.int64)
    elif bad == "strided":
        qi = torch.cat([qi, qi], dim=1)[:, ::2]
    elif bad == "avg_f64":
        avg = avg.to(torch.float64)
    elif bad == "n_shape":
        n = n.reshape(-1)
    elif bad == "n_int64":
        n = n.to(torch.int64)
    else:
        n = n.to("meta")
    with pytest.raises(ValueError):
        chain_v3._check_inputs(hi, lo, qi, span, n, avg)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "cap%d_gs%g_mdy%d" % (
    c["iter_cap"], c["gap_scale"], c["max_dist_y"]))
def test_kernel_matches_plain_on_card(batch, cfg):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, arrays = batch
    t = to_torch(arrays, "cuda")
    launches = chain_v3.launches
    f, p = chain_v3.chain_scores_v3(*t, **cfg)
    torch.cuda.synchronize()
    assert chain_v3.launches == launches + 1
    f2, p2 = chain_v3.chain_scores_v3_reference(*t, **cfg)
    assert torch.equal(f, f2) and torch.equal(p, p2)
