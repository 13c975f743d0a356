"""The port's general-contract chaining (mm2tpu_torch.ops.chain_v2, K2)
against the JAX package.

The plain PyTorch version must equal the Pallas v2 kernel (run in
interpret mode, as the JAX package's own tests run it on the CPU) and the
NumPy window oracle exactly, on two-segment anchors (paired reads, with
cross-segment pairs at dr == 0 for the pair bonus) and on cDNA scoring:
the DP is integer, so the tolerance is 0 on the full (B, N) f and p. The
same NumPy-seeded planes go to both."""
import numpy as np
import pytest
import torch

from mm2tpu.ops.chain_pallas import pack_anchors
from mm2tpu.ops.chain_pallas_v2 import chain_scores_device_v2
from mm2tpu.ops.chain_ref import avg_qspan_scaled, chain_scores_window
from mm2tpu.options import MM_SEED_SEG_SHIFT
from mm2tpu_torch.ops import chain_v2, chain_v3
from test_chain_pallas import synth_anchors
from test_torch_chain_v3 import to_torch

B, N = 8, 1024

# (is_cdna, n_segs): read pairs, spliced reads, spliced pairs
CONTRACTS = [(False, 2), (True, 1), (True, 2)]
CONFIGS = {
    # -x sr on a 2 x 150 bp pair: chain_gaps gives (gap_ref 500,
    # gap_qry 300), bw 100
    "sr": dict(max_dist_x=500, max_dist_y=300, bw=100, iter_cap=1024,
               gap_scale=1.0),
    # -x splice: gap_ref = max_gap_ref 200000, gap_qry 2000, bw 200000
    "splice": dict(max_dist_x=200000, max_dist_y=2000, bw=200000,
                   iter_cap=1024, gap_scale=1.0),
    "gap_scale0.8": dict(max_dist_x=5000, max_dist_y=5000, bw=500,
                         iter_cap=1024, gap_scale=0.8),
    "iter_cap500": dict(max_dist_x=5000, max_dist_y=5000, bw=500,
                        iter_cap=500, gap_scale=1.0),
}


def two_segment(a, seed):
    """`a` with segment ids 0/1 in y's segment bits, drawn at random
    anchor by anchor, and one anchor in ten moved onto its predecessor's
    x (dr == 0: across segments, the pair bonus)."""
    rng = np.random.default_rng(seed)
    a = a.copy()
    n = len(a)
    sid = (rng.random(n) < 0.5).astype(np.uint64)
    a[:, 1] |= sid << np.uint64(MM_SEED_SEG_SHIFT)
    dup = np.flatnonzero(rng.random(n) < 0.1)
    dup = dup[dup > 0]
    a[dup, 0] = a[dup - 1, 0]
    return a


def make_batch(n_segs, seed=0):
    """B task rows, multi-rid reverse-strand, dense (windows hit the 1024
    cap), tie-heavy and sparse (scale 400: gaps of tens of kb, where the
    cDNA cost differs), with uneven n and padding."""
    kinds = [dict(n_rids=3, rev_frac=0.4), dict(scale=2),
             dict(scale=1, span=19), dict(scale=400, n_rids=2, rev_frac=1.0)]
    tasks = []
    for b in range(B):
        n = N - 17 * b - (0 if b % 3 else 300)
        a = synth_anchors(n, seed=seed + b, **kinds[b % 4])
        tasks.append(two_segment(a, seed + b) if n_segs > 1 else a)
    planes = [np.stack(x) for x in zip(*(pack_anchors(a, N) for a in tasks))]
    n = np.array([[len(a)] for a in tasks], np.int32)
    avg = np.array([[avg_qspan_scaled(a)] for a in tasks], np.float32)
    return tasks, (*planes, n, avg)    # hi, lo, qi, span, sid, n, avg


@pytest.fixture(scope="module")
def batches():
    return {n_segs: make_batch(n_segs, seed=60 + n_segs) for n_segs in (1, 2)}


def cases():
    return [pytest.param(c, name, id="%s-cdna%d-segs%d" % (name, *c))
            for c in CONTRACTS for name in CONFIGS]


@pytest.mark.parametrize("contract,name", cases())
def test_plain_matches_pallas_v2_interpret(batches, contract, name):
    is_cdna, n_segs = contract
    _, arrays = batches[n_segs]
    cfg = dict(CONFIGS[name], is_cdna=is_cdna, n_segs=n_segs)
    f_ref, p_ref = chain_scores_device_v2(*arrays, interpret=True, **cfg)
    f, p = chain_v2.chain_scores_v2_reference(*to_torch(arrays), **cfg)
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_ref))
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))


@pytest.mark.parametrize("contract,name", cases())
def test_plain_matches_window_oracle(batches, contract, name):
    is_cdna, n_segs = contract
    tasks, arrays = batches[n_segs]
    cfg = CONFIGS[name]
    f, p = chain_v2.chain_scores_v2_reference(
        *to_torch(arrays), is_cdna=is_cdna, n_segs=n_segs, **cfg)
    f, p = f.numpy(), p.numpy()
    for b, a in enumerate(tasks):
        n = len(a)
        fo, po, _ = chain_scores_window(
            a, cfg["max_dist_x"], cfg["max_dist_y"], cfg["bw"],
            cfg["iter_cap"], cfg["gap_scale"], is_cdna, n_segs)
        np.testing.assert_array_equal(f[b, :n], fo)
        np.testing.assert_array_equal(p[b, :n], po)
        assert (f[b, n:] == 0).all() and (p[b, n:] == -1).all()


def test_pair_bonus_and_cdna_cost_are_exercised(batches):
    """The inputs reach the branches that only the general contract has:
    cross-segment chains at dr == 0 and cDNA scores that differ from the
    uniseg cost on the same anchors."""
    _, arrays = batches[2]
    t = to_torch(arrays)
    hi, lo, qi, span, sid = t[:5]
    f2, p2 = chain_v2.chain_scores_v2_reference(
        *t, is_cdna=False, n_segs=2, **CONFIGS["sr"])
    rows, cols = torch.nonzero(p2 >= 0, as_tuple=True)
    j = p2[rows, cols].long()
    cross = sid[rows, cols] != sid[rows, j]
    assert (cross & (lo[rows, cols] == lo[rows, j])).any()
    _, arrays1 = batches[1]
    t1 = to_torch(arrays1)
    cfg = CONFIGS["splice"]
    f_cdna, _ = chain_v2.chain_scores_v2_reference(
        *t1, is_cdna=True, n_segs=1, **cfg)
    f_uni, _ = chain_v3.chain_scores_v3_reference(
        *t1[:4], *t1[5:], **cfg)
    assert not torch.equal(f_cdna, f_uni)


def test_cpu_tensors_route_to_plain_version(batches):
    _, arrays = batches[2]
    t = to_torch(arrays)
    cfg = dict(CONFIGS["sr"], is_cdna=False, n_segs=2)
    launches, calls = chain_v2.launches, chain_v2.reference_calls
    f, p = chain_v2.chain_scores_v2(*t, **cfg)
    assert chain_v2.reference_calls == calls + 1
    assert chain_v2.launches == launches
    f2, p2 = chain_v2.chain_scores_v2_reference(*t, **cfg)
    assert torch.equal(f, f2) and torch.equal(p, p2)


def test_wrapper_rejects_other_devices(batches):
    _, arrays = batches[2]
    t = [x.to("meta") for x in to_torch(arrays)]
    with pytest.raises(ValueError, match="unsupported device"):
        chain_v2.chain_scores_v2(*t, is_cdna=False, n_segs=2,
                                 **CONFIGS["sr"])


@pytest.mark.parametrize("fn", [chain_v2.chain_scores_v2,
                                chain_v2.chain_scores_v2_reference],
                         ids=["wrapper", "plain"])
def test_uniseg_contract_is_refused(batches, fn):
    """The single-segment non-cDNA contract is K1's (chain_v3)."""
    _, arrays = batches[1]
    with pytest.raises(ValueError, match="chain_v3"):
        fn(*to_torch(arrays), is_cdna=False, n_segs=1, **CONFIGS["sr"])


@pytest.mark.parametrize("bad", ["ragged_n", "sid_int64", "sid_strided",
                                 "sid_shape", "avg_f64", "n_shape",
                                 "n_int64", "n_device"])
def test_kernel_input_checks(batches, bad):
    """What the kernel cannot take raises before any launch, the n plane
    (which the kernel reads to stop each row) included."""
    _, arrays = batches[2]
    hi, lo, qi, span, sid, n, avg = to_torch(arrays)
    chain_v3._check_inputs(hi, lo, qi, span, n, avg, sid=sid)
    if bad == "ragged_n":
        hi, lo, qi, span, sid = (x[:, :1000].contiguous()
                                 for x in (hi, lo, qi, span, sid))
    elif bad == "sid_int64":
        sid = sid.to(torch.int64)
    elif bad == "sid_strided":
        sid = torch.cat([sid, sid], dim=1)[:, ::2]
    elif bad == "sid_shape":
        sid = sid[:4].contiguous()
    elif bad == "avg_f64":
        avg = avg.to(torch.float64)
    elif bad == "n_shape":
        n = n[:4].contiguous()
    elif bad == "n_int64":
        n = n.to(torch.int64)
    else:
        n = n.to("meta")
    with pytest.raises(ValueError):
        chain_v3._check_inputs(hi, lo, qi, span, n, avg, sid=sid)


@pytest.mark.gpu
@pytest.mark.parametrize("contract,name", cases())
def test_kernel_matches_plain_on_card(batches, contract, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    is_cdna, n_segs = contract
    _, arrays = batches[n_segs]
    t = to_torch(arrays, "cuda")
    cfg = dict(CONFIGS[name], is_cdna=is_cdna, n_segs=n_segs)
    launches = chain_v2.launches
    f, p = chain_v2.chain_scores_v2(*t, **cfg)
    torch.cuda.synchronize()
    assert chain_v2.launches == launches + 1
    f2, p2 = chain_v2.chain_scores_v2_reference(*t, **cfg)
    assert torch.equal(f, f2) and torch.equal(p, p2)
