"""The port's wire-plane chaining (mm2tpu_torch.ops.chain_packed) against
mm2tpu.ops.chain_packed on the same pack_tasks16 planes, handed to both
through planes_to_torch, under both contracts (v3: single-segment
non-cDNA; v2: the rest). f and prel must be array-equal (tolerance 0:
integer DP), and the NumPy helpers copied into the port must equal their
originals."""
import numpy as np
import pytest
import torch

import mm2tpu.ops.chain_packed as jax_packed
from mm2tpu.ops.chain_pallas_v2 import v_carry_host as jax_v_carry_host
from mm2tpu_torch.ops import chain_packed, chain_v2, chain_v3
from test_chain_pallas import synth_anchors
from test_torch_chain_v2 import two_segment

N = 2048


@pytest.fixture(scope="module")
def tasks():
    """8 rows as a batch bucket carries them: uneven real tasks, then
    empty padding rows."""
    kinds = [dict(n_rids=3, rev_frac=0.4), dict(scale=2), dict(scale=1),
             dict(span=21, rev_frac=0.5)]
    real = [synth_anchors(N - 211 * b, seed=70 + b, **kinds[b % 4])
            for b in range(6)]
    return real + [np.zeros((0, 2), np.uint64)] * 2


def test_pack_tasks16_copy_matches_original(tasks):
    for a, b in zip(chain_packed.pack_tasks16(tasks, N),
                    jax_packed.pack_tasks16(tasks, N)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cfg", [
    dict(max_dist_x=5000, max_dist_y=5000, bw=500, iter_cap=5000,
         gap_scale=1.0),
    dict(max_dist_x=5000, max_dist_y=5000, bw=500, iter_cap=500,
         gap_scale=0.8),
], ids=["map-ont", "cap500_gs0.8"])
def test_chain_scores_packed_matches_jax(tasks, cfg):
    planes = jax_packed.pack_tasks16(tasks, N)
    f_ref, pr_ref = jax_packed.chain_scores_packed(
        *planes, is_cdna=False, n_segs=1, interpret=True, **cfg)
    f, pr = chain_packed.chain_scores_packed(
        *chain_packed.planes_to_torch(*planes, "cpu"), is_cdna=False,
        n_segs=1, **cfg)
    assert f.dtype == torch.int32 and pr.dtype == torch.int16
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_ref))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(pr_ref))

    # the copied host helpers, on the kernel's real output
    f_np, pr_np = f.numpy(), pr.numpy()
    for row, a in enumerate(tasks):
        n = len(a)
        p = chain_packed.unpack_prel(pr_np[row], n)
        np.testing.assert_array_equal(p, jax_packed.unpack_prel(pr_np[row], n))
        np.testing.assert_array_equal(
            chain_packed.v_carry_host(f_np[row:row + 1, :n], p[None]),
            jax_v_carry_host(f_np[row:row + 1, :n], p[None]))


def test_p_rel_and_derive_qss_match_jax():
    from mm2tpu.ops.chain_packed import _derive_qss, _p_rel
    rng = np.random.default_rng(5)
    i = np.arange(N, dtype=np.int32)
    p = np.where(rng.random((4, N)) < 0.3, -1,
                 i - rng.integers(1, 1025, (4, N))).astype(np.int32)
    p = np.where(p < 0, -1, p)
    np.testing.assert_array_equal(
        chain_packed.p_rel(torch.from_numpy(p)).numpy(), np.asarray(_p_rel(p)))
    yhi = rng.integers(-2**31, 2**31, (4, N)).astype(np.int32)
    ylo = rng.integers(-2**31, 2**31, (4, N)).astype(np.int32)
    for a, b in zip(chain_packed.derive_qss(torch.from_numpy(yhi),
                                            torch.from_numpy(ylo)),
                    _derive_qss(yhi, ylo)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("is_cdna,n_segs", [(True, 1), (False, 2)])
def test_v2_contract_matches_jax(tasks, is_cdna, n_segs):
    """Spliced-read (cDNA) and read-pair (two-segment) batches go to the
    v2 contract in both packages, with the same f and prel."""
    if n_segs > 1:
        tasks = [two_segment(a, 90 + b) for b, a in enumerate(tasks)]
    planes = jax_packed.pack_tasks16(tasks, N)
    cfg = dict(max_dist_x=5000, max_dist_y=5000, bw=500, iter_cap=5000,
               gap_scale=1.0, is_cdna=is_cdna, n_segs=n_segs)
    f_ref, pr_ref = jax_packed.chain_scores_packed(*planes, interpret=True,
                                                   **cfg)
    calls, calls3 = chain_v2.reference_calls, chain_v3.reference_calls
    f, pr = chain_packed.chain_scores_packed(
        *chain_packed.planes_to_torch(*planes, "cpu"), **cfg)
    assert chain_v2.reference_calls == calls + 1
    assert chain_v3.reference_calls == calls3
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_ref))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(pr_ref))
