"""The rooflines' counts equal brute-force counts of what the frozen
plain DPs visit."""
import numpy as np
import pytest
import torch

from gpubench import counts
from gpubench.ref import chain as rchain
from gpubench.ref import ksw2_ref


def anchors(rng, n, spread):
    rid = rng.integers(0, 2, n).astype(np.uint64)
    pos = rng.integers(0, spread, n).astype(np.uint64)
    strand = rng.integers(0, 2, n).astype(np.uint64)
    x = (strand << np.uint64(63)) | (rid << np.uint64(32)) | pos
    qpos = rng.integers(0, 5000, n).astype(np.uint64)
    y = (np.uint64(15) << np.uint64(32)) | qpos
    a = np.stack([x, y], 1)
    return a[np.argsort(a[:, 0], kind="stable")]


class _Arange:
    """np as the frozen DP sees it, counting the predecessors it scores
    (each anchor's `np.arange(lo, i)`)."""

    def __init__(self):
        self.pairs = 0

    def __getattr__(self, k):
        return getattr(np, k)

    def arange(self, *a, **kw):
        r = np.arange(*a, **kw)
        if len(a) == 2:
            self.pairs += len(r)
        return r


@pytest.mark.parametrize("n,spread,max_dist,max_iter", [
    (300, 20000, 5000, 5000), (2000, 3000, 5000, 5000),
    (1500, 1000, 200000, 5000), (500, 4000, 5000, 50), (1, 10, 10, 10)])
def test_chain_pairs_equal_the_dp(monkeypatch, n, spread, max_dist,
                                  max_iter):
    a = anchors(np.random.default_rng(n), n, spread)
    spy = _Arange()
    monkeypatch.setattr(rchain, "np", spy)
    rchain.chain_scores_window(a, max_dist, 5000, 500, max_iter, 1.0,
                               False, 1)
    monkeypatch.undo()
    ax, _, _, _ = rchain.unpack_anchors(a)
    assert counts.chain_pairs_np(ax, max_dist, max_iter) == spy.pairs
    # brute force, and the device count on a padded (B, N) bucket
    axl = [int(v) for v in ax]
    brute = sum(1 for i in range(n) for j in range(i)
                if axl[i] - axl[j] <= max_dist and
                i - j <= min(max_iter, 1024))
    assert brute == spy.pairs
    N = 64 * ((n + 63) // 64 + 1)
    hi = np.full((2, N), -0x7FFFFF0, np.int32)
    lo = np.zeros((2, N), np.int32)
    x = a[:, 0]
    hi[0, :n] = (x >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo[0, :n] = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    nn = torch.tensor([[n], [0]], dtype=torch.int32)
    got = counts.chain_pairs_t(torch.from_numpy(hi), torch.from_numpy(lo),
                               nn, max_dist, min(max_iter, 1024))
    assert int(got) == spy.pairs


def band_cells_brute(qlen, tlen, w):
    """The anti-diagonal band of ksw2_ref.ksw_extd2's loop, cell by
    cell."""
    if w < 0:
        w = max(tlen, qlen)
    cells = 0
    for r in range(qlen + tlen - 1):
        st, en = 0, tlen - 1
        if st < r - qlen + 1:
            st = r - qlen + 1
        if en > r:
            en = r
        if st < (r - w + 1) >> 1:
            st = (r - w + 1) >> 1
        if en > (r + w) >> 1:
            en = (r + w) >> 1
        if st > en:
            break
        cells += sum(1 for t in range(st, en + 1) if 0 <= r - t < qlen)
    return cells


@pytest.mark.parametrize("qlen,tlen,w", [(50, 60, 10), (200, 120, 500),
                                         (7, 300, 3), (100, 100, -1),
                                         (1, 1, 0)])
def test_extd2_cells_equal_the_band(qlen, tlen, w):
    assert counts.extd2_cells(qlen, tlen, w) == band_cells_brute(qlen, tlen,
                                                                 w)


def test_extd2_cells_of_a_real_fill():
    """On a fill the frozen ksw_extd2 runs to its end, its anti-diagonal
    loop visits exactly the counted band."""
    rng = np.random.default_rng(1)
    t8 = rng.integers(0, 4, 300).astype(np.uint8)
    q8 = t8[5:290].copy()
    mat = ksw2_ref.gen_simple_mat(2, 4, 1)
    ez = ksw2_ref.ksw_extd2(len(q8), q8, len(t8), t8, mat, 4, 2, 24, 1, 40,
                            400, -1, 0)
    assert not ez.zdropped
    assert counts.extd2_cells(len(q8), len(t8), 40) == \
        band_cells_brute(len(q8), len(t8), 40)


def test_exts2_cells_and_peak():
    assert counts.exts2_cells(30, 4000) == 120000
    assert counts.exts2_cells(0, 10) == 0
    assert counts.int32_peak(132, 1980) == pytest.approx(1.672704e13)
    assert counts.least_time(1.672704e13, 0, 1.672704e13) == 1.0
    assert counts.least_time(0, 3.35e12, 1.0) == 1.0


def test_roofline_is_none_without_work():
    class W:
        ops = 0
        bytes = 0

    class T:
        def kernel_seconds(self, p):
            return 1.0

    class R:
        work = {"k1": W()}
        trace = T()
        ops_peak = 1e13

    assert counts.roofline_share(R(), "k1", "x") is None
    R.work["k1"].ops = 1e13
    assert counts.roofline_share(R(), "k1", "x") == pytest.approx(100.0)
