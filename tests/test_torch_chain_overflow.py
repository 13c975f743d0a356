"""Chain scores that would wrap an int32 predecessor key are keyed in
int64 by K1/K2 and their plain versions.

The Pallas kernels pick a predecessor by the int32 key sc * 1024 +
(1024 - d), exact up to sc = `chain_packed.KEY_SCORE_MAX` (2^21 - 2). A
collinear task of 9000 anchors of span 255, 300 bp apart, scores 255
more at each anchor and passes it at anchor 8224 (f = 2,097,375), where
an int32 key wraps. Its span sum is over the bound, so K1/K2 (csrc/
chain.cu) and their plain versions key its row in int64 and give
`chain_ref.chain_scores_window`'s f and p, the contract's oracle, at
every device chaining site: the batch round (single device and mesh),
the device seeding round, `chain_scores_task`, the mesh steps and
`chain_scores_packed8`. The task of its first 8224 anchors, whose span
sum 2,097,120 is just under the bound, keeps the int32 key. Integer DP:
f and p must be equal, tolerance 0."""
import numpy as np
import pytest
import torch

from mm2tpu_torch.mapping import pipeline
from mm2tpu_torch.ops import chain_packed, chain_ref, chain_v2, chain_v3
from mm2tpu_torch.parallel import mesh as M
from mm2tpu_torch.utils import profiling

SPAN, STEP = 255, 300
OVER, UNDER = 9000, 8224
KW = dict(max_dist_x=5000, max_dist_y=5000, bw=500, iter_cap=1024,
          gap_scale=1.0, is_cdna=False, n_segs=1)


def collinear(n):
    pos = STEP * np.arange(n, dtype=np.uint64)
    y = (np.uint64(SPAN) << np.uint64(32)) | pos
    return np.stack([pos, y], axis=1)


def oracle(a):
    return chain_ref.chain_scores_window(
        a, KW["max_dist_x"], KW["max_dist_y"], KW["bw"], KW["iter_cap"],
        KW["gap_scale"], KW["is_cdna"], KW["n_segs"])


@pytest.fixture(scope="module")
def tasks():
    over, under = collinear(OVER), collinear(UNDER)
    return {"over": (over, oracle(over)), "under": (under, oracle(under))}


@pytest.fixture
def profile():
    profiling.enable()
    try:
        yield profiling.counters
    finally:
        profiling.disable()


def test_the_bound_and_the_wrap(tasks):
    """The bound is the exact threshold of the int32 key, the two tasks
    lie on either side of it, the oracle's scores of the task over it
    would wrap that key, and the plain K1 keys only that row in int64."""
    assert chain_packed.KEY_SCORE_MAX == 2**21 - 2
    assert (chain_packed.KEY_SCORE_MAX * 1024 + 1024) <= 2**31 - 1 < \
        (chain_packed.KEY_SCORE_MAX + 1) * 1024 + 1024
    over, (f_over, _, _) = tasks["over"]
    under, _ = tasks["under"]
    assert chain_packed.score_bound(under) == SPAN * UNDER <= \
        chain_packed.KEY_SCORE_MAX < chain_packed.score_bound(over)
    assert int(f_over[8224]) == 2_097_375
    sc = torch.tensor([[2_097_375]], dtype=torch.int32)
    age = torch.tensor([1023], dtype=torch.int32)
    assert int(chain_v3.pair_keys(sc, age, None)) < 0       # wraps
    assert int(chain_v3.pair_keys(sc, age, torch.tensor([[True]]))) == \
        2_097_375 * 1024 + 1023
    hi, lo, yhi, ylo, n, avg = chain_packed.pack_tasks16([under, over], 9216)
    wide = chain_v3.wide_rows(torch.from_numpy(yhi & 0xFF))
    assert wide.flatten().tolist() == [False, True]
    assert chain_v3.wide_rows(torch.from_numpy(yhi[:1] & 0xFF)) is None
    f, prel = chain_packed.chain_scores_packed(
        *chain_packed.planes_to_torch(hi, lo, yhi, ylo, n, avg, "cpu"), **KW)
    for r, (a, (f_w, p_w, _)) in enumerate((tasks["under"], tasks["over"])):
        np.testing.assert_array_equal(f[r, :len(a)].numpy(), f_w)
        np.testing.assert_array_equal(
            chain_packed.unpack_prel(prel[r].numpy(), len(a)), p_w)


def test_chain_scores_task(tasks, profile):
    for name in ("over", "under"):
        a, (f_w, p_w, v_w) = tasks[name]
        calls = chain_v3.reference_calls
        f, p, v = chain_packed.chain_scores_task(
            a, KW["max_dist_x"], KW["max_dist_y"], KW["bw"], 5000, 1.0,
            False, 1, device="cpu")
        np.testing.assert_array_equal(f, f_w)
        np.testing.assert_array_equal(p, p_w)
        np.testing.assert_array_equal(v, v_w)
        assert chain_v3.reference_calls - calls == 1
    assert profile["chain.wide_key"] == 1


@pytest.mark.parametrize("wire", ["packed8", "mesh", "mesh8"])
def test_planes_sites(tasks, wire):
    """`chain_scores_packed8` and both mesh steps on a batch of the two
    tasks and two empty rows: each row equals the oracle."""
    rows = [tasks["under"][0], np.zeros((0, 2), np.uint64),
            tasks["over"][0], np.zeros((0, 2), np.uint64)]
    N = 9216
    if wire == "mesh":
        hi, lo, yhi, ylo, n, avg = chain_packed.pack_tasks16(rows, N)
        step = M.sharded_chain_step(M.make_mesh(2, devices=["cpu"] * 2),
                                    **KW)
        f, p = (t.numpy() for t in step(
            hi, lo, *chain_packed.derive_qss(yhi, ylo), n, avg).result())
    else:
        p8 = chain_packed.pack_tasks8(rows, N)
        if wire == "packed8":
            f, prel = chain_packed.chain_scores_packed8(
                *chain_packed.planes_to_torch(*p8, "cpu"), **KW)
        else:
            step = M.sharded_chain_step8(
                M.make_mesh(4, devices=["cpu"] * 4), **KW)
            f, prel = step(*p8).result()
        f = f.numpy()
        p = np.stack([chain_packed.unpack_prel(prel[r].numpy(), N)
                      for r in range(4)])
    for r, name in ((0, "under"), (2, "over")):
        a, (f_w, p_w, _) = tasks[name]
        np.testing.assert_array_equal(f[r, :len(a)], f_w)
        np.testing.assert_array_equal(p[r, :len(a)], p_w)
        assert (f[r, len(a):] == 0).all() and (p[r, len(a):] == -1).all()


@pytest.mark.parametrize("mesh", [None, 2], ids=["one-device", "mesh2"])
def test_batch_round(tasks, profile, monkeypatch, mesh):
    """The batch round of `map_frags_batched`, its seeding stage replaced
    by the two tasks as each fragment's anchors: the (a, u) it hands to
    the post-chain stage equal the oracle's backtrack for both tasks, on
    the plain K1, and the task over the bound is counted."""
    from mm2tpu_torch.mapping.seed import SeedResult
    from mm2tpu_torch.options import set_opt
    _, opt = set_opt("map-ont")
    names = ["over", "under"]

    def frag_ctx(seqs, o, qname):
        a = tasks[qname][0]
        return pipeline._FragCtx(
            seqs=seqs, qlens=[len(seqs[0])], qlen_sum=len(seqs[0]),
            qname=qname, hash_=0, is_splice=False, is_sr=False, n_segs=1,
            mv=None, sr=SeedResult(a, 0, np.zeros(0, np.uint64), 0),
            gap_ref=KW["max_dist_x"], gap_qry=KW["max_dist_y"])

    got = {}

    def post_regions(mi, ctx, o, a, u):
        got[ctx.qname] = (a, u)
        return []

    monkeypatch.setattr(pipeline, "_frag_ctx", frag_ctx)
    monkeypatch.setattr(pipeline, "_seed_first_pass", lambda *a, **kw: None)
    monkeypatch.setattr(pipeline, "_post_regions", post_regions)
    calls = chain_v3.reference_calls
    m = None if mesh is None else M.make_mesh(mesh, devices=["cpu"] * mesh)
    pipeline.map_frags_batched(None, [["A" * 10000]] * 2, opt, names, "cpu",
                               mesh=m)
    assert chain_v3.reference_calls > calls
    for name in names:
        a, (f_w, p_w, v_w) = tasks[name]
        want = chain_ref.chain_backtrack(len(a), f_w, p_w, v_w, a,
                                         opt.min_cnt, opt.min_chain_score)
        for x, y in zip(got[name], want):
            np.testing.assert_array_equal(x, y)
    assert profile["chain.wide_key"] == 1


@pytest.mark.parametrize("contract", [(True, 1), (False, 2)],
                         ids=["cdna", "two-segment"])
def test_general_contract_over_the_bound(tasks, contract):
    """The plain K2 (the cDNA contract, and two segments with every
    anchor in the first) on the task over the bound: f and p equal the
    oracle's under the same contract."""
    is_cdna, n_segs = contract
    a = tasks["over"][0]
    kw = dict(KW, is_cdna=is_cdna, n_segs=n_segs)
    f_w, p_w, _ = chain_ref.chain_scores_window(
        a, kw["max_dist_x"], kw["max_dist_y"], kw["bw"], kw["iter_cap"],
        kw["gap_scale"], is_cdna, n_segs)
    assert int(f_w.max()) > chain_packed.KEY_SCORE_MAX
    calls = chain_v2.reference_calls
    f, prel = chain_packed.chain_scores_packed(
        *chain_packed.planes_to_torch(*chain_packed.pack_tasks16([a], 9216),
                                      "cpu"), **kw)
    assert chain_v2.reference_calls - calls == 1
    np.testing.assert_array_equal(f[0, :OVER].numpy(), f_w)
    np.testing.assert_array_equal(
        chain_packed.unpack_prel(prel[0].numpy(), OVER), p_w)


def test_seed_round_keeps_reads_over_the_bound_on_the_device(
        monkeypatch, tmp_path, profile):
    """`--seed-backend gpu` with the bound lowered under every read's span
    sum: each read stays in the device seeding round, its row keyed in
    int64 by the plain K1 and counted; the PAF is unchanged, since no
    score wraps at this size."""
    from test_torch_nojax import REPO
    import importlib.util
    from mm2tpu_torch.cli import main
    spec = importlib.util.spec_from_file_location(
        "make_workload", REPO / "scripts" / "make_workload.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ref, reads = mod.make(str(tmp_path), genome_mb=0.2, n_reads=6,
                          mean_len=2000, seed=9)
    base = tmp_path / "base.paf"
    assert main(["-x", "map-ont", "--map-mode", "batch", "--device", "cpu",
                 "-o", str(base), ref, reads]) == 0
    monkeypatch.setattr(chain_v3, "KEY_SCORE_MAX", 100)
    monkeypatch.setattr(chain_packed, "KEY_SCORE_MAX", 100)
    out = tmp_path / "dev.paf"
    assert main(["-x", "map-ont", "--map-mode", "batch", "--seed-backend",
                 "gpu", "--device", "cpu", "--profile", "-o", str(out), ref,
                 reads]) == 0
    c = dict(profiling.counters)
    assert out.read_text() == base.read_text()
    assert "seed.host_frags" not in c and c["chain.wide_key"] == 6, c
    assert c["chain.launches"] >= 1, c
