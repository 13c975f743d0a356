"""The port's data-parallel mesh (mm2tpu_torch.parallel.mesh) and its 8 B
delta wire (mm2tpu_torch.ops.chain_packed) against the JAX package.

The JAX side runs on conftest's 8-device virtual CPU mesh, its Pallas
kernels in interpret mode; the port's mesh is D `cpu` shards, whose
kernels run their plain PyTorch versions. The same NumPy-seeded inputs
go to both. Everything is integer (chaining DP, index probe, extd2
registers), so the outputs must be array-equal and the PAF
byte-identical: tolerance 0."""
import numpy as np
import jax
import pytest
import torch

import mm2tpu.ops.chain_packed as JP
import mm2tpu.parallel.mesh as JM
from mm2tpu.parallel.batching import pack_tasks
from mm2tpu_torch.ops import chain_packed as TP
from mm2tpu_torch.ops import seed_device as sd
from mm2tpu_torch.parallel import mesh as TM
from test_chain_pallas import synth_anchors
from test_torch_chain_v2 import two_segment

N = 1024
KW = dict(max_dist_x=5000, max_dist_y=5000, bw=500, iter_cap=1024,
          gap_scale=1.0)
# (is_cdna, n_segs) of single-segment reads, read pairs, spliced reads
CONTRACTS = {"uniseg": (False, 1), "two-seg": (False, 2), "cdna": (True, 1)}


def jax_mesh(D):
    return JM.make_mesh(D, devices=jax.devices("cpu"))


def cpu_mesh(D):
    return TM.make_mesh(D, devices=["cpu"] * D)


def batch(contract, seed=0):
    """8 rows as a bucket carries them: 6 tasks of uneven n (multi-rid
    reverse-strand, dense, tie-heavy with span 19, sparse), then 2 empty
    rows; two-segment tasks for read pairs."""
    kinds = [dict(n_rids=3, rev_frac=0.4), dict(scale=2),
             dict(scale=1, span=19), dict(scale=400, n_rids=2, rev_frac=1.0)]
    rng = np.random.default_rng(seed)
    rows = []
    for b in range(6):
        a = synth_anchors(int(rng.integers(N // 4, N + 1)), seed=seed + b,
                          **kinds[b % 4])
        rows.append(two_segment(a, seed + b) if contract == "two-seg"
                    else a)
    return rows + [np.zeros((0, 2), np.uint64)] * 2


def test_pack_tasks8_copy_matches_original():
    rows = batch("two-seg", seed=3)
    for a, b in zip(TP.pack_tasks8(rows, N), JP.pack_tasks8(rows, N)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert TP.E_LADDER == JP.E_LADDER
    # a row that needs more than the top tier of exceptions: no 8 B wire
    pos = np.arange(TP.E_LADDER[-1] + 64, dtype=np.uint64) * \
        np.uint64(1 << 20)
    a = np.stack([pos, np.full(len(pos), (15 << 32) | 7, np.uint64)], 1)
    assert TP.pack_tasks8([a], 4096) is None


@pytest.mark.parametrize("contract", ["uniseg", "two-seg"])
def test_decode8_matches_jax_and_the_16b_planes(contract):
    import jax.numpy as jnp
    rows = batch(contract, seed=5)
    p8 = TP.pack_tasks8(rows, N)
    got = TP.decode8(*TP.planes_to_torch(*p8[:6], "cpu"))
    want = JP._decode8(*[jnp.asarray(x) for x in p8[:6]])
    hi, lo, yhi, ylo, _, _ = TP.pack_tasks16(rows, N)
    qi, span, sid = TP.derive_qss(yhi, ylo)
    live = np.arange(N) < p8[6]   # pack_tasks16 leaves qi/span/sid 0 past n
    for g, w, plane in zip(got, want, (hi, lo, qi, span, sid)):
        assert g.dtype == torch.int32 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(np.where(live, g.numpy(), 0),
                                      np.where(live, plane, 0))
    np.testing.assert_array_equal(got[0].numpy(), hi)   # the pad's hi too
    np.testing.assert_array_equal(got[1].numpy(), lo)


@pytest.mark.parametrize("contract", list(CONTRACTS))
def test_chain_scores_packed8_matches_jax(contract):
    is_cdna, n_segs = CONTRACTS[contract]
    rows = batch(contract, seed=11)
    p8 = TP.pack_tasks8(rows, N)
    f_j, pr_j = JP.chain_scores_packed8(
        *p8, is_cdna=is_cdna, n_segs=n_segs, interpret=True,
        lanes=JP.pick_lanes(8, not is_cdna and n_segs == 1), **KW)
    f, pr = TP.chain_scores_packed8(*TP.planes_to_torch(*p8, "cpu"),
                                    is_cdna=is_cdna, n_segs=n_segs, **KW)
    assert f.dtype == torch.int32 and pr.dtype == torch.int16
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_j))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(pr_j))
    # and equal to the 16 B wire's
    f16, pr16 = TP.chain_scores_packed(
        *TP.planes_to_torch(*TP.pack_tasks16(rows, N), "cpu"),
        is_cdna=is_cdna, n_segs=n_segs, **KW)
    assert torch.equal(f, f16) and torch.equal(pr, pr16)


@pytest.mark.parametrize("D,contract,wire8", [
    (2, "uniseg", False),      # B/D = 4
    (8, "uniseg", True),
    (4, "two-seg", False),
    (2, "two-seg", True),
    (8, "cdna", False),
    (4, "cdna", True),
])
def test_sharded_chain_step_matches_jax(D, contract, wire8):
    is_cdna, n_segs = CONTRACTS[contract]
    rows = batch(contract, seed=20 + D)
    kw = dict(KW, is_cdna=is_cdna, n_segs=n_segs)
    if wire8:
        planes = TP.pack_tasks8(rows, N)
        want = JM.sharded_chain_step8(jax_mesh(D), interpret=True,
                                      **kw)(*planes)
        got = TM.sharded_chain_step8(cpu_mesh(D), **kw)(*planes).result()
    else:
        pb = pack_tasks(rows, list(range(len(rows))), N)
        planes = (pb.hi, pb.lo, pb.qi, pb.span, pb.sid, pb.n, pb.avg)
        want = JM.sharded_chain_step(jax_mesh(D), interpret=True,
                                     **kw)(*planes)
        got = TM.sharded_chain_step(cpu_mesh(D), **kw)(*planes).result()
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def small_index():
    from mm2tpu_torch.index.build import build_index
    rng = np.random.default_rng(11)
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 50000)])
    return build_index(["c0"], [genome], w=10, k=15)


@pytest.mark.parametrize("D", [2, 8])
def test_sharded_probe_step_matches_jax(small_index, D):
    """Queries: real keys, misses, and pads (the port's PAD_Q; a miss on
    the JAX side, which has no pad value): (start, cnt) equal JAX's and
    the replicated K5 probe's."""
    mi = small_index
    rng = np.random.default_rng(12 + D)
    B, M = 16, 64
    q = mi.keys[rng.integers(0, len(mi.keys), (B, M))].copy()
    miss = rng.random((B, M)) < 0.4
    q[miss] = rng.integers(2**33, 2**34, int(miss.sum()), dtype=np.uint64)
    pad = rng.random((B, M)) < 0.1
    q_t = TM.split_keys(q)
    q_t[pad] = sd.PAD_Q
    q_j = q.copy()
    q_j[pad] = np.uint64(2**35)
    khi, klo, jst, jcnt, jranges = JM.shard_index_arrays(
        mi.keys, mi.start, mi.cnt, D)
    s_j, c_j = JM.sharded_probe_step(jax_mesh(D))(
        khi, klo, jst, jcnt, *JM.split_keys(q_j))
    keys, st, cnt, ranges = TM.shard_index_arrays(mi.keys, mi.start, mi.cnt,
                                                  D)
    assert ranges == jranges and len(keys) == len(khi)
    assert (keys[len(mi.keys):] == TM.PAD_KEY).all()
    mesh = cpu_mesh(D)
    s, c = TM.sharded_probe_step(mesh)(TM.shard_index(mesh, keys, st, cnt),
                                       q_t).result()
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    assert (c.numpy()[pad] == 0).all() and (c.numpy()[~pad & ~miss] > 0).all()
    index = sd.prepare_index_device(mi, "cpu")
    s_r, c_r = sd.probe_index(index, torch.from_numpy(q_t))
    assert torch.equal(s, s_r) and torch.equal(c, c_r)


def test_sharded_map_step_matches_jax():
    """K5 hits, K1's f and p and K3's 14 ez registers of every fill, over
    4 shards (JAX's extd2 given every DP row: Rmax = qlen + tlen - 1)."""
    from mm2tpu_torch.parallel.dryrun import _example_batch
    D, B, RMAX, TPAD = 4, 8, 64, 128
    planes = _example_batch(B, N, seed=1)
    erng = np.random.default_rng(4)
    lens = np.stack([np.full(B, RMAX, np.int32),
                     np.full(B, TPAD - 32, np.int32)], axis=1)
    t8 = erng.integers(0, 4, (B, TPAD - 32))
    tsf = np.zeros((B, TPAD), np.int32)
    tsf[:, :TPAD - 32] = t8
    qcol = t8[:, :RMAX].copy()
    qcol[:, ::7] = (qcol[:, ::7] + 1) % 4      # a mismatch in seven
    qcol = qcol.astype(np.int32)
    keys = np.unique(np.random.default_rng(2).integers(
        0, 2**40, 4096).astype(np.uint64))
    kstart = np.arange(len(keys), dtype=np.int32)
    kcnt = np.ones(len(keys), dtype=np.int32)
    q = keys[np.random.default_rng(3).integers(0, len(keys), (B, 64))]
    ext = dict(q=4, e=2, q2=24, e2=1, zdrop=400, sc_mch=2, sc_mis=-4,
               sc_N=-1, w=32, right=False, approx=True, approx_drop=True)
    kw = dict(KW, is_cdna=False, n_segs=1)
    want = JM.sharded_map_step(
        jax_mesh(D), interpret=True, ext_params=dict(ext, Rmax=160), **kw)(
        *JM.split_keys(keys), kstart, kcnt, *JM.split_keys(q), *planes,
        lens, tsf, qcol)
    mesh = cpu_mesh(D)
    got = TM.sharded_map_step(
        mesh, ext_params=dict(ext, extz_only=False, end_bonus=0), **kw)(
        TM.replicate_index(mesh, TM.split_keys(keys), kstart, kcnt),
        TM.split_keys(q), *planes, lens, tsf.astype(np.uint8),
        qcol.astype(np.uint8)).result()
    for k in range(4):     # hit start, hit cnt, f, p
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert (got[1].numpy() == 1).all()
    np.testing.assert_array_equal(got[4].numpy()[:, :14],
                                  np.asarray(want[5])[:, :14])


def paf_lines(write_paf, mi, mo, names, frags, res):
    lines = []
    for name, fr, frag in zip(names, res, frags):
        if not fr.regs[0]:
            lines.append(write_paf(mi, name, len(frag[0]), None, mo.flag,
                                   fr.rep_len))
        for r in fr.regs[0]:
            lines.append(write_paf(mi, name, len(frag[0]), r, mo.flag,
                                   fr.rep_len, qseq=frag[0]))
    return "\n".join(lines)


def test_map_frags_batched_over_8_shards_matches_jax_mesh():
    """The batch pipeline over 8 CPU shards: its PAF byte-identical to the
    port's single-device run and to the JAX package's
    `map_frags_batched(mesh=make_mesh(8, cpus))` (the multichip dry run's
    genome and 10 uneven reads)."""
    from mm2tpu.cli import mapopt_update as j_update
    from mm2tpu.index.build import build_index as j_build
    from mm2tpu.io.format import write_paf as j_paf
    from mm2tpu.mapping.pipeline import map_frags_batched as j_map
    from mm2tpu.options import set_opt as j_set_opt
    from mm2tpu_torch.index.build import build_index
    from mm2tpu_torch.io.format import write_paf
    from mm2tpu_torch.mapping.pipeline import map_frags_batched
    from mm2tpu_torch.options import mapopt_update, set_opt
    from mm2tpu_torch.utils import profiling
    grng = np.random.default_rng(7)
    genome = "".join(np.array(list("ACGT"))[grng.integers(0, 4, 60000)])
    frags, names = [], []
    for i in range(10):
        L = int(grng.integers(300, 3000))
        st = int(grng.integers(0, len(genome) - L))
        s = list(genome[st:st + L])
        for _ in range(L // 20):
            s[int(grng.integers(0, L))] = "ACGT"[grng.integers(0, 4)]
        frags.append(["".join(s)])
        names.append("r%d" % i)
    mi = build_index(["c0"], [genome], w=10, k=15)
    _, mo = set_opt("map-ont")
    mapopt_update(mo, mi)
    mesh = cpu_mesh(8)
    profiling.enable()
    try:
        res_mesh = map_frags_batched(mi, frags, mo, names, "cpu", mesh=mesh)
        c = dict(profiling.counters)
    finally:
        profiling.disable()
    assert c["mesh.shards"] == 8 * c["chain.launches"] and \
        c["mesh.wire8"] == c["chain.launches"], c
    res_one = map_frags_batched(mi, frags, mo, names, "cpu")
    jmi = j_build(["c0"], [genome], w=10, k=15)
    _, jmo = j_set_opt("map-ont")
    j_update(jmo, jmi)
    res_jax = j_map(jmi, frags, jmo, names, mesh=jax_mesh(8))
    got = paf_lines(write_paf, mi, mo, names, frags, res_mesh)
    assert got == paf_lines(write_paf, mi, mo, names, frags, res_one)
    assert got == paf_lines(j_paf, jmi, jmo, names, frags, res_jax)
    assert sum(1 for fr in res_mesh if fr.regs[0]) >= 8


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    from test_torch_nojax import REPO
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_workload", REPO / "scripts" / "make_workload.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make(str(tmp_path_factory.mktemp("wl")), genome_mb=0.2,
                    n_reads=8, mean_len=2000, seed=13)


def test_cli_mesh_matches_jax_mesh(workload, tmp_path):
    """`--device cpu --mesh 2` through the port's CLI against its run
    without a mesh and the JAX package's `--mesh 2`."""
    from mm2tpu.cli import main as j_main
    from mm2tpu_torch.cli import main
    ref, reads = workload
    out = {k: tmp_path / k for k in ("mesh", "one", "jax")}
    assert main(["-x", "map-ont", "--map-mode", "batch", "--device", "cpu",
                 "--mesh", "2", "-o", str(out["mesh"]), ref, reads]) == 0
    assert main(["-x", "map-ont", "--map-mode", "batch", "--device", "cpu",
                 "-o", str(out["one"]), ref, reads]) == 0
    assert j_main(["-x", "map-ont", "--mesh", "2", "-o", str(out["jax"]),
                   ref, reads]) == 0
    got = out["mesh"].read_text()
    assert len(got.splitlines()) >= 8
    assert got == out["one"].read_text() == out["jax"].read_text()


def test_dryrun_multichip_on_cpu_shards():
    from mm2tpu_torch.parallel.dryrun import dryrun_multichip
    line = dryrun_multichip(8, "cpu")
    assert line.startswith("dryrun_multichip OK: mesh of 8 shards")


def test_collectives_and_mesh_checks():
    mesh = cpu_mesh(4)
    rng = np.random.default_rng(1)
    parts = [torch.from_numpy(rng.integers(0, 100, (8, 3)).astype(np.int32))
             for _ in range(4)]
    for g in TM.all_gather(mesh, [p[:2] for p in parts]):
        assert torch.equal(g, torch.cat([p[:2] for p in parts]))
    total = sum(parts)
    for s, g in enumerate(TM.psum_scatter(mesh, parts)):
        assert torch.equal(g, total[2 * s:2 * s + 2])
    outs = TM.gather(mesh, [(p[:2], p[2:4, :1]) for p in parts]).result()
    assert torch.equal(outs[0], torch.cat([p[:2] for p in parts]))
    assert torch.equal(outs[1], torch.cat([p[2:4, :1] for p in parts]))
    with pytest.raises(ValueError, match="needs 3 devices; 2 given"):
        TM.make_mesh(3, devices=["cpu", "cpu"])
    pb = pack_tasks([np.zeros((0, 2), np.uint64)] * 6, list(range(6)), N)
    with pytest.raises(ValueError, match="equal shards"):
        TM.sharded_chain_step(mesh, is_cdna=False, n_segs=1, **KW)(
            pb.hi, pb.lo, pb.qi, pb.span, pb.sid, pb.n, pb.avg)
    assert len(TM.make_mesh(devices=["cpu"] * 3)) == 3
