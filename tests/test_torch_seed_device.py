"""The port's device seeding (mm2tpu_torch/ops/seed_device.py: the index
probe K5 and the anchor build K6, with the sort and K1) against the JAX
package's (mm2tpu/parallel/mesh.py::lookup_index_device and
mm2tpu/ops/seed_device.py::seed_chain_device, whose K1 runs in interpret
mode), and the CUDA source of both kernels (csrc/seed.cu) built with g++
against the CPU stand-in of CUDA in tests/test_torch_ksw2_shim.py against
the plain versions.

The same seeded genome goes into both packages' own indexes, and the same
reads' minimizers (the port's sketch) into both probes and both builds.
Integer outputs and the f32 avg: exact equality."""
import functools
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mm2tpu.index.build as jax_build
import mm2tpu.options as jax_options
import mm2tpu_torch.index.build as port_build
import mm2tpu_torch.options as port_options
from mm2tpu.mapping.pipeline import _seed_device_eligible as jax_eligible
from mm2tpu.ops import seed_device as jsd
from mm2tpu.parallel.mesh import lookup_index_device, split_keys
from mm2tpu_torch.mapping.pipeline import _seed_device_eligible, _seed_meta
from mm2tpu_torch.mapping.seed import collect_minimizers, collect_seed_hits
from mm2tpu_torch.ops import seed_device as sd
from mm2tpu_torch.ops.chain_packed import unpack_prel
from mm2tpu_torch.ops.chain_ref import avg_qspan_scaled
from test_torch_ksw2_shim import build_on_cpu, one_torch_thread

SRC = Path(sd.__file__).resolve().parent.parent / "csrc" / "seed.cu"
BASES = np.array(list("ACGT"))
MID_OCC = 4          # the repeat below has 6 copies: its minimizers go over
REPEAT_COPIES = 6
# map-ont's chaining settings for reads of a few kb (chain_gaps)
CHAIN = dict(max_dist_x=5000, max_dist_y=5000, bw=500, iter_cap=5000,
             gap_scale=1.0)
GARBAGE = 0x5A5A5A5A


def revcomp(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


@functools.cache
def genome():
    """80 kb of seeded random bases with a 400 bp element copied
    REPEAT_COPIES times."""
    rng = np.random.default_rng(21)
    g = list("".join(BASES[rng.integers(0, 4, 80000)]))
    rep = list("".join(BASES[rng.integers(0, 4, 400)]))
    for k in range(REPEAT_COPIES):
        st = 3000 + 12500 * k
        g[st:st + len(rep)] = rep
    return "".join(g)


@functools.cache
def indexes():
    """The port's index and the JAX package's, of the same genome."""
    return (port_build.build_index(["c0"], [genome()], w=10, k=15),
            jax_build.build_index(["c0"], [genome()], w=10, k=15))


@functools.cache
def map_ont():
    _, mo = port_options.set_opt("map-ont")
    mo.mid_occ = MID_OCC
    return mo


def minimizers(seq):
    mi, _ = indexes()
    return collect_minimizers(mi, map_ont(), [seq], [len(seq)])


def mutate(rng, s, rate=0.03):
    s = np.array(list(s))
    hit = rng.random(len(s)) < rate
    s[hit] = BASES[rng.integers(0, 4, int(hit.sum()))]
    return "".join(s)


def host_total(mv):
    """Anchors that host seeding gives a read at MID_OCC."""
    mi, _ = indexes()
    _, c = mi.get_many(mv[:, 0] >> np.uint64(8))
    return int(c[c < MID_OCC].sum())


def real_reads(B, M, N, seed):
    """B rows of a (B, M, N) bucket as the round fills it: reads of the
    genome with 3% substitutions on either strand, each with at most M
    minimizers and N anchors (more than M / 4 minimizers where the bucket
    is M = 2048), and among them a read whose second half repeats its first
    (ties in x), a read across a repeat copy (minimizers over MID_OCC), a
    read of bases not in the genome (no anchor) and, for B = 8, two empty
    rows."""
    rng = np.random.default_rng(seed)
    g = genome()
    lo_m = M // 4 if M > 512 else 1
    L_max = min(M, N) * 5
    rows = []
    half = g[20000:20000 + L_max // 4]
    rows.append(half + half)                                   # ties in x
    rows.append(mutate(rng, g[2800:2800 + min(L_max, 1600)]))  # repeat
    rows.append("".join(BASES[rng.integers(0, 4, 600)]))       # no anchor
    n_real = B - 2 if B == 8 else B
    while len(rows) < n_real:
        L = int(rng.integers(L_max // 3, L_max))
        st = int(rng.integers(0, len(g) - L))
        s = mutate(rng, g[st:st + L])
        rows.append(revcomp(s) if rng.random() < 0.5 else s)
    out = []
    for s in rows:
        mv = minimizers(s)
        while len(mv) > M or host_total(mv) > N:
            s = s[:len(s) * 3 // 4]
            mv = minimizers(s)
        out.append((s, mv))
    assert any(len(mv) > lo_m for _, mv in out[3:])
    return out + [None] * (B - len(out))


def seed_meta(mv):
    """What the round computes on the host from a read's counts: rep_len,
    mini_pos, the anchor total and avg."""
    mi, _ = indexes()
    _, c = mi.get_many(mv[:, 0] >> np.uint64(8))
    return _seed_meta(sd.split_query_minimizers(mv), c, MID_OCC)


def port_planes(rows, M):
    B = len(rows)
    q = np.full((B, M), sd.PAD_Q, np.int64)
    qpos = np.zeros((B, M), np.int32)
    qyhi = np.zeros((B, M), np.int32)
    qlen = np.ones(B, np.int32)
    avg = np.zeros((B, 1), np.float32)
    for r, row in enumerate(rows):
        if row is None:
            continue
        s, mv = row
        h, p, span, tand = sd.split_query_minimizers(mv)
        q[r, :len(h)] = h
        qpos[r, :len(h)] = p
        qyhi[r, :len(h)] = span | (tand << 10)
        qlen[r] = len(s)
        avg[r, 0] = seed_meta(mv)[3]
    return [torch.from_numpy(a) for a in (q, qpos, qyhi, qlen, avg)]


def jax_run(rows, M, N):
    _, jmi = indexes()
    d = jsd.prepare_index_device(jmi)
    B = len(rows)
    qhi = np.full((B, M), 0x7FFFFFFF, np.int32)
    qlo = np.zeros((B, M), np.int32)
    qpos = np.zeros((B, M), np.int32)
    qspan = np.zeros((B, M), np.int32)
    qtand = np.zeros((B, M), np.int32)
    qlen = np.ones(B, np.int32)
    avg = np.zeros((B, 1), np.float32)
    for r, row in enumerate(rows):
        if row is None:
            continue
        s, mv = row
        h, lo, p, span, tand = jsd.split_query_minimizers(mv)
        m = len(h)
        qhi[r, :m], qlo[r, :m], qpos[r, :m] = h, lo, p
        qspan[r, :m], qtand[r, :m] = span, tand
        qlen[r] = len(s)
        avg[r, 0] = seed_meta(mv)[3]
    out = jsd.seed_chain_device(
        d["khi"], d["klo"], d["start"], d["cnt"], d["poshi"], d["poslo"],
        qhi, qlo, qpos, qspan, qtand, qlen, avg, N=N, mid_occ=MID_OCC,
        interpret=True, **CHAIN)
    return [np.asarray(o) for o in out]


def test_probe_matches_lookup_index_device():
    """The plain K5 (through its wrapper, on CPU tensors) gives the JAX
    package's (start, cnt) for hits, misses, the first and last keys and
    values past them; a pad gives (0, 0)."""
    mi, jmi = indexes()
    rng = np.random.default_rng(5)
    keys = mi.keys
    q = np.concatenate([keys[rng.integers(0, len(keys), 3000)],
                        rng.integers(0, 1 << 56, 1000).astype(np.uint64),
                        keys[[0, -1]], keys[[0, -1]] + np.uint64(1),
                        np.array([0, (1 << 56) - 1], np.uint64)])
    khi, klo = split_keys(jmi.keys)
    qhi, qlo = split_keys(q)
    js, jc = lookup_index_device(khi, klo, jmi.start.astype(np.int32),
                                 jmi.cnt.astype(np.int32), qhi, qlo)
    idx = sd.prepare_index_device(mi, "cpu")
    calls = dict(sd.reference_calls)
    qt = torch.from_numpy(np.append(q.astype(np.int64), sd.PAD_Q))
    s, c = sd.probe_counts(idx["keys"], idx["start"], idx["cnt"], qt)
    assert sd.reference_calls["probe"] == calls["probe"] + 1
    assert s.dtype == c.dtype == torch.int32
    np.testing.assert_array_equal(s[:-1].numpy(), np.asarray(js))
    np.testing.assert_array_equal(c[:-1].numpy(), np.asarray(jc))
    assert (int(s[-1]), int(c[-1])) == (0, 0)
    assert (c[:3000] > 0).all() and (c[3000:4000] == 0).all()


@pytest.mark.parametrize("B,M,N", [(8, 512, 1024), (8, 2048, 2048),
                                   (32, 512, 2048), (32, 2048, 1024)])
def test_seed_chain_matches_seed_chain_device(B, M, N):
    """Probe, build, sort and K1 through the plain versions == the JAX
    package's seed_chain_device (interpret mode) on a bucket of real
    reads: anchors, n, f and the relative p over each row's [:n]; the
    anchors are also the host seeding's (its stable radix sort by x), and
    rep_len, mini_pos and avg (bit for bit) from the counts are what host
    seeding and the host path's packing derive."""
    mi, _ = indexes()
    rows = real_reads(B, M, N, seed=B * 1000 + M + N)
    idx = sd.prepare_index_device(mi, "cpu")
    with one_torch_thread():
        hi, lo, yhi, ylo, f, prel, n = (t.numpy() for t in sd.seed_chain(
            idx, *port_planes(rows, M), N=N, mid_occ=MID_OCC, **CHAIN))
    xhi_j, xlo_j, yhi_j, ylo_j, f_j, prel_j, n_j = jax_run(rows, M, N)
    assert n.shape == (B, 1) and yhi.dtype == np.int16
    np.testing.assert_array_equal(n[:, 0], n_j)
    seen = set()
    for r, row in enumerate(rows):
        k = int(n[r, 0])
        a = sd.anchors_from_device(hi[r], lo[r], yhi[r], ylo[r], k)
        a_j = jsd.anchors_from_device(xhi_j[r], xlo_j[r], yhi_j[r],
                                      ylo_j[r], k)
        np.testing.assert_array_equal(a, a_j)
        np.testing.assert_array_equal(f[r, :k], f_j[r, :k])
        np.testing.assert_array_equal(prel[r, :k], prel_j[r, :k])
        if row is None:
            assert k == 0
            seen.add("empty")
            continue
        s, mv = row
        rep_len, mini_pos, total, avg = seed_meta(mv)
        host = collect_seed_hits(mi, map_ont(), MID_OCC, mv, None, len(s))
        assert k == total and rep_len == host.rep_len
        np.testing.assert_array_equal(mini_pos, host.mini_pos)
        np.testing.assert_array_equal(a, host.anchors)
        if k:
            assert avg.tobytes() == avg_qspan_scaled(host.anchors).tobytes()
        if k and (np.diff(a[:, 0].astype(np.float64)) == 0).any():
            seen.add("ties")
        if host.rep_len > 0:
            seen.add("over mid_occ")
        if k == 0:
            seen.add("no anchor")
        # past n: pack_tasks16's pad, so K1 sees the host path's planes
        assert (hi[r, k:] == sd.PAD_HI).all() and (lo[r, k:] == 0).all()
        if k:
            p = unpack_prel(prel[r], k)
            assert (p < np.arange(k)).all()
    want = {"ties", "over mid_occ", "no anchor"} | (
        {"empty"} if B == 8 else set())
    assert want <= seen, seen


def test_anchor_reassembly_round_trips():
    """Anchors with both strands, the TANDEM bit, large rids and positions
    go through the build's key/y words, `sort_anchors` and
    `anchors_from_device` unchanged, in x order (the counterpart of
    tests/test_seed_device.py::test_device_seed_units)."""
    rng = np.random.default_rng(0)
    n, N = 257, 1024
    rid = rng.integers(0, 1000, n).astype(np.uint64)
    rev = rng.integers(0, 2, n).astype(np.uint64)
    rpos = rng.integers(0, 1 << 30, n).astype(np.uint64)
    span = rng.integers(10, 200, n).astype(np.uint64)
    tand = rng.integers(0, 2, n).astype(np.uint64)
    ypos = rng.integers(0, 1 << 30, n).astype(np.uint64)
    x = (rev << np.uint64(63)) | (rid << np.uint64(32)) | rpos
    y = (tand << np.uint64(42)) | (span << np.uint64(32)) | ypos
    x[5] = x[9]             # a tie: slot order decides
    key = np.full((1, N), sd.PAD_KEY, np.int64)
    yy = np.zeros((1, N), np.int64)
    key[0, :n] = (x ^ np.uint64(1 << 63)).view(np.int64)
    yy[0, :n] = y.view(np.int64)
    hi, lo, qi, sp, yhi, nn = sd.sort_anchors(
        torch.from_numpy(key), torch.from_numpy(yy),
        torch.tensor([n], dtype=torch.int32))
    a = sd.anchors_from_device(hi[0].numpy(), lo[0].numpy(),
                               yhi[0].numpy(), qi[0].numpy(), n)
    order = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(a[:, 0], x[order])
    np.testing.assert_array_equal(a[:, 1], y[order])
    np.testing.assert_array_equal(sp[0, :n].numpy(), span[order])
    assert int(nn[0, 0]) == n and (sp[0, n:] == 0).all()
    assert (hi[0, n:] == sd.PAD_HI).all() and (qi[0, n:] == 0).all()


def synthetic_index(seed):
    """A small CSR index: 300 sorted keys, 1-12 hits each, positions on 3
    rids and both strands."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(1 << 40, 300, replace=False)).astype(np.int64)
    cnt = rng.integers(1, 13, len(keys)).astype(np.int32)
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int32)
    npos = int(cnt.sum())
    pos = (rng.integers(0, 3, npos).astype(np.int64) << 32) | \
        (rng.integers(0, 1 << 20, npos).astype(np.int64) << 1) | \
        rng.integers(0, 2, npos).astype(np.int64)
    return keys, start, cnt, pos


def synthetic_bucket(keys, cnt, B, M, seed, mid_occ):
    """Queries of B ragged rows (lengths cycle through M, 7 M / 11, 0: the
    last an empty row), 60% of them hits, with the first two rows holding
    keys whose count is mid_occ - 1 and mid_occ; the rows' qpos, qyhi
    and qlen."""
    rng = np.random.default_rng(seed)
    q = np.full((B, M), sd.PAD_Q, np.int64)
    for b in range(B):
        L = (M, 7 * M // 11, 0)[b % 3]
        q[b, :L] = np.where(rng.random(L) < 0.6,
                            keys[rng.integers(0, len(keys), L)],
                            rng.integers(0, 1 << 40, L))
    for b, c in ((0, mid_occ - 1), (1, mid_occ)):
        at = np.nonzero(cnt == c)[0]
        q[b, 3:3 + len(at[:4])] = keys[at[:4]]
    qpos = ((rng.integers(0, 5000, (B, M)) << 1) |
            rng.integers(0, 2, (B, M))).astype(np.int32)
    qyhi = (rng.integers(10, 20, (B, M)) |
            (rng.integers(0, 2, (B, M)) << 10)).astype(np.int32)
    qlen = np.full(B, 6000, np.int32)
    return q, qpos, qyhi, qlen


# (B, M, N, threads a K6 block): several tiles of the scan a row, one warp
# a block, the kernel's own 512, and a row whose total passes N
SHIM_CASES = {"t64": (5, 300, 1024, 64), "t32": (3, 70, 1024, 32),
              "t512": (2, 700, 2048, None), "over_n": (2, 300, 256, 64)}


def shim_lib(threads, out_dir, mutant=None):
    src = SRC.read_text()
    if mutant:
        old, new = mutant
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    defines = () if threads is None else ("SEED_THREADS=%d" % threads,)
    return build_on_cpu(src, Path(out_dir), defines, stamped=False)


def run_shim(lib, B, M, N, seed, mid_occ=9):
    """K5 then K6 of the stand-in build on a synthetic bucket, with the
    plain versions on the same inputs; outputs start as garbage."""
    keys, start, cnt, pos = synthetic_index(seed)
    q, qpos, qyhi, qlen = synthetic_bucket(keys, cnt, B, M, seed, mid_occ)
    s = np.full((B, M), GARBAGE, np.int32)
    c = np.full((B, M), GARBAGE, np.int32)
    assert lib.mm2tpu_seed_probe(keys.ctypes.data, start.ctypes.data,
                                 cnt.ctypes.data, len(keys), q.ctypes.data,
                                 B * M, s.ctypes.data, c.ctypes.data,
                                 None) == 0
    key = np.full((B, N), GARBAGE, np.int64)
    y = np.full((B, N), GARBAGE, np.int64)
    n = np.full(B, GARBAGE, np.int32)
    assert lib.mm2tpu_seed_build(s.ctypes.data, c.ctypes.data,
                                 qpos.ctypes.data, qyhi.ctypes.data,
                                 qlen.ctypes.data, pos.ctypes.data,
                                 key.ctypes.data, y.ctypes.data,
                                 n.ctypes.data, B, M, N, mid_occ, None) == 0
    T = torch.from_numpy
    with one_torch_thread():
        s2, c2 = sd.probe_counts_reference(T(keys), T(start), T(cnt), T(q))
        k2, y2, n2 = sd.build_anchors_reference(
            s2, c2, T(qpos), T(qyhi), T(qlen), T(pos), N=N, mid_occ=mid_occ)
    return (s, c, key, y, n), tuple(t.numpy() for t in (s2, c2, k2, y2, n2))


@pytest.mark.parametrize("case", list(SHIM_CASES))
def test_cuda_source_on_the_stand_in_equals_the_plain_versions(
        case, tmp_path_factory):
    """csrc/seed.cu's K5 and K6, built with g++ against the CUDA stand-in,
    give the plain versions' (start, cnt), keys, y words and n on ragged
    rows, an empty row, minimizers at mid_occ - 1 (kept) and at mid_occ
    (dropped), and a row whose total passes N (n unclamped, the first N
    slots built)."""
    B, M, N, threads = SHIM_CASES[case]
    lib = shim_lib(threads, str(tmp_path_factory.mktemp("seed_%s" % case)))
    got, want = run_shim(lib, B, M, N, seed=len(case) + M)
    for name, g, w in zip(("start", "cnt", "key", "y", "n"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    n = want[4]
    assert (n[2::3] == 0).all() and (n[:2] > 0).all()
    assert (n > N).any() == (case == "over_n")


def test_cuda_source_without_the_scan_barrier_fails(tmp_path_factory):
    """The same source with the barrier between the warps' sums and their
    scan removed gives other anchors on the stand-in, whose scheduler lets
    warps fall behind: the test above would see a race."""
    B, M, N, threads = SHIM_CASES["t64"]
    lib = shim_lib(threads, str(tmp_path_factory.mktemp("seed_mutant")),
                   ("if (lane == 31) warp_sum[w] = v;\n    __syncthreads();",
                    "if (lane == 31) warp_sum[w] = v;"))
    got, want = run_shim(lib, B, M, N, seed=len("t64") + M)
    assert not all(np.array_equal(g, w) for g, w in zip(got[2:], want[2:]))


def test_wrappers_run_the_plain_versions_on_the_cpu_only():
    """CPU tensors go to the plain versions (counted, no launch); tensors
    on another device are refused rather than moved."""
    keys, start, cnt, pos = (torch.from_numpy(a) for a in synthetic_index(3))
    q = keys[:8].reshape(2, 4).contiguous()
    launches = dict(sd.launches)
    calls = dict(sd.reference_calls)
    s, c = sd.probe_counts(keys, start, cnt, q)
    qpos = torch.zeros((2, 4), dtype=torch.int32)
    sd.build_anchors(s, c, qpos, qpos, torch.ones(2, dtype=torch.int32), pos,
                     N=64, mid_occ=50)
    assert sd.launches == launches
    assert sd.reference_calls == {k: v + 1 for k, v in calls.items()}
    meta = q.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sd.probe_counts(keys, start, cnt, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        sd.build_anchors(s.to("meta"), c.to("meta"), qpos, qpos, qpos, pos,
                         N=64, mid_occ=50)


@pytest.mark.parametrize("preset", ["map-ont", "map-pb", "asm20", "sr",
                                    "splice", "ava-ont"])
@pytest.mark.parametrize("n_segs,n_mv", [(1, 5), (2, 5), (1, 0)])
def test_eligibility_is_the_jax_packages(preset, n_segs, n_mv):
    """Which fragments device seeding takes: the JAX package's contract,
    for every preset, one or two segments, with or without minimizers."""
    _, mo = port_options.set_opt(preset)
    _, jmo = jax_options.set_opt(preset)
    mo.mid_occ = jmo.mid_occ = 50
    ctx = SimpleNamespace(n_segs=n_segs, is_splice=preset == "splice",
                          mv=np.zeros((n_mv, 2), np.uint64))
    got = _seed_device_eligible(mo, ctx)
    assert got == jax_eligible(jmo, ctx)
    assert got == (preset in ("map-ont", "map-pb", "asm20", "sr") and
                   n_segs == 1 and n_mv > 0)
