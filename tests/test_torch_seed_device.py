"""The port's device seeding (mm2tpu_torch/ops/seed_device.py: the index
probe K5 and the anchor pipeline K6, with K1) against the JAX package's
(mm2tpu/parallel/mesh.py::lookup_index_device and
mm2tpu/ops/seed_device.py::seed_chain_device, whose K1 runs in interpret
mode); the bucket table against the host index's native LUT; and the
CUDA source of both kernels (csrc/seed.cu) built with g++ against the
CPU stand-in of CUDA in tests/test_torch_ksw2_shim.py (blocks started in
a shuffled order) against the plain versions, with each barrier between
passes removed in turn.

The same seeded genome goes into both packages' own indexes, and the same
reads' minimizers (the port's sketch) into both probes and both builds.
Integer outputs and the f32 avg: exact equality."""
import ctypes
import faulthandler
import functools
import os
import signal
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
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
    s, c = sd.probe_index(idx, qt)
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


def synthetic_index(seed, n_keys=300, rid_max=2, rpos_bits=20,
                    tie_key=None):
    """A small CSR index: `n_keys` sorted keys, 1-12 hits each, positions
    on rids 0..rid_max and both strands, rpos below 2^rpos_bits, with the
    largest rid and rpos present (the top bits of K6's packed key). With
    `tie_key` = (k, c), key k has c hits at one position (equal x)."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(1 << 40, n_keys, replace=False)) \
        .astype(np.int64)
    cnt = rng.integers(1, 13, len(keys)).astype(np.int32)
    if tie_key is not None:
        cnt[tie_key[0]] = tie_key[1]
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int32)
    npos = int(cnt.sum())
    rid = rng.integers(0, rid_max + 1, npos).astype(np.int64)
    rpos = rng.integers(0, 1 << rpos_bits, npos).astype(np.int64)
    rid[npos // 2], rpos[npos // 3] = rid_max, (1 << rpos_bits) - 1
    pos = (rid << 32) | (rpos << 1) | rng.integers(0, 2, npos)
    if tie_key is not None:
        k = tie_key[0]
        pos[start[k]:start[k] + cnt[k]] = pos[start[k]]
    return keys, start, cnt, pos


def synthetic_bucket(keys, cnt, B, M, seed, mid_occ, tie_key=None):
    """Queries of B ragged rows (lengths cycle through M, 7 M / 11, 0: the
    last an empty row), 60% of them hits, with the first two rows holding
    keys whose count is mid_occ - 1 and mid_occ; the rows' qpos, qyhi
    and qlen. With `tie_key`, row 1 is that key M times on one strand:
    every anchor of the row has the same x."""
    rng = np.random.default_rng(seed)
    q = np.full((B, M), sd.PAD_Q, np.int64)
    for b in range(B):
        L = (M, 7 * M // 11, 0)[b % 3]
        q[b, :L] = np.where(rng.random(L) < 0.6,
                            keys[rng.integers(0, len(keys), L)],
                            rng.integers(0, 1 << 40, L))
    for b, c in ((0, mid_occ - 1), (1, mid_occ))[:B]:
        at = np.nonzero(cnt == c)[0]
        q[b, 3:3 + len(at[:4])] = keys[at[:4]]
    qpos = ((rng.integers(0, 5000, (B, M)) << 1) |
            rng.integers(0, 2, (B, M))).astype(np.int32)
    qyhi = (rng.integers(10, 20, (B, M)) |
            (rng.integers(0, 2, (B, M)) << 10)).astype(np.int32)
    if tie_key is not None:
        q[1] = keys[tie_key[0]]
        qpos[1] &= ~1
    qlen = np.full(B, 6000, np.int32)
    return q, qpos, qyhi, qlen


def skewed_keys(n, crowd, seed):
    """n sorted distinct keys, `crowd` of them in one bucket of the table
    (consecutive values just above 2^39), the rest spread below 2^40."""
    rng = np.random.default_rng(seed)
    spread = rng.choice(1 << 40, 2 * n, replace=False)
    spread = spread[(spread < 1 << 39) | (spread > (1 << 39) + 10 * crowd)]
    keys = np.concatenate([spread[:n - crowd],
                           (1 << 39) + 3 * np.arange(crowd)])
    return np.sort(keys).astype(np.int64)


def native_lut_of(keys):
    """`MMIndex._native_lut` of a key array."""
    return port_build.MMIndex._native_lut(
        SimpleNamespace(keys=keys.astype(np.uint64), _nlut=None))


@pytest.mark.parametrize("which", ["genome", "70000", "skewed", "one"])
def test_bucket_table_equals_the_native_lut(which):
    """The table that `bucket_table` builds with torch's integer ops (as
    on the card) is the host index's native LUT: its bits, shift and
    offsets; a key set of 0 keys gets an empty table of 2 buckets."""
    if which == "genome":
        mi, _ = indexes()
        keys = mi.keys.astype(np.int64)
        table = sd.prepare_index_device(mi, "cpu")["table"]
    else:
        keys = {"70000": synthetic_index(4, n_keys=70000)[0],
                "skewed": skewed_keys(70000, 2500, 6),
                "one": np.array([12345], np.int64)}[which]
        ones = torch.ones(len(keys), dtype=torch.int32)
        table = sd.bucket_table(torch.from_numpy(keys), ones, ones)
    bits, shift, lut = native_lut_of(keys)
    assert (table.bits, table.shift) == (bits, shift)
    assert table.lut.dtype == torch.int32
    np.testing.assert_array_equal(table.lut.numpy(), lut)
    if which == "skewed":
        assert int(np.diff(lut).max()) >= 2000
    empty = sd.bucket_table(torch.zeros(0, dtype=torch.int64),
                            torch.zeros(0, dtype=torch.int32),
                            torch.zeros(0, dtype=torch.int32))
    assert (empty.bits, empty.shift) == (1, 0)
    assert empty.lut.tolist() == [0, 0, 0]


# ---- csrc/seed.cu on the CUDA stand-in ----

# K6's builds: threads a block and slots a thread (a small tile makes a
# row span many blocks of the expand and many tickets of the sort); the
# stand-in starts the blocks in a seeded random order and runs RESIDENT
# of them at once, on a card of 3 multiprocessors: a grid of at most 6
# blocks, fewer than the slot ranges and tiles of most cases, and all of
# them resident (with 3, no tile's look-back met an aggregate word)
BUILDS = {"t256": (None, None), "t64": (64, 2), "t32": (32, 1)}
RESIDENT = 6
# sources with one barrier between passes removed (each must fail), on
# the t64 build: the scan of (a) (tile counts), the staging of a tile in
# (c), and in (d) the ranks before the look-back, the look-back before
# the scatter, the scatter before the next ticket, and the warp's rank
# reads before its count update; and two faults of (d)'s look-back: an
# aggregate word (a tile's own count, its prefix not yet known) taken as
# inclusive, and an unpublished word taken as an inclusive 0
MUTANTS = {
    "scan": ("  if (lane == 31) sums[w] = v;\n  __syncthreads();",
             "  if (lane == 31) sums[w] = v;"),
    "staging": ("        cum[t] = INT_MAX;\n      }\n      __syncthreads();",
                "        cum[t] = INT_MAX;\n      }"),
    "ranks": ("      __syncwarp();\n    }\n    __syncthreads();",
              "      __syncwarp();\n    }"),
    "look-back": ("      prefix[d] = before;\n    }\n    __syncthreads();",
                  "      prefix[d] = before;\n    }"),
    "next ticket": ("    __syncthreads();  // the next ticket",
                    "    // the next ticket"),
    "warp": ("      rank[k] = wcnt[w][d] + __popc(below);\n"
             "      __syncwarp();",
             "      rank[k] = wcnt[w][d] + __popc(below);"),
    "aggregate as inclusive": (
        "            inc = stop = (v[k] & FLAG_INC) != 0;",
        "            inc = stop = true;"),
    "unpublished as inclusive": (
        "            if (v[k] == 0) {\n              stop = true;",
        "            if (v[k] == 0) {\n              inc = stop = true;"),
}
BARRIERS = ["scan", "staging", "ranks", "look-back", "next ticket", "warp"]


@pytest.fixture(scope="module")
def seed_libs(tmp_path_factory):
    """Every build of csrc/seed.cu the tests use, built side by side:
    BUILDS by name and MUTANTS as "mutant:<name>"."""
    src = SRC.read_text()
    jobs = {}
    for name, (threads, items) in BUILDS.items():
        jobs[name] = (src, threads, items)
    for name, (old, new) in MUTANTS.items():
        assert src.count(old) == 1, old
        jobs["mutant:" + name] = (src.replace(old, new), *BUILDS["t64"])

    dirs = {name: tmp_path_factory.mktemp(
        "seed_" + name.replace(":", "_").replace(" ", "_")) for name in jobs}

    def build(item):
        name, (text, threads, items) = item
        defines = ["SHIM_SHUFFLE_BLOCKS",
                   "SHIM_RESIDENT_BLOCKS=%d" % RESIDENT]
        if threads:
            defines += ["SEED_THREADS=%d" % threads, "SEED_ITEMS=%d" % items]
        return name, build_on_cpu(text, dirs[name], defines, stamped=False)

    with ThreadPoolExecutor(8) as pool:
        return dict(pool.map(build, jobs.items()))


def shim_probe(lib, index, q):
    """K5 of a stand-in build on host queries; outputs start as garbage."""
    t = index["table"]
    s = np.full(q.shape, GARBAGE, np.int32)
    c = np.full(q.shape, GARBAGE, np.int32)
    assert lib.mm2tpu_seed_probe(
        t.keys.data_ptr(), t.lut.data_ptr(), t.sc.data_ptr(), t.bits,
        t.shift, q.ctypes.data, q.size, s.ctypes.data, c.ctypes.data,
        None) == 0
    return s, c


def shim_anchors(lib, index, q, qpos, qyhi, qlen, N, mid_occ):
    """K6 of a stand-in build; returns its error, the planes and n, which
    start as garbage."""
    t = index["table"]
    B, M = q.shape
    nbytes, passes = ctypes.c_longlong(), ctypes.c_int()
    assert lib.mm2tpu_seed_workspace(
        B, M, N, index["rid_bits"], index["pos_bits"], ctypes.byref(nbytes),
        ctypes.byref(passes)) == 0
    ws = np.full(nbytes.value, 0x5A, np.uint8)
    planes = np.full((4, B, N), GARBAGE, np.int32)
    yhi = np.full((B, N), 0x5A5A, np.int16)
    n = np.full((B, 1), GARBAGE, np.int32)
    err = lib.mm2tpu_seed_anchors(
        t.keys.data_ptr(), t.lut.data_ptr(), t.sc.data_ptr(), t.bits,
        t.shift, index["pos"].data_ptr(), q.ctypes.data, qpos.ctypes.data,
        qyhi.ctypes.data, qlen.ctypes.data, B, M, N, mid_occ,
        index["rid_bits"], index["pos_bits"], ws.ctypes.data,
        nbytes.value, *(planes[k].ctypes.data for k in range(4)),
        yhi.ctypes.data, n.ctypes.data, None)
    return err, (*planes, yhi, n), passes.value


def probe_queries(keys, seed):
    """Hits, values below, between and above every key, and a pad."""
    rng = np.random.default_rng(seed)
    if len(keys) == 0:
        return np.array([0, 5, 1 << 40, sd.PAD_Q], np.int64)
    pick = keys[rng.integers(0, len(keys), 2000)]
    return np.concatenate([
        pick, pick + 1, pick - 1, keys[[0, -1]], [0, keys[0] - 1,
                                                  keys[-1] + 1, 1 << 56,
                                                  (1 << 62) + 7, sd.PAD_Q],
        rng.integers(0, 1 << 41, 1000)]).astype(np.int64)


@pytest.mark.parametrize("which", ["empty", "one", "70000", "skewed"])
def test_probe_on_the_stand_in_equals_the_plain_version(which, seed_libs):
    """csrc/seed.cu's K5 through the bucket table, built with g++ against
    the CUDA stand-in, gives the plain version's (start, cnt) on key sets
    of 0, 1 and 70,000 keys and on one whose crowded bucket holds 2,500
    keys (binary steps inside the bucket), for hits, misses below,
    between and above every key, values past the table's last bucket and
    a pad."""
    keys = {"empty": np.zeros(0, np.int64),
            "one": np.array([1 << 38], np.int64),
            "70000": synthetic_index(8, n_keys=70000)[0],
            "skewed": skewed_keys(70000, 2500, 9)}[which]
    cnt = (np.arange(len(keys)) % 7 + 1).astype(np.int32)
    start = (3 * np.arange(len(keys))).astype(np.int32)
    index = sd.device_index(keys, start, cnt, "cpu")
    q = probe_queries(keys, seed=len(keys))
    if which == "skewed":
        crowd = keys[(keys >= 1 << 39) & (keys < (1 << 39) + 10 ** 5)]
        q = np.concatenate([q, crowd[::7], crowd[::7] + 1])
    got = shim_probe(seed_libs["t256"], index, q)
    with one_torch_thread():
        want = sd.probe_counts_reference(index["keys"], index["start"],
                                         index["cnt"], torch.from_numpy(q))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert (got[1] > 0).sum() == (0 if which == "empty" else
                                  np.isin(q, keys).sum())
    assert (got[0][-1], got[1][-1]) == (0, 0) or which == "skewed"


# (B, M, N, build, index and bucket options) of the K6 cases
PIPE_CASES = {
    "tiles": (5, 700, 4096, "t64", {}),
    "t256": (3, 700, 2048, "t256", {}),
    "one_warp": (3, 70, 1024, "t32", {}),
    "over_n": (2, 300, 256, "t64", {}),
    "ties": (3, 300, 2048, "t64", {"tie_key": (7, 5)}),
    "top_bits": (5, 300, 2048, "t64", {"rid_max": 1000, "rpos_bits": 31}),
    "one_pass": (1, 300, 2048, "t64", {"rid_max": 0, "rpos_bits": 6}),
}


def pipeline_inputs(case, seed, mid_occ=9):
    """The index and the bucket of a K6 case, and the plain versions'
    planes and n on them."""
    B, M, N, _, opts = PIPE_CASES[case]
    keys, start, cnt, pos = synthetic_index(seed, **opts)
    q, qpos, qyhi, qlen = synthetic_bucket(keys, cnt, B, M, seed, mid_occ,
                                           opts.get("tie_key"))
    index = sd.device_index(keys, start, cnt, "cpu", pos=pos)
    T = torch.from_numpy
    with one_torch_thread():
        want = sd.seed_anchors_reference(index, T(q), T(qpos), T(qyhi),
                                         T(qlen), N=N, mid_occ=mid_occ)
    return (index, q, qpos, qyhi, qlen, N, mid_occ), \
        tuple(t.numpy() for t in want)


def run_pipeline(lib, case, seed):
    """K6 of the stand-in build on a K6 case, and the plain versions on
    the same inputs. Returns (error, got, want, passes)."""
    args, want = pipeline_inputs(case, seed)
    err, got, passes = shim_anchors(lib, *args)
    return err, got, want, passes


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_cuda_source_on_the_stand_in_equals_the_plain_versions(
        case, seed_libs):
    """csrc/seed.cu's K6 (probe, count, offsets, expand, radix sort into
    K1's planes), built with g++ against the CUDA stand-in, gives the
    plain versions' hi, lo, qi, span, yhi and n: on ragged rows whose
    slots span many blocks and tickets, an empty row, minimizers at
    mid_occ - 1 (kept) and at mid_occ (dropped), a row whose total passes
    N (n unclamped, its first N slots sorted), a row whose anchors all
    have one x (slot order kept), rids and rpos at the packed key's top
    bits (six passes of the sort) and a key of one pass; its blocks
    resident together (a tile's look-back finds earlier tiles' words
    unpublished or aggregate), and its grid smaller than the work."""
    B, M, N, build, _ = PIPE_CASES[case]
    err, got, want, passes = run_pipeline(seed_libs[build], case,
                                          seed=len(case) + M)
    assert err == 0
    for name, g, w in zip(("hi", "lo", "qi", "span", "yhi", "n"), got,
                          want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    n = want[5][:, 0]
    assert (n[2::3] == 0).all() and (n[:2] > 0).all()
    assert (n > N).any() == (case == "over_n")
    if case == "ties":
        k = int(n[1])
        assert k > 100 and len(set(got[0][1, :k])) == 1 and \
            len(set(got[1][1, :k])) == 1 and len(set(got[2][1, :k])) > 1
    if case in ("top_bits", "one_pass"):
        assert passes == {"top_bits": 6, "one_pass": 1}[case]
    if case == "tiles":   # more slot ranges and tiles than the 6 blocks
        assert np.minimum(n, N).sum() > 4 * 6 * 64 * 2


def mutant_fails(lib, case="tiles"):
    """True when a stand-in build gives other planes than the plain
    versions on `case`, returns an error, or crashes: the build runs in a
    child process (a mutant's offsets may write out of bounds), which
    runs only the build's C code."""
    B, M, N, _, _ = PIPE_CASES[case]
    args, want = pipeline_inputs(case, seed=len(case) + M)
    with warnings.catch_warnings():   # fork() of a threaded process
        warnings.simplefilter("ignore")
        pid = os.fork()
    if pid == 0:
        code = 1
        try:
            faulthandler.disable()
            err, got, _ = shim_anchors(lib, *args)
            code = int(err == 0 and all(np.array_equal(g, w)
                                        for g, w in zip(got, want)))
        finally:
            os._exit(code)
    for _ in range(1200):     # a hang counts as a failure after 120 s
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            return not (os.WIFEXITED(status) and os.WEXITSTATUS(status) == 1)
        time.sleep(0.1)
    os.kill(pid, signal.SIGKILL)
    os.waitpid(pid, 0)
    return True


def test_cuda_source_without_the_scan_barrier_fails(seed_libs):
    """The same source with the barrier between the warps' sums and their
    scan removed gives other anchors on the stand-in, whose scheduler lets
    warps fall behind: the test above would see a race. The unchanged
    source, run the same way in a child, passes."""
    assert not mutant_fails(seed_libs["t64"])
    assert mutant_fails(seed_libs["mutant:scan"])


@pytest.mark.parametrize("mutant", [m for m in BARRIERS if m != "scan"])
def test_cuda_source_without_a_pass_barrier_fails(mutant, seed_libs):
    """Each barrier between two passes of K6 is needed: without it the
    stand-in's schedule gives other planes, an error or a crash."""
    assert mutant_fails(seed_libs["mutant:" + mutant])


@pytest.mark.parametrize("mutant", [m for m in MUTANTS
                                    if m not in BARRIERS])
def test_cuda_source_with_a_faulty_look_back_fails(mutant, seed_libs):
    """The sort's look-back must sum aggregate words back to an inclusive
    one and wait for an unpublished word: the stand-in's resident blocks
    leave earlier tiles' words in both states, so a look-back that takes
    either for an inclusive word gives other planes."""
    assert mutant_fails(seed_libs["mutant:" + mutant])


def test_wrappers_run_the_plain_versions_on_the_cpu_only():
    """CPU tensors go to the plain versions (counted, no launch); tensors
    on another device are refused rather than moved."""
    keys, start, cnt, pos = synthetic_index(3)
    index = sd.device_index(keys, start, cnt, "cpu", pos=pos)
    q = index["keys"][:8].reshape(2, 4).contiguous()
    launches = dict(sd.launches)
    calls = dict(sd.reference_calls)
    sd.probe_index(index, q)
    qpos = torch.zeros((2, 4), dtype=torch.int32)
    sd.seed_anchors(index, q, qpos, qpos, torch.ones(2, dtype=torch.int32),
                    N=64, mid_occ=50)
    assert sd.launches == launches
    assert sd.reference_calls == {k: v + 2 if k == "probe" else v + 1
                                  for k, v in calls.items()}
    meta = q.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sd.probe_index(index, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        sd.seed_anchors(index, meta, qpos, qpos, qpos, N=64, mid_occ=50)


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
