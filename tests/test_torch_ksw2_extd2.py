"""The port's extd2 extension (mm2tpu_torch.ops.ksw2_extd2) against the
JAX package.

The same NumPy-seeded (q8, t8) fills go through the Pallas extd2 kernel
with its device trace (interpret mode, as the JAX package's own tests run
it on the CPU), the NumPy oracle `ksw2_ref.ksw_extd2` and the port's
`extd2_batch` on the CPU (its plain PyTorch version). The DP is integer,
so every ExtzResult field, the CIGAR included, must be equal: tolerance
0. Sizes stay small because interpret mode compiles each shape anew."""
import numpy as np
import pytest
import torch

from mm2tpu.ops import ksw2_ref as K
from mm2tpu.ops.ksw2_pallas import extd2_batch as pallas_extd2_batch
from mm2tpu_torch.ops import ksw2_extd2 as X
from test_ksw2_pallas import FIELDS, MAT, global_tasks, mutate
from test_torch_ksw2_shim import (build_on_cpu, one_torch_thread,
                                  ring_check)

EXT = K.KSW_EZ_EXTZ_ONLY
RIGHT = K.KSW_EZ_RIGHT
APPROX = K.KSW_EZ_APPROX_MAX
DROP = K.KSW_EZ_APPROX_DROP
REV = K.KSW_EZ_REV_CIGAR


def ext_tasks(rng, n_tasks=4, lo=60, hi=200):
    """Extension shape: the query is a mutated prefix of the target."""
    tasks = []
    for _ in range(n_tasks):
        t8 = rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.uint8)
        tasks.append((mutate(t8[: len(t8) * 2 // 3], rng), t8))
    return tasks


def break_tasks(rng):
    """Divergent tails: Z-drop ends the fills early."""
    tasks = []
    for _ in range(3):
        t8 = rng.integers(0, 4, 220).astype(np.uint8)
        q8 = np.concatenate([mutate(t8[:90], rng),
                             rng.integers(0, 4, 130).astype(np.uint8)])
        tasks.append((q8, t8))
    return tasks


def mixed_tasks(rng):
    return global_tasks(rng, n_tasks=2, lo=20, hi=40) + \
        global_tasks(rng, n_tasks=2, lo=150, hi=250)


def long_tasks(rng):
    """Long banded fills: the Pallas kernel's moving band window."""
    t8 = rng.integers(0, 4, 900).astype(np.uint8)
    q8 = mutate(t8, rng, sub=0.08, ind=0.04)
    t2 = rng.integers(0, 4, 1150).astype(np.uint8)
    return [(q8, t8), (mutate(t2[:320], rng), t2)]


def narrow_tasks(rng):
    """Queries much longer than their targets (and one the other way)
    under a band of w = 1: the band stays one column wide on some rows,
    where the seed rereads H at en0-1 a row after it was written."""
    tasks = []
    for qlen, tlen in ((8, 2), (30, 12), (12, 30), (25, 25), (40, 9)):
        t8 = rng.integers(0, 4, tlen).astype(np.uint8)
        q8 = np.concatenate([t8, rng.integers(0, 4, max(qlen - tlen, 0))
                             .astype(np.uint8)])[:qlen]
        tasks.append((mutate(q8, rng, sub=0.05, ind=0.0), t8))
    return tasks


def long_ext_tasks(rng):
    t8 = rng.integers(0, 4, 1000).astype(np.uint8)
    return [(mutate(t8[:780], rng, sub=0.08, ind=0.04), t8)]


# name -> (task maker, seed, (q, e, q2, e2), w, zdrop, end_bonus, flag)
CASES = {
    "global0": (global_tasks, 0, (4, 2, 24, 1), 151, 400, -1, 0),
    "global2": (global_tasks, 2, (4, 2, 24, 1), 151, 400, -1, 0),
    "right": (global_tasks, 10, (4, 2, 24, 1), 151, 400, -1, RIGHT),
    "approx": (global_tasks, 20, (4, 2, 24, 1), 151, 200, -1, APPROX),
    "approx_drop": (global_tasks, 21, (4, 2, 24, 1), 151, 200, -1,
                    APPROX | DROP),
    "ext_only": (ext_tasks, 30, (4, 2, 24, 1), 151, 400, 10, EXT),
    "right_ext_rev": (ext_tasks, 30, (4, 2, 24, 1), 151, 400, 10,
                      EXT | RIGHT | REV),
    "zdrop_break": (break_tasks, 40, (4, 2, 24, 1), 300, 100, -1, 0),
    "zdrop_break_approx": (break_tasks, 40, (4, 2, 24, 1), 300, 100, -1,
                           APPROX | DROP),
    "full_band": (lambda rng: global_tasks(rng, n_tasks=3, lo=30, hi=70), 50,
                  (4, 2, 24, 1), -1, 400, -1, 0),
    "mixed_sizes": (mixed_tasks, 60, (4, 2, 24, 1), 151, 400, -1, 0),
    "windowed_long": (long_tasks, 70, (4, 2, 24, 1), 201, 400, -1, 0),
    "windowed_long_approx": (long_tasks, 70, (4, 2, 24, 1), 201, 200, -1,
                             APPROX | DROP),
    "windowed_right_ext_rev": (long_ext_tasks, 71, (4, 2, 24, 1), 151, 400,
                               10, EXT | RIGHT | REV),
    "n_bases": (lambda rng: global_tasks(rng, with_n=True), 1,
                (4, 2, 24, 1), 151, 400, -1, 0),
    "equal_costs": (global_tasks, 11, (4, 2, 4, 2), 151, 400, -1, 0),
    "equal_costs_ext_rev": (ext_tasks, 12, (4, 2, 4, 2), 151, 400, 10,
                            EXT | REV),
    # q2 + e2 < q + e: the kernel swaps the two gap pairs
    "swapped_gaps": (global_tasks, 13, (24, 1, 4, 2), 151, 400, -1, 0),
    "one_column_band": (narrow_tasks, 14, (4, 2, 24, 1), 1, -1, -1, 0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_and_oracle(name):
    make, seed, (q, e, q2, e2), w, zdrop, end_bonus, flag = CASES[name]
    tasks = make(np.random.default_rng(seed))
    kw = dict(q=q, e=e, q2=q2, e2=e2, w=w, zdrop=zdrop, end_bonus=end_bonus,
              flag=flag)
    calls = X.reference_calls
    port = X.extd2_batch(tasks, MAT, **kw, device="cpu")
    assert X.reference_calls == calls + 1
    pallas = pallas_extd2_batch(tasks, MAT, **kw, interpret=True,
                                device_trace=True)
    for i, (q8, t8) in enumerate(tasks):
        exp = K.ksw_extd2(len(q8), q8, len(t8), t8, MAT, q, e, q2, e2, w,
                          zdrop, end_bonus, flag)
        for f in FIELDS:
            assert getattr(port[i], f) == getattr(exp, f), (i, f, "oracle")
            assert getattr(port[i], f) == getattr(pallas[i], f), \
                (i, f, "pallas")


def test_skip_rule_and_empty_tasks():
    """Empty fills and a matrix with -min_sc > 2(q+e) do not run: their
    ExtzResult stays the default, as in ksw_extd2_sse."""
    rng = np.random.default_rng(80)
    tasks = global_tasks(rng, n_tasks=2)
    tasks.insert(1, (np.zeros(0, np.uint8), tasks[0][1]))
    res = X.extd2_batch(tasks, MAT, 4, 2, 24, 1, 151, 400, -1, 0,
                        device="cpu")
    default = K.ExtzResult()
    assert all(getattr(res[1], f) == getattr(default, f) for f in FIELDS)
    assert res[0].cigar and res[2].cigar
    harsh = K.gen_simple_mat(2, 60, 1)
    pk = X.pack_fills(tasks, harsh, 4, 2, 24, 1)
    assert pk.run_idx == [] and pk.lens.shape == (0, 2)
    res = X.extd2_batch(tasks, harsh, 4, 2, 24, 1, 151, 400, -1, 0,
                        device="cpu")
    assert all(getattr(r, f) == getattr(default, f)
               for r in res for f in FIELDS)


def test_pack_fills_layout():
    rng = np.random.default_rng(81)
    tasks = mixed_tasks(rng)
    pk = X.pack_fills(tasks, MAT, 4, 2, 24, 1)
    tl = max(len(t) for _, t in tasks)
    ql = max(len(q) for q, _ in tasks)
    assert pk.tsf.shape == (4, (tl + 15) // 16 * 16 + 16)
    assert pk.qcol.shape == (4, (ql + 15) // 16 * 16)
    assert (pk.sc_mch, pk.sc_mis, pk.sc_N) == (2, -4, -1)
    for b, (q8, t8) in enumerate(tasks):
        assert tuple(pk.lens[b]) == (len(q8), len(t8))
        np.testing.assert_array_equal(pk.tsf[b, :len(t8)], t8)
        np.testing.assert_array_equal(pk.qcol[b, :len(q8)], q8)
        assert not pk.qcol[b, len(q8):].any()


def test_wrapper_routes_cpu_and_rejects_other_devices():
    rng = np.random.default_rng(82)
    pk = X.pack_fills(global_tasks(rng, n_tasks=2), MAT, 4, 2, 24, 1)
    kw = dict(q=4, e=2, q2=24, e2=1, zdrop=400, sc_mch=pk.sc_mch,
              sc_mis=pk.sc_mis, sc_N=pk.sc_N, w=151, right=False,
              approx=False, approx_drop=False, extz_only=False, end_bonus=-1)
    planes = [torch.from_numpy(a) for a in (pk.lens, pk.tsf, pk.qcol)]
    launches, calls = X.launches, X.reference_calls
    out = X.extd2_traced(*planes, **kw)
    assert X.reference_calls == calls + 1 and X.launches == launches
    ref = X.extd2_traced_reference(*planes, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert out[0].dtype == torch.int32 and out[1].dtype == torch.uint8
    with pytest.raises(ValueError, match="unsupported device"):
        X.extd2_traced(*(p.to("meta") for p in planes), **kw)


@pytest.mark.parametrize("bad", ["lens_int64", "tsf_strided", "qcol_rows"])
def test_kernel_input_checks(bad):
    rng = np.random.default_rng(83)
    pk = X.pack_fills(global_tasks(rng, n_tasks=2), MAT, 4, 2, 24, 1)
    lens, tsf, qcol = (torch.from_numpy(a) for a in
                       (pk.lens, pk.tsf, pk.qcol))
    if bad == "lens_int64":
        lens = lens.to(torch.int64)
    elif bad == "tsf_strided":
        tsf = torch.cat([tsf, tsf], dim=1)[:, ::2]
    else:
        qcol = qcol[:1].contiguous()
    with pytest.raises(ValueError):
        X._check_inputs(lens, tsf, qcol)


def planes_for(tasks, gaps=(4, 2, 24, 1)):
    pk = X.pack_fills(tasks, MAT, *gaps)
    return pk, [torch.from_numpy(a) for a in (pk.lens, pk.tsf, pk.qcol)]


def traced_kw(pk, gaps, w, zdrop, end_bonus, flag):
    q, e, q2, e2 = gaps
    return dict(q=q, e=e, q2=q2, e2=e2, zdrop=zdrop, sc_mch=pk.sc_mch,
                sc_mis=pk.sc_mis, sc_N=pk.sc_N, w=w,
                right=bool(flag & RIGHT), approx=bool(flag & APPROX),
                approx_drop=bool(flag & DROP), extz_only=bool(flag & EXT),
                end_bonus=end_bonus)


def test_wrapper_takes_host_lens_and_checks_them():
    """The CPU route takes the packer's host lengths (no read-back of
    lens) and refuses lengths that do not match lens or do not fit the
    planes."""
    pk, planes = planes_for(global_tasks(np.random.default_rng(84)))
    kw = traced_kw(pk, (4, 2, 24, 1), 151, 400, -1, 0)
    out = X.extd2_traced(*planes, **kw, lens_h=pk.lens)
    ref = X.extd2_traced_reference(*planes, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    for bad in (pk.lens[:1], pk.lens + [0, 4096]):
        with pytest.raises(ValueError):
            X.extd2_traced(*planes, **kw, lens_h=bad)


def test_extd2_batch_counts_d2_rows_and_passes_host_lens():
    """Under --profile each extd2 flush adds its longest fill's rows to
    ext.d2_rows, its wide fills to ext.d2_wide and, when the kernel
    launched, the span of its stamps to ext.d2_kernel; extd2_batch hands
    the wrapper the host lengths (no read-back of the uploaded lens)."""
    from mm2tpu_torch.utils import profiling
    rng = np.random.default_rng(87)
    small = global_tasks(rng, n_tasks=3)
    t8 = rng.integers(0, 4, 2500).astype(np.uint8)
    wide = [(mutate(t8, rng), t8)]
    seen = []

    def fake(lens, tsf, qcol, *, lens_h, w, **kw):
        """A launch as the wrapper records it: fill b runs from b to 10 +
        2 b ns."""
        assert np.array_equal(lens_h, lens.numpy())
        seen.append((lens_h, w))
        B, smax = len(lens_h), int(lens_h.sum(1).max()) - 1
        X.launches += 1
        b = torch.arange(B, dtype=torch.int64)
        X.record_stamps(torch.stack([b, b + 5, 10 + 2 * b], 1))
        return (torch.zeros((B, X.NREG), dtype=torch.int32),
                torch.full((B, smax), 255, dtype=torch.uint8),
                torch.full((B,), -1, dtype=torch.int32),
                torch.full((B,), -1, dtype=torch.int32))

    batches = ((small, 151), (small[:1] + wide, -1), (small[1:], 500))
    profiling.enable()
    try:
        for tasks, w in batches:
            X.extd2_batch(tasks, MAT, 4, 2, 24, 1, w, 400, -1, 0,
                          device="cpu", fn=fake)
        rows = profiling.counters["ext.d2_rows"]
        n_wide = profiling.counters["ext.d2_wide"]
        kernel_s = profiling.snapshot()["ext.d2_kernel"]
    finally:
        profiling.disable()
        X.launches -= len(seen)
    assert [w for _, w in seen] == [w for _, w in batches]
    assert rows == sum(max(len(q) + len(t) - 1 for q, t in tasks)
                       for tasks, _ in batches)
    assert n_wide == 1     # the 2500-base fill at w = -1
    assert kernel_s[1] == 3
    assert abs(kernel_s[0] - sum(10 + 2 * (len(lh) - 1) for lh, _ in seen)
               / 1e9) < 1e-15


def band_spans(qlen, tlen, w):
    """(st0, en0, st, en, fe, hi) of every row of a (qlen, tlen) fill
    under band w up to the row before the band breaks, as
    csrc/ksw2_extd2.cu and the plain version compute them."""
    st, en, st0, en0 = X.band_offsets(qlen, tlen, w)
    brk = np.flatnonzero(st0 > en0)
    n = int(brk[0]) if len(brk) else len(st)
    st0, en0, st, en = st0[:n], en0[:n], st[:n], en[:n]
    fe = st0 + (en0 - st0) // 16 * 16 + 16
    return st0, en0, st, en, fe, np.maximum(en, fe - 1)


def test_ring_need_of_the_band():
    """`ring_need` is max over the live rows of (the largest hi so far -
    st + 2): 529 and 769 columns for 5000 x 5000 at w = 500 and 751
    (map-ont's gap fills and extensions), 1016 for 1000 x 1000 at w = -1
    and 3025 at w = 3001 (-x ava-ont's band). It never exceeds
    `ring_bound`, on fills whose band breaks too."""
    for (q, t, w), need in (((5000, 5000, 500), 529), ((5000, 5000, 751),
                                                       769),
                            ((1000, 1000, -1), 1016),
                            ((5000, 5000, 3001), 3025)):
        assert X.ring_need(q, t, w) == need
    rng = np.random.default_rng(89)
    cases = [(q, t, w) for q in (1, 2, 15, 16, 17, 40) for t in
             (1, 16, 17, 33, 90) for w in (-1, 0, 1, 2, 7, 16, 40)]
    cases += [(int(q), int(t), int(w)) for q, t, w in zip(
        rng.integers(1, 3000, 200), rng.integers(1, 3000, 200),
        rng.integers(-1, 1200, 200))]
    for q, t, w in cases:
        st0, en0, st, en, fe, hi = band_spans(q, t, w)
        need = X.ring_need(q, t, w)
        assert need == (np.maximum.accumulate(hi) - st + 2).max(), (q, t, w)
        assert need <= X.ring_bound([[q, t]], w)[0], (q, t, w)


# (qlen, tlen, w) fills for the ring replay: one-base sequences, narrow
# bands (one column wide on some rows), bands that break, ends at
# multiples of 16 +- 1 and bands that slide across small rings
RING_BANDS = {
    "ones": [(1, 1, 0), (1, 2, 1), (2, 1, 1), (1, 40, 3), (40, 1, 3),
             (30, 30, 0), (30, 31, 1)],
    "narrow": [(60, 60, 1), (61, 60, 2), (200, 60, 1), (60, 200, 2),
               (100, 90, 3), (90, 100, 4)],
    "breaks": [(150, 400, 100), (400, 150, 100), (300, 40, 20),
               (40, 300, 21), (90, 20, 5)],
    "sixteens": [(47, 48, 16), (48, 49, 15), (49, 47, 17), (64, 64, 31),
                 (65, 63, 32), (96, 97, 33)],
    "wide": [(300, 320, 60), (320, 300, 61), (400, 400, 120),
             (250, 260, -1), (260, 250, 400)],
}


@pytest.mark.parametrize("name", list(RING_BANDS))
def test_ring_rule_of_the_band(name):
    """Each fill's own ring (the one `ring_plan` gives it) and a ring of
    exactly `ring_need` slots are sound; two slots fewer are not once a
    fill has two rows: the replay has teeth. Also seeded random fills."""
    fills = list(RING_BANDS[name])
    rng = np.random.default_rng(sorted(RING_BANDS).index(name) + 90)
    fills += [(int(a), int(b), int(c)) for a, b, c in zip(
        rng.integers(1, 120, 3), rng.integers(1, 300, 3),
        rng.integers(0, 80, 3))]
    for qlen, tlen, w in fills:
        W, smem, wide = X.ring_plan(np.array([[qlen, tlen]]), w)
        need = X.ring_need(qlen, tlen, w)
        assert not wide[0] and W >= need and W & (W - 1) == 0
        assert smem == max(X.RING_STATES * 4 * W, X.TRACE_TILE_BYTES)
        spans = band_spans(qlen, tlen, w)
        assert ring_check(spans, W, carry_h=True) is None, (qlen, tlen, w)
        assert ring_check(spans, need, carry_h=True) is None, \
            (qlen, tlen, w, need)
        if len(spans[0]) > 1:
            assert ring_check(spans, need - 2, carry_h=True) is not None, \
                (qlen, tlen, w)


def test_ring_plan_and_launch_plan():
    """`ring_plan` sends a fill to device memory exactly when its exact
    `ring_need` exceeds the widest ring (2048 columns, 120 KB of the 227
    KB a block may have; 2032 x 2032 needs 2048 exactly, beyond its
    bound of 2063), W serves the others, and a launch of wide fills only
    still has room for the trace's tile; `launch_plan` lays the band
    planes end to end at `band_cap`'s width."""
    lens = np.array([[5000, 5000], [2032, 2032], [2100, 2100],
                     [300, 9000], [9000, 9000]])
    W, smem, wide = X.ring_plan(lens, -1)
    need = [X.ring_need(q, t, -1) for q, t in lens]
    assert wide.tolist() == [n > X.RING_MAX for n in need] == \
        [True, False, True, False, True]
    assert W == X.RING_MAX and smem == 15 * 4 * 2048 <= X.SMEM_MAX
    W, smem, wide = X.ring_plan(lens[[0, 2, 4]], -1)
    assert wide.all() and W == 16 and smem == X.TRACE_TILE_BYTES
    W, smem, wide = X.ring_plan(lens, 751)
    assert not wide.any() and W == 1024
    meta, nbytes, smax, W2, smem2, wide2 = X.launch_plan(lens, 751)
    caps = [X.band_cap(int(q), int(t), 751) for q, t in lens]
    rows = lens.sum(1) - 1
    assert meta[:, 1].tolist() == caps and smax == rows.max()
    assert meta[:, 0].tolist() == [0, *np.cumsum(rows * caps)[:-1]]
    assert nbytes == (rows * caps).sum() and (meta[:, 2] == -1).all()
    meta, *_, wide = X.launch_plan(lens, -1)
    assert meta[:, 2].tolist() == [0, -1, 1, -1, 2]


@pytest.fixture(scope="module")
def kernel_on_cpu(tmp_path_factory):
    """csrc/ksw2_extd2.cu built with g++ against the CUDA stand-in, with
    its C entry point bound by ctypes exactly as ops/_build.py binds it.
    96 threads: the control warp and two compute warps, so a band wider
    than 64 columns takes the kernel's loop over a thread's columns."""
    from pathlib import Path
    src = (Path(X.__file__).resolve().parent.parent / "csrc" /
           "ksw2_extd2.cu").read_text()
    return build_on_cpu(src, tmp_path_factory.mktemp("extd2_shim"),
                        ("EXTD2_THREADS=96",))


def shim_traced(lib, lens, tsf, qcol, *, q, e, q2, e2, zdrop, sc_mch,
                sc_mis, sc_N, w, right, approx, approx_drop, extz_only,
                end_bonus, wide_too=()):
    """`extd2_traced`'s launch with CPU buffers: `launch_plan`'s layout;
    the fills in `wide_too` run on state in device memory even though
    they fit the ring."""
    lens_h = lens.numpy().astype(np.int64)
    meta, plane_bytes, Smax, W, smem, wide = X.launch_plan(lens_h, w)
    wide = wide.copy()
    wide[list(wide_too)] = True
    meta[:, 2] = np.where(wide, np.cumsum(wide) - 1, -1)
    B, Tpad = tsf.shape
    stride = Tpad + 16
    # scratch starts as garbage: the kernel must initialise nothing
    state = np.full((max(int(wide.sum()), 1), stride, X.RING_STATES),
                    0x5A5A5A5A, np.int32)
    plane = np.full(plane_bytes, 0xEE, np.uint8)
    ez = np.zeros((B, X.NREG), np.int32)
    ops = np.zeros((B, Smax), np.uint8)
    ij = np.zeros((B, 2), np.int32)
    stamps = np.zeros((B, 3), np.int64)
    meta = np.ascontiguousarray(meta, np.int64)
    g = X.gap_constants(q, e, q2, e2)
    flags = int(right) | int(approx) << 1 | int(approx_drop) << 2 | \
        int(extz_only) << 3
    ptr = [t.data_ptr() for t in (lens, tsf, qcol)] + \
        [a.ctypes.data for a in (meta, state, plane, ez, ops, ij, stamps)]
    err = lib.mm2tpu_ksw2_extd2(*ptr, B, Tpad, qcol.shape[1], stride, Smax,
                                W, smem, *g, zdrop, sc_mch, sc_mis, sc_N, w,
                                end_bonus, flags, None)
    assert err == 0
    assert (stamps[:, 0] <= stamps[:, 1]).all() and \
        (stamps[:, 1] <= stamps[:, 2]).all()
    return [torch.from_numpy(a) for a in (ez, ops, ij[:, 0].copy(),
                                          ij[:, 1].copy())]


def band_tasks(rng, lo=700, hi=1300):
    """Fills long enough that map-ont's bands (w = 500, 751) bind: two
    global, two extension-shaped (a mutated 2/3 prefix), N bases in
    one."""
    tasks = global_tasks(rng, n_tasks=2, lo=lo, hi=hi, with_n=True) + \
        ext_tasks(rng, n_tasks=2, lo=lo, hi=hi)
    return tasks


def band_break_tasks(rng):
    """Lengths that differ by more than the band (w = 100): the band
    breaks, beside a fill that ends and one that Z-drops."""
    t8 = rng.integers(0, 4, 900).astype(np.uint8)
    t2 = rng.integers(0, 4, 200).astype(np.uint8)
    return [(mutate(t8[:150], rng), t8),
            (np.concatenate([mutate(t2, rng),
                             rng.integers(0, 4, 500).astype(np.uint8)]), t2),
            (mutate(t2, rng), t2)] + break_tasks(rng)[:1]


G = (4, 2, 24, 1)
# name -> (task maker, seed, gaps, w, zdrop, end_bonus, flag, fills forced
# onto state in device memory)
SHIM_CASES = {
    "w500": (band_tasks, 100, G, 500, 400, -1, 0, ()),
    "w500_approx": (band_tasks, 101, G, 500, 200, -1, APPROX, (1,)),
    "w751_approx_drop": (band_tasks, 102, G, 751, 200, -1, APPROX | DROP,
                         ()),
    "w751_ext": (band_tasks, 103, G, 751, 400, 10, EXT, (0, 3)),
    "w751_right_ext_rev": (band_tasks, 104, G, 751, 400, 10,
                           EXT | RIGHT | REV, ()),
    "full_band_mixed": (mixed_tasks, 60, G, -1, 400, -1, 0, (0, 2)),
    "zdrop_break": (break_tasks, 40, G, 300, 100, -1, 0, (1,)),
    "zdrop_break_approx": (break_tasks, 40, G, 300, 100, -1, APPROX | DROP,
                           ()),
    "band_breaks": (band_break_tasks, 105, G, 100, -1, -1, 0, (2,)),
    "band_breaks_ext": (band_break_tasks, 106, G, 100, 400, 10, EXT, ()),
    "swapped_gaps_right": (global_tasks, 13, (24, 1, 4, 2), 151, 400, -1,
                           RIGHT, (0, 1, 2, 3)),
    "one_column_band": (narrow_tasks, 14, G, 1, -1, -1, 0, (1,)),
}


@pytest.mark.parametrize("name", list(SHIM_CASES))
def test_kernel_source_on_cpu_matches_plain(kernel_on_cpu, name):
    """The CUDA source of K3 itself, built with g++ against a CPU
    stand-in of CUDA, equals the plain version (every ez register, op
    code and the final (i, j)) under the five flag sets, at w = 500, 751
    and -1, with Z-drops and bands that break, its state in the
    shared-memory ring, in device memory, and both in one launch.
    Integer DP: tolerance 0."""
    make, seed, gaps, w, zdrop, end_bonus, flag, wide_too = SHIM_CASES[name]
    pk, planes = planes_for(make(np.random.default_rng(seed)), gaps)
    kw = traced_kw(pk, gaps, w, zdrop, end_bonus, flag)
    got = shim_traced(kernel_on_cpu, *planes, **kw, wide_too=wide_too)
    with one_torch_thread():
        want = X.extd2_traced_reference(*planes, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b.to(a.dtype))
    if name.startswith("band_breaks"):
        # the first fill's band breaks before its last row
        st, en, st0, en0 = X.band_offsets(*map(int, pk.lens[0]), w)
        assert (st0 > en0).any() and got[0][0, X.R_BREAK] == 1
