"""The port's exts2 splice extension (mm2tpu_torch.ops.ksw2_exts2) against
the JAX package.

The same NumPy-seeded (q8, t8) splice fills (exons around a GT..AG
intron, optionally with --junc-bed flags) go through the Pallas exts2
kernel (interpret mode, as the JAX package's own tests run it on the
CPU), the NumPy oracle `ksw2_splice_ref.ksw_exts2` and the port's
`exts2_batch` on the CPU (its plain PyTorch version). The DP is integer,
so every ExtzResult field, the CIGAR with its N operations included,
must be equal: tolerance 0."""
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mm2tpu.ops import ksw2_ref as K
from mm2tpu.ops.ksw2_pallas import exts2_batch as pallas_exts2_batch
from mm2tpu.ops.ksw2_splice_ref import ksw_exts2
from mm2tpu_torch.mapping.extbatch import TorchExtBatcher, worker_scope
from mm2tpu_torch.ops import ksw2_exts2 as S
from mm2tpu_torch.ops import ksw2_extd2 as X
from test_ksw2_pallas import FIELDS, MAT, mutate, splice_tasks
from test_torch_ksw2_shim import (build_on_cpu, one_torch_thread,
                                  ring_check)

FOR, REV, FLANK = K.KSW_EZ_SPLICE_FOR, K.KSW_EZ_SPLICE_REV, \
    K.KSW_EZ_SPLICE_FLANK
EXT, RIGHT, REVC = K.KSW_EZ_EXTZ_ONLY, K.KSW_EZ_RIGHT, K.KSW_EZ_REV_CIGAR
APPROX, DROP = K.KSW_EZ_APPROX_MAX, K.KSW_EZ_APPROX_DROP
# the presets' scoring (options.py): -x splice and -x splice:hq
SPLICE = (K.gen_simple_mat(1, 2, 1), 2, 1, 32, 9, 200, 9)
SPLICE_HQ = (K.gen_simple_mat(1, 4, 1), 6, 1, 24, 9, 200, 5)
TESTS = (MAT, 4, 2, 32, 9, 200, 9)   # test_ksw2_pallas.py's scoring


def ext_tasks(rng):
    """Right-extension shape: the query stops inside the second exon."""
    return [(q8[: len(q8) * 3 // 4], t8) for q8, t8 in splice_tasks(rng)]


def left_ext_tasks(rng, exon=60):
    """Left-extension shape: align1 reverses both sequences (and the
    site motifs with REV_CIGAR); the query starts inside the first
    exon."""
    return [(q8[len(q8) // 4:][::-1].copy(), t8[::-1].copy())
            for q8, t8 in splice_tasks(rng, exon=exon)]


def zdrop_tasks(rng):
    """A long mismatching tail forces a Z-drop (test_pallas_exts2_zdrop)."""
    t8 = rng.integers(0, 4, 300).astype(np.uint8)
    q8 = np.concatenate([t8[:80], (t8[80:] + 2) % 4]).astype(np.uint8)
    return [(q8, t8)] + splice_tasks(rng, n_tasks=2)


def mixed_tasks(rng):
    """Several sizes and intron lengths in one batch, N bases in one."""
    tasks = splice_tasks(rng, n_tasks=2, exon=30, intron=50) + \
        splice_tasks(rng, n_tasks=2, exon=90, intron=300)
    q8 = tasks[1][0].copy()
    q8[[3, 17]] = 4
    tasks[1] = (q8, tasks[1][1])
    return tasks


def with_juncs(tasks):
    """--junc-bed flags: an annotated donor at the intron's start and an
    acceptor at its end, and a stray donor flag elsewhere."""
    out = []
    for q8, t8 in tasks:
        j = np.zeros(len(t8), np.uint8)
        e = (len(t8) - 120) // 2 if len(t8) > 120 else 1
        j[e] |= 1
        j[len(t8) - e - 1] |= 2
        j[min(10, len(t8) - 1)] |= 8
        out.append((q8, t8, j))
    return out


# name -> (task maker, seed, scoring, flag, junc)
CASES = {
    "splice_for0": (splice_tasks, 0, TESTS, FOR, False),
    "splice_for1": (splice_tasks, 1, TESTS, FOR, False),
    "rev_flank": (splice_tasks, 5, TESTS, REV | FLANK, False),
    "left_ext": (left_ext_tasks, 6, TESTS, FOR | RIGHT | REVC | EXT,
                 False),
    "right_ext": (ext_tasks, 9, TESTS, FOR | EXT, False),
    "gap_fill_approx": (splice_tasks, 10, TESTS, FOR | APPROX, False),
    "approx_drop_junc": (splice_tasks, 7, TESTS, FOR | APPROX | DROP, True),
    "zdrop": (zdrop_tasks, 8, (MAT, 4, 2, 32, 9, 50, 9), FOR, False),
    "zdrop_approx": (zdrop_tasks, 8, (MAT, 4, 2, 32, 9, 50, 9),
                     FOR | APPROX | DROP, False),
    "splice_preset": (splice_tasks, 11, SPLICE, FOR | REV | FLANK, True),
    # exons long enough that an intron pays at the preset's +1 a match
    "splice_preset_left_ext": (lambda rng: left_ext_tasks(rng, 150), 12,
                               SPLICE,
                               FOR | REV | FLANK | RIGHT | REVC | EXT,
                               False),
    "splice_hq_preset": (splice_tasks, 13, SPLICE_HQ, FOR | FLANK, True),
    "splice_hq_gap_fill": (mixed_tasks, 14, SPLICE_HQ,
                           FOR | REV | FLANK | APPROX, False),
    "no_splice_flags": (splice_tasks, 15, TESTS, 0, False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_and_oracle(name):
    make, seed, (mat, q, e, q2, noncan, zdrop, bonus), flag, junc = \
        CASES[name]
    pairs = make(np.random.default_rng(seed))
    tasks = with_juncs(pairs) if junc else [(q8, t8, None)
                                            for q8, t8 in pairs]
    juncs = [t[2] for t in tasks] if junc else None
    kw = dict(q=q, e=e, q2=q2, noncan=noncan, zdrop=zdrop, junc_bonus=bonus,
              flag=flag)
    calls = S.reference_calls
    port = S.exts2_batch(tasks, mat, **kw, device="cpu")
    assert S.reference_calls == calls + 1
    pallas = pallas_exts2_batch(pairs, mat, **kw, juncs=juncs,
                                interpret=True)
    for i, (q8, t8, j) in enumerate(tasks):
        exp = ksw_exts2(len(q8), q8, len(t8), t8, mat, q, e, q2, noncan,
                        zdrop, bonus, flag, junc=j)
        for f in FIELDS:
            assert getattr(port[i], f) == getattr(exp, f), (i, f, "oracle")
            assert getattr(port[i], f) == getattr(pallas[i], f), \
                (i, f, "pallas")
    if flag & (FOR | REV) and not name.startswith("zdrop"):
        # the splice state fired: an intron (N) in some CIGAR
        assert any(c & 0xF == 3 for r in port for c in r.cigar)


def test_skip_rules_and_empty_tasks():
    """q2 <= q + e runs nothing, empty fills and a matrix with -min_sc >
    2(q+e) do not run: their ExtzResult stays the default, as in
    ksw_exts2_sse."""
    rng = np.random.default_rng(80)
    tasks = [(q8, t8, None) for q8, t8 in splice_tasks(rng, n_tasks=2)]
    tasks.insert(1, (np.zeros(0, np.uint8), tasks[0][1], None))
    default = K.ExtzResult()
    res = S.exts2_batch(tasks, MAT, 4, 2, 32, 9, 200, 9, FOR, device="cpu")
    assert all(getattr(res[1], f) == getattr(default, f) for f in FIELDS)
    assert res[0].cigar and res[2].cigar
    calls = S.reference_calls
    for mat, q2 in ((MAT, 6), (MAT, 4), (K.gen_simple_mat(2, 60, 1), 32)):
        assert S.pack_splice_fills(tasks, mat, 4, 2, q2, 9, 9,
                                   FOR).run_idx == []
        res = S.exts2_batch(tasks, mat, 4, 2, q2, 9, 200, 9, FOR,
                            device="cpu")
        assert all(getattr(r, f) == getattr(default, f)
                   for r in res for f in FIELDS)
    assert S.reference_calls == calls


def test_pack_splice_fills_layout():
    rng = np.random.default_rng(81)
    tasks = with_juncs(mixed_tasks(rng))
    pk = S.pack_splice_fills(tasks, MAT, 4, 2, 32, 9, 9, FOR | FLANK)
    tl = max(len(t) for _, t, _ in tasks)
    ql = max(len(q) for q, _, _ in tasks)
    Tpad = (tl + 15) // 16 * 16 + 16
    assert pk.tsf.shape == pk.don.shape == pk.acc.shape == (4, Tpad)
    assert pk.don.dtype == pk.acc.dtype == np.int32
    assert pk.qcol.shape == (4, (ql + 15) // 16 * 16)
    # sc_N is -e (not -e2) when the matrix's N entry is 0
    assert (pk.sc_mch, pk.sc_mis, pk.sc_N) == (2, -4, -1)
    mat0 = np.asarray(MAT).copy()
    mat0[24] = 0
    assert S.pack_splice_fills(tasks, mat0, 4, 2, 32, 9, 9, FOR).sc_N == -2
    from mm2tpu.ops.ksw2_splice_ref import _site_arrays
    for b, (q8, t8, junc) in enumerate(tasks):
        assert tuple(pk.lens[b]) == (len(q8), len(t8))
        np.testing.assert_array_equal(pk.tsf[b, :len(t8)], t8)
        np.testing.assert_array_equal(pk.qcol[b, :len(q8)], q8)
        tpad_c = (len(t8) + 15) // 16 * 16
        dn, ac = _site_arrays(len(t8), tpad_c, t8.astype(np.int32), junc, 9,
                              9, FOR | FLANK)
        np.testing.assert_array_equal(pk.don[b, :tpad_c], dn)
        np.testing.assert_array_equal(pk.acc[b, :tpad_c], ac)
        assert not pk.don[b, tpad_c:].any() and not pk.acc[b, tpad_c:].any()


@pytest.mark.parametrize("flag", [FOR, REV, FOR | REV | FLANK,
                                  FOR | REVC, REV | FLANK | REVC, 0])
def test_site_arrays_match_the_jax_package(flag):
    """The port's vectorised donor/acceptor rows equal the JAX package's
    per-base loop, with and without --junc-bed flags, on targets from 0
    bases up, N bases included."""
    from mm2tpu.ops.ksw2_splice_ref import _site_arrays
    rng = np.random.default_rng(flag)
    for tlen in (0, 1, 2, 3, 4, 5, 17, 250):
        for junc in (None, rng.integers(0, 16, tlen).astype(np.uint8)):
            t8 = rng.integers(0, 5, tlen).astype(np.int32)
            tpad = (tlen + 15) // 16 * 16
            for noncan in (9, 7):
                want = _site_arrays(tlen, tpad, t8, junc, noncan, 9, flag)
                got = S.site_arrays(tlen, tpad, t8, junc, noncan, 9, flag)
                for a, b in zip(want, got):
                    assert b.dtype == np.int32
                    np.testing.assert_array_equal(a, b)


def test_gap_constants_match_the_oracle():
    """long_thres/long_diff use e only (not extd2's e - e2)."""
    for q, e, q2 in ((2, 1, 32), (6, 1, 24), (4, 2, 32), (4, 2, 7)):
        lt = (q2 - q) // e - 1
        if q2 > q + e + lt * e:
            lt += 1
        assert S.gap_constants(q, e, q2) == (lt, lt * e - (q2 - q))
    assert S.gap_constants(2, 1, 32) == (29, -1)


def test_cigar_tail_and_trace_table_emit_introns():
    """The leftover target run of a trace is N from min_intron_len on,
    else D, and state 3 of the trace table is N only for splice fills."""
    ops = np.array([0, 0, 3, 3, 0, 255], np.uint8)
    assert X._cigar_from_ops(ops, 4, -1, True, 5) == \
        [2 << 4 | 0, 2 << 4 | 3, 1 << 4 | 0, 5 << 4 | 2]
    assert X._cigar_from_ops(ops, 4, -1, True, 4) == \
        [2 << 4 | 0, 2 << 4 | 3, 1 << 4 | 0, 5 << 4 | 3]
    assert X._cigar_from_ops(ops, 4, -1, True) == \
        [2 << 4 | 0, 2 << 4 | 3, 1 << 4 | 0, 5 << 4 | 2]
    plain, intron = X._next_state_table(), S._NEXT_INTRON
    for state in range(5):
        for code in range(130):
            a, b = plain[state * 130 + code], intron[state * 130 + code]
            assert a >> 2 == b >> 2
            assert (b & 3) == (3 if b >> 2 == 3 else a & 3)


def planes_for(tasks, flag=FOR):
    pk = S.pack_splice_fills(tasks, MAT, 4, 2, 32, 9, 9, flag)
    kw = dict(q=4, e=2, q2=32, zdrop=200, sc_mch=pk.sc_mch,
              sc_mis=pk.sc_mis, sc_N=pk.sc_N, right=False, approx=False,
              approx_drop=False, extz_only=False)
    return [torch.from_numpy(a) for a in pk.planes()], kw


def test_wrapper_routes_cpu_and_rejects_other_devices():
    rng = np.random.default_rng(82)
    tasks = [(q8, t8, None) for q8, t8 in splice_tasks(rng, n_tasks=2)]
    planes, kw = planes_for(tasks)
    launches, calls = S.launches, S.reference_calls
    out = S.exts2_traced(*planes, **kw)
    assert S.reference_calls == calls + 1 and S.launches == launches
    ref = S.exts2_traced_reference(*planes, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert out[0].dtype == torch.int32 and out[1].dtype == torch.uint8
    assert out[0].shape == (2, X.NREG)
    with pytest.raises(ValueError, match="unsupported device"):
        S.exts2_traced(*(p.to("meta") for p in planes), **kw)
    assert S.launches == launches


@pytest.mark.parametrize("bad", ["lens_int64", "tsf_strided", "qcol_rows",
                                 "don_int64", "acc_short", "q2_small",
                                 "tsf_narrow"])
def test_wrapper_input_checks(bad):
    rng = np.random.default_rng(83)
    tasks = [(q8, t8, None) for q8, t8 in splice_tasks(rng, n_tasks=2)]
    (lens, tsf, qcol, don, acc), kw = planes_for(tasks)
    if bad == "lens_int64":
        lens = lens.to(torch.int64)
    elif bad == "tsf_strided":
        tsf = torch.cat([tsf, tsf], dim=1)[:, ::2]
    elif bad == "qcol_rows":
        qcol = qcol[:1].contiguous()
    elif bad == "don_int64":
        don = don.to(torch.int64)
    elif bad == "acc_short":
        acc = acc[:, :-16].contiguous()
    elif bad == "q2_small":
        kw["q2"] = kw["q"] + kw["e"]
    else:
        tsf, don, acc = (t[:, :-16].contiguous() for t in (tsf, don, acc))
    calls = S.reference_calls
    with pytest.raises(ValueError):
        S.exts2_traced(lens, tsf, qcol, don, acc, **kw)
    assert S.reference_calls == calls


def test_batcher_groups_splice_and_extd2_fills():
    """Splice and extd2 fills from concurrent workers meet in one
    TorchExtBatcher; each kind flushes through its own batch function,
    junc travelling with its fill, and every result equals its oracle."""
    rng = np.random.default_rng(84)
    splice = with_juncs(splice_tasks(rng, n_tasks=4))
    mat8 = np.asarray(MAT, np.int8)
    plain = []
    for _ in range(3):
        t8 = rng.integers(0, 4, int(rng.integers(60, 120))).astype(np.uint8)
        plain.append((mutate(t8, rng), t8))
    work = [("s", t, FOR if i % 2 else FOR | APPROX)
            for i, t in enumerate(splice)] + [("d", t, 0) for t in plain]
    bat = TorchExtBatcher("cpu", max_batch=8, min_cells=0)
    calls_s, calls_d = S.reference_calls, X.reference_calls
    gate = threading.Barrier(len(work))

    def run_one(item):
        kind, task, flag = item
        with worker_scope(bat):
            gate.wait(timeout=60)
            if kind == "s":
                return bat.submit_exts2(*task, mat8, 4, 2, 32, 9, 200, 9,
                                        flag)
            return bat.submit(*task, mat8, 4, 2, 24, 1, 151, 400, -1, flag)

    with ThreadPoolExecutor(len(work)) as ex:
        results = list(ex.map(run_one, work))
    assert bat.n_batched == len(work)
    n_s, n_d = S.reference_calls - calls_s, X.reference_calls - calls_d
    assert n_s >= 2 and n_d >= 1 and n_s + n_d == bat.n_dispatches
    assert bat.n_dispatches < len(work)
    for (kind, task, flag), rz in zip(work, results):
        if kind == "s":
            q8, t8, j = task
            exp = ksw_exts2(len(q8), q8, len(t8), t8, MAT, 4, 2, 32, 9, 200,
                            9, flag, junc=j)
        else:
            q8, t8 = task
            exp = K.ksw_extd2(len(q8), q8, len(t8), t8, MAT, 4, 2, 24, 1,
                              151, 400, -1, flag)
        for f in FIELDS:
            assert getattr(rz, f) == getattr(exp, f), (kind, f)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(85)
    tasks = with_juncs(splice_tasks(rng, n_tasks=8, exon=200, intron=900))
    for flag in (FOR | FLANK, FOR | APPROX, FOR | EXT | RIGHT | REVC):
        launches = S.launches
        kern = S.exts2_batch(tasks, MAT, 4, 2, 32, 9, 200, 9, flag,
                             device="cuda")
        assert S.launches == launches + 1
        plain = S.exts2_batch(tasks, MAT, 4, 2, 32, 9, 200, 9, flag,
                              device="cuda", fn=S.exts2_traced_reference)
        for a, b in zip(kern, plain):
            for f in FIELDS:
                assert getattr(a, f) == getattr(b, f), f


def row_spans(qlen, tlen):
    """(st0, en0, st, en, fe, hi) of every row of a (qlen, tlen) fill, as
    csrc/ksw2_exts2.cu and the plain version compute them."""
    r = np.arange(qlen + tlen - 1)
    st0 = np.maximum(0, r - qlen + 1)
    en0 = np.minimum(tlen - 1, r)
    st = st0 // 16 * 16
    en = (en0 + 16) // 16 * 16 - 1
    fe = st0 + (en0 - st0) // 16 * 16 + 16
    return st0, en0, st, en, fe, np.maximum(en, fe - 1)


def test_ring_need_matches_the_row_spans():
    """`ring_need`'s closed form equals max over rows of (the largest hi so
    far - st + 2), from the row spans, on every (qlen, tlen) up to 80,
    around multiples of 16 and at random lengths up to 9000."""
    rng = np.random.default_rng(86)
    pairs = [(q, t) for q in range(1, 81) for t in range(1, 81)]
    pairs += [(q + d, t + d2) for q in (256, 1024, 4064, 4080)
              for t in (256, 1024, 4080) for d in (-1, 0, 1, 15, 16, 17)
              for d2 in (-1, 0, 1)]
    pairs += [tuple(int(x) for x in rng.integers(1, 9000, 2))
              for _ in range(300)]
    q, t = np.array(pairs).T
    got = S.ring_need(q, t)
    for (qq, tt), n in zip(pairs, got):
        st0, en0, st, en, fe, hi = row_spans(qq, tt)
        assert n == (np.maximum.accumulate(hi) - st + 2).max(), (qq, tt)
        assert n <= min(qq, tt) + 31
        assert n <= X.band_cap(qq, tt, -1) + 16


# (qlen, tlen) fills for the ring replay: one-base sequences, qlen > tlen,
# ends at multiples of 16 +- 1, and long targets that wrap small rings
RING_FILLS = {
    "ones": [(1, 1), (1, 2), (2, 1), (1, 40), (40, 1)],
    "sixteens": [(15, 15), (16, 16), (17, 17), (16, 17), (17, 16),
                 (31, 33), (33, 31), (47, 48), (48, 49), (49, 47)],
    "query_longer": [(60, 20), (100, 33), (130, 64), (70, 17)],
    "introns": [(40, 700), (16, 500), (33, 900), (65, 400)],
    "at_the_limit": [(16, 16), (48, 48), (60, 48), (112, 112), (200, 112)],
}


@pytest.mark.parametrize("name", list(RING_FILLS))
def test_ring_rule_property(name):
    """Each fill's own ring (the narrowest `ring_plan` gives it) and a
    ring of exactly `ring_need` slots are sound; two slots fewer are not
    once a fill has two rows (`ring_need` keeps one slot to spare): the
    replay has teeth. Also seeded random fills."""
    fills = list(RING_FILLS[name])
    rng = np.random.default_rng(sorted(RING_FILLS).index(name))
    fills += [(int(a), int(b)) for a, b in zip(rng.integers(1, 90, 3),
                                               rng.integers(1, 400, 3))]
    for qlen, tlen in fills:
        W, smem, wide = S.ring_plan(np.array([[qlen, tlen]]))
        need = int(S.ring_need(qlen, tlen))
        assert not wide[0] and W >= need and W & (W - 1) == 0
        assert W == 16 or W // 2 < need
        assert smem == max(S.RING_STATES * 4 * W, S.TRACE_TILE_BYTES)
        spans = row_spans(qlen, tlen)
        assert ring_check(spans, W) is None, (qlen, tlen, W)
        if name == "at_the_limit" and (qlen, tlen) in RING_FILLS[name]:
            assert need in (32, 64, 128) and W == need
        assert ring_check(spans, need) is None, (qlen, tlen, need)
        if qlen + tlen > 2:
            assert ring_check(spans, need - 2) is not None, (qlen, tlen)


def test_ring_plan_wide_mask():
    """`wide_mask` is set exactly for the fills whose `ring_need` exceeds
    the widest ring (4096 columns, 208 KB of the 227 KB a block may
    have); W serves the others, and a launch of wide fills only still
    has room for the trace's tile."""
    lens = np.array([[4080, 4080], [4081, 4081], [5000, 4080], [5000, 4081],
                     [4065, 4200], [300, 9000], [9000, 9000]])
    need = S.ring_need(lens[:, 0], lens[:, 1])
    assert need.tolist() == [4096, 4097, 4096, 4097, 4096, 321, 9016]
    for (qq, tt), n in zip(lens.tolist(), need):
        st0, en0, st, en, fe, hi = row_spans(qq, tt)
        assert n == (np.maximum.accumulate(hi) - st + 2).max()
    W, smem, wide = S.ring_plan(lens)
    assert wide.tolist() == [False, True, False, True, False, False, True]
    assert W == S.RING_MAX and smem == 13 * 4 * 4096 <= S.SMEM_MAX
    W, smem, wide = S.ring_plan(lens[[1, 3, 6]])
    assert wide.all() and W == 16 and smem == S.TRACE_TILE_BYTES
    W, smem, wide = S.ring_plan(lens[[5]])
    assert W == 512 and not wide.any()


def test_exts2_batch_counts_s2_rows_and_passes_host_lens():
    """Under --profile each exts2 flush adds its longest fill's rows to
    ext.s2_rows, its wide fills to ext.s2_wide and, when the kernel
    launched, the span of its stamps to ext.s2_kernel; exts2_batch hands
    the wrapper the host lengths (no read-back of the uploaded lens)."""
    from mm2tpu_torch.utils import profiling
    rng = np.random.default_rng(87)
    small = [(q8, t8, None) for q8, t8 in splice_tasks(rng, n_tasks=3)]
    wide = [(rng.integers(0, 4, 4200).astype(np.uint8),
             rng.integers(0, 4, 4300).astype(np.uint8), None)]
    seen = []

    def fake(lens, tsf, qcol, don, acc, *, lens_h, **kw):
        """A launch as the wrapper records it: fill b runs from b to 10 +
        2 b ns."""
        assert np.array_equal(lens_h, lens.numpy())
        seen.append(lens_h)
        B, smax = len(lens_h), int(lens_h.sum(1).max()) - 1
        S.launches += 1
        b = torch.arange(B, dtype=torch.int64)
        S.record_stamps(torch.stack([b, b + 5, 10 + 2 * b], 1))
        return (torch.zeros((B, X.NREG), dtype=torch.int32),
                torch.full((B, smax), 255, dtype=torch.uint8),
                torch.full((B,), -1, dtype=torch.int32),
                torch.full((B,), -1, dtype=torch.int32))

    profiling.enable()
    try:
        for tasks in (small, small[:1] + wide, small[1:]):
            S.exts2_batch(tasks, MAT, 4, 2, 32, 9, 200, 9, FOR | EXT,
                          device="cpu", fn=fake)
        rows = profiling.counters["ext.s2_rows"]
        n_wide = profiling.counters["ext.s2_wide"]
        kernel_s = profiling.snapshot()["ext.s2_kernel"]
    finally:
        profiling.disable()
        S.launches -= len(seen)
    assert len(seen) == 3
    assert rows == sum(int(lh.sum(1).max()) - 1 for lh in seen)
    assert rows == sum(max(len(q) + len(t) - 1 for q, t, _ in tasks)
                       for tasks in (small, small[:1] + wide, small[1:]))
    assert n_wide == 1
    assert kernel_s[1] == 3
    assert abs(kernel_s[0] - sum(10 + 2 * (len(lh) - 1) for lh in seen)
               / 1e9) < 1e-15
    # the CPU route takes the host lengths too, and checks them
    planes, kw = planes_for(small)
    out = S.exts2_traced(*planes, **kw, lens_h=planes[0].numpy())
    ref = S.exts2_traced_reference(*planes, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    with pytest.raises(ValueError):
        S.exts2_traced(*planes, **kw, lens_h=planes[0].numpy()[:1])


@pytest.fixture(scope="module")
def kernel_on_cpu(tmp_path_factory):
    """csrc/ksw2_exts2.cu built with g++ against the CUDA stand-in, with
    its C entry point bound by ctypes exactly as ops/_build.py binds it.
    96 threads: the control warp and two compute warps, so a row wider
    than 64 columns takes the kernel's loop over a thread's columns."""
    from pathlib import Path
    src = (Path(S.__file__).resolve().parent.parent / "csrc" /
           "ksw2_exts2.cu").read_text()
    return build_on_cpu(src, tmp_path_factory.mktemp("exts2_shim"),
                        ("EXTS2_THREADS=96",))


def shim_traced(lib, lens, tsf, qcol, don, acc, *, q, e, q2, zdrop, sc_mch,
                sc_mis, sc_N, right, approx, approx_drop, extz_only,
                wide_too=()):
    """`exts2_traced`'s launch with CPU buffers: `launch_plan`'s layout;
    the fills in `wide_too` run on state in device memory even though
    they fit the ring."""
    lens_h = lens.numpy().astype(np.int64)
    meta, plane_bytes, Smax, W, smem, wide = S.launch_plan(lens_h)
    wide = wide.copy()
    wide[list(wide_too)] = True
    meta[:, 2] = np.where(wide, np.cumsum(wide) - 1, -1)
    B, Tpad = tsf.shape
    stride = Tpad + 16
    # scratch starts as garbage: the kernel must initialise nothing
    state = np.full((max(int(wide.sum()), 1), stride, S.RING_STATES),
                    0x5A5A5A5A, np.int32)
    plane = np.full(plane_bytes, 0xEE, np.uint8)
    ez = np.zeros((B, X.NREG), np.int32)
    ops = np.zeros((B, Smax), np.uint8)
    ij = np.zeros((B, 2), np.int32)
    stamps = np.zeros((B, 3), np.int64)
    meta = np.ascontiguousarray(meta, np.int64)
    lt, ld = S.gap_constants(q, e, q2)
    flags = int(right) | int(approx) << 1 | int(approx_drop) << 2 | \
        int(extz_only) << 3
    ptr = [t.data_ptr() for t in (lens, tsf, qcol, don, acc)] + \
        [a.ctypes.data for a in (meta, state, plane, ez, ops, ij, stamps)]
    err = lib.mm2tpu_ksw2_exts2(*ptr, B, Tpad, qcol.shape[1], stride, Smax,
                                W, smem, q, e, q2, lt, ld, zdrop, sc_mch,
                                sc_mis, sc_N, flags, None)
    assert err == 0
    assert (stamps[:, 0] <= stamps[:, 1]).all() and \
        (stamps[:, 1] <= stamps[:, 2]).all()
    return [torch.from_numpy(a) for a in (ez, ops, ij[:, 0].copy(),
                                          ij[:, 1].copy())]


# (case of CASES, fills forced onto state in device memory)
SHIM_CASES = [("splice_for0", ()), ("left_ext", (1,)), ("zdrop", (0, 2)),
              ("zdrop_approx", ()), ("approx_drop_junc", (0, 1, 2)),
              ("splice_hq_gap_fill", (1, 3))]


@pytest.mark.parametrize("name,wide_too", SHIM_CASES)
def test_kernel_source_on_cpu_matches_plain(kernel_on_cpu, name, wide_too):
    """The CUDA source of K4 itself, built with g++ against a CPU
    stand-in of CUDA, equals the plain version (every ez register, op
    code and the final (i, j)), with its state in the shared-memory ring,
    in device memory, and both in one launch. Integer DP: tolerance 0."""
    make, seed, (mat, q, e, q2, noncan, zdrop, bonus), flag, junc = \
        CASES[name]
    pairs = make(np.random.default_rng(seed))
    tasks = with_juncs(pairs) if junc else [(q8, t8, None)
                                            for q8, t8 in pairs]
    pk = S.pack_splice_fills(tasks, mat, q, e, q2, noncan, bonus, flag)
    planes = [torch.from_numpy(a) for a in pk.planes()]
    kw = dict(q=q, e=e, q2=q2, zdrop=zdrop, sc_mch=pk.sc_mch,
              sc_mis=pk.sc_mis, sc_N=pk.sc_N, right=bool(flag & RIGHT),
              approx=bool(flag & APPROX), approx_drop=bool(flag & DROP),
              extz_only=bool(flag & EXT))
    got = shim_traced(kernel_on_cpu, *planes, **kw, wide_too=wide_too)
    with one_torch_thread():
        want = S.exts2_traced_reference(*planes, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b.to(a.dtype))
