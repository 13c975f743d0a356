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
