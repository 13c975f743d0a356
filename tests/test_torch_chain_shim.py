"""The CUDA source of the chaining kernel itself (csrc/chain.cu: K1 and the
three K2 specialisations), built with g++ against the CPU stand-in of
CUDA in tests/test_torch_ksw2_shim.py and bound as ops/_build.py binds
it, against the plain versions (`chain_scores_v3_reference`,
`chain_scores_v2_reference`) under every contract and the settings of
tests/test_torch_chain_v3.py and tests/test_torch_chain_v2.py.

Each batch has N = 2048 (the window wraps) and three rows shaped like a
pipeline launch: an empty row (n = 0), a ragged one (n = 1517, not a
multiple of 32) and a dense one whose window hits the 1024 cap, with
`pack_tasks16`'s pad past n. The outputs start as garbage, so every cell
the kernel leaves unwritten shows. The stand-in lets whole warps sit out
passes of its scheduler, so that a warp falls barriers behind the others;
a source with one partial buffer instead of two, or without the stores
past n, fails. Integer DP: tolerance 0."""
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from mm2tpu_torch.ops import chain_v2, chain_v3
from mm2tpu_torch.ops.chain_packed import derive_qss, pack_tasks16
from test_chain_pallas import synth_anchors
from test_torch_chain_v2 import CONFIGS as V2_CONFIGS
from test_torch_chain_v2 import CONTRACTS, two_segment
from test_torch_chain_v3 import CONFIGS as V3_CONFIGS
from test_torch_ksw2_shim import build_on_cpu, one_torch_thread

N = 2048
SRC = Path(chain_v3.__file__).resolve().parent.parent / "csrc" / "chain.cu"
GARBAGE = 0x5A5A5A5A
# contract -> {setting name: setting}; None is K1's (single segment)
SETTINGS = {None: {"cap%d_gs%g_mdy%d" % (c["iter_cap"], c["gap_scale"],
                                         c["max_dist_y"]): c
                   for c in V3_CONFIGS}}
SETTINGS.update({c: V2_CONFIGS for c in CONTRACTS})
CASES = [pytest.param(c, name, id="%s-%s" % (
    "k1" if c is None else "k2_cdna%d_segs%d" % c, name))
    for c, settings in SETTINGS.items() for name in settings]
# source edits that must each break the kernel: (old text, new text)
MUTANTS = {
    "one_partial_buffer": (("__shared__ long long part[2][WARPS];",
                            "__shared__ long long part[1][WARPS];"),
                           ("part[i & 1]", "part[0]")),
    "no_stores_past_n": (("f_out[row + i] = span[row + i];", ""),
                         ("p_out[row + i] = -1;", ""),
                         ("dp ? tile_f[t] : tile[3][t]", "tile_f[t]"),
                         ("dp ? tile_p[t] : -1", "tile_p[t]")),
}


@functools.cache
def planes(n_segs):
    """hi, lo, qi, span, sid, n, avg of the three rows, as the pipeline
    packs them."""
    tasks = [np.zeros((0, 2), np.uint64),
             synth_anchors(1517, seed=70, n_rids=3, rev_frac=0.4),
             synth_anchors(N, seed=71, scale=2)]
    if n_segs > 1:
        tasks = [two_segment(a, 72 + k) for k, a in enumerate(tasks)]
    hi, lo, yhi, ylo, n, avg = (torch.from_numpy(a)
                                for a in pack_tasks16(tasks, N))
    qi, span, sid = (x.contiguous() for x in derive_qss(yhi, ylo))
    return hi, lo, qi, span, sid, n, avg


@functools.cache
def plain(contract, name):
    cfg = SETTINGS[contract][name]
    with one_torch_thread():
        if contract is None:
            hi, lo, qi, span, _, n, avg = planes(1)
            return chain_v3.chain_scores_v3_reference(hi, lo, qi, span, n,
                                                      avg, **cfg)
        is_cdna, n_segs = contract
        return chain_v2.chain_scores_v2_reference(
            *planes(n_segs), **cfg, is_cdna=is_cdna, n_segs=n_segs)


def shim_chain(lib, contract, name):
    """The kernel's launch on CPU buffers: (cudaError, f, p)."""
    cfg = SETTINGS[contract][name]
    hi, lo, qi, span, sid, n, avg = planes(1 if contract is None
                                           else contract[1])
    B = hi.shape[0]
    f = torch.full((B, N), GARBAGE, dtype=torch.int32)
    p = torch.full((B, N), GARBAGE, dtype=torch.int32)
    args = (B, N, cfg["max_dist_x"], cfg["max_dist_y"], cfg["bw"],
            min(cfg["iter_cap"], chain_v3.WINDOW), float(cfg["gap_scale"]),
            int(cfg["gap_scale"] != 1.0))
    if contract is None:
        err = lib.mm2tpu_chain_v3(*(t.data_ptr() for t in (
            hi, lo, qi, span, n, avg, f, p)), *args, None)
    else:
        is_cdna, n_segs = contract
        exact_log = max(cfg["max_dist_x"], cfg["max_dist_y"],
                        cfg["bw"]) + 1 >= (1 << 24)
        err = lib.mm2tpu_chain_v2(*(t.data_ptr() for t in (
            hi, lo, qi, span, sid, n, avg, f, p)), *args, int(exact_log),
            int(is_cdna), n_segs, None)
    return err, f, p


def build(tmp_path_factory, tag, defines=(), edits=()):
    src = SRC.read_text()
    for old, new in edits:
        assert src.count(old) >= 1, old
        src = src.replace(old, new)
    return build_on_cpu(src, tmp_path_factory.mktemp(tag), defines,
                        stamped=False)


@pytest.fixture(scope="module")
def kernel_128(tmp_path_factory):
    """Four warps: each thread owns 8 window slots."""
    return build(tmp_path_factory, "chain_128", ("CHAIN_THREADS=128",))


@pytest.mark.parametrize("contract,name", CASES)
def test_kernel_source_on_cpu_matches_plain(kernel_128, contract, name):
    """csrc/chain.cu at 128 threads equals the plain version on every
    cell, the empty row's and the tails past n included."""
    err, f, p = shim_chain(kernel_128, contract, name)
    assert err == 0
    f2, p2 = plain(contract, name)
    assert torch.equal(f, f2) and torch.equal(p, p2)
    # the dense row chains across the whole window, the empty row not at
    # all
    assert (p[2] >= 0).sum() > N // 2 and (p[0] == -1).all()


def test_kernel_source_at_1024_threads_matches_plain(tmp_path_factory):
    """The default block (one slot a thread, 32 warps) on K2's cDNA
    pairs under -x splice's settings."""
    lib = build(tmp_path_factory, "chain_1024")
    contract = (True, 2)
    err, f, p = shim_chain(lib, contract, "splice")
    assert err == 0
    f2, p2 = plain(contract, "splice")
    assert torch.equal(f, f2) and torch.equal(p, p2)


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_broken_sources_fail(tmp_path_factory, mutant):
    """One partial buffer lets a warp that runs ahead overwrite a partial
    the step's owner warp has not read; without the stores past n the
    tails keep the garbage. Either shows on K1's first setting (or as
    a deadlock of the stand-in)."""
    lib = build(tmp_path_factory, "chain_" + mutant,
                ("CHAIN_THREADS=128",), MUTANTS[mutant])
    contract, name = None, next(iter(SETTINGS[None]))
    err, f, p = shim_chain(lib, contract, name)
    f2, p2 = plain(contract, name)
    assert err != 0 or not (torch.equal(f, f2) and torch.equal(p, p2))


# the kernel's key-width threshold, lowered in a copy of the source so
# that N = 2048 rows pass it: the dense row (span sum 30720) goes to the
# int64 key, the ragged one (22755) and the empty one stay on int32
KEY_EDIT = ("constexpr long long KEY_SCORE_MAX = (0x7fffffffLL - WINDOW) / "
            "WINDOW;", "constexpr long long KEY_SCORE_MAX = 25000;")


@pytest.fixture(scope="module")
def kernel_128_wide(tmp_path_factory):
    return build(tmp_path_factory, "chain_128_wide", ("CHAIN_THREADS=128",),
                 (KEY_EDIT,))


@pytest.mark.parametrize("contract", list(SETTINGS), ids=[
    "k1" if c is None else "k2_cdna%d_segs%d" % c for c in SETTINGS])
def test_kernel_source_int64_key_matches_plain(kernel_128_wide, contract):
    """With the threshold lowered, the dense row runs on the int64 key
    beside int32 rows in one launch: no score there comes near 2^21, so
    every cell equals the plain version's (which keys no row in int64 at
    the real threshold)."""
    name = next(iter(SETTINGS[contract]))
    err, f, p = shim_chain(kernel_128_wide, contract, name)
    assert err == 0
    span = planes(1 if contract is None else contract[1])[3]
    assert span.sum(dim=1).tolist()[1] <= 25000 < span.sum(dim=1).tolist()[2]
    f2, p2 = plain(contract, name)
    assert torch.equal(f, f2) and torch.equal(p, p2)
