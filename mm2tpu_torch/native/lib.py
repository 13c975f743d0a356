"""ctypes binding to the native C++ runtime, built by the port from
`native/mm2tpu_native.cpp`.

All entry points fall back gracefully to the Python/NumPy references
when the shared library cannot be built.

Array arguments are declared `c_void_p` and passed as raw `.ctypes.data`
pointers: the ndpointer/from_param validation machinery costs ~10us per
call, which dominates short-read workloads (thousands of small native
calls per batch). Each wrapper guarantees dtype + contiguity itself via
`_ptr` and keeps the backing array alive across the call.

The port's copy of `mm2tpu/native/lib.py`, verbatim apart from its
imports, from where the library comes from, and from the batch seeding
entries at its end with the index-pointer cache (`_index_ptrs`) that
they share with `seed_hits`. The port compiles the C++ source (which
stays in `native/`) itself, with `native/Makefile`'s compiler and
flags, and with its own `seed_batch.cpp` beside it, into
`build/mm2tpu_torch/libmm2tpu_host_<hash>.so`, named by a hash of the
sources and the flags: an edited source is never served by an older
build. It builds at first use under a file lock, and
`build(force=True)` recompiles. It never loads `native/libmm2tpu.so`.
"""
from __future__ import annotations

import ctypes
import hashlib
import pathlib
import threading as _threading
from typing import Optional, Tuple

import numpy as np

import os as _os

_REPO = pathlib.Path(__file__).resolve().parents[2]
_SRCS = (_REPO / "native" / "mm2tpu_native.cpp",
         pathlib.Path(__file__).with_name("seed_batch.cpp"))
BUILD_DIR = _REPO / "build" / "mm2tpu_torch"
# native/Makefile's CXX and CXXFLAGS, and the threads of seed_batch.cpp
_CXX = ("g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
        "-Wall", "-pthread")
_lib: Optional[ctypes.CDLL] = None
_checked = False
loaded_from: Optional[pathlib.Path] = None   # the library _load() opened

_VP = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64


def _ptr(a, dtype):
    """(keepalive, raw pointer) for an array coerced to C-contiguous dtype."""
    a = np.ascontiguousarray(a, dtype)
    return a, a.ctypes.data


def so_path() -> pathlib.Path:
    """Where the build of the current sources and flags lives."""
    h = hashlib.sha256(" ".join(_CXX).encode())
    for src in _SRCS:
        h.update(src.read_bytes())
    return BUILD_DIR / ("libmm2tpu_host_%s.so" % h.hexdigest()[:16])


def build(force: bool = False) -> pathlib.Path:
    """Compile the native runtime into BUILD_DIR unless that build is
    there already (or `force`), under an exclusive lock: concurrent test
    workers must not race the compiler. Returns the library's path;
    raises if the compiler fails."""
    import fcntl
    import subprocess
    so = so_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libmm2tpu_host.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if force or not so.exists():
            tmp = so.with_name("%s.%d.tmp" % (so.name, _os.getpid()))
            r = subprocess.run([*_CXX, "-o", str(tmp), *map(str, _SRCS)],
                               capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError("native build failed (rc=%d): %s\n%s" % (
                    r.returncode, " ".join(r.args), r.stderr[-4000:]))
            _os.replace(tmp, so)
    return so


_load_lock = _threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    if _checked:
        return _lib or None
    with _load_lock:   # no caller sees "absent" while the build runs
        if not _checked:
            _open()
    return _lib or None


def _open() -> None:
    global _lib, _checked, loaded_from
    try:
        so = build()
    except Exception:
        _checked = True
        return
    lib = ctypes.CDLL(str(so))
    loaded_from = so
    lib.mm2_chain_exact.argtypes = [
        _I64, _I32, _I32, _I32, _I32, _I32, ctypes.c_float, _I32, _I32,
        _VP, _VP, _VP, _VP, _VP]
    lib.mm2_chain_exact.restype = None
    if hasattr(lib, "mm2_chain_exact2"):
        lib.mm2_chain_exact2.argtypes = [
            _I64, _I32, _I32, _I32, _I32, _I32, ctypes.c_float, _I32,
            _I32, _VP, _VP, _VP, _VP]
        lib.mm2_chain_exact2.restype = None
    lib.mm2_v_carry.argtypes = [_I64, _VP, _VP, _VP]
    lib.mm2_v_carry.restype = None
    lib.mm2_sketch.argtypes = [
        _VP, _I64, _I32, _I32, ctypes.c_uint32, _I32, _VP, _VP, _I64]
    lib.mm2_sketch.restype = _I64
    if hasattr(lib, "mm2_finalize_index"):
        lib.mm2_finalize_index.argtypes = [_I64, _VP, _VP, _VP, _VP, _VP,
                                           _VP, _I32]
        lib.mm2_finalize_index.restype = _I64
    if hasattr(lib, "mm2_finalize_pieces"):
        lib.mm2_finalize_pieces.argtypes = [_I32, _VP, _VP, _VP, _I32,
                                            _VP, _VP, _VP, _VP, _I32]
        lib.mm2_finalize_pieces.restype = _I64
    if hasattr(lib, "mm2_read_mmi_buckets"):
        lib.mm2_scan_mmi_buckets.argtypes = [
            _VP, _I64, _I32, ctypes.POINTER(_I64), ctypes.POINTER(_I64),
            ctypes.POINTER(_I64)]
        lib.mm2_scan_mmi_buckets.restype = ctypes.c_int
        lib.mm2_read_mmi_buckets.argtypes = [
            _VP, _I64, _I32, _I64, _VP, _VP, _VP, _VP]
        lib.mm2_read_mmi_buckets.restype = ctypes.c_int
    if hasattr(lib, "mm2_update_stats"):
        for fn in (lib.mm2_update_stats, lib.mm2_zdrop_scan):
            fn.argtypes = [_VP, _I64, _VP, _VP, _VP, _I32, _I32, _VP]
            fn.restype = None
    if hasattr(lib, "mm2_sdust"):
        lib.mm2_sdust.argtypes = [_VP, _I64, _I32, _I32, _VP, _I64]
        lib.mm2_sdust.restype = _I64
    if hasattr(lib, "mm2_pack_seq4"):
        lib.mm2_pack_seq4.argtypes = [_VP, _I64, _VP, _I64]
        lib.mm2_pack_seq4.restype = None
    if hasattr(lib, "mm2_lookup_many"):
        lib.mm2_lookup_many.argtypes = [
            _I64, _VP, _I64, _VP, _VP, _VP, _I32, _I32, _VP, _VP, _VP]
        lib.mm2_lookup_many.restype = None
    if hasattr(lib, "mm2_seed_hits"):
        lib.mm2_seed_hits.argtypes = [
            _I64, _VP, _I64, _VP, _VP, _VP, _I32, _I32, _VP, _VP,
            _I32, _I64, _I32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.POINTER(_I64), ctypes.POINTER(_I64)]
        lib.mm2_seed_hits.restype = _I64
    if hasattr(lib, "mm2t_sketch_batch"):
        lib.mm2t_sketch_batch.argtypes = [_VP, _VP, _VP, _VP, _I64, _I32,
                                          _I32, _I32, _I32, _VP]
        lib.mm2t_sketch_batch.restype = _VP
        lib.mm2t_seed_hits_batch.argtypes = [
            _VP, _VP, _I64, _VP, _I64, _VP, _VP, _VP, _I32, _I32, _VP, _VP,
            _I32, _I32, _I32, _VP, _VP, _VP]
        lib.mm2t_seed_hits_batch.restype = _VP
        lib.mm2t_batch_take.argtypes = [_VP, _I32, _VP, _VP]
        lib.mm2t_batch_take.restype = None
    if hasattr(lib, "mm2_set_parent_select"):
        lib.mm2_set_parent_select.argtypes = [
            _I64] + [_VP] * 7 + [ctypes.c_float, _I32, _I32, _I32,
                                 ctypes.c_float, _I32, _I32] + [_VP] * 5
        lib.mm2_set_parent_select.restype = _I64
    if hasattr(lib, "mm2_chain_backtrack"):
        lib.mm2_chain_backtrack.argtypes = [
            _I64, _VP, _VP, _VP, _VP, _I32, _I32, _VP, _VP,
            ctypes.POINTER(_I64)]
        lib.mm2_chain_backtrack.restype = _I64
        lib.mm2_gen_regs.argtypes = [_I64, _VP, _VP, ctypes.c_uint64,
                                     _I32] + [_VP] * 12
        lib.mm2_gen_regs.restype = None
    if hasattr(lib, "mm2_ksw_ll"):
        lib.mm2_ksw_ll.argtypes = [_I32, _VP, _I32, _VP, _VP, _I32, _I32,
                                   _VP]
        lib.mm2_ksw_ll.restype = None
    if hasattr(lib, "mm2_ksw_exts2"):
        lib.mm2_ksw_exts2.argtypes = [
            _I32, _VP, _I32, _VP, _VP, _I32, _I32, _I32, _I32, _I32, _I32,
            _I32, _VP, _VP,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.POINTER(_I32)]
        lib.mm2_ksw_exts2.restype = ctypes.c_int
    if hasattr(lib, "mm2_ksw_extd2"):
        lib.mm2_ksw_extd2.argtypes = [
            _I32, _VP, _I32, _VP, _VP, _I32, _I32, _I32, _I32, _I32, _I32,
            _I32, _I32, _VP,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.POINTER(_I32)]
        lib.mm2_ksw_extd2.restype = ctypes.c_int
        lib.mm2_free.argtypes = [_VP]
        lib.mm2_free.restype = None
    if hasattr(lib, "mm2_ksw_extd2_fill"):
        lib.mm2_ksw_extd2_fill.argtypes = [
            _I32, _VP, _I32, _VP, _VP, _I32, _I32, _I32, _I32, _I32, _I32,
            _I32, _I32, _I32, _I32, _I64, _I64, _VP,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.POINTER(_I32), ctypes.POINTER(_I32)]
        lib.mm2_ksw_extd2_fill.restype = ctypes.c_int
        lib.mm2_ksw_extd2_fillp.argtypes = [
            _VP, _VP, _VP, _VP, _VP,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.POINTER(_I32), ctypes.POINTER(_I32)]
        lib.mm2_ksw_extd2_fillp.restype = ctypes.c_int
    if hasattr(lib, "mm2_fix_cigar"):
        lib.mm2_fix_cigar.argtypes = [_VP, _I64, _VP, _VP, _VP]
        lib.mm2_fix_cigar.restype = _I64
    if hasattr(lib, "mm2_ksw_fill_walk"):
        lib.mm2_ksw_fill_walk.argtypes = [
            _VP, _I64, _VP, _VP, _VP,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.POINTER(_I32), _VP]
        lib.mm2_ksw_fill_walk.restype = ctypes.c_int
    if hasattr(lib, "mm2_cigar_str"):
        lib.mm2_cigar_str.argtypes = [_VP, _I64, _I32, _I32,
                                      ctypes.c_char, _VP]
        lib.mm2_cigar_str.restype = _I64
    if hasattr(lib, "mm2_fix_bad_ends"):
        lib.mm2_fix_bad_ends.argtypes = [_VP, _I64, _I32, _I32, _I32,
                                         _I32, ctypes.POINTER(_I64),
                                         ctypes.POINTER(_I64)]
        lib.mm2_fix_bad_ends.restype = None
    if hasattr(lib, "mm2_est_err"):
        lib.mm2_est_err.argtypes = [_I32, _I32] + [_VP] * 8 + [_I64, _VP,
                                                               _VP]
        lib.mm2_est_err.restype = None
    _lib = lib
    _checked = True


def available() -> bool:
    return _load() is not None


def chain_scores_exact(a: np.ndarray, max_dist_x: int, max_dist_y: int,
                       bw: int, max_skip: int, max_iter: int,
                       gap_scale: float, is_cdna: bool, n_segs: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Native exact chaining DP; same contract as chain_ref.chain_scores_exact."""
    lib = _load()
    n = len(a)
    f = np.zeros(n, np.int32)
    p = np.full(n, -1, np.int32)
    v = np.zeros(n, np.int32)
    if n:
        if hasattr(lib, "mm2_chain_exact2"):
            aa, ap = _ptr(a, np.uint64)
            lib.mm2_chain_exact2(n, max_dist_x, max_dist_y, bw, max_skip,
                                 max_iter, gap_scale, int(is_cdna), n_segs,
                                 ap, f.ctypes.data, p.ctypes.data,
                                 v.ctypes.data)
        else:
            ax, axp = _ptr(a[:, 0], np.uint64)
            ay, ayp = _ptr(a[:, 1], np.uint64)
            lib.mm2_chain_exact(n, max_dist_x, max_dist_y, bw, max_skip,
                                max_iter, gap_scale, int(is_cdna), n_segs,
                                axp, ayp, f.ctypes.data, p.ctypes.data,
                                v.ctypes.data)
    return f, p, v


def v_carry(f: np.ndarray, p: np.ndarray) -> np.ndarray:
    lib = _load()
    n = len(f)
    v = np.zeros(n, np.int32)
    if n:
        fa, fp = _ptr(f, np.int32)
        pa, pp = _ptr(p, np.int32)
        lib.mm2_v_carry(n, fp, pp, v.ctypes.data)
    return v


def has_ksw() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mm2_ksw_extd2")


def ksw_extd2(qlen: int, query: np.ndarray, tlen: int, target: np.ndarray,
              mat: np.ndarray, q: int, e: int, q2: int, e2: int, w: int,
              zdrop: int, end_bonus: int, flag: int):
    """Native extd2 extension DP; same contract (and bit-identical
    results) as ops/ksw2_ref.ksw_extd2. Releases the GIL."""
    from ..ops.ksw2_ref import ExtzResult

    lib = _load()
    ez_out = np.zeros(10, np.int64)
    cig_ptr = ctypes.POINTER(ctypes.c_uint32)()
    n_cig = ctypes.c_int32(0)
    qa, qp = _ptr(query, np.uint8)
    ta, tp = _ptr(target, np.uint8)
    ma, mp = _ptr(np.asarray(mat).reshape(-1), np.int8)
    rc = lib.mm2_ksw_extd2(
        qlen, qp, tlen, tp, mp, q, e, q2, e2, w, zdrop, end_bonus, flag,
        ez_out.ctypes.data, ctypes.byref(cig_ptr), ctypes.byref(n_cig))
    if rc != 0:
        raise MemoryError("mm2_ksw_extd2 allocation failed")
    ez = ExtzResult()
    (ez.max, zd, ez.max_q, ez.max_t, ez.mqe, ez.mqe_t, ez.mte,
     ez.mte_q, ez.score, re_) = ez_out.tolist()
    ez.zdropped = bool(zd)
    ez.reach_end = bool(re_)
    if n_cig.value:
        ez.cigar = np.frombuffer(ctypes.string_at(cig_ptr, 4 * n_cig.value),
                                 np.uint32).tolist()
        lib.mm2_free(cig_ptr)
    return ez


def has_fill() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mm2_ksw_extd2_fill")


class _FillCtx(_threading.local):
    """Per-thread reusable FFI state for the fused fill: buffers, byrefs
    and the packed-parameter array are built once per thread, not per
    call (the per-call wrapper cost was ~20us x ~50 fills/read)."""

    def __init__(self):
        self.par = np.zeros(17, np.int64)
        self.parp = self.par.ctypes.data
        self.ez = np.zeros(10, np.int64)
        self.ezp = self.ez.ctypes.data
        self.cig = ctypes.POINTER(ctypes.c_uint32)()
        self.ncig = ctypes.c_int32(0)
        self.code = ctypes.c_int32(0)
        self.br_cig = ctypes.byref(self.cig)
        self.br_ncig = ctypes.byref(self.ncig)
        self.br_code = ctypes.byref(self.code)
        self.walk = np.zeros(4, np.int64)
        self.walkp = self.walk.ctypes.data


_fill_ctx = _FillCtx()

# scoring-matrix pointer cache: the keepalive entry holds the array, so
# the cached id stays valid for as long as it is cached
_mat_cache: dict = {}


def _mat_ptr(mat) -> int:
    ent = _mat_cache.get(id(mat))
    if ent is None or ent[0] is not mat:
        a = np.ascontiguousarray(mat, np.int8)
        if len(_mat_cache) > 32:
            _mat_cache.clear()
        ent = (mat, a, a.ctypes.data)
        _mat_cache[id(mat)] = ent
    return ent[2]


_ExtzResult = None


def _parse_fill_result(lib, c):
    global _ExtzResult
    if _ExtzResult is None:
        from ..ops.ksw2_ref import ExtzResult
        _ExtzResult = ExtzResult
    # hot path (~50 calls/read): bypass the dataclass __init__ + 10
    # setattr — one __dict__ literal per result
    mx, zd, mq, mt, mqe, mqe_t, mte, mte_q, sc, re_ = c.ez.tolist()
    n = c.ncig.value
    if n:
        cig = np.frombuffer(ctypes.string_at(c.cig, 4 * n),
                            np.uint32).tolist()
        lib.mm2_free(c.cig)
    else:
        cig = []
    ez = _ExtzResult.__new__(_ExtzResult)
    ez.__dict__ = {
        "max": mx, "zdropped": bool(zd), "max_q": mq, "max_t": mt,
        "mqe": mqe, "mqe_t": mqe_t, "mte": mte, "mte_q": mte_q,
        "score": sc, "reach_end": bool(re_), "cigar": cig}
    return ez, int(c.code.value)


def ksw_extd2_fill_ref(s_ptr: int, ref_off: int, tlen: int, q_ptr: int,
                       qlen: int, mat, q: int, e: int, q2: int, e2: int,
                       w: int, zdrop: int, zdrop_inv: int, flag: int,
                       inv_enabled: bool, max_gap: int, min_inv_score: int,
                       min_dp_max: int):
    """Fused fill with zero per-call array marshalling: the target comes
    from the 4-bit packed reference (unpacked in C — no per-fill getseq)
    and the query rides as a raw base pointer + offset. Returns
    (ExtzResult, zdrop_code) exactly as ksw_extd2_fill."""
    lib = _load()
    c = _fill_ctx
    par = c.par
    par[0] = qlen
    par[1] = tlen
    par[2] = q
    par[3] = e
    par[4] = q2
    par[5] = e2
    par[6] = w
    par[7] = zdrop
    par[8] = zdrop_inv
    par[9] = flag
    par[10] = 1 if inv_enabled else 0
    par[11] = max_gap
    par[12] = min_inv_score
    par[13] = min_dp_max
    par[14] = s_ptr
    par[15] = ref_off
    par[16] = q_ptr
    rc = lib.mm2_ksw_extd2_fillp(c.parp, 0, 0, _mat_ptr(mat), c.ezp,
                                 c.br_cig, c.br_ncig, c.br_code)
    if rc != 0:
        raise MemoryError("mm2_ksw_extd2_fillp allocation failed")
    return _parse_fill_result(lib, c)


def has_fill_walk() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mm2_ksw_fill_walk")


def ksw_fill_walk(gaps: np.ndarray, s_ptr: int, q_ptr: int, mat, q: int,
                  e: int, q2: int, e2: int, zdrop: int, zdrop_inv: int,
                  flag: int, inv_enabled: bool, max_gap: int,
                  min_inv_score: int, min_dp_max: int):
    """Batched seed-walk: ONE FFI crossing runs the whole precomputed
    gap-fill plan (align.c:700-771 loop) — each row a fused fill — with
    CIGAR boundary-merging and score accumulation in C. gaps is an
    (n, 5) int64 array [qlen, tlen, q_off, ref_off, bw]. Returns
    (n_done, zdrop_code, score_sum, zdropped, cigar_list, ez-of-last)."""
    lib = _load()
    c = _fill_ctx
    par = c.par
    par[2] = q
    par[3] = e
    par[4] = q2
    par[5] = e2
    par[7] = zdrop
    par[8] = zdrop_inv
    par[9] = flag
    par[10] = 1 if inv_enabled else 0
    par[11] = max_gap
    par[12] = min_inv_score
    par[13] = min_dp_max
    par[14] = s_ptr
    par[16] = q_ptr
    ga, gp = _ptr(gaps, np.int64)
    rc = lib.mm2_ksw_fill_walk(gp, len(ga), c.parp, _mat_ptr(mat), c.ezp,
                               c.br_cig, c.br_ncig, c.walkp)
    if rc != 0:
        raise MemoryError("mm2_ksw_fill_walk allocation failed")
    n = c.ncig.value
    if n:
        cig = np.frombuffer(ctypes.string_at(c.cig, 4 * n),
                            np.uint32).tolist()
        lib.mm2_free(c.cig)
    else:
        cig = []
    c.code.value = int(c.walk[1])
    c.ncig.value = 0
    ez, _ = _parse_fill_result(lib, c)
    ez.cigar = []  # the merged walk cigar rides separately
    return (int(c.walk[0]), int(c.walk[1]), int(c.walk[2]),
            bool(c.walk[3]), cig, ez)


def ksw_extd2_fill(qlen: int, query: np.ndarray, tlen: int,
                   target: np.ndarray, mat: np.ndarray, q: int, e: int,
                   q2: int, e2: int, w: int, zdrop: int, zdrop_inv: int,
                   flag: int, inv_enabled: bool, max_gap: int,
                   min_inv_score: int, min_dp_max: int):
    """Fused seed-gap fill (approx extd2 + mm_test_zdrop incl. inversion
    probe + exact re-run) — one FFI call for the whole align.c:733-761
    fill sequence. Returns (ExtzResult, zdrop_code)."""
    from ..ops.ksw2_ref import ExtzResult

    lib = _load()
    c = _fill_ctx
    par = c.par
    par[0] = qlen
    par[1] = tlen
    par[2] = q
    par[3] = e
    par[4] = q2
    par[5] = e2
    par[6] = w
    par[7] = zdrop
    par[8] = zdrop_inv
    par[9] = flag
    par[10] = 1 if inv_enabled else 0
    par[11] = max_gap
    par[12] = min_inv_score
    par[13] = min_dp_max
    par[14] = par[15] = par[16] = 0
    if query.dtype == np.uint8 and query.flags.c_contiguous:
        qa, qp = query, query.ctypes.data
    else:
        qa, qp = _ptr(query, np.uint8)
    if target.dtype == np.uint8 and target.flags.c_contiguous:
        ta, tp = target, target.ctypes.data
    else:
        ta, tp = _ptr(target, np.uint8)
    ma, mp = _ptr(mat, np.int8)
    rc = lib.mm2_ksw_extd2_fillp(c.parp, qp, tp, mp, c.ezp, c.br_cig,
                                 c.br_ncig, c.br_code)
    if rc != 0:
        raise MemoryError("mm2_ksw_extd2_fill allocation failed")
    return _parse_fill_result(lib, c)


def has_finalize() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mm2_finalize_index")


def finalize_index(x: np.ndarray, y: np.ndarray, n_threads: int = 1):
    """Native minimizer sort into CSR (index.c:191-243 semantics).
    Returns (keys, start, cnt, pos)."""
    lib = _load()
    n = len(x)
    xa, xp = _ptr(x, np.uint64)
    ya, yp = _ptr(y, np.uint64)
    pos = np.empty(n, np.uint64)
    keys = np.empty(n, np.uint64)
    start = np.empty(n, np.int64)
    cnt = np.empty(n, np.int32)
    nk = lib.mm2_finalize_index(n, xp, yp, pos.ctypes.data, keys.ctypes.data,
                                start.ctypes.data, cnt.ctypes.data,
                                n_threads)
    # views, not copies: this box's memory bandwidth makes 130MB of copies
    # cost seconds; the over-allocation tail is ~20% and freed with the part
    return keys[:nk], start[:nk], cnt[:nk], pos


def has_finalize_pieces() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mm2_finalize_pieces")


def finalize_index_pieces(xs, ys, key_bits: int, n_threads: int = 1):
    """Native minimizer sort into CSR straight from the per-contig sketch
    pieces — no concatenation pass (index.c:191-243 semantics; the piece
    list is the analogue of the reference's per-bucket kvec scatter,
    index.c:321-327). Returns (keys, start, cnt, pos)."""
    import ctypes as _ct
    lib = _load()
    xs = [np.ascontiguousarray(x, np.uint64) for x in xs]
    ys = [np.ascontiguousarray(y, np.uint64) for y in ys]
    np_ = len(xs)
    ns = np.array([len(x) for x in xs], np.int64)
    xp = (_ct.c_void_p * np_)(*[x.ctypes.data for x in xs])
    yp = (_ct.c_void_p * np_)(*[y.ctypes.data for y in ys])
    n = int(ns.sum())
    pos = np.empty(n, np.uint64)
    keys = np.empty(n, np.uint64)
    start = np.empty(n, np.int64)
    cnt = np.empty(n, np.int32)
    nk = lib.mm2_finalize_pieces(
        np_, ns.ctypes.data, _ct.cast(xp, _ct.c_void_p),
        _ct.cast(yp, _ct.c_void_p), int(key_bits), pos.ctypes.data,
        keys.ctypes.data, start.ctypes.data, cnt.ctypes.data, n_threads)
    return keys[:nk], start[:nk], cnt[:nk], pos


def has_mmi_reader() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mm2_read_mmi_buckets")


def read_mmi_buckets(data, b: int):
    """Native .mmi bucket-region parse into CSR arrays. Returns
    (keys, start, cnt, pos, consumed_bytes). Two-phase: a header scan
    sizes the outputs so the fill pass writes caller memory directly."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    bp, bl = buf.ctypes.data, len(buf)
    del buf  # release the buffer export: the caller may grow `data`
    # after catching ValueError (a traceback-held view would make the
    # bytearray resize raise BufferError)
    n_entries = ctypes.c_int64()
    npos = ctypes.c_int64()
    consumed = ctypes.c_int64()
    if lib.mm2_scan_mmi_buckets(bp, bl, b,
                                ctypes.byref(n_entries), ctypes.byref(npos),
                                ctypes.byref(consumed)) != 0:
        raise ValueError("corrupt .mmi bucket region")
    nk = n_entries.value
    keys = np.empty(nk, np.uint64)
    start = np.empty(nk, np.int64)
    cnt = np.empty(nk, np.int32)
    pos = np.empty(npos.value, np.uint64)
    if lib.mm2_read_mmi_buckets(bp, bl, b, nk,
                                keys.ctypes.data, start.ctypes.data,
                                cnt.ctypes.data, pos.ctypes.data) != 0:
        raise ValueError("corrupt .mmi bucket region")
    return keys, start, cnt, pos, consumed.value


def has_cigar_walks() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mm2_update_stats")


def has_fix_cigar() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mm2_fix_cigar")


def fix_cigar(cig: np.ndarray, qseq: np.ndarray, tseq: np.ndarray):
    """Native mm_fix_cigar (align.c:91-167) over a uint32 cigar array
    (modified in place). Returns (n_new, qshift, tshift, lead_op, qoff,
    toff); the caller applies region-coordinate updates and truncates."""
    lib = _load()
    out = np.zeros(5, np.int64)
    qa, qp = _ptr(qseq, np.uint8)
    ta, tp = _ptr(tseq, np.uint8)
    n = lib.mm2_fix_cigar(cig.ctypes.data, len(cig), qp, tp,
                          out.ctypes.data)
    o = out.tolist()
    return int(n), o[0], o[1], o[2], o[3], o[4]


def has_cigar_str() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mm2_cigar_str")


class _CigBuf(_threading.local):
    def __init__(self):
        self.buf = ctypes.create_string_buffer(1 << 14)


_cigstr = _CigBuf()


def cigar_str(cigar, clip0: int = 0, clip1: int = 0,
              clip_char: str = "S") -> str:
    """Format a cigar (list or uint32 array) as '<len><op>' text with
    optional soft/hard clips (format.c:365-389). One FFI call replaces
    the per-op f-string path (~240 ns/op -> ~5 ns/op on long CIGARs)."""
    lib = _load()
    ca, cp = _ptr(cigar, np.uint32)
    need = 11 * (len(ca) + 2) + 1
    if len(_cigstr.buf) < need:
        _cigstr.buf = ctypes.create_string_buffer(need)
    base = ctypes.addressof(_cigstr.buf)
    n = lib.mm2_cigar_str(cp, len(ca), clip0, clip1,
                          clip_char.encode("ascii"), base)
    if n < 0:  # op nibble >= 10: corrupt CIGAR, match the Python path's raise
        raise IndexError("invalid CIGAR op nibble in %r" % (list(ca[:8]),))
    return ctypes.string_at(base, n).decode("ascii")


def update_stats(cigar: np.ndarray, qseq: np.ndarray, tseq: np.ndarray,
                 mat: np.ndarray, q: int, e: int) -> np.ndarray:
    """Native mm_update_extra stats walk (align.c:240-286); returns
    int64 [blen, mlen, n_ambi, dp_max, qoff, toff]."""
    lib = _load()
    out = np.zeros(6, np.int64)
    ca, cp = _ptr(cigar, np.uint32)
    qa, qp = _ptr(qseq, np.uint8)
    ta, tp = _ptr(tseq, np.uint8)
    ma, mp = _ptr(np.asarray(mat).reshape(-1), np.int8)
    lib.mm2_update_stats(cp, len(ca), qp, tp, mp, q, e, out.ctypes.data)
    return out


def zdrop_scan(cigar: np.ndarray, qseq: np.ndarray, tseq: np.ndarray,
               mat: np.ndarray, q: int, e: int):
    """Native mm_test_zdrop scan (align.c:52-68); returns
    (max_zdrop, [[i0, i1], [j0, j1]])."""
    lib = _load()
    out = np.zeros(5, np.int64)
    ca, cp = _ptr(cigar, np.uint32)
    qa, qp = _ptr(qseq, np.uint8)
    ta, tp = _ptr(tseq, np.uint8)
    ma, mp = _ptr(np.asarray(mat).reshape(-1), np.int8)
    lib.mm2_zdrop_scan(cp, len(ca), qp, tp, mp, q, e, out.ctypes.data)
    o = out.tolist()
    return o[0], [[o[1], o[2]], [o[3], o[4]]]


def has_sdust() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mm2_sdust")


def sdust(codes: np.ndarray, T: int, W: int):
    """Native SDUST; returns [(start, finish), ...]."""
    lib = _load()
    ca, cp = _ptr(codes, np.uint8)
    cap = len(ca) // 2 + 2
    out = np.empty(2 * cap, np.int64)
    n = lib.mm2_sdust(cp, len(ca), T, W, out.ctypes.data, cap)
    return list(zip(out[0:2 * n:2].tolist(), out[1:2 * n:2].tolist()))


def has_pack_seq4() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mm2_pack_seq4")


def pack_seq4(codes: np.ndarray, S: np.ndarray, offset: int) -> None:
    """Native 4-bit reference packing (mm_seq4_set)."""
    lib = _load()
    ca, cp = _ptr(codes, np.uint8)
    lib.mm2_pack_seq4(cp, len(ca), S.ctypes.data, offset)


def has_lookup() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mm2_lookup_many")


def has_seed_hits() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mm2_seed_hits")


def _index_ptrs(keys, start, cnt, lut, pos, cache_obj):
    """(key, originals, coerced arrays, (n_keys, raw pointers)) of the
    five index planes, memoized on `cache_obj` (see `seed_hits`)."""
    st = getattr(cache_obj, "_nat_seedptrs", None) \
        if cache_obj is not None else None
    key = (id(keys), id(start), id(cnt), id(lut), id(pos))
    if st is None or st[0] != key:
        ka, kp = _ptr(keys, np.uint64)
        sa, sp = _ptr(start, np.int64)
        ca, cp = _ptr(cnt, np.int32)
        la, lp = _ptr(lut, np.int64)
        pa, pp = _ptr(pos, np.uint64)
        st = (key, (keys, start, cnt, lut, pos), (ka, sa, ca, la, pa),
              (len(ka), kp, sp, cp, lp, pp))
        if cache_obj is not None:
            cache_obj._nat_seedptrs = st
    return st


def seed_hits(mv: np.ndarray, keys: np.ndarray, start: np.ndarray,
              cnt: np.ndarray, lut_bits: int, shift: int, lut: np.ndarray,
              pos: np.ndarray, max_occ: int, qlen: int, skip_mode: int,
              cache_obj=None) -> Tuple[np.ndarray, int, np.ndarray]:
    """One-pass native seeding (collect_matches + collect_seed_hits +
    radix_sort_128x, map.c:90-247): index probe, repeat accounting,
    anchor construction and stable x-sort. skip_mode: 0 none,
    1 forward-only, 2 reverse-only. Returns (anchors (n,2) u64,
    rep_len, mini_pos u64).

    cache_obj: optional object (the index) on which the coerced
    index-array pointers are memoized — the five index planes are
    identical every call, and re-deriving raw pointers costs ~30us/read.
    The cache pins the coerced arrays, so the identity key cannot be
    recycled while the entry is alive."""
    lib = _load()
    mva, mvp = _ptr(mv, np.uint64)
    st = _index_ptrs(keys, start, cnt, lut, pos, cache_obj)
    keep = st[1], st[2]  # noqa: F841  (pin originals + coerced arrays)
    n_keys, kp, sp, cp, lp, pp = st[3]
    out_a = ctypes.POINTER(ctypes.c_uint64)()
    out_m = ctypes.POINTER(ctypes.c_uint64)()
    n_mini = _I64(0)
    rep = _I64(0)
    na = lib.mm2_seed_hits(len(mva), mvp, n_keys, kp, sp, cp, lut_bits,
                           shift, lp, pp, max_occ, qlen, skip_mode,
                           ctypes.byref(out_a), ctypes.byref(out_m),
                           ctypes.byref(n_mini), ctypes.byref(rep))
    # outputs point into per-thread native scratch (valid until this
    # thread's next call): copy out, do NOT free
    if na > 0:
        a = np.empty((na, 2), np.uint64)
        ctypes.memmove(a.ctypes.data, out_a, na * 16)
    else:
        a = np.zeros((0, 2), np.uint64)
    if n_mini.value > 0:
        mini = np.empty(n_mini.value, np.uint64)
        ctypes.memmove(mini.ctypes.data, out_m, n_mini.value * 8)
    else:
        mini = np.zeros(0, np.uint64)
    return a, int(rep.value), mini


def lookup_many(q: np.ndarray, keys: np.ndarray, start: np.ndarray,
                cnt: np.ndarray, lut_bits: int, shift: int,
                lut: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Batched CSR index probe (mm_idx_get, index.c:81-98): LUT + short
    binary search with interleaved prefetch; same contract as
    MMIndex.get_many."""
    lib = _load()
    nq = len(q)
    out_start = np.empty(nq, np.int64)
    out_cnt = np.empty(nq, np.int32)
    qa, qp = _ptr(q, np.uint64)
    ka, kp = _ptr(keys, np.uint64)
    sa, sp = _ptr(start, np.int64)
    ca, cp = _ptr(cnt, np.int32)
    la, lp = _ptr(lut, np.int64)
    lib.mm2_lookup_many(nq, qp, len(ka), kp, sp, cp, lut_bits, shift, lp,
                        out_start.ctypes.data, out_cnt.ctypes.data)
    return out_start, out_cnt


def has_backtrack() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mm2_chain_backtrack")


def chain_backtrack(n: int, f: np.ndarray, p: np.ndarray, v: np.ndarray,
                    a: np.ndarray, min_cnt: int, min_sc: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Native chain.c:348-422; same contract as chain_ref.chain_backtrack."""
    lib = _load()
    fa, fp = _ptr(f, np.int32)
    pa, pp = _ptr(p, np.int32)
    va, vp = _ptr(v, np.int32)
    aa, ap = _ptr(a, np.uint64)
    idx = np.empty(n, np.int64)
    u_out = np.empty(n, np.uint64)
    n_u = _I64(0)
    n_v = lib.mm2_chain_backtrack(n, fp, pp, vp, ap, min_cnt, min_sc,
                                  idx.ctypes.data, u_out.ctypes.data,
                                  ctypes.byref(n_u))
    if n_v == 0:
        return np.zeros((0, 2), np.uint64), np.zeros(0, np.uint64)
    return a[idx[:n_v]], u_out[:n_u.value].copy()


def has_set_parent() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mm2_set_parent_select")


def set_parent_select(score, qs, qe, cnt, rid, rs, re, mask_level: float,
                      mask_len: int, sub_diff: int, hard_mask: bool,
                      pri_ratio: float, min_diff: int, best_n: int):
    """Native pre-align set_parent+select_sub+sync over gen_regs arrays.
    Returns (keep_idx, parent, n_sub, subsc, sam_pri)."""
    lib = _load()
    n = len(score)
    keep = np.empty(n, np.int64)
    parent = np.empty(n, np.int32)
    n_sub = np.empty(n, np.int32)
    subsc = np.empty(n, np.int32)
    sam_pri = np.empty(n, np.uint8)
    ptrs = [_ptr(x, np.int32) for x in (score, qs, qe, cnt, rid, rs, re)]
    n_keep = lib.mm2_set_parent_select(
        n, *[p for _, p in ptrs], ctypes.c_float(mask_level), mask_len,
        sub_diff, 1 if hard_mask else 0, ctypes.c_float(pri_ratio),
        min_diff, best_n, keep.ctypes.data, parent.ctypes.data,
        n_sub.ctypes.data, subsc.ctypes.data, sam_pri.ctypes.data)
    k = int(n_keep)
    return keep[:k], parent[:k], n_sub[:k], subsc[:k], sam_pri[:k]


def gen_regs_arrays(u: np.ndarray, a: np.ndarray, hash_: int, qlen: int):
    """Native mm_gen_regs core; returns the per-region field arrays in
    final (descending tie-broken score) order."""
    lib = _load()
    n_u = len(u)
    ua, up = _ptr(u, np.uint64)
    aa, ap = _ptr(a, np.uint64)
    score = np.empty(n_u, np.int32)
    hash_out = np.empty(n_u, np.uint32)
    cnt = np.empty(n_u, np.int32)
    as_ = np.empty(n_u, np.int64)
    rev = np.empty(n_u, np.uint8)
    rid = np.empty(n_u, np.int32)
    rs = np.empty(n_u, np.int32)
    re = np.empty(n_u, np.int32)
    qs = np.empty(n_u, np.int32)
    qe = np.empty(n_u, np.int32)
    mlen = np.empty(n_u, np.int32)
    blen = np.empty(n_u, np.int32)
    lib.mm2_gen_regs(n_u, up, ap, ctypes.c_uint64(hash_), qlen,
                     *[x.ctypes.data for x in
                       (score, hash_out, cnt, as_, rev, rid, rs, re, qs,
                        qe, mlen, blen)])
    return score, hash_out, cnt, as_, rev, rid, rs, re, qs, qe, mlen, blen


def has_ksw_ll() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mm2_ksw_ll")


def ksw_ll(qlen: int, query: np.ndarray, tlen: int, target: np.ndarray,
           mat: np.ndarray, gapo: int, gape: int):
    """Native striped local SW; same contract (and identical tie behavior)
    as ops/ksw2_ref.ksw_ll. Returns (score, qe, te)."""
    if qlen <= 0 or tlen <= 0:
        return 0, -1, -1
    lib = _load()
    out = np.zeros(3, np.int64)
    qa, qp = _ptr(query, np.uint8)
    ta, tp = _ptr(target, np.uint8)
    ma, mp = _ptr(np.asarray(mat).reshape(-1), np.int8)
    lib.mm2_ksw_ll(qlen, qp, tlen, tp, mp, gapo, gape, out.ctypes.data)
    return int(out[0]), int(out[1]), int(out[2])


def has_exts2() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mm2_ksw_exts2")


def ksw_exts2(qlen: int, query: np.ndarray, tlen: int, target: np.ndarray,
              mat: np.ndarray, q: int, e: int, q2: int, noncan: int,
              zdrop: int, junc_bonus: int, flag: int, junc=None):
    """Native splice extension DP; same contract (and bit-identical
    results) as ops/ksw2_splice_ref.ksw_exts2. Releases the GIL."""
    from ..ops.ksw2_ref import ExtzResult

    lib = _load()
    ez_out = np.zeros(10, np.int64)
    cig_ptr = ctypes.POINTER(ctypes.c_uint32)()
    n_cig = ctypes.c_int32(0)
    qa, qp = _ptr(query, np.uint8)
    ta, tp = _ptr(target, np.uint8)
    ma, mp = _ptr(np.asarray(mat).reshape(-1), np.int8)
    if junc is not None:
        ja, jp = _ptr(junc, np.uint8)
    else:
        ja, jp = None, None
    rc = lib.mm2_ksw_exts2(
        qlen, qp, tlen, tp, mp, q, e, q2, noncan, zdrop, junc_bonus, flag,
        jp, ez_out.ctypes.data, ctypes.byref(cig_ptr), ctypes.byref(n_cig))
    if rc != 0:
        raise MemoryError("mm2_ksw_exts2 allocation failed")
    ez = ExtzResult()
    (ez.max, zd, ez.max_q, ez.max_t, ez.mqe, ez.mqe_t, ez.mte,
     ez.mte_q, ez.score, re_) = ez_out.tolist()
    ez.zdropped = bool(zd)
    ez.reach_end = bool(re_)
    if n_cig.value:
        ez.cigar = np.frombuffer(ctypes.string_at(cig_ptr, 4 * n_cig.value),
                                 np.uint32).tolist()
        lib.mm2_free(cig_ptr)
    return ez


def sketch_xy(codes: np.ndarray, w: int, k: int, rid: int,
              is_hpc: bool):
    """Native minimizer sketch over nt4 codes; returns (x, y) uint64
    arrays (views of the over-allocated buffers — no copy)."""
    lib = _load()
    ca, cp = _ptr(codes, np.uint8)
    cap = max(len(ca), 64)
    x = np.empty(cap, np.uint64)
    y = np.empty(cap, np.uint64)
    n = lib.mm2_sketch(cp, len(ca), w, k, rid, int(is_hpc),
                       x.ctypes.data, y.ctypes.data, cap)
    if n < 0:  # capacity miss (pathological w/k); retry with exact size
        cap = -n
        x = np.empty(cap, np.uint64)
        y = np.empty(cap, np.uint64)
        n = lib.mm2_sketch(cp, len(ca), w, k, rid, int(is_hpc),
                           x.ctypes.data, y.ctypes.data, cap)
    return x[:n], y[:n]


def sketch(codes: np.ndarray, w: int, k: int, rid: int,
           is_hpc: bool) -> np.ndarray:
    """Native minimizer sketch over nt4 codes; returns (n,2) uint64."""
    x, y = sketch_xy(codes, w, k, rid, is_hpc)
    return np.stack([x, y], axis=1)


def has_est_err() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mm2_est_err")


def est_err_div(qlen: int, as_: np.ndarray, cnt: np.ndarray,
                rev: np.ndarray, qs: np.ndarray, rs: np.ndarray,
                re: np.ndarray, l_ref: np.ndarray, a: np.ndarray,
                mini_pos: np.ndarray) -> np.ndarray:
    """mm_est_err divergence (esterr.c:30-64) for all regions of a read
    in one call. Returns float32 div per region (-1 = undefined)."""
    lib = _load()
    n_regs = len(cnt)
    div = np.full(n_regs, -1.0, np.float32)  # C returns early on n_mini==0
    if n_regs == 0:
        return div
    asa, asp = _ptr(as_, np.int64)
    ca, cp = _ptr(cnt, np.int32)
    ra, rp = _ptr(rev, np.uint8)
    qa, qp = _ptr(qs, np.int32)
    rsa, rsp = _ptr(rs, np.int32)
    rea, rep = _ptr(re, np.int32)
    la, lp = _ptr(l_ref, np.int32)
    aa, ap = _ptr(a, np.uint64)
    ma, mp = _ptr(mini_pos, np.uint64)
    lib.mm2_est_err(qlen, n_regs, asp, cp, rp, qp, rsp, rep, lp, ap,
                    len(ma), mp, div.ctypes.data)
    return div


def has_fix_bad_ends() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "mm2_fix_bad_ends")


def fix_bad_ends(a: np.ndarray, as0: int, cnt: int, bw: int,
                 min_match: int, mlen: int) -> Tuple[int, int]:
    """mm_fix_bad_ends (align.c:459-493): end-trim a chain; returns the
    adjusted (as_, cnt)."""
    lib = _load()
    aa, ap = _ptr(a, np.uint64)
    as_out = _I64(0)
    cnt_out = _I64(0)
    lib.mm2_fix_bad_ends(ap, as0, cnt, bw, min_match, mlen,
                         ctypes.byref(as_out), ctypes.byref(cnt_out))
    return int(as_out.value), int(cnt_out.value)


# ---- the port's batch seeding entries (mm2tpu_torch/native/seed_batch.cpp)

def has_seed_batch() -> bool:
    return available() and hasattr(_load(), "mm2t_seed_hits_batch")


def _offsets(counts: np.ndarray) -> np.ndarray:
    off = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    return off


def _take(lib, handle, n_threads: int, *shapes) -> list:
    """The handle's outputs as new uint64 arrays of `shapes`, the handle
    freed whatever happens."""
    if not handle:
        raise MemoryError("the native batch seeding ran out of memory")
    try:
        outs = [np.empty(s, np.uint64) for s in shapes]
    except BaseException:
        lib.mm2t_batch_take(handle, 0, None, None)
        raise
    ptrs = [o.ctypes.data for o in outs] + [None] * (2 - len(outs))
    lib.mm2t_batch_take(handle, n_threads, *ptrs)
    return outs


def sketch_batch(seq: bytes, seg_off: np.ndarray, seg_shift: np.ndarray,
                 read_seg: np.ndarray, w: int, k: int, is_hpc: bool,
                 n_threads: int) -> Tuple[np.ndarray, np.ndarray]:
    """Every read's minimizers, on `n_threads` threads: segment s is
    seq[seg_off[s]:seg_off[s + 1]] (bases, coded as `encode_nt4` codes
    them), sketched with rid = its index in its read and its y raised by
    seg_shift[s]; read r is segments read_seg[r] .. read_seg[r + 1] - 1.
    Returns (mv (n, 2) u64, mv_off): read r's are
    mv[mv_off[r]:mv_off[r + 1]]."""
    lib = _load()
    n_reads = len(read_seg) - 1
    ca, cp = _ptr(np.frombuffer(seq, np.uint8), np.uint8)
    so, sop = _ptr(seg_off, np.int64)
    sh, shp = _ptr(seg_shift, np.uint64)
    rs, rsp = _ptr(read_seg, np.int64)
    n_mv = np.empty(n_reads, np.int64)
    h = lib.mm2t_sketch_batch(cp, sop, shp, rsp, n_reads, w, k, int(is_hpc),
                              n_threads, n_mv.ctypes.data)
    off = _offsets(n_mv)
    mv, = _take(lib, h, n_threads, (int(off[-1]), 2))
    return mv, off


def seed_hits_batch(mv: np.ndarray, mv_off: np.ndarray, qlen: np.ndarray,
                    keys: np.ndarray, start: np.ndarray, cnt: np.ndarray,
                    lut_bits: int, shift: int, lut: np.ndarray,
                    pos: np.ndarray, max_occ: int, skip_mode: int,
                    n_threads: int, cache_obj=None):
    """`seed_hits` of every read of a batch, on `n_threads` threads: read
    r's minimizers are mv[mv_off[r]:mv_off[r + 1]], its query length
    qlen[r]. Returns (anchors (n, 2) u64, anchor offsets, mini_pos u64,
    mini_pos offsets, rep_len int64 a read), read r's anchors being
    anchors[a_off[r]:a_off[r + 1]]; a read without minimizers has none
    and rep_len 0."""
    lib = _load()
    n_reads = len(mv_off) - 1
    mva, mvp = _ptr(mv, np.uint64)
    oa, op = _ptr(mv_off, np.int64)
    qa, qp = _ptr(qlen, np.int64)
    st = _index_ptrs(keys, start, cnt, lut, pos, cache_obj)
    keep = st[1], st[2]  # noqa: F841  (pin originals + coerced arrays)
    n_keys, kp, sp, cp, lp, pp = st[3]
    n_a, n_mini, rep = (np.empty(n_reads, np.int64) for _ in range(3))
    h = lib.mm2t_seed_hits_batch(
        mvp, op, n_reads, qp, n_keys, kp, sp, cp, lut_bits, shift, lp, pp,
        max_occ, skip_mode, n_threads, n_a.ctypes.data, n_mini.ctypes.data,
        rep.ctypes.data)
    a_off, m_off = _offsets(n_a), _offsets(n_mini)
    a, mini = _take(lib, h, n_threads, (int(a_off[-1]), 2),
                    int(m_off[-1]))
    return a, a_off, mini, m_off, rep
