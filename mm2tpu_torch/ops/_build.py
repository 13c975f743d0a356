"""Build `csrc/*.cu` with nvcc for sm_90a and bind it with ctypes.

The shared library has a plain C interface (no PyTorch headers), so the
build takes seconds. It goes to `build/mm2tpu_torch/` at the repository
root, named by a hash of the sources and flags, and is built at first
use: one nvcc process per source, all started together, then one link.
A failed build raises with nvcc's stderr; nothing falls back. The first
build runs under a lock, so threads that reach `load()` together (the
stream mode's mapping threads, its warm-up thread) build once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mm2tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

# what the last build printed (the ptxas register/shared-memory report);
# None when the library came from the build directory
build_log = None

_LOCK = threading.Lock()
_LIB = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels of mm2tpu_torch are built from "
                       "source at first use")


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library, once per
    process."""
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                _LIB = _build_and_load()
    return _LIB


def loaded() -> bool:
    """True once `load()` has returned, checked without starting it."""
    return _LIB is not None


def _build_and_load() -> ctypes.CDLL:
    global build_log
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    so = BUILD_DIR / ("libmm2tpu_torch_%s.so" % h.hexdigest()[:16])
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = "%s.%d" % (h.hexdigest()[:16], os.getpid())
        nvcc = _nvcc()
        objs = [BUILD_DIR / ("%s.%s.o" % (s.stem, tag)) for s in srcs]
        jobs = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                for s, o in zip(srcs, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in jobs]
        logs = []
        for cmd, pr in zip(jobs, procs):
            _, err = pr.communicate()
            if pr.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError("nvcc failed (rc=%d): %s\n%s" % (
                    pr.returncode, " ".join(cmd), err))
            logs.append(err)
        tmp = so.with_name(so.name + ".%d.tmp" % os.getpid())
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        for o in objs:
            o.unlink(missing_ok=True)
        if r.returncode != 0:
            raise RuntimeError("nvcc link failed (rc=%d): %s\n%s" % (
                r.returncode, " ".join(cmd), r.stderr))
        build_log = "".join(logs)
        os.replace(tmp, so)
    return bind(ctypes.CDLL(str(so)))


def build_variants(src: str, define: str, values, out_dir: Path,
                   tag: str) -> dict:
    """Build `csrc/<src>` alone into `out_dir` once for each value of the
    macro `define` (one nvcc per value, all started together), print each
    build's ptxas register and spill lines prefixed with `[tag]`, and
    return {value: bound library}. For scripts that compare builds."""
    nvcc = _nvcc()
    sos = {v: out_dir / ("lib%s_%s.so" % (Path(src).stem, v))
           for v in values}
    procs = {v: subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-D%s=%s" % (define, v), "-shared", "-o",
         str(so), str(CSRC / src)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for v, so in sos.items()}
    libs = {}
    for v, pr in procs.items():
        _, err = pr.communicate()
        if pr.returncode != 0:
            for other in procs.values():
                other.kill()
                other.wait()
            raise RuntimeError("nvcc failed for %s=%s:\n%s" % (define, v,
                                                                 err))
        for ln in err.splitlines():
            if "registers" in ln or "spill" in ln:
                print("[%s] %s=%s, ptxas: %s" % (tag, define, v, ln.strip()),
                      flush=True)
        libs[v] = bind(ctypes.CDLL(str(sos[v])))
    return libs


_vp, _i32 = ctypes.c_void_p, ctypes.c_int
# the C entry points of csrc/*.cu: argument types (all return an int32
# cudaError_t)
SIGNATURES = {
    "mm2tpu_chain_v3": [_vp] * 8 + [_i32] * 6 + [ctypes.c_float, _i32, _vp],
    "mm2tpu_chain_v2": [_vp] * 9 + [_i32] * 6 + [ctypes.c_float, _i32, _i32,
                                                 _i32, _i32, _vp],
    "mm2tpu_ksw2_extd2": [_vp] * 10 + [_i32] * 20 + [_vp],
    "mm2tpu_ksw2_exts2": [_vp] * 12 + [_i32] * 17 + [_vp],
    "mm2tpu_seed_probe": [_vp] * 3 + [_i32] * 2 + [_vp, _i32] + [_vp] * 3,
    "mm2tpu_seed_workspace": [_i32] * 5 + [_vp] * 2,
    "mm2tpu_seed_anchors": [_vp] * 3 + [_i32] * 2 + [_vp] * 5 + [_i32] * 6
    + [_vp, ctypes.c_longlong] + [_vp] * 7,
}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Give each entry point of SIGNATURES that `lib` exports its
    argument and return types."""
    for name, argtypes in SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _i32
    return lib
