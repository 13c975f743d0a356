"""Build `csrc/*.cu` with nvcc for sm_90a and bind it with ctypes.

The shared library has a plain C interface (no PyTorch headers), so the
build takes seconds. It goes to `build/mm2tpu_torch/` at the repository
root, named by a hash of the sources and flags, and is built at first
use. A failed build raises with nvcc's stderr; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mm2tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# what the last build printed (the ptxas register/shared-memory report);
# None when the library came from the build directory
build_log = None


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


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    global build_log
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    so = BUILD_DIR / ("libmm2tpu_torch_%s.so" % h.hexdigest()[:16])
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(so.name + ".%d.tmp" % os.getpid())
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError("nvcc failed (rc=%d): %s\n%s" % (
                r.returncode, " ".join(cmd), r.stderr))
        build_log = r.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mm2tpu_chain_v3.argtypes = [vp] * 7 + [i32] * 6 + [
        ctypes.c_float, i32, vp]
    lib.mm2tpu_chain_v3.restype = i32
    return lib
