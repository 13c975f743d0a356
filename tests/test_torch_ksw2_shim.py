"""What the CPU tests of the port's CUDA sources share (the two ksw2
kernels K3, csrc/ksw2_extd2.cu, and K4, csrc/ksw2_exts2.cu, in the ksw2
tests; the chaining kernel K1/K2, csrc/chain.cu, in
tests/test_torch_chain_shim.py; the seeding kernels K5/K6, csrc/seed.cu,
in tests/test_torch_seed_device.py), with tests of its own:

- `CUDA_SHIM` and `build_on_cpu`: a CPU stand-in for the CUDA that the
  kernels use, so that g++ builds a kernel's own source here and ctypes
  binds its C entry point with the signature ops/_build.py gives it;
- `one_torch_thread`: runs the plain versions beside it on one torch
  thread (their tensors are small, and a pool of threads slows tenfold
  when other processes load the cores);
- `ring_check`: a replay of a kernel's accesses to its shared-memory ring
  of row state (column t at slot t mod W), which returns the first read
  that would find another column's value, or None."""
import contextlib
import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from mm2tpu_torch.ops import _build

# One fiber per CUDA thread on the calling thread (so the tests' time does
# not depend on what else runs on the machine), blocks in series, a
# barrier for __syncthreads and for the two halves of a warp reduction or
# shuffle, a static array for the dynamic shared memory, and the integer
# and float intrinsics of the chaining and seeding kernels.
CUDA_SHIM = r"""
#pragma once
#include <setjmp.h>
#include <ucontext.h>
#include <algorithm>
#include <chrono>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <numeric>
#include <random>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x) alignas(x)
#define __shared__ static
struct dim3_ { int x = 0; };
inline dim3_ threadIdx, blockIdx;  // the running fiber's
struct alignas(8) int2 { int x, y; };
inline int2 make_int2(int a, int b) { return int2{a, b}; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline int __clz(int v) {
  return v == 0 ? 32 : __builtin_clz(static_cast<unsigned>(v));
}
inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, sizeof i);
  return i;
}
inline float __int2float_rn(int v) { return static_cast<float>(v); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline int __float2int_rz(float f) {  // saturating, NaN -> 0, as on the card
  if (f != f) return 0;
  if (f >= 2147483648.0f) return INT_MAX;
  if (f <= -2147483648.0f) return INT_MIN;
  return static_cast<int>(f);
}
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess;
}
// Each CUDA thread of a block is a fiber on the calling thread; a fiber
// runs until it waits at a barrier, and the scheduler resumes the fibers
// in a new seeded random order on every pass. Each warp sits a pass out
// with probability kSitOut%, so that a warp can fall several of its own
// barriers behind the others (a race that needs a slow warp shows). 64
// passes in a row in which no fiber reached a barrier or its end are a
// deadlock (threads waiting at different barriers): the launch stops and
// reports an error.
constexpr int kSitOut = 50;
enum { cudaErrorLaunchFailure = 719 };
inline int g_error = cudaSuccess;
inline unsigned long g_progress;
inline cudaError_t cudaGetLastError() {
  const int e = g_error;
  g_error = cudaSuccess;
  return e;
}
// A fiber starts on its own stack through makecontext/swapcontext; after
// that every switch is a _setjmp/_longjmp pair, which saves no signal mask
// (swapcontext makes a system call for it on every switch).
struct Fiber {
  ucontext_t ctx;
  jmp_buf jb;
  std::vector<char> stack;
  bool started = false, done = false;
};
inline std::vector<Fiber>* g_fibers;
inline ucontext_t g_sched;
inline jmp_buf g_sched_jb;
inline int g_cur;
inline const std::function<void()>* g_body;
inline void shim_yield() {
  if (!_setjmp((*g_fibers)[g_cur].jb)) _longjmp(g_sched_jb, 1);
}
struct Barrier {
  int n, count = 0;
  unsigned long gen = 0;
  void arrive_and_wait() {
    const unsigned long g = gen;
    ++g_progress;
    if (++count == n) {
      count = 0;
      ++gen;
    } else {
      while (gen == g) shim_yield();
    }
  }
};
inline Barrier* g_bar;
inline Barrier* g_warp_bar;
inline int g_warp_buf[32][32];
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline int __reduce_max_sync(unsigned, int v) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  g_warp_buf[w][lane] = v;
  g_warp_bar[w].arrive_and_wait();
  int m = v;
  for (int k = 0; k < 32; ++k) m = std::max(m, g_warp_buf[w][k]);
  g_warp_bar[w].arrive_and_wait();
  return m;
}
inline int __shfl_up_sync(unsigned, int v, unsigned delta) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  g_warp_buf[w][lane] = v;
  g_warp_bar[w].arrive_and_wait();
  const int u = lane >= static_cast<int>(delta) ? g_warp_buf[w][lane - delta]
                                                : v;
  g_warp_bar[w].arrive_and_wait();
  return u;
}
inline unsigned long long shim_timer() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
      std::chrono::steady_clock::now().time_since_epoch()).count();
}
inline void shim_fiber() {
  (*g_body)();
  ++g_progress;
  (*g_fibers)[g_cur].done = true;
  _longjmp(g_sched_jb, 1);
}
inline void shim_launch(int nb, int nt, const std::function<void()>& f) {
  g_body = &f;
  std::mt19937 rng(12345);
  for (int b = 0; b < nb; ++b) {
    std::vector<Fiber> fibers(nt);
    g_fibers = &fibers;
    Barrier bar{nt};
    g_bar = &bar;
    std::vector<Barrier> warps(nt / 32, Barrier{32});
    g_warp_bar = warps.data();
    for (auto& fb : fibers) {
      fb.stack.resize(1 << 17);
      getcontext(&fb.ctx);
      fb.ctx.uc_stack.ss_sp = fb.stack.data();
      fb.ctx.uc_stack.ss_size = fb.stack.size();
      fb.ctx.uc_link = nullptr;
      makecontext(&fb.ctx, shim_fiber, 0);
    }
    std::vector<int> order(nt);
    std::iota(order.begin(), order.end(), 0);
    std::vector<char> out((nt + 31) / 32);
    for (int left = nt, idle = 0; left > 0;) {
      const unsigned long before = g_progress;
      std::shuffle(order.begin(), order.end(), rng);
      for (auto& o : out) o = static_cast<int>(rng() % 100) < kSitOut;
      for (int t : order) {
        if (fibers[t].done || out[t >> 5]) continue;
        g_cur = t;
        threadIdx.x = t;
        blockIdx.x = b;
        if (!_setjmp(g_sched_jb)) {
          if (fibers[t].started) _longjmp(fibers[t].jb, 1);
          fibers[t].started = true;
          swapcontext(&g_sched, &fibers[t].ctx);
        }
        if (fibers[t].done) --left;
      }
      idle = g_progress == before ? idle + 1 : 0;
      if (left > 0 && idle >= 64) {
        g_error = cudaErrorLaunchFailure;
        return;
      }
    }
  }
}
"""


def build_on_cpu(src: str, out_dir: Path, defines=(),
                 stamped=True) -> ctypes.CDLL:
    """Build CUDA source text `src` (kernels, or templates of them, each
    launched as `name<<<grid, threads, smem, stream>>>(...)` with a name
    or a literal for each of the first three arguments; when `stamped`, with exactly one declaration of
    the dynamic shared memory `dsmem` and one `%globaltimer` stamp line,
    else with neither) with g++ against CUDA_SHIM into `out_dir`, load it
    and bind its entry points as ops/_build.py does."""
    assert src.count("#include <cuda_runtime.h>") == 1
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_shim.h"')
    for old, new in (
            ("extern __shared__ __align__(16) unsigned char dsmem[];",
             "alignas(16) static unsigned char dsmem[232448];"),
            ('asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));',
             "t = shim_timer();")):
        assert src.count(old) == int(stamped), old
        src = src.replace(old, new)
    src, n = re.subn(
        r"(\w+(?:<\w+>)?)<<<(\w+), (\w+), \w+, stream>>>\(([^;]*)\);",
        r"shim_launch(\2, \3, [&]() { \1(\4); });", src)
    assert n >= 1
    (out_dir / "cuda_shim.h").write_text(CUDA_SHIM)
    (out_dir / "k.cpp").write_text(src)
    so = out_dir / "libkernel_shim.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-fno-strict-aliasing",
                    "-ffp-contract=off", "-U_FORTIFY_SOURCE",
                    *("-D" + d for d in defines), "-shared", "-fPIC",
                    "-o", str(so), str(out_dir / "k.cpp")],
                   check=True, cwd=out_dir)
    return _build.bind(ctypes.CDLL(str(so)))


@contextlib.contextmanager
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def ring_check(spans, W, carry_h=False):
    """Replay the ring accesses of csrc/ksw2_exts2.cu (or, with carry_h,
    csrc/ksw2_extd2.cu) for one fill on a ring of W slots (column t at t
    mod W) and return the first fault, or None. `spans` = (st0, en0, st,
    en, fe, hi) of each row the fill computes. Arrays: the DP state
    ("uv": u, v, x, y, x2 (, y2)) and the H row of the exact max in two
    generations (row r reads generation r mod 2, written by row r-1, and
    writes the other; during row r the control warp reads row r-1's H at
    its en0 and st0, and its u and v inside its [st0, en0] for the H0
    walk) and the score row s. With carry_h the cell at st0 copies H at
    st0-1 from the old generation to the new. For every row r:
      - a column read from the ring holds that column's last write: its
        slot's last writer is the same column (for the DP state and H,
        row r-1);
      - the columns read in row r and the columns written to the same
        array in rows r-1 and r never share a slot unless they are the
        same column;
      - a column read by rule (the DP state above the previous row's en,
        s above the largest column any row refreshed) was written by no
        earlier row, so device memory would still hold the initial value
        the kernel takes instead; H is never read by rule."""
    st0, en0, st, en, fe, hi = (np.asarray(a).tolist() for a in spans)
    ever = {"uv": set(), "s": set(), "H": set()}
    last = {}          # (array, generation, slot) -> (column, row)
    prev_st = prev_en = sfront = -1
    wrote_prev = {}
    for r in range(len(st)):
        g_old, g_new = r % 2, (r + 1) % 2
        cols = list(range(st[r], en[r] + 1))
        reads, rule = [], []
        covered = st[r] > 0 and prev_st <= st[r] - 1 <= prev_en
        tm1 = ([st[r] - 1] if covered else []) + [t - 1 for t in cols[1:]]
        for c in cols + tm1:
            (rule if c > prev_en else reads).append(("uv", g_old, c))
        stale = [c for c in cols if not st0[r] <= c < fe[r]]
        for c in stale:
            (rule if c > sfront else reads).append(("s", 0, c))
        hw = list(range(st0[r], en0[r] + 1))
        if r > 0:
            # the cells of [st0, en0), the seed (H at en0-1, or at 0 when
            # en0 is 0) and the control warp (row r-1's en0 and st0, and
            # its u and v for the H0 walk)
            hcols = list(range(st0[r], en0[r])) + [max(en0[r] - 1, 0)] + \
                [en0[r - 1], st0[r - 1]]
            if carry_h and st0[r] > 0:
                hcols.append(st0[r] - 1)
                hw.append(st0[r] - 1)
            reads += [("H", g_old, c) for c in hcols]
            reads += [("uv", g_old, c)
                      for c in range(st0[r - 1], en0[r - 1] + 1)]
        writes = [("uv", g_new, c) for c in cols] + \
            [("s", 0, c) for c in range(st0[r], fe[r])] + \
            [("H", g_new, c) for c in hw]
        for a, g, c in rule:
            if c in ever[a]:
                return "row %d: %s column %d read by rule, but written" % (
                    r, a, c)
        for a, g, c in reads:
            if c not in ever[a]:
                return "row %d: %s column %d read, never written" % (r, a, c)
            col, row = last.get((a, g, c % W), (None, None))
            if col != c or (a != "s" and row != r - 1):
                return "row %d: %s column %d finds column %s of row %s" % (
                    r, a, c, col, row)
        slots = {}
        for a, g, c in writes + list(wrote_prev.get(r - 1, [])):
            slots.setdefault((a, g, c % W), set()).add(c)
        for a, g, c in reads:
            if slots.get((a, g, c % W), {c}) != {c}:
                return "row %d: %s column %d shares a slot with %s" % (
                    r, a, c, sorted(slots[(a, g, c % W)]))
        for a, g, c in writes:
            ever[a].add(c)
            last[(a, g, c % W)] = (c, r)
        wrote_prev = {r: writes}
        prev_st, prev_en = st[r], en[r]
        sfront = max(sfront, fe[r] - 1)
    return None


SHIM_PROBE = r"""
#include <cuda_runtime.h>
namespace {
__global__ void probe(const int* in, int* out, int hang) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  int* buf = reinterpret_cast<int*>(dsmem);
  const int tid = threadIdx.x;
  buf[tid] = in[blockIdx.x * THREADS + tid];
  if (hang && tid == 5) return;  // the others wait for it forever
  __syncthreads();
  // each thread reads its mirror image, written by another thread
  const int v = buf[THREADS - 1 - tid];
  const int m = __reduce_max_sync(0xffffffffu, v);
  if ((tid & 31) == 0) out[blockIdx.x * (THREADS / 32) + (tid >> 5)] = m;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
}
}  // namespace
extern "C" cudaError_t probe_launch(const void* in, void* out, int B,
                                    int hang, cudaStream_t stream) {
  const int smem = 4 * THREADS;
  probe<<<B, THREADS, smem, stream>>>(static_cast<const int*>(in),
                                      static_cast<int*>(out), hang);
  return cudaGetLastError();
}
"""


def test_stand_in_runs_barriers_and_warp_max(tmp_path):
    """The stand-in runs every block, makes writes before __syncthreads
    visible after it, gives each warp the max of its 32 lanes, and
    reports a launch whose threads can never all meet at a barrier as
    an error instead of hanging."""
    lib = build_on_cpu(SHIM_PROBE, tmp_path, ("THREADS=96",))
    lib.probe_launch.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    rng = np.random.default_rng(88)
    x = rng.integers(-1000, 1000, (3, 96)).astype(np.int32)
    out = np.zeros((3, 3), np.int32)
    assert lib.probe_launch(x.ctypes.data, out.ctypes.data, 3, 0, None) == 0
    np.testing.assert_array_equal(out, x[:, ::-1].reshape(3, 3, 32).max(2))
    assert lib.probe_launch(x.ctypes.data, out.ctypes.data, 1, 1, None) \
        == 719
    assert lib.probe_launch(x.ctypes.data, out.ctypes.data, 1, 0, None) == 0


def test_ring_check_finds_a_column_that_another_overwrote():
    """Hand-made rows whose two-column band slides one column a row: a
    ring of 2 slots holds them, 1 does not; and a band one column wide
    rereads H at en0-1 a row after the row that wrote it, which only the
    carried H holds."""
    rows = 6
    st0 = np.arange(rows)
    en0 = st0 + 1
    spans = (st0, en0, st0, en0, en0 + 1, en0)
    assert ring_check(spans, 2) is None
    assert "finds column 1" in ring_check(spans, 1)
    # a band one column wide: the seed at en0 rereads H at en0-1, which
    # only a carried H holds
    one = np.array([0, 1, 1, 1])
    narrow = (one, one, np.zeros(4, int), np.full(4, 15), one + 16,
              np.array([15, 16, 16, 16]))
    assert ring_check(narrow, 32, carry_h=True) is None
    assert "finds column" in ring_check(narrow, 32)
