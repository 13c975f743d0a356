// Anchor-chaining DP for Hopper (sm_90a), bounded 1024-anchor lookback.
//
// Replaces the TPU kernel mm2tpu/ops/chain_pallas_v3.py::_chain_kernel_v3
// (launched by chain_scores_device_v3), together with the uniseg branch of
// mm2tpu/ops/chain_pallas_v2.py::_pair_key and ::_ilog2_tile that it calls.
// Its output is bit-identical to that kernel's.
//
// Contract, for task row b and anchor i < N (all int32, (B, N) row-major):
//   candidates j = i - d, d in [1, min(cap, i)], cap = min(iter_cap, 1024),
//   with hi[j] == hi[i] and, for dr = lo[i]-lo[j], dq = qi[i]-qi[j]:
//     max_dist_x <= max_dist_y:  1 <= min(dr,dq), max(dr,dq) <= max_dist_x
//     otherwise:                 dr <= max_dist_x, dr != 0, 0 < dq,
//                                dq <= min(max_dist_x, max_dist_y)
//     and dd = |dr - dq| <= bw.
//   sc  = min(dr, dq, span[i]) - gap + f[j],
//   gap = int(f32(dd) * avg) + (ilog2(dd) >> 1),
//         then int(f32(gap) * gap_scale + 0.499f) when gap_scale != 1.
//   key = sc * 1024 + (1024 - d): the max key picks the best score, and
//   ties go to the smallest d (the largest j). With best_sc = key >> 10,
//   f[i] = best_sc and p[i] = i - d if best_sc > span[i], else f[i] =
//   span[i] and p[i] = -1. Pad cells (a never-matching hi sentinel,
//   lo = qi = span = 0) come out as f = 0, p = -1.
//
// What bounds it on the H100: the DP is a chain of N dependent steps per
// task (f[i] needs the f of the 1024 anchors before it), and one launch
// carries at most 128 tasks, so at most 128 warps are in flight on 132
// SMs. Each step reads up to 1024 candidates x 16 B from shared memory;
// device memory sees only 24 B per anchor. The kernel is latency-bound.
//
// Design: one warp per task, with no block barrier. The last 1024 anchors'
// (hi, lo, qi, f) sit in a shared-memory ring of 16 KB per warp; each lane
// scores every 32nd candidate, a 5-step __shfl_xor_sync max reduces the
// packed key, and the lane that owns anchor i writes it into the ring.
// Anchors are loaded, and f/p stored, 32 at a time with coalesced accesses.
//
// Parity: int32 arithmetic wraps as in XLA (done in unsigned). The float
// products use __fmul_rn/__fadd_rn so nvcc cannot contract them into FMA,
// and __float2int_rz truncates like a float->int32 convert. ilog2 is
// 31 - clz(dd) for dd > 0 and 0 otherwise, which equals _ilog2_tile.
#include <cuda_runtime.h>

namespace {

constexpr int WINDOW = 1024;
constexpr int WARPS = 2;  // tasks per block: 2 x 16 KB of static shared memory
constexpr int NEG = -0x20000000;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int ilog2(int v) { return v > 0 ? 31 - __clz(v) : 0; }

__global__ void __launch_bounds__(32 * WARPS)
chain_v3_kernel(const int* __restrict__ hi, const int* __restrict__ lo,
                const int* __restrict__ qi, const int* __restrict__ span,
                const float* __restrict__ avg, int* __restrict__ f_out,
                int* __restrict__ p_out, int B, int N, int max_dist_x,
                int max_dist_y, int bw, int cap, float gap_scale,
                int use_gap_scale) {
  __shared__ int ring_hi[WARPS][WINDOW];
  __shared__ int ring_lo[WARPS][WINDOW];
  __shared__ int ring_qi[WARPS][WINDOW];
  __shared__ int ring_f[WARPS][WINDOW];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // whole warp leaves together

  int* rh = ring_hi[warp];
  int* rl = ring_lo[warp];
  int* rq = ring_qi[warp];
  int* rf = ring_f[warp];
  const size_t row = static_cast<size_t>(b) * N;
  const float a = avg[b];
  const bool fast = max_dist_x <= max_dist_y;
  const int max_dq = min(max_dist_x, max_dist_y);

  for (int base = 0; base < N; base += 32) {
    const int my_hi = hi[row + base + lane];
    const int my_lo = lo[row + base + lane];
    const int my_qi = qi[row + base + lane];
    const int my_span = span[row + base + lane];
    int my_f = 0, my_p = -1;

    for (int s = 0; s < 32; ++s) {
      const int i = base + s;
      const int hi_i = __shfl_sync(FULL, my_hi, s);
      const int lo_i = __shfl_sync(FULL, my_lo, s);
      const int qi_i = __shfl_sync(FULL, my_qi, s);
      const int span_i = __shfl_sync(FULL, my_span, s);
      const int dmax = min(cap, i);

      int best = NEG;
      for (int d = lane + 1; d <= dmax; d += 32) {
        const int slot = (i - d) & (WINDOW - 1);
        if (rh[slot] != hi_i) continue;
        const int dr = wsub(lo_i, rl[slot]);
        const int dq = wsub(qi_i, rq[slot]);
        int dd, min3;
        if (fast) {
          const int lohi = max(dr, dq);
          const int lolo = min(dr, dq);
          if (lolo < 1 || lohi > max_dist_x) continue;
          dd = wsub(lohi, lolo);
          min3 = min(lolo, span_i);
        } else {
          if (dr > max_dist_x || dr == 0 || dq <= 0 || dq > max_dq) continue;
          const int diff = wsub(dr, dq);
          dd = diff < 0 ? wsub(0, diff) : diff;  // |INT_MIN| stays INT_MIN
          min3 = min(min(dq, dr), span_i);
        }
        if (dd > bw) continue;
        int gap = __float2int_rz(__fmul_rn(__int2float_rn(dd), a)) +
                  (ilog2(dd) >> 1);
        if (use_gap_scale)
          gap = __float2int_rz(
              __fadd_rn(__fmul_rn(__int2float_rn(gap), gap_scale), 0.499f));
        const int sc = wadd(wsub(min3, gap), rf[slot]);
        const int key = wadd(static_cast<int>(static_cast<unsigned>(sc) * WINDOW),
                             WINDOW - d);
        best = max(best, key);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        best = max(best, __shfl_xor_sync(FULL, best, o));

      const int best_sc = best >> 10;
      const int best_d = WINDOW - (best & (WINDOW - 1));
      const bool better = best_sc > span_i;
      const int f_i = better ? best_sc : span_i;
      if (lane == s) {
        // slot i & 1023 held j = i - 1024, which every lane has read by now
        // (its loads fed the shuffles above)
        my_f = f_i;
        my_p = better ? i - best_d : -1;
        const int slot = i & (WINDOW - 1);
        rh[slot] = hi_i;
        rl[slot] = lo_i;
        rq[slot] = qi_i;
        rf[slot] = f_i;
      }
      __syncwarp();
    }
    f_out[row + base + lane] = my_f;
    p_out[row + base + lane] = my_p;
  }
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (cudaSuccess = 0).
// B >= 1 task rows of N anchors, N a multiple of 32 (the wrapper demands
// a multiple of 1024). cap = min(iter_cap, 1024).
extern "C" cudaError_t mm2tpu_chain_v3(const void* hi, const void* lo,
                                       const void* qi, const void* span,
                                       const void* avg, void* f, void* p,
                                       int B, int N, int max_dist_x,
                                       int max_dist_y, int bw, int cap,
                                       float gap_scale, int use_gap_scale,
                                       cudaStream_t stream) {
  if (B < 1 || N < 32 || N % 32 != 0 || cap > WINDOW)
    return cudaErrorInvalidValue;
  const dim3 grid((B + WARPS - 1) / WARPS);
  chain_v3_kernel<<<grid, 32 * WARPS, 0, stream>>>(
      static_cast<const int*>(hi), static_cast<const int*>(lo),
      static_cast<const int*>(qi), static_cast<const int*>(span),
      static_cast<const float*>(avg), static_cast<int*>(f),
      static_cast<int*>(p), B, N, max_dist_x, max_dist_y, bw, cap, gap_scale,
      use_gap_scale);
  return cudaGetLastError();
}
