// Anchor-chaining DP for Hopper (sm_90a), bounded 1024-anchor lookback, for
// both chaining contracts of the JAX package.
//
// Replaces two TPU kernels, each bit for bit:
//   K1  mm2tpu/ops/chain_pallas_v3.py::_chain_kernel_v3 (launched by
//       chain_scores_device_v3): single-segment, non-cDNA tasks, with the
//       uniseg branch of mm2tpu/ops/chain_pallas_v2.py::_pair_key and
//       ::_ilog2_tile. Entry point mm2tpu_chain_v3.
//   K2  mm2tpu/ops/chain_pallas_v2.py::_chain_kernel_v2 (launched by
//       chain_scores_device_v2) on every other task: the general branch of
//       _pair_key, with multi-segment gates and the pair bonus of paired
//       reads (n_segs > 1) and the cDNA gap cost of spliced reads
//       (is_cdna). Entry point mm2tpu_chain_v2.
// One kernel template serves both, specialised on the contract: UNISEG (K1),
// MULTISEG, CDNA and CDNA_MULTISEG (K2).
//
// Contract, for task row b and anchor i < N (all int32, (B, N) row-major):
// candidates j = i - d, d in [1, min(cap, i)], cap = min(iter_cap, 1024),
// with hi[j] == hi[i], dr = lo[i]-lo[j], dq = qi[i]-qi[j] and dd = |dr - dq|.
//   UNISEG (K1):
//     max_dist_x <= max_dist_y:  1 <= min(dr,dq), max(dr,dq) <= max_dist_x
//     otherwise:                 dr <= max_dist_x, dr != 0, 0 < dq,
//                                dq <= min(max_dist_x, max_dist_y)
//     and dd <= bw; gap = lin = int(f32(dd) * avg) + (ilog2(dd) >> 1);
//     sc = min(dr, dq, span[i]) - gap + f[j].
//   General (K2), same = (sid[j] == sid[i]):
//     dr <= max_dist_x; not (same && dr == 0); dq > 0;
//     not (same && dq > max_dist_y); dq <= max_dist_x; not (same && dd > bw);
//     for MULTISEG only (not CDNA_MULTISEG): not (same && dr > max_dist_y).
//     in_branch = is_cdna || !same; pair_bonus = !same && dr == 0.
//     In the branch: gap = 0 with the pair bonus (and min3 + 1), else
//     min(c_lin, log_dd) when dr > dq || !same, else lin; out of it,
//     gap = lin. (c_lin = int(f32(dd) * avg), log_dd = ilog2(dd), and
//     log_dd is not halved inside the min.) sc = base - gap + f[j] with
//     base = min(dq, dr, span[i]) (+1 with the pair bonus).
//   Both: gap = int(f32(gap) * gap_scale + 0.499f) when gap_scale != 1.
//   key = sc * 1024 + (1024 - d): the max key picks the best score, and
//   ties go to the smallest d (the largest j); |sc| < 2^20 keeps it exact.
//   With best_sc = key >> 10, f[i] = best_sc and p[i] = i - d if best_sc >
//   span[i], else f[i] = span[i] and p[i] = -1. Pad cells (a never-matching
//   hi sentinel, lo = qi = span = sid = 0) come out as f = 0, p = -1.
//
// The Pallas K2 resolves the dependencies inside a chunk of 8 anchors with
// a max-plus closure of the 8x8 pair keys, which keeps the first hop's
// (1024 - d) bits: it equals this serial scan, key for key.
//
// What bounds it on the H100: the DP is a chain of N dependent steps per
// task (f[i] needs the f of the 1024 anchors before it), and one launch
// carries at most 128 tasks, so at most 128 warps are in flight on 132
// SMs. Each step reads up to 1024 candidates x 16 B (20 B for K2) from
// shared memory; device memory sees only 24 B (28 B) per anchor. The kernel
// is latency-bound.
//
// Design: one warp per task, with no block barrier. The last 1024 anchors'
// (hi, lo, qi, f), and for K2 their sid, sit in a shared-memory ring of
// 16 KB (20 KB) per warp, 2 warps a block: 40 KB of static shared memory at
// most, under the 48 KB static limit. Each lane scores every 32nd
// candidate, a 5-step __shfl_xor_sync max reduces the packed key, and the
// lane that owns anchor i writes it into the ring. Anchors are loaded, and
// f/p stored, 32 at a time with coalesced accesses.
//
// Parity: int32 arithmetic wraps as in XLA (done in unsigned). The float
// products use __fmul_rn/__fadd_rn so nvcc cannot contract them into FMA,
// and __float2int_rz truncates like a float->int32 convert. For K1, ilog2
// is 31 - clz(dd) for dd > 0 and 0 otherwise, which equals _ilog2_tile on
// every candidate its gates let through (0 <= dd <= bw). K2 lets
// cross-segment candidates through with any dd, so it computes
// _ilog2_tile's own way: the f32 exponent of dd when max(max_dist_x,
// max_dist_y, bw) + 1 < 2^24 (exact_log == 0), else 31 - clz.
#include <cuda_runtime.h>

namespace {

constexpr int WINDOW = 1024;
constexpr int WARPS = 2;  // tasks per block
constexpr int NEG = -0x20000000;
constexpr unsigned FULL = 0xffffffffu;

enum Contract { UNISEG = 0, MULTISEG = 1, CDNA = 2, CDNA_MULTISEG = 3 };

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int ilog2(int v) { return v > 0 ? 31 - __clz(v) : 0; }

// _ilog2_tile's exponent trick: floor(log2(f32(v))) for v > 0, else 0
__device__ __forceinline__ int ilog2_f32(int v) {
  return max((__float_as_int(__int2float_rn(v)) >> 23) - 127, 0);
}

__device__ __forceinline__ int scale_gap(int gap, float gap_scale) {
  return __float2int_rz(
      __fadd_rn(__fmul_rn(__int2float_rn(gap), gap_scale), 0.499f));
}

template <int kContract>
__global__ void __launch_bounds__(32 * WARPS)
chain_kernel(const int* __restrict__ hi, const int* __restrict__ lo,
             const int* __restrict__ qi, const int* __restrict__ span,
             const int* __restrict__ sid, const float* __restrict__ avg,
             int* __restrict__ f_out, int* __restrict__ p_out, int B, int N,
             int max_dist_x, int max_dist_y, int bw, int cap, float gap_scale,
             int use_gap_scale, int exact_log) {
  constexpr bool kUniseg = kContract == UNISEG;
  constexpr bool kCdna = kContract == CDNA || kContract == CDNA_MULTISEG;
  constexpr bool kMultisegGate = kContract == MULTISEG;
  constexpr int kFields = kUniseg ? 4 : 5;  // hi, lo, qi, f (, sid)
  __shared__ int ring[WARPS][kFields][WINDOW];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;  // whole warp leaves together

  int* rh = ring[warp][0];
  int* rl = ring[warp][1];
  int* rq = ring[warp][2];
  int* rf = ring[warp][3];
  int* rs = ring[warp][kFields - 1];  // the sid ring (K2 only)
  const size_t row = static_cast<size_t>(b) * N;
  const float a = avg[b];
  const bool fast = max_dist_x <= max_dist_y;
  const int max_dq = min(max_dist_x, max_dist_y);

  for (int base = 0; base < N; base += 32) {
    const int my_hi = hi[row + base + lane];
    const int my_lo = lo[row + base + lane];
    const int my_qi = qi[row + base + lane];
    const int my_span = span[row + base + lane];
    const int my_sid = kUniseg ? 0 : sid[row + base + lane];
    int my_f = 0, my_p = -1;

    for (int s = 0; s < 32; ++s) {
      const int i = base + s;
      const int hi_i = __shfl_sync(FULL, my_hi, s);
      const int lo_i = __shfl_sync(FULL, my_lo, s);
      const int qi_i = __shfl_sync(FULL, my_qi, s);
      const int span_i = __shfl_sync(FULL, my_span, s);
      const int sid_i = kUniseg ? 0 : __shfl_sync(FULL, my_sid, s);
      const int dmax = min(cap, i);

      int best = NEG;
      for (int d = lane + 1; d <= dmax; d += 32) {
        const int slot = (i - d) & (WINDOW - 1);
        if (rh[slot] != hi_i) continue;
        const int dr = wsub(lo_i, rl[slot]);
        const int dq = wsub(qi_i, rq[slot]);
        int gap, base_sc;
        if constexpr (kUniseg) {
          int dd;
          if (fast) {
            const int lohi = max(dr, dq);
            const int lolo = min(dr, dq);
            if (lolo < 1 || lohi > max_dist_x) continue;
            dd = wsub(lohi, lolo);
            base_sc = min(lolo, span_i);
          } else {
            if (dr > max_dist_x || dr == 0 || dq <= 0 || dq > max_dq) continue;
            const int diff = wsub(dr, dq);
            dd = diff < 0 ? wsub(0, diff) : diff;  // |INT_MIN| stays INT_MIN
            base_sc = min(min(dq, dr), span_i);
          }
          if (dd > bw) continue;
          gap = wadd(__float2int_rz(__fmul_rn(__int2float_rn(dd), a)),
                     ilog2(dd) >> 1);
        } else {
          const bool same = rs[slot] == sid_i;
          if (dr > max_dist_x || dq <= 0 || dq > max_dist_x) continue;
          if (same && (dr == 0 || dq > max_dist_y)) continue;
          const int diff = wsub(dr, dq);
          const int dd = diff < 0 ? wsub(0, diff) : diff;
          if (same && dd > bw) continue;
          if (kMultisegGate && same && dr > max_dist_y) continue;
          const int log_dd = exact_log ? ilog2(dd) : ilog2_f32(dd);
          const int c_lin = __float2int_rz(__fmul_rn(__int2float_rn(dd), a));
          const int lin = wadd(c_lin, log_dd >> 1);
          base_sc = min(min(dq, dr), span_i);
          if (kCdna || !same) {  // in_branch
            if (!same && dr == 0) {  // pair bonus
              gap = 0;
              base_sc = wadd(base_sc, 1);
            } else {
              gap = (dr > dq || !same) ? min(c_lin, log_dd) : lin;
            }
          } else {
            gap = lin;
          }
        }
        if (use_gap_scale) gap = scale_gap(gap, gap_scale);
        const int sc = wadd(wsub(base_sc, gap), rf[slot]);
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
        if constexpr (!kUniseg) rs[slot] = sid_i;
      }
      __syncwarp();
    }
    f_out[row + base + lane] = my_f;
    p_out[row + base + lane] = my_p;
  }
}

template <int kContract>
cudaError_t launch(const void* hi, const void* lo, const void* qi,
                   const void* span, const void* sid, const void* avg, void* f,
                   void* p, int B, int N, int max_dist_x, int max_dist_y,
                   int bw, int cap, float gap_scale, int use_gap_scale,
                   int exact_log, cudaStream_t stream) {
  const dim3 grid((B + WARPS - 1) / WARPS);
  chain_kernel<kContract><<<grid, 32 * WARPS, 0, stream>>>(
      static_cast<const int*>(hi), static_cast<const int*>(lo),
      static_cast<const int*>(qi), static_cast<const int*>(span),
      static_cast<const int*>(sid), static_cast<const float*>(avg),
      static_cast<int*>(f), static_cast<int*>(p), B, N, max_dist_x,
      max_dist_y, bw, cap, gap_scale, use_gap_scale, exact_log);
  return cudaGetLastError();
}

bool bad_shape(int B, int N, int cap) {
  return B < 1 || N < 32 || N % 32 != 0 || cap > WINDOW;
}

}  // namespace

// K1. Launch on `stream`; returns the launch's cudaError_t (cudaSuccess =
// 0). B >= 1 task rows of N anchors, N a multiple of 32 (the wrapper
// demands a multiple of 1024). cap = min(iter_cap, 1024).
extern "C" cudaError_t mm2tpu_chain_v3(const void* hi, const void* lo,
                                       const void* qi, const void* span,
                                       const void* avg, void* f, void* p,
                                       int B, int N, int max_dist_x,
                                       int max_dist_y, int bw, int cap,
                                       float gap_scale, int use_gap_scale,
                                       cudaStream_t stream) {
  if (bad_shape(B, N, cap)) return cudaErrorInvalidValue;
  return launch<UNISEG>(hi, lo, qi, span, nullptr, avg, f, p, B, N,
                        max_dist_x, max_dist_y, bw, cap, gap_scale,
                        use_gap_scale, 1, stream);
}

// K2: the general contract (is_cdna or n_segs > 1; the uniseg contract is
// refused, it is K1's). As mm2tpu_chain_v3, plus the sid plane; exact_log
// is 1 when max(max_dist_x, max_dist_y, bw) + 1 >= 2^24.
extern "C" cudaError_t mm2tpu_chain_v2(const void* hi, const void* lo,
                                       const void* qi, const void* span,
                                       const void* sid, const void* avg,
                                       void* f, void* p, int B, int N,
                                       int max_dist_x, int max_dist_y, int bw,
                                       int cap, float gap_scale,
                                       int use_gap_scale, int exact_log,
                                       int is_cdna, int n_segs,
                                       cudaStream_t stream) {
  if (bad_shape(B, N, cap) || n_segs < 1 || (!is_cdna && n_segs == 1))
    return cudaErrorInvalidValue;
  const auto run = !is_cdna     ? &launch<MULTISEG>
                   : n_segs > 1 ? &launch<CDNA_MULTISEG>
                                : &launch<CDNA>;
  return run(hi, lo, qi, span, sid, avg, f, p, B, N, max_dist_x, max_dist_y,
             bw, cap, gap_scale, use_gap_scale, exact_log, stream);
}
