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
//   ties go to the smallest d (the largest j). In int32, as the Pallas
//   kernels hold it, the key is exact while sc * 1024 + 1024 fits, that
//   is sc <= 2^21 - 2 (KEY_SCORE_MAX), and wraps without an error past
//   it. A task's span sum bounds its scores (a step adds at most
//   span[i]), so each block sums its row's spans first: a row whose sum
//   is at most KEY_SCORE_MAX runs on the int32 key, bit for bit the
//   Pallas kernel's; a row over it runs the same DP on an int64 key,
//   which does not wrap and gives chain_ref.chain_scores_window's f and p
//   (the Pallas kernels' scores wrap there).
//   With best_sc = key >> 10, f[i] = best_sc and p[i] = i - d if best_sc >
//   span[i], else f[i] = span[i] and p[i] = -1. Pad cells (a never-matching
//   hi sentinel, lo = qi = span = sid = 0) come out as f = 0, p = -1.
//
// The Pallas K2 resolves the dependencies inside a chunk of 8 anchors with
// a max-plus closure of the 8x8 pair keys, which keeps the first hop's
// (1024 - d) bits: it equals this serial scan, key for key.
//
// Row n[b] and past it. The kernel reads n[b] (clamped to [0, N]) and runs
// the DP for i < n[b] only; every i >= n[b] gets f = span[i], p = -1, with
// no step. That is what the DP gives there when the row's tail is
// pack_tasks16's pad, which the callers guarantee: pad against pad fails
// the dr/dq gates of every contract (dr = dq = 0), a real anchor against a
// pad fails hi (the pad's hi is the sentinel -0x7FFFFF0). So a launch costs
// sum(n) steps, not B x N, and an empty row only its tail stores. Before
// its steps a block sums span[0..n) (one coalesced pass and a block
// reduction) to pick the key's width.
//
// What bounds it on the H100: a task is a chain of n dependent steps (f[i]
// needs the f of the 1024 anchors before it). A step is up to 1024
// candidates of ~32 (K1) or ~45 (K2) int32 instructions, a max over them and
// the hand-over of f[i] to the next step: issue and latency on one SM, not
// bytes (device memory sees 24 B, 28 B for K2, an anchor). A launch carries
// at most 128 tasks, so at most 128 of the 132 SMs work.
//
// Design: one block of CHAIN_THREADS threads (1024 by default) per task,
// one task per SM.
//   - The window lives in registers. Slot s (0..1023) holds the newest
//     anchor j < i with j = s mod 1024; thread t owns slots t, t + T, ...
//     (T = CHAIN_THREADS) and keeps each one's hi, lo, qi and f (K2: sid) in
//     registers. At step i slot s is at distance d = ((i-1-s) & 1023) + 1
//     and is a candidate iff d <= min(cap, i). Consecutive j sit in one warp,
//     so a run of candidates the gates reject idles whole warps.
//   - The anchors come through shared memory: 1024 at a time, loaded
//     coalesced (16 KB, 20 KB for K2) between two barriers; every thread
//     reads anchor i + 1 by broadcast before barrier i. f and p of the tile
//     are staged there too and stored coalesced once the tile is done.
//   - One barrier a step. Each thread takes the max key over its slots, the
//     warp's max is one __reduce_max_sync, and lane 0 writes it to
//     part[i & 1][warp]. After __syncthreads() the warp that owns slot
//     i & 1023 reduces the partials; its owner lane writes f[i], p[i] into
//     the tile and anchor i (with f[i]) into the slot's registers, and goes
//     on to step i + 1. The other warps go on at once: step i + 1 needs only
//     slots they own and the anchor tile.
//   - The int64 key (rows over KEY_SCORE_MAX) reduces a warp by five
//     __shfl_xor_sync rounds in place of one __reduce_max_sync, and its
//     partials take 8 B; the rest of the step is the int32 one's.
//   - Two partial buffers are enough: a warp writes part[(i + 1) & 1] only
//     after it has passed barrier i. Every read of the step-(i - 1)
//     partials, which live in that same buffer, was made by the owner warp
//     of step i - 1 before it arrived at barrier i. With one buffer a warp
//     could overwrite a partial that the owner warp of step i has not read.
//
// Parity: int32 arithmetic wraps as in XLA (done in unsigned). The float
// products use __fmul_rn/__fadd_rn so nvcc cannot contract them into FMA,
// and __float2int_rz truncates like a float->int32 convert. For K1, ilog2
// is 31 - clz(dd) for dd > 0 and 0 otherwise, which equals _ilog2_tile on
// every candidate its gates let through (0 <= dd <= bw). K2 lets
// cross-segment candidates through with any dd, so it computes
// _ilog2_tile's own way: the f32 exponent of dd when max(max_dist_x,
// max_dist_y, bw) + 1 < 2^24 (exact_log == 0), else 31 - clz. Keys of
// distinct d never tie, so the order of the max reduction does not matter.
#include <cuda_runtime.h>

#ifndef CHAIN_THREADS
#define CHAIN_THREADS 1024
#endif

namespace {

constexpr int WINDOW = 1024;
constexpr int THREADS = CHAIN_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int SLOTS = WINDOW / THREADS;  // window slots a thread owns
constexpr int TILE = 1024;               // anchors staged at a time
constexpr int NEG = -0x20000000;
constexpr unsigned FULL = 0xffffffffu;
// the largest score whose int32 key sc * 1024 + 1024 fits: 2^21 - 2
constexpr long long KEY_SCORE_MAX = (0x7fffffffLL - WINDOW) / WINDOW;
static_assert(THREADS % 32 == 0 && THREADS >= 32 && WINDOW % THREADS == 0,
              "CHAIN_THREADS: a multiple of 32 that divides 1024");

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

struct Params {
  int max_dist_x, max_dist_y, bw, cap;
  float gap_scale;
  int use_gap_scale, exact_log;
};

__device__ __forceinline__ int warp_max(int v) {
  return __reduce_max_sync(FULL, v);
}

__device__ __forceinline__ long long warp_max(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// The key (int32 or int64) of candidate j at distance d for anchor i, or
// NEG where a gate rejects it.
template <int kContract, typename Key>
__device__ __forceinline__ Key pair_key(const Params& P, float a, int d,
                                        int hi_j, int lo_j, int qi_j, int f_j,
                                        int sid_j, int hi_i, int lo_i,
                                        int qi_i, int span_i, int sid_i) {
  constexpr bool kCdna = kContract == CDNA || kContract == CDNA_MULTISEG;
  constexpr bool kMultisegGate = kContract == MULTISEG;
  if (hi_j != hi_i) return NEG;
  const int dr = wsub(lo_i, lo_j);
  const int dq = wsub(qi_i, qi_j);
  int gap, base_sc;
  if constexpr (kContract == UNISEG) {
    int dd;
    if (P.max_dist_x <= P.max_dist_y) {
      const int lohi = max(dr, dq);
      const int lolo = min(dr, dq);
      if (lolo < 1 || lohi > P.max_dist_x) return NEG;
      dd = wsub(lohi, lolo);
      base_sc = min(lolo, span_i);
    } else {
      if (dr > P.max_dist_x || dr == 0 || dq <= 0 ||
          dq > min(P.max_dist_x, P.max_dist_y))
        return NEG;
      const int diff = wsub(dr, dq);
      dd = diff < 0 ? wsub(0, diff) : diff;  // |INT_MIN| stays INT_MIN
      base_sc = min(min(dq, dr), span_i);
    }
    if (dd > P.bw) return NEG;
    gap = wadd(__float2int_rz(__fmul_rn(__int2float_rn(dd), a)),
               ilog2(dd) >> 1);
  } else {
    const bool same = sid_j == sid_i;
    if (dr > P.max_dist_x || dq <= 0 || dq > P.max_dist_x) return NEG;
    if (same && (dr == 0 || dq > P.max_dist_y)) return NEG;
    const int diff = wsub(dr, dq);
    const int dd = diff < 0 ? wsub(0, diff) : diff;
    if (same && dd > P.bw) return NEG;
    if (kMultisegGate && same && dr > P.max_dist_y) return NEG;
    const int log_dd = P.exact_log ? ilog2(dd) : ilog2_f32(dd);
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
  if (P.use_gap_scale) gap = scale_gap(gap, P.gap_scale);
  const int sc = wadd(wsub(base_sc, gap), f_j);
  if constexpr (sizeof(Key) == 4)
    return wadd(static_cast<int>(static_cast<unsigned>(sc) * WINDOW),
                WINDOW - d);
  else
    return static_cast<long long>(sc) * WINDOW + (WINDOW - d);
}

// The DP of one task row (block) on a Key of int32 or int64: the tiles up
// to n, then the stores past them. `part` is the kernel's partial buffer
// as Key[2][WARPS].
template <int kContract, typename Key>
__device__ __forceinline__ void chain_row(
    const int* const (&planes)[5], const int* __restrict__ span,
    int* __restrict__ f_out, int* __restrict__ p_out, size_t row, int n,
    int N, float a, const Params& P, int (*tile)[TILE], int* tile_f,
    int* tile_p, Key (*part)[WARPS]) {
  constexpr bool kUniseg = kContract == UNISEG;
  constexpr int kFields = kUniseg ? 4 : 5;  // hi, lo, qi, span (, sid)
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the window slots tid + k * THREADS; a slot is read only once the step
  // of its anchor has written it (d <= i)
  int s_hi[SLOTS], s_lo[SLOTS], s_qi[SLOTS], s_f[SLOTS], s_sid[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k)
    s_hi[k] = s_lo[k] = s_qi[k] = s_f[k] = s_sid[k] = 0;

  for (int base = 0; base < n; base += TILE) {
    // each thread loads (and below stores) only its own tile indices, and
    // every read of the last tile ended before the barrier after its steps
    for (int t = tid; t < TILE && base + t < N; t += THREADS)
#pragma unroll
      for (int c = 0; c < kFields; ++c) tile[c][t] = planes[c][row + base + t];
    __syncthreads();
    const int end = min(n - base, TILE);
    int next[kFields];  // the next step's anchor
#pragma unroll
    for (int c = 0; c < kFields; ++c) next[c] = tile[c][0];
    for (int s = 0; s < end; ++s) {
      const int i = base + s;
      const int hi_i = next[0];
      const int lo_i = next[1];
      const int qi_i = next[2];
      const int span_i = next[3];
      const int sid_i = kUniseg ? 0 : next[kFields - 1];
      const int dmax = min(P.cap, i);
      Key best = NEG;
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        const int d = ((i - 1 - (tid + k * THREADS)) & (WINDOW - 1)) + 1;
        if (d <= dmax)
          best = max(best, pair_key<kContract, Key>(
                               P, a, d, s_hi[k], s_lo[k], s_qi[k], s_f[k],
                               s_sid[k], hi_i, lo_i, qi_i, span_i, sid_i));
      }
      best = warp_max(best);
      if (lane == 0) part[i & 1][warp] = best;
      // anchor i + 1, read before the barrier so that no warp waits on
      // shared memory after it (past the tile's end it is never used)
#pragma unroll
      for (int c = 0; c < kFields; ++c) next[c] = tile[c][min(s + 1, TILE - 1)];
      __syncthreads();
      const int own = i & (WINDOW - 1);
      if (warp == (own % THREADS) >> 5) {
        const Key m = warp_max(lane < WARPS ? part[i & 1][lane] : Key(NEG));
        if (lane == (own & 31)) {
          const int best_sc = static_cast<int>(m >> 10);
          const bool better = best_sc > span_i;
          const int f_i = better ? best_sc : span_i;
          tile_f[s] = f_i;
          tile_p[s] = better ? i - (WINDOW - static_cast<int>(
                                                 m & (WINDOW - 1)))
                             : -1;
          // slot own held j = i - 1024, which only this thread reads
#pragma unroll
          for (int k = 0; k < SLOTS; ++k)
            if (k == own / THREADS) {
              s_hi[k] = hi_i;
              s_lo[k] = lo_i;
              s_qi[k] = qi_i;
              s_f[k] = f_i;
              s_sid[k] = sid_i;
            }
        }
      }
    }
    __syncthreads();
    for (int t = tid; t < TILE && base + t < N; t += THREADS) {
      const bool dp = t < end;
      f_out[row + base + t] = dp ? tile_f[t] : tile[3][t];
      p_out[row + base + t] = dp ? tile_p[t] : -1;
    }
  }
  // the tiles past n: no step
  for (int i = (n + TILE - 1) / TILE * TILE + tid; i < N; i += THREADS) {
    f_out[row + i] = span[row + i];
    p_out[row + i] = -1;
  }
}

template <int kContract>
__global__ void __launch_bounds__(THREADS, 1)
chain_kernel(const int* __restrict__ hi, const int* __restrict__ lo,
             const int* __restrict__ qi, const int* __restrict__ span,
             const int* __restrict__ sid, const int* __restrict__ n_rows,
             const float* __restrict__ avg, int* __restrict__ f_out,
             int* __restrict__ p_out, int N, Params P) {
  constexpr int kFields = kContract == UNISEG ? 4 : 5;
  __shared__ int tile[kFields][TILE];
  __shared__ int tile_f[TILE];
  __shared__ int tile_p[TILE];
  __shared__ long long part[2][WARPS];  // Key[2][WARPS] for either Key

  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * N;
  const int n = min(max(n_rows[blockIdx.x], 0), N);
  const float a = avg[blockIdx.x];
  const int* const planes[5] = {hi, lo, qi, span, sid};

  // the row's span sum, which bounds its scores: the key's width
  long long bound = 0;
  for (int t = tid; t < n; t += THREADS) bound += span[row + t];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) bound += __shfl_xor_sync(FULL, bound, o);
  if ((tid & 31) == 0) part[0][tid >> 5] = bound;
  __syncthreads();
  bound = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) bound += part[0][w];
  __syncthreads();  // part is the steps' from here

  if (bound > KEY_SCORE_MAX)
    chain_row<kContract, long long>(planes, span, f_out, p_out, row, n, N,
                                    a, P, tile, tile_f, tile_p, part);
  else
    chain_row<kContract, int>(planes, span, f_out, p_out, row, n, N, a, P,
                              tile, tile_f, tile_p,
                              reinterpret_cast<int (*)[WARPS]>(part));
}

template <int kContract>
cudaError_t launch(const void* hi, const void* lo, const void* qi,
                   const void* span, const void* sid, const void* n,
                   const void* avg, void* f, void* p, int B, int N,
                   const Params& P, cudaStream_t stream) {
  chain_kernel<kContract><<<B, THREADS, 0, stream>>>(
      static_cast<const int*>(hi), static_cast<const int*>(lo),
      static_cast<const int*>(qi), static_cast<const int*>(span),
      static_cast<const int*>(sid), static_cast<const int*>(n),
      static_cast<const float*>(avg), static_cast<int*>(f),
      static_cast<int*>(p), N, P);
  return cudaGetLastError();
}

bool bad_shape(int B, int N, int cap) {
  return B < 1 || N < 32 || N % 32 != 0 || cap > WINDOW;
}

}  // namespace

// K1. Launch on `stream`; returns the launch's cudaError_t (cudaSuccess =
// 0). B >= 1 task rows of N anchors, N a multiple of 32 (the wrapper
// demands a multiple of 1024); n: B int32 row lengths, each row past its n
// pack_tasks16's pad. cap = min(iter_cap, 1024).
extern "C" cudaError_t mm2tpu_chain_v3(const void* hi, const void* lo,
                                       const void* qi, const void* span,
                                       const void* n, const void* avg,
                                       void* f, void* p, int B, int N,
                                       int max_dist_x, int max_dist_y, int bw,
                                       int cap, float gap_scale,
                                       int use_gap_scale,
                                       cudaStream_t stream) {
  if (bad_shape(B, N, cap)) return cudaErrorInvalidValue;
  const Params P{max_dist_x, max_dist_y, bw, cap, gap_scale, use_gap_scale,
                 1};
  return launch<UNISEG>(hi, lo, qi, span, nullptr, n, avg, f, p, B, N, P,
                        stream);
}

// K2: the general contract (is_cdna or n_segs > 1; the uniseg contract is
// refused, it is K1's). As mm2tpu_chain_v3, plus the sid plane; exact_log
// is 1 when max(max_dist_x, max_dist_y, bw) + 1 >= 2^24.
extern "C" cudaError_t mm2tpu_chain_v2(const void* hi, const void* lo,
                                       const void* qi, const void* span,
                                       const void* sid, const void* n,
                                       const void* avg, void* f, void* p,
                                       int B, int N, int max_dist_x,
                                       int max_dist_y, int bw, int cap,
                                       float gap_scale, int use_gap_scale,
                                       int exact_log, int is_cdna, int n_segs,
                                       cudaStream_t stream) {
  if (bad_shape(B, N, cap) || n_segs < 1 || (!is_cdna && n_segs == 1))
    return cudaErrorInvalidValue;
  const Params P{max_dist_x, max_dist_y, bw, cap, gap_scale, use_gap_scale,
                 exact_log};
  const auto run = !is_cdna     ? &launch<MULTISEG>
                   : n_segs > 1 ? &launch<CDNA_MULTISEG>
                                : &launch<CDNA>;
  return run(hi, lo, qi, span, sid, n, avg, f, p, B, N, P, stream);
}
