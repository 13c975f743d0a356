// Device seeding for Hopper (sm_90a): the index probe and the anchor build.
//
// Replaces the device code of the JAX package's --seed-backend tpu:
//   K5  mm2tpu/parallel/mesh.py::lookup_index_device (called by
//       mm2tpu/ops/seed_device.py::probe_counts and seed_chain_device): a
//       binary search of each query minimizer hash in the sorted CSR keys
//       of the index, returning (start, cnt), cnt = 0 on a miss. Entry
//       point mm2tpu_seed_probe.
//   K6  the front half of mm2tpu/ops/seed_device.py::seed_chain_device:
//       the hits of the minimizers with cnt < mid_occ expanded into
//       anchors, slot by slot, in slot order (minimizer, then hit in pos).
//       Entry point mm2tpu_seed_build. The stable sort by x that follows,
//       and the chaining on K1, are the callers' (ops/seed_device.py).
//
// Contract of K5, for query i < n_queries (int64 hashes, keys sorted and
// >= 0, so int64 order is the uint64 order of minimizer hashes below
// 2^56): j = the first index with keys[j] >= q[i]; if j < n_keys and
// keys[j] == q[i], (start, cnt)[i] = (start[j], cnt[j]), else (0, 0). A
// padded query (-1) never matches.
//
// Contract of K6, for row b of B (all (B, M) int32 row-major: start and
// cnt from K5, qpos = lastpos<<1 | strand, qyhi = span | TANDEM<<10; qlen
// (B,) int32; pos int64 = rid<<32 | rpos<<1 | strand): kept counts c[m] =
// cnt[m] if cnt[m] < mid_occ else 0, total = sum c, and slot s < total
// belongs to the minimizer m with C[m-1] <= s < C[m] (C the inclusive
// prefix sum), hit k = s - C[m-1], r = pos[start[m] + k]. With forward =
// (r & 1) == (qpos[m] & 1), qe = qpos[m] >> 1 and span = qyhi[m] & 0xFF:
//   x = (forward ? 0 : 1<<63) | (r >> 32)<<32 | (r & 0xFFFFFFFF) >> 1
//   y_pos = forward ? qe : qlen - (qe + 1 - span) - 1
//   key[s] = x ^ (1<<63) (signed order = unsigned order of x)
//   y[s] = qyhi[m]<<32 | y_pos
// for s < min(total, N); key = INT64_MAX and y = 0 for total <= s < N;
// n[b] = total (unclamped: the caller sizes N >= total and checks).
//
// What bounds them on the H100. K5: a query is ~log2(n_keys) dependent
// loads (23 for a 48 Mb genome's ~6M keys), each a 32-byte sector of a
// key array of tens of MB: latency, with ~a hundred thousand queries a
// launch in flight to cover it; the first levels of every search read
// the same few keys, which stay in L2. One thread a query, no shared
// memory. K6: the bytes, 16 B written a slot plus the 8 B pos gather; the
// hazard is balance, since a minimizer owns 0 to mid_occ - 1 slots. So
// one block a row walks its minimizers in tiles of THREADS: a block-wide
// scan of the tile's kept counts (warp shuffles, then the warps' sums) into
// shared memory, the tile's start/qpos/qyhi staged beside it, and then
// each thread fills one slot at a time and finds its minimizer by a binary
// search of the tile's scanned counts in shared memory (log2(THREADS)
// steps), the JAX package's per-slot search restricted to the tile. Every
// thread does equal work whatever the hit counts, and the scanned counts
// never need more than a tile of shared memory, whatever M is.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int PROBE_THREADS = 256;
#ifndef SEED_THREADS
#define SEED_THREADS 512
#endif
constexpr int THREADS = SEED_THREADS;  // K6: threads a block, and the tile
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS % 32 == 0 && WARPS <= 32, "one warp scans the sums");

__global__ void __launch_bounds__(PROBE_THREADS)
    seed_probe(const long long* __restrict__ keys,
               const int* __restrict__ start, const int* __restrict__ cnt,
               int n_keys, const long long* __restrict__ q, int n_queries,
               int* __restrict__ s_out, int* __restrict__ c_out) {
  const int i = blockIdx.x * PROBE_THREADS + threadIdx.x;
  if (i >= n_queries) return;
  const long long v = __ldg(q + i);
  int lo = 0, len = n_keys;
  while (len > 0) {  // lower bound, without a branch in the body
    const int half = len >> 1;
    const bool less = __ldg(keys + lo + half) < v;
    lo = less ? lo + half + 1 : lo;
    len = less ? len - half - 1 : half;
  }
  const bool hit = lo < n_keys && __ldg(keys + lo) == v;
  s_out[i] = hit ? __ldg(start + lo) : 0;
  c_out[i] = hit ? __ldg(cnt + lo) : 0;
}

// Inclusive scan of v over the 32 lanes of a warp.
__device__ __forceinline__ int warp_scan(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(THREADS)
    seed_build(const int* __restrict__ start, const int* __restrict__ cnt,
               const int* __restrict__ qpos, const int* __restrict__ qyhi,
               const int* __restrict__ qlen,
               const long long* __restrict__ pos, long long* __restrict__ key,
               long long* __restrict__ y, int* __restrict__ n_out, int M,
               int N, int mid_occ) {
  __shared__ int cum[THREADS];  // inclusive prefix sum of the kept counts
  __shared__ int t_start[THREADS], t_qpos[THREADS], t_qyhi[THREADS];
  __shared__ int warp_sum[WARPS];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const long long row_m = static_cast<long long>(blockIdx.x) * M;
  const long long row_n = static_cast<long long>(blockIdx.x) * N;
  const long long ql = qlen[blockIdx.x];
  int base = 0;  // the slots of the tiles before this one
  for (int m0 = 0; m0 < M; m0 += THREADS) {
    const int m = m0 + t;
    int c = 0;
    if (m < M) {
      c = cnt[row_m + m];
      if (c >= mid_occ) c = 0;
      t_start[t] = start[row_m + m];
      t_qpos[t] = qpos[row_m + m];
      t_qyhi[t] = qyhi[row_m + m];
    }
    int v = warp_scan(c, lane);
    if (lane == 31) warp_sum[w] = v;
    __syncthreads();
    if (w == 0) {
      const int s = warp_scan(lane < WARPS ? warp_sum[lane] : 0, lane);
      if (lane < WARPS) warp_sum[lane] = s;
    }
    __syncthreads();
    if (w > 0) v += warp_sum[w - 1];
    cum[t] = v;
    __syncthreads();
    const int tile = cum[THREADS - 1];
    const int end = min(tile, N - base);
    for (int s = t; s < end; s += THREADS) {
      int lo = 0, hi = THREADS - 1;  // the first j with cum[j] > s
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cum[mid] > s)
          hi = mid;
        else
          lo = mid + 1;
      }
      const int k = s - (lo > 0 ? cum[lo - 1] : 0);
      const long long r = __ldg(pos + t_start[lo] + k);
      const int mp = t_qpos[lo];
      const long long yh = t_qyhi[lo];
      const bool forward = static_cast<int>(r & 1) == (mp & 1);
      const long long qe = mp >> 1;
      const long long y_pos = forward ? qe : ql - (qe + 1 - (yh & 0xFF)) - 1;
      unsigned long long x =
          (static_cast<unsigned long long>(r >> 32) << 32) |
          static_cast<unsigned long long>((r & 0xFFFFFFFFLL) >> 1);
      if (!forward) x |= 1ULL << 63;
      key[row_n + base + s] = static_cast<long long>(x ^ (1ULL << 63));
      y[row_n + base + s] = (yh << 32) | (y_pos & 0xFFFFFFFFLL);
    }
    base += tile;
    __syncthreads();  // the next tile overwrites cum and the staged planes
  }
  for (int s = min(base, N) + t; s < N; s += THREADS) {
    key[row_n + s] = LLONG_MAX;
    y[row_n + s] = 0;
  }
  if (t == 0) n_out[blockIdx.x] = base;
}

}  // namespace

// K5. Launch on `stream`; returns the launch's cudaError_t (cudaSuccess =
// 0). keys: n_keys sorted int64 (>= 0); start, cnt: n_keys int32; q:
// n_queries int64; s_out, c_out: n_queries int32.
extern "C" cudaError_t mm2tpu_seed_probe(const void* keys, const void* start,
                                         const void* cnt, int n_keys,
                                         const void* q, int n_queries,
                                         void* s_out, void* c_out,
                                         cudaStream_t stream) {
  if (n_keys < 0 || n_queries < 1) return cudaErrorInvalidValue;
  const int grid = (n_queries + PROBE_THREADS - 1) / PROBE_THREADS;
  seed_probe<<<grid, PROBE_THREADS, 0, stream>>>(
      static_cast<const long long*>(keys), static_cast<const int*>(start),
      static_cast<const int*>(cnt), n_keys, static_cast<const long long*>(q),
      n_queries, static_cast<int*>(s_out), static_cast<int*>(c_out));
  return cudaGetLastError();
}

// K6. Launch on `stream` (one block a row); returns the launch's
// cudaError_t. start, cnt, qpos, qyhi: (B, M) int32; qlen: B int32; pos:
// int64; key, y: (B, N) int64 out; n: B int32 out.
extern "C" cudaError_t mm2tpu_seed_build(const void* start, const void* cnt,
                                         const void* qpos, const void* qyhi,
                                         const void* qlen, const void* pos,
                                         void* key, void* y, void* n, int B,
                                         int M, int N, int mid_occ,
                                         cudaStream_t stream) {
  if (B < 1 || M < 1 || N < 1) return cudaErrorInvalidValue;
  seed_build<<<B, THREADS, 0, stream>>>(
      static_cast<const int*>(start), static_cast<const int*>(cnt),
      static_cast<const int*>(qpos), static_cast<const int*>(qyhi),
      static_cast<const int*>(qlen), static_cast<const long long*>(pos),
      static_cast<long long*>(key), static_cast<long long*>(y),
      static_cast<int*>(n), M, N, mid_occ);
  return cudaGetLastError();
}
