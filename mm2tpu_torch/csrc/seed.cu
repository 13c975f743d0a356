// Device seeding for Hopper (sm_90a): the index probe and the anchor
// pipeline (probe, count, expand, sort) that feeds the chaining kernel.
//
// Replaces the device code of the JAX package's --seed-backend tpu:
//   K5  mm2tpu/parallel/mesh.py::lookup_index_device (called by
//       mm2tpu/ops/seed_device.py::probe_counts and seed_chain_device):
//       (start, cnt) of each query minimizer hash in the sorted CSR keys
//       of the index, cnt = 0 on a miss. Entry point mm2tpu_seed_probe.
//   K6  the front half of mm2tpu/ops/seed_device.py::seed_chain_device:
//       the probe again, the hits of the minimizers with cnt < mid_occ
//       expanded into anchors, the anchors of each row sorted stably by x
//       and laid out as the chaining kernel's planes. Entry point
//       mm2tpu_seed_anchors; the chaining on K1 is the caller's.
//
// Contract of K5, for query i (int64 hashes, keys sorted, >= 0 below the
// pads): if keys[j] == q[i] for some j, (start, cnt)[i] = sc[j], else
// (0, 0). A padded query (< 0) never matches.
//
// Contract of K6, for row b of B (q (B, M) int64; qpos = lastpos<<1 |
// strand and qyhi = span | TANDEM<<10, (B, M) int32; qlen (B,) int32; pos
// int64 = rid<<32 | rpos<<1 | strand): the K5 hit (start, cnt) of each
// minimizer m, its kept count c[m] = cnt < mid_occ ? cnt : 0, and slot s <
// n[b] = sum c (unclamped: the caller sizes N and checks) owned by the
// minimizer with C[m-1] <= s < C[m] (C the inclusive prefix sum), hit k =
// s - C[m-1], r = pos[start[m] + k]. With forward = (r & 1) == (qpos[m] &
// 1), qe = qpos[m] >> 1, span = qyhi[m] & 0xFF:
//   x = (forward ? 0 : 1<<63) | (r >> 32)<<32 | (r & 0xFFFFFFFF) >> 1
//   y = qyhi[m]<<32 | (forward ? qe : qlen - (qe + 1 - span) - 1)
// The slots s < min(n[b], N) sorted stably by x (equal x keep slot order)
// go to the chaining planes: hi = x >> 32, lo = x & 0xFFFFFFFF, qi = y &
// 0xFFFFFFFF, yhi = y >> 32 (int16), span = yhi & 0xFF; (B, N) int32 but
// yhi. Past min(n[b], N): pack_tasks16's pad (hi = PAD_HI, the rest 0).
//
// The bucket table. Both kernels find a key through the index's table of
// 2^bits buckets on the key's top bits (the host index's native LUT,
// index/build.py::_native_lut): bucket = min(key >> shift, 2^bits - 1),
// lut[bkt] .. lut[bkt + 1] the keys of the bucket. A query goes to its
// bucket by the same rule, so a key equal to it lies in that range, and
// the range is searched (binary steps down to SCAN keys, then those keys
// compared at once). With ~1.6 keys a bucket at 2^22 buckets that is
// three dependent loads: the bucket's two offsets, its keys (one or two
// 32-byte sectors) and, on a hit, (start, cnt) as one 8-byte load of the
// interleaved sc plane. A skewed bucket of thousands of keys is still
// right: it takes log2 of its size in binary steps.
//
// What bounds them on the H100. K5: latency, three dependent loads a
// query into tens of MB that L2 does not hold; one thread a query, no
// shared memory. K6 is bytes (minimizer planes in, 8 B of pos an anchor,
// 18 B of planes a slot out) at small sizes (~66k anchors in a dispatch
// of 786k slots), so its time is the chain of launches and the fill of
// the card, not the bytes. The pipeline, each a launch on the stream:
//   (a) seed_count, one block a (row, tile of THREADS minimizers): the
//       K5 probe, the kept counts and their block-wide scan; each
//       minimizer's (start, inclusive count in its tile) and each tile's
//       total.
//   (b) seed_offsets, one block: each row's n, each row's offset in one
//       flat array of the real slots (min(n, N) a row), and each tile's
//       first slot there; zeroes the sort's histograms and tickets.
//   (c) seed_expand: a fixed grid (BLOCKS_PER_SM a multiprocessor, no
//       more than B * N slots need) strides over ranges of SLOTS flat
//       slots up to the real total the card computed in (b), so the work
//       scales with the real slots, not with B; blocks without a range
//       leave at once. A block finds a range's first tile by a
//       THREADS-ary search of the tile offsets, and each slot's minimizer
//       by a binary search of its tile's scanned counts staged in shared
//       memory; writes the slot's 64-bit sort key (row, strand, rid,
//       rpos) packed into only the bits the dispatch and the index can
//       set, and its y word; counts the digits of every sort pass in
//       shared-memory histograms, added to the global ones once a block.
//       More blocks write the pads of the planes.
//   (d) seed_sort_pass, once a pass of 8 bits, on a grid fixed the same
//       way: a stable LSD radix sort of the flat real slots. A block
//       takes tiles of SORT_TILE slots in the order of a ticket from an
//       atomic counter until they run out (blocks past the tiles leave
//       at once), ranks each slot among its warp's slots of the same
//       digit with ballots (stable: earlier lanes and chunks first),
//       publishes its tile's digit counts and looks back over the
//       earlier tiles', LOOK words at a time (decoupled look-back: a tile
//       waits only on tiles whose tickets came first, which are running
//       or done), then scatters. The last pass writes the chaining planes
//       straight from the key and the y word.
// Row order is the key's top field, so the sort keeps each row's slots
// together and in place in the flat array.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int PROBE_THREADS = 256;
#ifndef SEED_THREADS
#define SEED_THREADS 256
#endif
#ifndef SEED_ITEMS
#define SEED_ITEMS 8
#endif
constexpr int THREADS = SEED_THREADS;  // a block of (a)-(d); (a)'s tile
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = SEED_ITEMS;      // slots a thread in (c) and (d)
constexpr int SLOTS = THREADS * ITEMS;       // (c): a block's range
constexpr int SORT_TILE = THREADS * ITEMS;   // (d): a ticket's slots
constexpr int PAD_SLOTS = THREADS * 8;       // (c): a pad block's slots
constexpr int RADIX_BITS = 8, RADIX = 1 << RADIX_BITS;
constexpr int MAX_PASSES = 8;
constexpr int SCAN = 3;                // bucket keys compared at once
constexpr int LOOK = 16;               // (d): earlier tiles read at once
constexpr int BLOCKS_PER_SM = 2;       // (c) and (d): the grid's cap
constexpr int PAD_HI = -0x7FFFFF0;     // pack_tasks16's hi sentinel
constexpr unsigned FULL = 0xffffffffu;
// a look-back word: the flag in the top two bits, the count below
constexpr unsigned FLAG_AGG = 1u << 30, FLAG_INC = 2u << 30;
constexpr unsigned COUNT_MASK = FLAG_AGG - 1;
static_assert(THREADS % 32 == 0 && WARPS <= 32, "one warp scans the sums");

struct Table {
  const long long* keys;  // n_keys sorted
  const int* lut;         // 2^bits + 1 offsets into keys
  const int2* sc;         // (start, cnt) of each key
  int bits, shift;
};

// (start, cnt) of v in the index, (0, 0) on a miss or a pad (v < 0).
__device__ __forceinline__ int2 probe_one(const Table& ix, long long v) {
  int2 r = make_int2(0, 0);
  if (v < 0) return r;
  const long long last = (1LL << ix.bits) - 1;
  long long b = v >> ix.shift;
  if (b > last) b = last;
  int lo = __ldg(ix.lut + b);
  const int hi = __ldg(ix.lut + b + 1);
  int len = hi - lo;  // the lower bound of v is in [lo, lo + len]
  while (len > SCAN) {
    const int half = len >> 1;
    const bool less = __ldg(ix.keys + lo + half) < v;
    lo = less ? lo + half + 1 : lo;
    len = less ? len - half - 1 : half;
  }
  int at = -1;
#pragma unroll
  for (int k = 0; k <= SCAN; ++k)
    if (k <= len && lo + k < hi && __ldg(ix.keys + lo + k) == v) at = lo + k;
  if (at >= 0) r = __ldg(ix.sc + at);
  return r;
}

__global__ void __launch_bounds__(PROBE_THREADS)
    seed_probe(Table ix, const long long* __restrict__ q, int n_queries,
               int* __restrict__ s_out, int* __restrict__ c_out) {
  const int i = blockIdx.x * PROBE_THREADS + threadIdx.x;
  if (i >= n_queries) return;
  const int2 r = probe_one(ix, __ldg(q + i));
  s_out[i] = r.x;
  c_out[i] = r.y;
}

// Inclusive scan of v over the 32 lanes of a warp.
__device__ __forceinline__ int warp_scan(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Inclusive scan of v over the block, with the block's sum in *total;
// `sums` is WARPS ints of shared memory, free again on return.
__device__ __forceinline__ int block_scan(int v, int* sums, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = warp_scan(v, lane);
  if (lane == 31) sums[w] = v;
  __syncthreads();
  if (w == 0) {
    const int s = warp_scan(lane < WARPS ? sums[lane] : 0, lane);
    if (lane < WARPS) sums[lane] = s;
  }
  __syncthreads();
  if (w > 0) v += sums[w - 1];
  *total = sums[WARPS - 1];
  __syncthreads();
  return v;
}

// (a) one block a (row, tile): ms[m] = (start, inclusive kept count in
// the tile), tile_tot[tile] = the tile's kept count.
__global__ void __launch_bounds__(THREADS)
    seed_count(Table ix, const long long* __restrict__ q, int M, int tpr,
               int mid_occ, int2* __restrict__ ms, int* __restrict__ tile_tot) {
  __shared__ int sums[WARPS];
  const int b = blockIdx.x / tpr;
  const int m = (blockIdx.x - b * tpr) * THREADS + threadIdx.x;
  const long long at = static_cast<long long>(b) * M + m;
  int2 hit = make_int2(0, 0);
  if (m < M) hit = probe_one(ix, __ldg(q + at));
  const int c = hit.y < mid_occ ? hit.y : 0;
  int tile;
  const int v = block_scan(c, sums, &tile);
  if (m < M) ms[at] = make_int2(hit.x, v);
  if (threadIdx.x == 0) tile_tot[blockIdx.x] = tile;
}

// (b) one block: n[b]; rowoff[b] = the row's first flat slot (rows of
// min(n, N) slots), rowoff[B] = the real slots; toff[t] = tile t's first
// flat slot, toff[B * tpr] = the real slots. Zeroes hist and tickets.
__global__ void __launch_bounds__(THREADS)
    seed_offsets(const int* __restrict__ tile_tot, int B, int tpr, int N,
                 int* __restrict__ n_out, int* __restrict__ rowoff,
                 int* __restrict__ toff, int* __restrict__ hist,
                 int* __restrict__ tickets) {
  __shared__ int sums[WARPS];
  const int t = threadIdx.x;
  for (int i = t; i < MAX_PASSES * RADIX; i += THREADS) hist[i] = 0;
  if (t < MAX_PASSES) tickets[t] = 0;
  int carry = 0;
  for (int b0 = 0; b0 < B; b0 += THREADS) {
    const int b = b0 + t;
    int n = 0;
    if (b < B)
      for (int k = 0; k < tpr; ++k) n += tile_tot[b * tpr + k];
    const int kept = b < B ? min(n, N) : 0;
    int chunk;
    const int off = carry + block_scan(kept, sums, &chunk) - kept;
    if (b < B) {
      n_out[b] = n;
      rowoff[b] = off;
      int u = 0;  // the row's slots before tile k, unclamped
      for (int k = 0; k < tpr; ++k) {
        toff[b * tpr + k] = off + min(u, N);
        u += tile_tot[b * tpr + k];
      }
    }
    carry += chunk;
  }
  if (t == 0) {
    rowoff[B] = carry;
    toff[B * tpr] = carry;
  }
}

struct KeyLayout {
  int row_shift, strand_shift, pos_bits;  // key = row | strand | rid | rpos
  int passes;
};

// (c) blocks [0, grid_real): flat slot ranges of SLOTS, strided; blocks
// past it: the pads of the planes, PAD_SLOTS of a row each.
__global__ void __launch_bounds__(THREADS)
    seed_expand(const int2* __restrict__ ms, const int* __restrict__ qpos,
                const int* __restrict__ qyhi, const int* __restrict__ qlen,
                const long long* __restrict__ pos,
                const int* __restrict__ toff, int n_tiles, int M, int tpr,
                KeyLayout kl, int grid_real,
                unsigned long long* __restrict__ key_out,
                long long* __restrict__ y_out, int* __restrict__ hist,
                unsigned* __restrict__ status, const int* __restrict__ n,
                int N, int* __restrict__ hi, int* __restrict__ lo,
                int* __restrict__ qi, int* __restrict__ span,
                short* __restrict__ yhi) {
  __shared__ int s_hist[MAX_PASSES * RADIX];
  __shared__ int cum[THREADS];  // the staged tile: inclusive counts
  __shared__ int t_start[THREADS], t_qpos[THREADS], t_qyhi[THREADS];
  __shared__ int sums[WARPS];
  const int t = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= grid_real) {  // the pads
    const int per_row = (N + PAD_SLOTS - 1) / PAD_SLOTS;
    const int pb = blockIdx.x - grid_real;
    const int b = pb / per_row;
    const int s0 = (pb - b * per_row) * PAD_SLOTS;
    const int from = max(s0, min(n[b], N)), to = min(s0 + PAD_SLOTS, N);
    const long long row = static_cast<long long>(b) * N;
    for (int s = from + t; s < to; s += THREADS) {
      hi[row + s] = PAD_HI;
      lo[row + s] = 0;
      qi[row + s] = 0;
      span[row + s] = 0;
      yhi[row + s] = 0;
    }
    return;
  }
  const int total = toff[n_tiles];
  // the blocks that have a range; the others leave at once
  const int active = min(grid_real, (total + SLOTS - 1) / SLOTS);
  if (static_cast<int>(blockIdx.x) >= active) return;
  const int words = kl.passes * ((total + SORT_TILE - 1) / SORT_TILE) *
                    RADIX;
  for (int i = blockIdx.x * THREADS + t; i < words; i += active * THREADS)
    status[i] = 0;
  for (int i = t; i < kl.passes * RADIX; i += THREADS) s_hist[i] = 0;
  __syncthreads();
  for (int g0 = blockIdx.x * SLOTS; g0 < total; g0 += active * SLOTS) {
    const int g1 = min(g0 + SLOTS, total);
    int T = 0, top = n_tiles;  // the last tile with toff <= g0
    while (T < top) {  // THREADS-ary: each thread tests one of the steps
      const int step = (top - T + THREADS) / THREADS;
      const int at = T + t * step;
      int below;
      block_scan(at <= top && toff[at] <= g0, sums, &below);
      T += (below - 1) * step;
      top = min(top, T + step - 1);
    }
    for (; T < n_tiles; ++T) {
      const int t0 = toff[T];
      if (t0 >= g1) break;
      const int t1 = toff[T + 1];
      if (t1 == t0) continue;
      const int b = T / tpr;
      const int m = (T - b * tpr) * THREADS + t;
      if (m < M) {
        const long long at = static_cast<long long>(b) * M + m;
        const int2 v = ms[at];
        t_start[t] = v.x;
        cum[t] = v.y;
        t_qpos[t] = qpos[at];
        t_qyhi[t] = qyhi[at];
      } else {
        cum[t] = INT_MAX;
      }
      __syncthreads();
      const long long ql = qlen[b];
      const unsigned long long row =
          static_cast<unsigned long long>(b) << kl.row_shift;
      // the tile's part of the range is at most SLOTS: ITEMS slots a
      // thread, their pos loads issued together
      const int from = max(g0, t0) + t, to = min(g1, t1);
      int slot[ITEMS];
      long long r[ITEMS];
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int k = from + i * THREADS - t0;
        slot[i] = -1;
        if (k + t0 >= to) continue;
        int j = 0, jh = THREADS - 1;  // the first j with cum[j] > k
        while (j < jh) {
          const int mid = (j + jh) >> 1;
          if (cum[mid] > k)
            jh = mid;
          else
            j = mid + 1;
        }
        slot[i] = j;
        r[i] = __ldg(pos + t_start[j] + k - (j > 0 ? cum[j - 1] : 0));
      }
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int j = slot[i];
        if (j < 0) continue;
        const int g = from + i * THREADS;
        const int mp = t_qpos[j];
        const long long yh = t_qyhi[j];
        const bool forward = static_cast<int>(r[i] & 1) == (mp & 1);
        const long long qe = mp >> 1;
        const long long y_pos =
            forward ? qe : ql - (qe + 1 - (yh & 0xFF)) - 1;
        const unsigned long long kk =
            row |
            (static_cast<unsigned long long>(!forward) << kl.strand_shift) |
            (static_cast<unsigned long long>(r[i] >> 32) << kl.pos_bits) |
            static_cast<unsigned long long>((r[i] & 0xFFFFFFFFLL) >> 1);
        key_out[g] = kk;
        y_out[g] = (yh << 32) | (y_pos & 0xFFFFFFFFLL);
        for (int p = 0; p < kl.passes; ++p)
          atomicAdd(s_hist + p * RADIX +
                        static_cast<int>((kk >> (p * RADIX_BITS)) &
                                         (RADIX - 1)),
                    1);
      }
      __syncthreads();  // the next tile overwrites the staged planes
    }
  }
  __syncthreads();
  for (int i = t; i < kl.passes * RADIX; i += THREADS)
    if (s_hist[i]) atomicAdd(hist + i, s_hist[i]);
}

__device__ __forceinline__ unsigned load_word(const unsigned* p) {
  return *static_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ void store_word(unsigned* p, unsigned v) {
  *static_cast<volatile unsigned*>(p) = v;
}

// (d) one pass of the radix sort over the flat real slots (toff[n_tiles]
// of them): digit `pass` of key_in; the slots move to key_out/y_out, or
// on the last pass to the chaining planes at row b = key >> row_shift,
// column dest - rowoff[b].
__global__ void __launch_bounds__(THREADS)
    seed_sort_pass(const unsigned long long* __restrict__ key_in,
                   const long long* __restrict__ y_in,
                   unsigned long long* __restrict__ key_out,
                   long long* __restrict__ y_out,
                   const int* __restrict__ toff, int n_tiles,
                   const int* __restrict__ hist, int* __restrict__ tickets,
                   unsigned* __restrict__ status, int pass, KeyLayout kl,
                   const int* __restrict__ rowoff, int N,
                   int* __restrict__ hi, int* __restrict__ lo,
                   int* __restrict__ qi, int* __restrict__ span,
                   short* __restrict__ yhi) {
  __shared__ int sums[WARPS];
  __shared__ int goff[RADIX];         // the digit's first flat slot
  __shared__ int wcnt[WARPS][RADIX];  // the warp's count; then its offset
  __shared__ int prefix[RADIX];       // the earlier tiles' count
  __shared__ int ticket;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int total = toff[n_tiles];
  const int tiles = (total + SORT_TILE - 1) / SORT_TILE;
  // blocks past the tiles leave at once; the others take every ticket
  if (static_cast<int>(blockIdx.x) >= tiles) return;
  const int shift = pass * RADIX_BITS;
  const bool last = pass == kl.passes - 1;
  unsigned* st = status + static_cast<long long>(pass) * tiles * RADIX;
  int carry = 0;
  for (int d0 = 0; d0 < RADIX; d0 += THREADS) {
    const int d = d0 + t;
    const int v = d < RADIX ? hist[pass * RADIX + d] : 0;
    int chunk;
    const int inc = block_scan(v, sums, &chunk);
    if (d < RADIX) goff[d] = carry + inc - v;
    carry += chunk;
  }
  for (;;) {
    if (t == 0) ticket = atomicAdd(tickets + pass, 1);
    for (int i = t; i < WARPS * RADIX; i += THREADS) (&wcnt[0][0])[i] = 0;
    __syncthreads();
    const int tile = ticket;
    if (tile >= tiles) break;
    // rank each slot among the warp's slots of its digit
    const int base = tile * SORT_TILE + w * 32 * ITEMS;
    unsigned long long kv[ITEMS];
    long long yv[ITEMS];
    int dig[ITEMS], rank[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {  // the loads first, all in flight
      const int e = base + k * 32 + lane;
      kv[k] = e < total ? key_in[e] : 0;
      yv[k] = e < total ? y_in[e] : 0;
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const bool valid = base + k * 32 + lane < total;
      const int d = static_cast<int>((kv[k] >> shift) & (RADIX - 1));
      dig[k] = d;
      unsigned peers = __ballot_sync(FULL, valid);
#pragma unroll
      for (int bit = 0; bit < RADIX_BITS; ++bit) {
        const bool on = (d >> bit) & 1;
        const unsigned vote = __ballot_sync(FULL, on);
        peers &= on ? vote : ~vote;
      }
      const unsigned below = peers & ((1u << lane) - 1);
      rank[k] = wcnt[w][d] + __popc(below);
      __syncwarp();
      if (valid && below == 0) wcnt[w][d] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // the warps' offsets in the tile, the tile's count, the look-back
    for (int d = t; d < RADIX; d += THREADS) {
      int sum = 0;
      for (int ww = 0; ww < WARPS; ++ww) {
        const int c = wcnt[ww][d];
        wcnt[ww][d] = sum;
        sum += c;
      }
      unsigned* mine = st + static_cast<long long>(tile) * RADIX + d;
      int before = 0;
      if (tile > 0) {
        store_word(mine, FLAG_AGG | static_cast<unsigned>(sum));
        // the earlier tiles' words, LOOK at a time from the nearest: sum
        // them back to the first inclusive one; an unpublished word (0)
        // is read again (tile 0's is inclusive, so j stays >= 0)
        for (int j = tile - 1;;) {
          unsigned v[LOOK];
#pragma unroll
          for (int k = 0; k < LOOK; ++k)
            v[k] = k <= j ? load_word(st + static_cast<long long>(j - k) *
                                               RADIX + d)
                          : 0;
          int used = 0;
          bool stop = false, inc = false;
#pragma unroll
          for (int k = 0; k < LOOK; ++k) {
            if (stop) continue;
            if (v[k] == 0) {
              stop = true;
              continue;
            }
            before += static_cast<int>(v[k] & COUNT_MASK);
            ++used;
            inc = stop = (v[k] & FLAG_INC) != 0;
          }
          if (inc) break;
          j -= used;
          if (used < LOOK) __nanosleep(32);
        }
      }
      store_word(mine, FLAG_INC | static_cast<unsigned>(before + sum));
      prefix[d] = before;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int e = base + k * 32 + lane;
      if (e >= total) continue;
      const int d = dig[k];
      const int dest = goff[d] + prefix[d] + wcnt[w][d] + rank[k];
      if (!last) {
        key_out[dest] = kv[k];
        y_out[dest] = yv[k];
        continue;
      }
      const unsigned long long kk = kv[k];
      const int b = static_cast<int>(kk >> kl.row_shift);
      const long long at = static_cast<long long>(b) * N + dest - rowoff[b];
      const unsigned long long rid =
          (kk >> kl.pos_bits) &
          ((1ULL << (kl.strand_shift - kl.pos_bits)) - 1);
      const unsigned strand =
          static_cast<unsigned>((kk >> kl.strand_shift) & 1);
      const int yh = static_cast<int>(yv[k] >> 32);
      hi[at] = static_cast<int>((strand << 31) | static_cast<unsigned>(rid));
      lo[at] = static_cast<int>(kk & ((1ULL << kl.pos_bits) - 1));
      qi[at] = static_cast<int>(yv[k] & 0xFFFFFFFFLL);
      span[at] = yh & 0xFF;
      yhi[at] = static_cast<short>(yh);
    }
    __syncthreads();  // the next ticket reuses ticket, wcnt and prefix
  }
}

int bit_width(long long v) {  // bits of v >= 0
  int b = 0;
  while (v > 0) {
    ++b;
    v >>= 1;
  }
  return b;
}

// The pipeline's scratch, in one allocation: offsets from its start.
struct Layout {
  long long ms, tile_tot, toff, rowoff, hist, tickets, key_a, key_b, y_a,
      y_b, status, bytes;
};

Layout layout(int B, int M, int N, int passes) {
  const long long tiles_m =
      static_cast<long long>(B) * ((M + THREADS - 1) / THREADS);
  const long long cap = static_cast<long long>(B) * N;
  const long long sort_tiles = (cap + SORT_TILE - 1) / SORT_TILE;
  Layout l;
  long long at = 0;
  auto take = [&at](long long bytes) {
    const long long here = at;
    at += (bytes + 255) / 256 * 256;
    return here;
  };
  l.ms = take(8 * static_cast<long long>(B) * M);
  l.tile_tot = take(4 * tiles_m);
  l.toff = take(4 * (tiles_m + 1));
  l.rowoff = take(4 * (static_cast<long long>(B) + 1));
  l.hist = take(4 * MAX_PASSES * RADIX);
  l.tickets = take(4 * MAX_PASSES);
  l.key_a = take(8 * cap);
  l.key_b = take(8 * cap);
  l.y_a = take(8 * cap);
  l.y_b = take(8 * cap);
  l.status = take(4 * static_cast<long long>(passes) * sort_tiles * RADIX);
  l.bytes = at;
  return l;
}

KeyLayout key_layout(int B, int rid_bits, int pos_bits) {
  KeyLayout kl;
  kl.pos_bits = pos_bits;
  kl.strand_shift = rid_bits + pos_bits;
  kl.row_shift = kl.strand_shift + 1;
  const int key_bits = kl.row_shift + bit_width(B - 1);
  kl.passes = (key_bits + RADIX_BITS - 1) / RADIX_BITS;
  return kl;
}

}  // namespace

// K5. Launch on `stream`; returns the launch's cudaError_t (cudaSuccess =
// 0). keys: n_keys int64; lut: 2^bits + 1 int32; sc: (n_keys, 2) int32;
// q: n_queries int64; s_out, c_out: n_queries int32.
extern "C" cudaError_t mm2tpu_seed_probe(const void* keys, const void* lut,
                                         const void* sc, int bits, int shift,
                                         const void* q, int n_queries,
                                         void* s_out, void* c_out,
                                         cudaStream_t stream) {
  if (n_queries < 1 || bits < 1 || bits > 30 || shift < 0 || shift > 62)
    return cudaErrorInvalidValue;
  const Table ix{static_cast<const long long*>(keys),
                 static_cast<const int*>(lut), static_cast<const int2*>(sc),
                 bits, shift};
  const int grid = (n_queries + PROBE_THREADS - 1) / PROBE_THREADS;
  seed_probe<<<grid, PROBE_THREADS, 0, stream>>>(
      ix, static_cast<const long long*>(q), n_queries,
      static_cast<int*>(s_out), static_cast<int*>(c_out));
  return cudaGetLastError();
}

// The scratch bytes of mm2tpu_seed_anchors at (B, M, N) and the key
// widths, in *bytes; the sort's passes in *passes.
extern "C" cudaError_t mm2tpu_seed_workspace(int B, int M, int N,
                                             int rid_bits, int pos_bits,
                                             long long* bytes, int* passes) {
  if (B < 1 || M < 1 || N < 1 || rid_bits < 0 || pos_bits < 0 ||
      pos_bits > 31 || rid_bits > 31)
    return cudaErrorInvalidValue;
  const KeyLayout kl = key_layout(B, rid_bits, pos_bits);
  if (kl.row_shift + bit_width(B - 1) > 64) return cudaErrorInvalidValue;
  *passes = kl.passes;
  *bytes = layout(B, M, N, kl.passes).bytes;
  return cudaSuccess;
}

// K6. Launch (a)-(d) on `stream`; returns the first launch's error. The
// index (keys, lut, sc, bits, shift as for K5; pos int64); q (B, M)
// int64; qpos, qyhi (B, M) int32; qlen (B,) int32; rid_bits and pos_bits
// bound every rid and rpos of pos; ws of ws_bytes from
// mm2tpu_seed_workspace. Out: hi, lo, qi, span (B, N) int32,
// yhi (B, N) int16, n (B,) int32.
extern "C" cudaError_t mm2tpu_seed_anchors(
    const void* keys, const void* lut, const void* sc, int bits, int shift,
    const void* pos, const void* q, const void* qpos, const void* qyhi,
    const void* qlen, int B, int M, int N, int mid_occ, int rid_bits,
    int pos_bits, void* ws, long long ws_bytes, void* hi,
    void* lo, void* qi, void* span, void* yhi, void* n,
    cudaStream_t stream) {
  long long need = 0;
  int passes = 0;
  if (mm2tpu_seed_workspace(B, M, N, rid_bits, pos_bits, &need, &passes) !=
          cudaSuccess ||
      ws_bytes < need || bits < 1 || bits > 30 || shift < 0 || shift > 62 ||
      static_cast<long long>(B) * N >= (1LL << 30) ||
      static_cast<long long>(B) * M >= (1LL << 31))
    return cudaErrorInvalidValue;
  const KeyLayout kl = key_layout(B, rid_bits, pos_bits);
  const Layout l = layout(B, M, N, passes);
  char* base = static_cast<char*>(ws);
  int2* ms = reinterpret_cast<int2*>(base + l.ms);
  int* tile_tot = reinterpret_cast<int*>(base + l.tile_tot);
  int* toff = reinterpret_cast<int*>(base + l.toff);
  int* rowoff = reinterpret_cast<int*>(base + l.rowoff);
  int* hist = reinterpret_cast<int*>(base + l.hist);
  int* tickets = reinterpret_cast<int*>(base + l.tickets);
  unsigned long long* keys_ab[2] = {
      reinterpret_cast<unsigned long long*>(base + l.key_a),
      reinterpret_cast<unsigned long long*>(base + l.key_b)};
  long long* y_ab[2] = {reinterpret_cast<long long*>(base + l.y_a),
                        reinterpret_cast<long long*>(base + l.y_b)};
  unsigned* status = reinterpret_cast<unsigned*>(base + l.status);
  int* hi_p = static_cast<int*>(hi);
  int* lo_p = static_cast<int*>(lo);
  int* qi_p = static_cast<int*>(qi);
  int* span_p = static_cast<int*>(span);
  short* yhi_p = static_cast<short*>(yhi);
  int* n_p = static_cast<int*>(n);
  const Table ix{static_cast<const long long*>(keys),
                 static_cast<const int*>(lut), static_cast<const int2*>(sc),
                 bits, shift};
  const int tpr = (M + THREADS - 1) / THREADS;
  const int n_tiles = B * tpr;
  const long long cap = static_cast<long long>(B) * N;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const long long most = static_cast<long long>(BLOCKS_PER_SM) * sms;
  auto grid_of = [cap, most](int per_block) {  // blocks that cover cap
    const long long need = (cap + per_block - 1) / per_block;
    return static_cast<int>(need < most ? need : most);
  };
  const int grid_real = grid_of(SLOTS);
  const int grid_expand = grid_real + B * ((N + PAD_SLOTS - 1) / PAD_SLOTS);
  const int grid_sort = grid_of(SORT_TILE);
  const int one = 1;
  seed_count<<<n_tiles, THREADS, 0, stream>>>(
      ix, static_cast<const long long*>(q), M, tpr, mid_occ, ms, tile_tot);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  seed_offsets<<<one, THREADS, 0, stream>>>(tile_tot, B, tpr, N, n_p, rowoff,
                                            toff, hist, tickets);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  seed_expand<<<grid_expand, THREADS, 0, stream>>>(
      ms, static_cast<const int*>(qpos), static_cast<const int*>(qyhi),
      static_cast<const int*>(qlen), static_cast<const long long*>(pos),
      toff, n_tiles, M, tpr, kl, grid_real, keys_ab[0], y_ab[0], hist,
      status, n_p, N, hi_p, lo_p, qi_p, span_p, yhi_p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int p = 0; p < passes; ++p) {
    const int from = p & 1;
    seed_sort_pass<<<grid_sort, THREADS, 0, stream>>>(
        keys_ab[from], y_ab[from], keys_ab[from ^ 1], y_ab[from ^ 1], toff,
        n_tiles, hist, tickets, status, p, kl, rowoff, N, hi_p, lo_p, qi_p,
        span_p, yhi_p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}
