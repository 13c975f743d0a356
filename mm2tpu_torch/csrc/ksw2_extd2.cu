// ksw2 extd2 extension DP (dual affine gaps) with its backtrack, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel mm2tpu/ops/ksw2_pallas.py::_extd2_kernel
// (launched by extd2_device) and the device code that follows it in
// extd2_device_traced: the backtrack start selection and trace_device.
// Its outputs are bit-identical to theirs: the ez registers (columns
// R_ZDROP .. R_BREAK of ops/ksw2_extd2.py), the per-step op codes
// (0 = M, 1 = I, 2 = D, 255 = inactive) and the final (i, j) of the trace.
//
// Contract, for fill b (qlen, tlen >= 1), anti-diagonal rows r = 0 ..
// qlen+tlen-2, all arithmetic in int32 (ksw_extd2_sse semantics, as
// ops/ksw2_ref.py documents them):
//   - the band [st0, en0] of row r is 16-aligned to [st, en]; cells of
//     [st, en] outside [st0, en0] are computed from stale values, which
//     persist from the row that last wrote them;
//   - the score row is refreshed in 16-wide blocks from st0, so a score
//     cell outside them keeps its old value;
//   - at column st the t-1 inputs come from the previous row only if it
//     covered st-1, else from the boundary (the long_thres/long_diff
//     decay at st == 0); at column r, u/y/y2 take boundary values;
//   - left gap alignment compares with >, right alignment with >=;
//   - the exact max keeps an H row and breaks ties like the SSE scan: the
//     seed at en0 first, then the 4-lane blocks by (lane, row in lane),
//     then the scalar tail; the approximate max walks H0 along the
//     diagonal; Z-drop uses e2 as its slope; st0 > en0 ends the fill with
//     zdropped set.
//
// What bounds it on the H100: a fill is a chain of qlen+tlen-1 dependent
// rows, each only as wide as the band (<= w+1 cells: 501 and 752 for
// map-ont's fills), and a flush carries at most 64 fills, one CTA each,
// so at most 64 of the 132 SMs work. The kernel is latency-bound: the
// time from a row's first load to the next row's first load sets its
// speed, not bytes or operations. A row is short work on many threads:
// its cost is the longest dependent chain of one warp plus one barrier,
// so each thread takes as few cells as it can.
//
// Design (that of csrc/ksw2_exts2.cu, with the band): one CTA of 1024
// threads per fill, rows in series. Warp 0 is the control warp; the
// other 31 warps compute, one column a thread (t = st + k, st + k + 992,
// ...), so a band of up to 992 columns costs each compute thread one
// cell a row. A thread keeps its first column's target base in a
// register until st moves.
//   1. Row state in a shared-memory ring, not in device memory. u, v, x,
//      y, x2, y2 and H in two generations and the score row s: 15 int32 a
//      column, column t at slot t & (W-1), the slot's 15 values side by
//      side (an odd stride, so a warp's 32 columns hit 32 banks). W, a
//      power of two up to 2048 (120 KB), is chosen per launch by
//      ops/ksw2_extd2.py::ring_plan: at least max over rows of (the
//      largest hi = max(en, fe-1) so far - st + 2), so a slot is never
//      shared by two columns that are both live. A column no row has
//      written has no slot of its own yet, so it takes its initial value
//      by rule, per array: u, v, x, y above the previous row's en get
//      -(q+e), x2 and y2 -(q2+e2); s above the largest column any row
//      refreshed gets 0; H is read only where the previous row wrote it.
//      Fills whose band needs more than 2048 columns run the same code
//      on state in device memory (the template parameter RING; in one
//      launch with the others, counted by ksw2_extd2.wide_fills).
//   2. One block barrier a row, and no thread waits on the row's max. H
//      has two generations, so the cell at en0 writes its seed H[en0] =
//      H[en0-1] + u itself, and the cell at st0 carries H[st0-1] into the
//      new generation (a band one column wide can reread it a row later).
//      Each compute warp reduces its (H, priority) key with two
//      __reduce_max_sync and leaves it in a shared slot double-buffered
//      by row parity; during row r the control warp combines row r-1's
//      31 keys with the seed, updates the ez registers (max, Z-drop with
//      slope e2, mqe, mte, score, or the H0 walk on row r-1's v and u)
//      and, on a Z-drop, stops the loop after row r's barrier. Row r is
//      then computed for nothing; it is written only past the
//      backtrack's start. A band that breaks (st0 > en0) stops the loop
//      in the row where it breaks, after the control warp's last step.
//   3. The trace staged through shared memory. A step lowers r = i + j by
//      1 or 2 and i by at most 1, so TK = 64 steps stay inside rows [r -
//      126, r] x columns [i - 63, i] of the plane. All threads copy that
//      tile (8 KB, four bytes a thread a row) into the ring's memory,
//      then one thread walks TK steps with the state machine of
//      ksw_backtrack: one device-memory round trip every 64 steps instead
//      of one a step.
// Thread 0 stamps %globaltimer at the start, after the last row and
// after the trace (stamps, (B, 3) int64 ns), so a run can split the time
// of a fill into its DP and its trace. Direction bytes are stored for
// each row's 16-aligned band only (row r at r * cap, column t at t - st).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the CPU test builds the source with fewer threads (EXTD2_THREADS, a
// multiple of 32 from 64 up), as host threads
#ifndef EXTD2_THREADS
#define EXTD2_THREADS 1024
#endif
constexpr int THREADS = EXTD2_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int NC = THREADS - 32;  // compute threads (warps 1 ..)
constexpr int NREG = 16;
constexpr int NEG_INF = -0x40000000;  // KSW_NEG_INF
constexpr int NEG32 = -0x7FFFFFFF;
constexpr int NSTATE = 15;      // u v x y x2 y2 H in two generations, s
constexpr int RING_MAX = 2048;  // columns of the widest ring (120 KB)
constexpr int TK = 64;          // trace steps walked from one staged tile
constexpr int TILE_ROWS = 2 * TK - 1;
constexpr int TILE_BYTES = TILE_ROWS * TK;
constexpr int SMEM_MAX = 232448 - 1024;  // a block's dynamic shared memory

enum { R_ZDROP, R_MAX, R_MAXQ, R_MAXT, R_MQE, R_MQET, R_MTE, R_MTEQ,
       R_SCORE, R_H0, R_LAST, R_PST, R_PEN, R_BREAK };
enum { F_RIGHT = 1, F_APPROX = 2, F_APPROX_DROP = 4, F_EXTZ_ONLY = 8 };
// the values of a column's slot: u, v, x, y, x2, y2, H of generation g at
// g * GEN + k, s at 14
constexpr int GEN = 7;
enum { A_U, A_V, A_X, A_Y, A_X2, A_Y2, A_H, A_S = 14 };

struct Params {
  int q, e, q2, e2;  // after the swap that makes (q, e) the short-gap pair
  int long_thres, long_diff, zdrop, sc_mch, sc_mis, sc_N, w, end_bonus;
  int flags;
};

// one fill's inputs and its direction plane
struct Fill {
  int qlen, tlen, w, Qpad;
  const uint8_t* ts;
  const uint8_t* qs;
  uint8_t* dp;
  long long cap;
};

// the ez registers, kept by the control warp
struct Regs {
  int ez_max = 0, max_q = -1, max_t = -1, mqe = NEG_INF, mqe_t = -1;
  int mte = NEG_INF, mte_q = -1, score = NEG_INF, zdropped = 0;
  int H0 = 0, last = 0, prev_st = -1, prev_en = -1;
};

// each compute warp's best (H, priority) of a row, by row parity
__shared__ int2 sh_key[2][WARPS];
__shared__ int sh_stop;  // the iteration after whose barrier the rows stop
__shared__ int sh_tr[4];  // the trace's (i, j, step, state) between tiles

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void band(int r, int qlen, int tlen, int w,
                                     int& st0, int& en0, int& st, int& en) {
  st0 = max(max(0, r - qlen + 1), (r - w + 1) >> 1);
  en0 = min(min(tlen - 1, r), (r + w) >> 1);
  st = st0 / 16 * 16;
  en = (en0 + 16) / 16 * 16 - 1;
}

// the column of a row's priority: above 2^26 the 4-lane blocks, 2^27 -
// ((rel & 3) << 22) - (rel >> 2) with rel = t - st0; else the scalar
// tail, 2^26 - t
__device__ __forceinline__ int pri_col(int pri, int st0) {
  if (pri > (1 << 26)) {
    const int x = (2 << 26) - pri;
    return st0 + (((x & 0x3FFFFF) << 2) | (x >> 22));
  }
  return (1 << 26) - pri;
}

// The (value, priority) lexicographic max over the warp: value first,
// then priority among the lanes that hold it.
__device__ __forceinline__ int2 warp_best(int v, int p) {
  const int vm = __reduce_max_sync(0xffffffffu, v);
  return make_int2(vm, __reduce_max_sync(0xffffffffu, v == vm ? p : NEG32));
}

// A compute thread's first column of the last row and its target base:
// the first column changes only when st does, every 32 rows or so, so
// most rows load only the query base from device memory.
struct Col {
  int t = -1, tv;
};

// Row r of one fill on a compute thread (ctid in [0, NC)); [st0, en0] and
// [st, en] are the row's band. S holds the state, column t's NSTATE
// values at (t & mask) * NSTATE (RING: mask W - 1, in shared memory;
// else -1, in device memory). prev_st and prev_en are the previous row's
// band, sfront the largest column of s refreshed so far.
template <bool RING>
__device__ __forceinline__ void compute_row(const Fill& f, int* S, int mask,
                                            const Params& p, int r,
                                            int ctid, int st0, int en0,
                                            int st, int en, int prev_st,
                                            int prev_en, int sfront,
                                            Col& col) {
  const int qe = p.q + p.e, qe2 = p.q2 + p.e2;
  const bool right = p.flags & F_RIGHT;
  const bool approx = p.flags & F_APPROX;
  const int fe = st0 + (en0 - st0) / 16 * 16 + 16;  // fresh score end
  const int en1 = st0 + (en0 - st0) / 4 * 4;         // 4-lane blocks end
  const int hi = max(en, fe - 1);
  int kv = NEG32, kp = NEG32;  // best (H, priority) of this thread

  if (st + ctid - (ctid & 31) <= hi) {  // the warp has a column
    const int* O = S + (r & 1) * GEN;        // the previous row's generation
    int* N = S + ((r & 1) ^ 1) * GEN;        // this row's
    const int row0 = r == 0 ? -qe
                     : r < p.long_thres ? -p.e
                     : r == p.long_thres ? p.long_diff : -p.e2;
    uint8_t* drow = f.dp + static_cast<long long>(r) * f.cap;

    for (int t = st + ctid; t <= hi; t += NC) {
      int tv;
      if (t == col.t) {
        tv = col.tv;
      } else {
        tv = __ldg(f.ts + t);
        if (t == st + ctid) col = Col{t, tv};
      }
      // score: fresh in [st0, fe), else what the row that last refreshed
      // the column left (0 if none did)
      int sc;
      if (t >= st0 && t < fe) {
        const int m = r - t;
        const int qv = (m >= 0 && m < f.Qpad) ? __ldg(f.qs + m) : 0;
        sc = (tv == 4 || qv == 4) ? p.sc_N : (tv == qv ? p.sc_mch : p.sc_mis);
        S[(t & mask) * NSTATE + A_S] = sc;
      } else {
        sc = t <= sfront ? S[(t & mask) * NSTATE + A_S] : 0;
      }
      if (t > en) continue;
      // the previous row's u, y, y2 at t and x, v, x2 at t-1; columns
      // above its en were written by no row; at st the t-1 inputs come
      // from the previous row only if it covered st-1
      const bool bnd = t == r;
      const bool fresh = t > prev_en;
      const int c = (t & mask) * NSTATE;
      const int ut = bnd ? row0 : fresh ? -qe : O[c + A_U];
      const int yt = bnd || fresh ? -qe : O[c + A_Y];
      const int y2t = bnd || fresh ? -qe2 : O[c + A_Y2];
      int xt1 = -qe, vt1 = -qe, x2t1 = -qe2;
      if (t == st) {
        if (st > 0 && prev_st <= st - 1 && st - 1 <= prev_en) {
          const int cl = ((st - 1) & mask) * NSTATE;
          xt1 = O[cl + A_X];
          vt1 = O[cl + A_V];
          x2t1 = O[cl + A_X2];
        } else if (st == 0) {
          vt1 = row0;
        }
      } else if (t - 1 <= prev_en) {
        const int cl = ((t - 1) & mask) * NSTATE;
        xt1 = O[cl + A_X];
        vt1 = O[cl + A_V];
        x2t1 = O[cl + A_X2];
      }
      int z = sc, a = xt1 + vt1, bb = yt + ut, a2 = x2t1 + vt1, b2 = y2t + ut;
      int d;
      if (!right) {  // gap left-alignment
        d = a > z ? 1 : 0;
        z = max(z, a);
        d = bb > z ? 2 : d;
        z = max(z, bb);
        d = a2 > z ? 3 : d;
        z = max(z, a2);
        d = b2 > z ? 4 : d;
        z = max(z, b2);
      } else {  // gap right-alignment
        d = z > a ? 0 : 1;
        z = max(z, a);
        d = z > bb ? d : 2;
        z = max(z, bb);
        d = z > a2 ? d : 3;
        z = max(z, a2);
        d = z > b2 ? d : 4;
        z = max(z, b2);
      }
      z = min(z, p.sc_mch);
      const int un = z - vt1, vn = z - ut;
      const int t1 = z - p.q, t2 = z - p.q2;
      a -= t1;
      bb -= t1;
      a2 -= t2;
      b2 -= t2;
      const bool ga = right ? a >= 0 : a > 0;
      const bool gb = right ? bb >= 0 : bb > 0;
      const bool ga2 = right ? a2 >= 0 : a2 > 0;
      const bool gb2 = right ? b2 >= 0 : b2 > 0;
      N[c + A_U] = un;
      N[c + A_V] = vn;
      N[c + A_X] = (ga ? a : 0) - qe;
      N[c + A_Y] = (gb ? bb : 0) - qe;
      N[c + A_X2] = (ga2 ? a2 : 0) - qe2;
      N[c + A_Y2] = (gb2 ? b2 : 0) - qe2;
      d |= (ga ? 0x08 : 0) | (gb ? 0x10 : 0) | (ga2 ? 0x20 : 0) |
           (gb2 ? 0x40 : 0);
      drow[t - st] = static_cast<uint8_t>(d);
      if (!approx) {
        if (r > 0 && t >= st0 && t < en0) {
          const int hn = O[c + A_H] + vn;
          N[c + A_H] = hn;
          const int rel = t - st0;
          const int pri = t < en1 ? (2 << 26) - ((rel & 3) << 22) - (rel >> 2)
                                  : (1 << 26) - t;
          if (hn > kv || (hn == kv && pri > kp)) {
            kv = hn;
            kp = pri;
          }
        } else if (t == en0) {  // the seed
          N[c + A_H] = r == 0    ? vn - qe
                       : en0 > 0 ? O[((en0 - 1) & mask) * NSTATE + A_H] + un
                                 : O[c + A_H] + vn;
        }
        if (r > 0 && t == st0 && st0 > 0) {  // carry H[st0-1] forward
          const int cp = ((st0 - 1) & mask) * NSTATE;
          N[cp + A_H] = O[cp + A_H];
        }
      }
    }
  }
  if (!approx) {
    const int2 k = warp_best(kv, kp);
    if ((ctid & 31) == 0) sh_key[r & 1][1 + (ctid >> 5)] = k;
  }
}

// The control warp's step for row r, after the compute warps' barrier of
// row r: the row's max, the ez registers and Z-drop. Returns true when the
// fill is z-dropped at row r.
__device__ __forceinline__ bool control_row(const Fill& f, const int* S,
                                            int mask, const Params& p, int r,
                                            int lane, Regs& g) {
  const int qlen = f.qlen, tlen = f.tlen;
  const int qe = p.q + p.e;
  const bool approx = p.flags & F_APPROX;
  const bool do_drop = !approx || (p.flags & F_APPROX_DROP);
  const int* G = S + ((r & 1) ^ 1) * GEN;  // the generation row r wrote
  int st0, en0, st, en;
  band(r, qlen, tlen, f.w, st0, en0, st, en);
  int zH, zt, h_end;  // h_end: H at en0 (exact) or H0
  if (!approx) {
    const int2 k = lane < WARPS - 1 ? sh_key[r & 1][1 + lane]
                                    : make_int2(NEG32, NEG32);
    const int2 best = warp_best(k.x, k.y);
    const int h_en0 = G[(en0 & mask) * NSTATE + A_H];
    h_end = h_en0;
    // the seed at en0 has the highest priority: it wins ties
    zH = h_en0;
    zt = r == 0 ? 0 : en0;
    if (r > 0 && best.x > h_en0) {
      zH = best.x;
      zt = pri_col(best.y, st0);
    }
    if (en0 == tlen - 1 && h_en0 > g.mte) {
      g.mte = h_en0;
      g.mte_q = r - en;
    }
    const int h_st0 = G[(st0 & mask) * NSTATE + A_H];
    if (r - st0 == qlen - 1 && h_st0 > g.mqe) {
      g.mqe = h_st0;
      g.mqe_t = st0;
    }
  } else {
    // approximate max: walk H0 along the main diagonal, on row r's u and
    // v (the walk stays inside [st0, en0])
    if (r == 0) {
      g.H0 = G[A_V] - qe;
      g.last = 0;
    } else {
      const int last = g.last;
      const bool c1 = last >= st0 && last <= en0;
      const bool c2 = last + 1 >= st0 && last + 1 <= en0;
      if (c1 && c2) {
        const int d0 = G[(last & mask) * NSTATE + A_V];
        const int d1 = G[((last + 1) & mask) * NSTATE + A_U];
        if (d1 >= d0) {
          g.H0 += d1;
          ++g.last;
        } else {
          g.H0 += d0;
        }
      } else if (c1) {
        g.H0 += G[(last & mask) * NSTATE + A_V];
      } else {
        ++g.last;
        g.H0 += G[(g.last & mask) * NSTATE + A_U];
      }
    }
    zH = h_end = g.H0;
    zt = g.last;
  }
  bool dropped = false;
  if (do_drop) {  // ksw_apply_zdrop (ksw2.h:160-176), e2 as the slope
    if (zH > g.ez_max) {
      g.ez_max = zH;
      g.max_t = zt;
      g.max_q = r - zt;
    } else if (zt >= g.max_t && r - zt >= g.max_q) {
      const int l = abs((zt - g.max_t) - ((r - zt) - g.max_q));
      dropped = p.zdrop >= 0 && g.ez_max - zH > p.zdrop + l * p.e2;
    }
  }
  if (!dropped && r == qlen + tlen - 2 && en0 == tlen - 1) g.score = h_end;
  g.prev_st = st;
  g.prev_en = en;
  if (dropped) g.zdropped = 1;
  return dropped;
}

// The rows of one fill: compute warps run row r while the control warp
// takes stock of row r-1; one barrier a row.
template <bool RING>
__device__ __forceinline__ void fill_rows(const Fill& f, int* S, int mask,
                                          const Params& p, Regs& g) {
  const int tid = threadIdx.x;
  const int R = f.qlen + f.tlen - 1;
  int prev_st = -1, prev_en = -1, sfront = -1;
  Col col;
  if (tid == 0) sh_stop = -1;
  __syncthreads();
  for (int r = 0; r <= R; ++r) {
    // row R does not exist; a row whose band broke is not computed
    int st0 = 0, en0 = -1, st = 0, en = -1;
    if (r < R) band(r, f.qlen, f.tlen, f.w, st0, en0, st, en);
    const bool none = st0 > en0;
    // a thread still reading iteration r-1's flag must not see r's: the
    // flag holds the iteration that stops
    if (tid < 32) {
      if (r > 0 && control_row(f, S, mask, p, r - 1, tid, g) && tid == 0)
        sh_stop = r;
    } else if (!none) {
      compute_row<RING>(f, S, mask, p, r, tid - 32, st0, en0, st, en,
                        prev_st, prev_en, sfront, col);
      prev_st = st;
      prev_en = en;
      sfront = max(sfront, st0 + (en0 - st0) / 16 * 16 + 15);
    }
    __syncthreads();
    if (none || sh_stop == r) {
      if (r < R) g.zdropped = 1;  // the band broke (or a Z-drop: set too)
      break;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
extd2_kernel(const int* __restrict__ lens, const uint8_t* __restrict__ tsf,
             const uint8_t* __restrict__ qcol,
             const long long* __restrict__ meta, int* __restrict__ state,
             uint8_t* __restrict__ plane, int* __restrict__ ez_out,
             uint8_t* __restrict__ ops, int* __restrict__ ij,
             long long* __restrict__ stamps, int Tpad, int Qpad, int stride,
             int Smax, int W, Params p) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const unsigned long long t_start = globaltimer();
  Fill f;
  f.qlen = lens[2 * b];
  f.tlen = lens[2 * b + 1];
  f.w = p.w >= 0 ? p.w : max(f.qlen, f.tlen);
  f.Qpad = Qpad;
  f.ts = tsf + static_cast<size_t>(b) * Tpad;
  f.qs = qcol + static_cast<size_t>(b) * Qpad;
  f.dp = plane + meta[3 * b];
  f.cap = meta[3 * b + 1];
  const long long wide = meta[3 * b + 2];
  const int qlen = f.qlen, tlen = f.tlen;
  uint8_t* op = ops + static_cast<size_t>(b) * Smax;
  for (int k = tid; k < Smax; k += THREADS) op[k] = 255;

  Regs g;
  if (wide >= 0)
    fill_rows<false>(f, state + wide * NSTATE * stride, -1, p, g);
  else
    fill_rows<true>(f, reinterpret_cast<int*>(dsmem), W - 1, p, g);
  // backtrack start (extd2_device_traced), from the control warp's
  // registers
  if (tid == 0) {
    const bool have_max = g.max_t >= 0 && g.max_q >= 0;
    int i, j;
    if (!(p.flags & F_EXTZ_ONLY)) {
      i = !g.zdropped ? tlen - 1 : (have_max ? g.max_t : -1);
      j = !g.zdropped ? qlen - 1 : (have_max ? g.max_q : -1);
    } else {
      const bool reach = !g.zdropped && g.mqe + p.end_bonus > g.ez_max;
      i = reach ? g.mqe_t : (have_max ? g.max_t : -1);
      j = reach ? qlen - 1 : (have_max ? g.max_q : -1);
    }
    sh_tr[0] = i;
    sh_tr[1] = j;
  }
  __syncthreads();  // the ring's memory now holds the trace's tiles
  const unsigned long long t_dp = globaltimer();

  // trace (trace_device)
  int i = sh_tr[0], j = sh_tr[1];
  uint8_t* tile = dsmem;
  int k = 0, st_m = 0;
  while (k < Smax && i >= 0 && j >= 0) {
    // rows r_top - [0, 2TK-2] x columns i_top - [0, TK-1]: all that TK
    // steps from (i_top, r_top) can read; a thread copies four columns
    const int r_top = i + j, i_top = i;
    for (int item = tid; item < TILE_ROWS * (TK / 4); item += THREADS) {
      const int dr = item / (TK / 4), c0 = i_top - 4 * (item % (TK / 4));
      const int rr = r_top - dr;
      if (rr < 0) continue;
      int s0, e0, s, e;
      band(rr, qlen, tlen, f.w, s0, e0, s, e);
      const uint8_t* row = f.dp + static_cast<long long>(rr) * f.cap - s;
      uint8_t* out = tile + dr * TK + (i_top - c0);
#pragma unroll
      for (int n = 0; n < 4; ++n)
        if (c0 - n >= s && c0 - n <= e) out[n] = row[c0 - n];
    }
    __syncthreads();
    if (tid == 0) {
      for (int n = 0; n < TK && k < Smax && i >= 0 && j >= 0; ++n, ++k) {
        const int r = i + j;
        int st0, en0, st, en;
        band(r, qlen, tlen, f.w, st0, en0, st, en);
        const bool f2 = i < st, f1 = i > en;
        const int tmp =
            (f1 || f2) ? 0 : tile[(r_top - r) * TK + (i_top - i)];
        int sn = st_m == 0 ? (tmp & 7)
                           : (((tmp >> (st_m + 2)) & 1) == 0 ? 0 : st_m);
        if (sn == 0) sn = tmp & 7;
        sn = f2 ? 2 : (f1 ? 1 : sn);
        const int opc = sn == 0 ? 0 : ((sn == 1 || sn == 3) ? 2 : 1);
        op[k] = static_cast<uint8_t>(opc);
        if (opc != 1) --i;
        if (opc != 2) --j;
        st_m = sn;
      }
      sh_tr[0] = i;
      sh_tr[1] = j;
      sh_tr[2] = k;
      sh_tr[3] = st_m;
    }
    __syncthreads();
    i = sh_tr[0];
    j = sh_tr[1];
    k = sh_tr[2];
    st_m = sh_tr[3];
  }
  if (tid != 0) return;
  const unsigned long long t_trace = globaltimer();
  stamps[3 * b] = static_cast<long long>(t_start);
  stamps[3 * b + 1] = static_cast<long long>(t_dp);
  stamps[3 * b + 2] = static_cast<long long>(t_trace);
  ij[2 * b] = i;
  ij[2 * b + 1] = j;

  int* ez = ez_out + static_cast<size_t>(b) * NREG;
  for (int n = 0; n < NREG; ++n) ez[n] = 0;
  ez[R_ZDROP] = g.zdropped;
  ez[R_MAX] = g.ez_max;
  ez[R_MAXQ] = g.max_q;
  ez[R_MAXT] = g.max_t;
  ez[R_MQE] = g.mqe;
  ez[R_MQET] = g.mqe_t;
  ez[R_MTE] = g.mte;
  ez[R_MTEQ] = g.mte_q;
  ez[R_SCORE] = g.score;
  ez[R_H0] = g.H0;
  ez[R_LAST] = g.last;
  ez[R_PST] = g.prev_st;
  ez[R_PEN] = g.prev_en;
  ez[R_BREAK] = g.zdropped;
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (cudaSuccess = 0).
// lens (B, 2) int32 [qlen, tlen >= 1]; tsf (B, Tpad) uint8 sf images with
// Tpad >= tlen + 16; qcol (B, Qpad) uint8 queries, zero past qlen; meta
// (B, 3) int64 [byte offset of the fill's band plane, its row width cap,
// -1 for a fill whose rows fit the ring else its index in state]; state
// (n, stride, 15) int32 scratch of the fills too wide for the ring,
// stride = Tpad + 16 columns (the kernel initialises nothing: see the
// header); plane: the band planes; ez (B, 16) int32; ops (B, Smax) uint8,
// Smax >= max(qlen + tlen - 1); ij (B, 2) int32 = (i_fin, j_fin); stamps
// (B, 3) int64 %globaltimer ns. W: the ring's columns, a power of two
// from 16 to 2048, at least ops/ksw2_extd2.py::ring_need of every fill
// not in state; smem: dynamic shared memory, at least 60 W and the trace
// tile. (q, e, q2, e2) come swapped so that q + e <= q2 + e2; w < 0 is
// max(qlen, tlen) for each fill; flags: 1 right, 2 approx max, 4 approx
// drop, 8 extension only.
extern "C" cudaError_t mm2tpu_ksw2_extd2(
    const void* lens, const void* tsf, const void* qcol, const void* meta,
    void* state, void* plane, void* ez, void* ops, void* ij, void* stamps,
    int B, int Tpad, int Qpad, int stride, int Smax, int W, int smem, int q,
    int e, int q2, int e2, int long_thres, int long_diff, int zdrop,
    int sc_mch, int sc_mis, int sc_N, int w, int end_bonus, int flags,
    cudaStream_t stream) {
  if (B < 1 || Tpad < 16 || Qpad < 1 || stride < Tpad + 16 || Smax < 1 ||
      q + e > q2 + e2 || W < 16 || W > RING_MAX || (W & (W - 1)) ||
      smem < NSTATE * 4 * W || smem < TILE_BYTES || smem > SMEM_MAX)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      extd2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const Params p{q, e, q2, e2, long_thres, long_diff, zdrop,
                 sc_mch, sc_mis, sc_N, w, end_bonus, flags};
  extd2_kernel<<<B, THREADS, smem, stream>>>(
      static_cast<const int*>(lens), static_cast<const uint8_t*>(tsf),
      static_cast<const uint8_t*>(qcol), static_cast<const long long*>(meta),
      static_cast<int*>(state), static_cast<uint8_t*>(plane),
      static_cast<int*>(ez), static_cast<uint8_t*>(ops), static_cast<int*>(ij),
      static_cast<long long*>(stamps), Tpad, Qpad, stride, Smax, W, p);
  return cudaGetLastError();
}
