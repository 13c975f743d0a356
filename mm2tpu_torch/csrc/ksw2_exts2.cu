// ksw2 exts2 splice extension DP with its backtrack, for Hopper (sm_90a).
//
// Replaces the TPU kernel mm2tpu/ops/ksw2_pallas.py::_exts2_kernel
// (launched by exts2_device) and the host backtrack that exts2_batch runs
// after it (_backtrack_abs with min_intron_len = long_thres). Its outputs
// are the Pallas kernel's ez registers, bit for bit (columns R_ZDROP ..
// R_BREAK of ops/ksw2_extd2.py), plus the trace of the direction plane as
// per-step op codes (0 = M, 1 = I, 2 = D, 3 = N, 255 = inactive) and the
// final (i, j), from which ops/ksw2_exts2.py::exts2_batch builds the same
// CIGAR as _backtrack_abs.
//
// Contract, for fill b (qlen, tlen >= 1), anti-diagonal rows r = 0 ..
// qlen+tlen-2, all arithmetic in int32 (ksw_exts2_sse semantics, as
// ops/ksw2_splice_ref.py documents them):
//   - no band: row r spans [st0, en0] = [max(0, r-qlen+1), min(tlen-1, r)],
//     16-aligned to [st, en]; cells of [st, en] outside [st0, en0] are
//     computed from stale values, which persist from the row that last
//     wrote them; the score row is refreshed in 16-wide blocks from st0;
//   - four states: H (z), the short gaps x and y, and the intron x2.
//     x2 starts at -q2; a2 = x2(t-1) + v(t-1) enters the max with the
//     acceptor score of column t added; x2 opens at the donor score as a
//     floor, x2' = max(a2 - (z - q2), donor) - q2; no clamp of z;
//   - at column st the t-1 inputs come from the previous row only if it
//     covered st-1, else from the boundary; the first column decays as
//     -q-e at r = 0, -e below long_thres, long_diff at it, 0 past it;
//   - left gap alignment compares with >, right alignment with >=
//     (a2 against the donor score too);
//   - the exact max keeps an H row and breaks ties like the SSE scan: the
//     seed at en0 first, then the 4-lane blocks by (lane, row in lane),
//     then the scalar tail; the approximate max walks H0 along the
//     diagonal; Z-drop has slope 0 (ksw2_exts2_sse.c:382);
//   - the backtrack starts at (tlen-1, qlen-1) unless the fill was
//     z-dropped or extends only, then at the max if it has one; state 3
//     is N when long_thres > 0 and steps i only.
//
// What bounds it on the H100: a fill is a chain of qlen+tlen-1 dependent
// rows. A splice fill has no band, so a fill across a 10 kb intron is
// ~10,000 rows, each only as wide as the shorter sequence (often a few
// hundred query bases); a flush holds at most 64 fills, so at most 64 of
// the 132 SMs work. The kernel is latency-bound: the time per row (three
// block barriers and a block reduction) sets its speed, not bytes or
// operations.
//
// Design (K3's, csrc/ksw2_extd2.cu): one CTA of 256 threads per fill.
// Threads stride across the row; rows run serially. u, v, x, y, x2 live in
// two generations in device memory (the fill's working set stays in L2),
// one read and one written per row; the score row s and the exact-max H
// row are single arrays. Both row ends only grow with r, so a column the
// previous row did not write was written by no row before it either, and
// the older generation still holds its initial value. Direction bytes are
// stored for each row's 16-aligned span only: row r at offset r * cap,
// column t at t - st, cap >= every row's en - st + 1. After each row a
// (value, priority, column) reduction finds the exact max; thread 0
// updates the ez registers, Z-drop and the score. After the last row
// thread 0 picks the backtrack start and walks the plane with the state
// machine of ksw_backtrack, writing one op code per step, so only ez,
// the op codes and (i, j) leave the card (the JAX package copies the whole
// plane to the host and walks it there one step at a time).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NREG = 16;
constexpr int NEG_INF = -0x40000000;  // KSW_NEG_INF
constexpr int NEG32 = -0x7FFFFFFF;
constexpr unsigned FULL = 0xffffffffu;

enum { R_ZDROP, R_MAX, R_MAXQ, R_MAXT, R_MQE, R_MQET, R_MTE, R_MTEQ,
       R_SCORE, R_H0, R_LAST, R_PST, R_PEN, R_BREAK };
enum { F_RIGHT = 1, F_APPROX = 2, F_APPROX_DROP = 4, F_EXTZ_ONLY = 8 };

struct Params {
  int q, e, q2, long_thres, long_diff, zdrop, sc_mch, sc_mis, sc_N, flags;
};

// (value, priority) lexicographic order of the exact-max scan
__device__ __forceinline__ bool beats(int v1, int p1, int v2, int p2) {
  return v1 > v2 || (v1 == v2 && p1 > p2);
}

__device__ __forceinline__ void span(int r, int qlen, int tlen, int& st0,
                                     int& en0, int& st, int& en) {
  st0 = max(0, r - qlen + 1);
  en0 = min(tlen - 1, r);
  st = st0 / 16 * 16;
  en = (en0 + 16) / 16 * 16 - 1;
}

__global__ void __launch_bounds__(THREADS)
exts2_kernel(const int* __restrict__ lens, const uint8_t* __restrict__ tsf,
             const uint8_t* __restrict__ qcol, const int* __restrict__ don,
             const int* __restrict__ acc, const long long* __restrict__ meta,
             int* __restrict__ state, uint8_t* __restrict__ plane,
             int* __restrict__ ez_out, uint8_t* __restrict__ ops,
             int* __restrict__ ij, int Tpad, int Qpad, int stride, int Smax,
             Params p) {
  __shared__ int sh_hprev, sh_u_en0, sh_v_en0, sh_h_en0, sh_h_st0, sh_brk;
  __shared__ int sh_val[WARPS], sh_pri[WARPS], sh_col[WARPS];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int qlen = lens[2 * b], tlen = lens[2 * b + 1];
  const int R = qlen + tlen - 1;
  uint8_t* dp = plane + meta[2 * b];
  const long long cap = meta[2 * b + 1];
  const uint8_t* ts = tsf + static_cast<size_t>(b) * Tpad;
  const uint8_t* qs = qcol + static_cast<size_t>(b) * Qpad;
  const int* dn = don + static_cast<size_t>(b) * Tpad;
  const int* ac = acc + static_cast<size_t>(b) * Tpad;
  uint8_t* op = ops + static_cast<size_t>(b) * Smax;
  int* base = state + static_cast<size_t>(b) * 12 * stride;
  const int qe = p.q + p.e;
  const bool right = p.flags & F_RIGHT;
  const bool approx = p.flags & F_APPROX;
  const bool approx_drop = p.flags & F_APPROX_DROP;
  int* s = base + 10 * stride;
  int* H = base + 11 * stride;

  // generations 0/1 of u, v, x, y at -(q+e), of x2 at -q2; each plane is
  // used from index -1 (the +1 below)
  for (int t = tid; t < stride; t += THREADS) {
    for (int g = 0; g < 2; ++g)
      for (int k = 0; k < 5; ++k)
        base[(g * 5 + k) * stride + t] = k < 4 ? -qe : -p.q2;
    s[t] = 0;
    H[t] = NEG_INF;
  }
  for (int k = tid; k < Smax; k += THREADS) op[k] = 255;
  if (tid == 0) sh_brk = 0;

  // ez registers: meaningful in thread 0 only
  int ez_max = 0, max_q = -1, max_t = -1, mqe = NEG_INF, mqe_t = -1;
  int mte = NEG_INF, mte_q = -1, score = NEG_INF, zdropped = 0;
  int H0 = 0, last = 0;
  // span of the previous row: the same in every thread
  int prev_st = -1, prev_en = -1, cur = 0;
  __syncthreads();

  for (int r = 0; r < R; ++r) {
    int st0, en0, st, en;
    span(r, qlen, tlen, st0, en0, st, en);
    int* Uo = base + (cur * 5 + 0) * stride + 1;
    int* Vo = base + (cur * 5 + 1) * stride + 1;
    int* Xo = base + (cur * 5 + 2) * stride + 1;
    int* Yo = base + (cur * 5 + 3) * stride + 1;
    int* X2o = base + (cur * 5 + 4) * stride + 1;
    const int nx = cur ^ 1;
    int* Un = base + (nx * 5 + 0) * stride + 1;
    int* Vn = base + (nx * 5 + 1) * stride + 1;
    int* Xn = base + (nx * 5 + 2) * stride + 1;
    int* Yn = base + (nx * 5 + 3) * stride + 1;
    int* X2n = base + (nx * 5 + 4) * stride + 1;

    // first-column boundary: 0 past long_thres (free intron extension)
    const int row0 = r == 0 ? -qe
                     : r < p.long_thres ? -p.e
                     : r == p.long_thres ? p.long_diff : 0;
    int x1 = -qe, x21 = -p.q2, v1 = st > 0 ? -qe : row0;
    if (st > 0 && prev_st <= st - 1 && st - 1 <= prev_en) {
      x1 = Xo[st - 1];
      x21 = X2o[st - 1];
      v1 = Vo[st - 1];
    }
    const int fe = st0 + (en0 - st0) / 16 * 16 + 16;  // fresh score end
    const int en1 = st0 + (en0 - st0) / 4 * 4;         // 4-lane blocks end
    const int hi = max(en, fe - 1);
    uint8_t* drow = dp + static_cast<long long>(r) * cap;
    int bv = NEG32, bp = NEG32, bc = 0;

    for (int t = st + tid; t <= hi; t += THREADS) {
      int sc;
      if (t >= st0 && t < fe) {
        const int tv = ts[t];
        const int m = r - t;
        const int qv = (m >= 0 && m < Qpad) ? qs[m] : 0;
        sc = (tv == 4 || qv == 4) ? p.sc_N : (tv == qv ? p.sc_mch : p.sc_mis);
        s[t] = sc;
      } else {
        sc = s[t];
      }
      if (t > en) continue;
      const bool bnd = t == r;
      const int ut = bnd ? row0 : Uo[t];
      const int yt = bnd ? -qe : Yo[t];
      const int xt1 = t == st ? x1 : Xo[t - 1];
      const int vt1 = t == st ? v1 : Vo[t - 1];
      const int x2t1 = t == st ? x21 : X2o[t - 1];
      const int dnt = dn[t];
      int z = sc, a = xt1 + vt1, bb = yt + ut, a2 = x2t1 + vt1;
      const int a2a = a2 + ac[t];
      int d;
      if (!right) {  // gap left-alignment
        d = a > z ? 1 : 0;
        z = max(z, a);
        d = bb > z ? 2 : d;
        z = max(z, bb);
        d = a2a > z ? 3 : d;
        z = max(z, a2a);
      } else {  // gap right-alignment
        d = z > a ? 0 : 1;
        z = max(z, a);
        d = z > bb ? d : 2;
        z = max(z, bb);
        d = z > a2a ? d : 3;
        z = max(z, a2a);
      }
      const int un = z - vt1, vn = z - ut;
      const int t1 = z - p.q;
      a -= t1;
      bb -= t1;
      a2 -= z - p.q2;
      const bool ga = right ? a >= 0 : a > 0;
      const bool gb = right ? bb >= 0 : bb > 0;
      const bool ga2 = right ? a2 >= dnt : a2 > dnt;
      Un[t] = un;
      Vn[t] = vn;
      Xn[t] = (ga ? a : 0) - qe;
      Yn[t] = (gb ? bb : 0) - qe;
      X2n[t] = max(a2, dnt) - p.q2;
      d |= (ga ? 0x08 : 0) | (gb ? 0x10 : 0) | (ga2 ? 0x20 : 0);
      drow[t - st] = static_cast<uint8_t>(d);
      if (!approx) {
        if (r > 0 && t >= st0 && t < en0) {
          const int ho = H[t];
          if (t == en0 - 1) sh_hprev = ho;
          const int hn = ho + vn;
          H[t] = hn;
          if (t == st0) sh_h_st0 = hn;
          const int rel = t - st0;
          const int pri = t < en1 ? (2 << 26) - ((rel & 3) << 22) - (rel >> 2)
                                  : (1 << 26) - t;
          if (beats(hn, pri, bv, bp)) {
            bv = hn;
            bp = pri;
            bc = t;
          }
        }
        if (t == en0) {
          sh_u_en0 = un;
          sh_v_en0 = vn;
          sh_h_en0 = H[t];
        }
      }
    }
    __syncthreads();

    bool do_drop = false;
    int zH = 0, zt = 0, h_end = 0;  // h_end: H at en0 (exact) or H0
    if (!approx) {
      // block reduction of (value, priority, column)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const int ov = __shfl_down_sync(FULL, bv, o);
        const int opr = __shfl_down_sync(FULL, bp, o);
        const int oc = __shfl_down_sync(FULL, bc, o);
        if (beats(ov, opr, bv, bp)) {
          bv = ov;
          bp = opr;
          bc = oc;
        }
      }
      if ((tid & 31) == 0) {
        sh_val[tid >> 5] = bv;
        sh_pri[tid >> 5] = bp;
        sh_col[tid >> 5] = bc;
      }
      __syncthreads();
      if (tid == 0) {
        for (int k = 1; k < WARPS; ++k)
          if (beats(sh_val[k], sh_pri[k], bv, bp)) {
            bv = sh_val[k];
            bp = sh_pri[k];
            bc = sh_col[k];
          }
        int h_en0;
        if (r == 0)
          h_en0 = sh_v_en0 - qe;
        else if (en0 > 0)
          h_en0 = (en0 - 1 >= st0 ? sh_hprev : H[en0 - 1]) + sh_u_en0;
        else
          h_en0 = sh_h_en0 + sh_v_en0;
        H[en0] = h_en0;
        h_end = h_en0;
        // the seed at en0 has the highest priority: it wins ties
        zH = h_en0;
        zt = r == 0 ? 0 : en0;
        if (r > 0 && bv > h_en0) {
          zH = bv;
          zt = bc;
        }
        if (en0 == tlen - 1 && h_en0 > mte) {
          mte = h_en0;
          mte_q = r - en;
        }
        const int h_st0 = st0 == en0 ? h_en0 : sh_h_st0;
        if (r - st0 == qlen - 1 && h_st0 > mqe) {
          mqe = h_st0;
          mqe_t = st0;
        }
        do_drop = true;
      }
    } else if (tid == 0) {
      // approximate max: walk H0 along the main diagonal
      if (r == 0) {
        H0 = Vn[0] - qe;
        last = 0;
      } else {
        const bool c1 = last >= st0 && last <= en0;
        const bool c2 = last + 1 >= st0 && last + 1 <= en0;
        if (c1 && c2) {
          const int d0 = Vn[last], d1 = Un[last + 1];
          if (d1 >= d0) {
            H0 += d1;
            ++last;
          } else {
            H0 += d0;
          }
        } else if (c1) {
          H0 += Vn[last];
        } else {
          ++last;
          H0 += Un[last];
        }
      }
      zH = h_end = H0;
      zt = last;
      do_drop = approx_drop;
    }

    if (tid == 0) {
      bool dropped = false;
      if (do_drop) {  // ksw_apply_zdrop (ksw2.h:160-176) with slope 0
        if (zH > ez_max) {
          ez_max = zH;
          max_t = zt;
          max_q = r - zt;
        } else if (zt >= max_t && r - zt >= max_q) {
          dropped = p.zdrop >= 0 && ez_max - zH > p.zdrop;
        }
      }
      if (!dropped && r == qlen + tlen - 2 && en0 == tlen - 1) score = h_end;
      if (dropped) zdropped = 1;
      sh_brk = zdropped;
    }
    prev_st = st;
    prev_en = en;
    cur = nx;
    __syncthreads();
    if (sh_brk) break;
  }
  __syncthreads();
  if (tid != 0) return;

  // backtrack start (exts2_batch) and trace (_backtrack_abs)
  int i = -1, j = -1;
  if (!zdropped && !(p.flags & F_EXTZ_ONLY)) {
    i = tlen - 1;
    j = qlen - 1;
  } else if (max_t >= 0 && max_q >= 0) {
    i = max_t;
    j = max_q;
  }
  const bool intron = p.long_thres > 0;
  int st_m = 0;
  for (int k = 0; k < Smax && i >= 0 && j >= 0; ++k) {
    const int r = i + j;
    int st0, en0, st, en;
    span(r, qlen, tlen, st0, en0, st, en);
    const bool f2 = i < st, f1 = i > en;
    const int tmp =
        (f1 || f2) ? 0 : dp[static_cast<long long>(r) * cap + (i - st)];
    int sn = st_m == 0 ? (tmp & 7)
                       : (((tmp >> (st_m + 2)) & 1) == 0 ? 0 : st_m);
    if (sn == 0) sn = tmp & 7;
    sn = f2 ? 2 : (f1 ? 1 : sn);
    const int opc = sn == 0 ? 0 : sn == 2 ? 1 : (sn == 3 && intron) ? 3 : 2;
    op[k] = static_cast<uint8_t>(opc);
    if (opc != 1) --i;                // M, D and N step the target
    if (opc == 0 || opc == 1) --j;    // M and I step the query
    st_m = sn;
  }
  ij[2 * b] = i;
  ij[2 * b + 1] = j;

  int* ez = ez_out + static_cast<size_t>(b) * NREG;
  for (int k = 0; k < NREG; ++k) ez[k] = 0;
  ez[R_ZDROP] = zdropped;
  ez[R_MAX] = ez_max;
  ez[R_MAXQ] = max_q;
  ez[R_MAXT] = max_t;
  ez[R_MQE] = mqe;
  ez[R_MQET] = mqe_t;
  ez[R_MTE] = mte;
  ez[R_MTEQ] = mte_q;
  ez[R_SCORE] = score;
  ez[R_H0] = H0;
  ez[R_LAST] = last;
  ez[R_PST] = prev_st;
  ez[R_PEN] = prev_en;
  ez[R_BREAK] = zdropped;
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (cudaSuccess = 0).
// lens (B, 2) int32 [qlen, tlen >= 1]; tsf (B, Tpad) uint8 sf images with
// Tpad >= tlen + 16; qcol (B, Qpad) uint8 queries, zero past qlen; don,
// acc (B, Tpad) int32 donor and acceptor scores; meta (B, 2) int64 [byte
// offset of the fill's direction plane, its row width cap]; state (B, 12,
// stride) int32 scratch, stride = Tpad + 16 (the kernel initialises it);
// plane: the direction planes; ez (B, 16) int32; ops (B, Smax) uint8,
// Smax >= max(qlen + tlen - 1); ij (B, 2) int32 = (i_fin, j_fin). Needs
// q2 > q + e; long_thres/long_diff as ops/ksw2_exts2.py::gap_constants
// gives them; flags: 1 right, 2 approx max, 4 approx drop, 8 extension
// only.
extern "C" cudaError_t mm2tpu_ksw2_exts2(
    const void* lens, const void* tsf, const void* qcol, const void* don,
    const void* acc, const void* meta, void* state, void* plane, void* ez,
    void* ops, void* ij, int B, int Tpad, int Qpad, int stride, int Smax,
    int q, int e, int q2, int long_thres, int long_diff, int zdrop,
    int sc_mch, int sc_mis, int sc_N, int flags, cudaStream_t stream) {
  if (B < 1 || Tpad < 16 || Qpad < 1 || stride < Tpad + 16 || Smax < 1 ||
      q2 <= q + e)
    return cudaErrorInvalidValue;
  const Params p{q, e, q2, long_thres, long_diff, zdrop,
                 sc_mch, sc_mis, sc_N, flags};
  exts2_kernel<<<B, THREADS, 0, stream>>>(
      static_cast<const int*>(lens), static_cast<const uint8_t*>(tsf),
      static_cast<const uint8_t*>(qcol), static_cast<const int*>(don),
      static_cast<const int*>(acc), static_cast<const long long*>(meta),
      static_cast<int*>(state), static_cast<uint8_t*>(plane),
      static_cast<int*>(ez), static_cast<uint8_t*>(ops), static_cast<int*>(ij),
      Tpad, Qpad, stride, Smax, p);
  return cudaGetLastError();
}
