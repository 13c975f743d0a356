// Host seeding a batch of reads at a time: the native runtime's own
// per-read sketch (mm2_sketch) and one-pass seed hits (mm2_seed_hits),
// called from one loop over the batch's reads on a pool of threads, so
// the caller crosses into native code twice a batch instead of twice a
// read.
//
// The sketch call takes the reads' bases as they are read and codes them
// itself (index/sketch.py::SEQ_NT4), each thread its own reads.
//
// Each read is computed whole by one thread; the threads take reads in
// turn as they finish (read lengths vary). mm2_sketch keeps no state and
// mm2_seed_hits keeps its scratch per thread, so the reads need no lock.
// A call returns a handle holding each read's outputs, and the counts of
// each; mm2t_batch_take then copies the reads' outputs, in read order,
// into the caller's arrays and frees the handle. So the result does not
// depend on the number of threads or on the order in which they ran.
//
// Compiled with native/mm2tpu_native.cpp into one library by
// mm2tpu_torch/native/lib.py.
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
int64_t mm2_sketch(const uint8_t *codes, int64_t len, int32_t w, int32_t k,
                   uint32_t rid, int32_t is_hpc, uint64_t *out_x,
                   uint64_t *out_y, int64_t cap);
int64_t mm2_seed_hits(int64_t n_mv, const uint64_t *mv,
                      int64_t nk, const uint64_t *keys, const int64_t *start,
                      const int32_t *cnt, int32_t lut_bits, int32_t shift,
                      const int64_t *lut, const uint64_t *pos,
                      int32_t max_occ, int64_t qlen, int32_t skip_mode,
                      uint64_t **out_anchors, uint64_t **out_mini_pos,
                      int64_t *out_n_mini, int64_t *out_rep_len);
}

namespace {

// index/sketch.py's SEQ_NT4: A, C, G, T (U) in either case to 0-3, every
// other byte to 4
struct Nt4Table {
    uint8_t code[256];
    Nt4Table() {
        memset(code, 4, sizeof code);
        for (int i = 0; i < 4; ++i)
            code[(uint8_t)"ACGT"[i]] = code[(uint8_t)"acgt"[i]] = (uint8_t)i;
        code[(uint8_t)'U'] = code[(uint8_t)'u'] = 3;
    }
};
const Nt4Table kNt4;

// The outputs of a batch: out[b][r] holds read r's words of output b.
struct Batch {
    std::vector<std::vector<uint64_t>> out[2];
};

// fn(i) for every i in [0, n), on n_threads threads (the calling thread
// one of them), each taking the next i when it has finished its last.
// False if any fn threw (std::bad_alloc); the others then stop early.
template <class F>
bool parallel_for(int64_t n, int32_t n_threads, F fn) {
    std::atomic<int64_t> next{0};
    std::atomic<bool> failed{false};
    auto work = [&]() {
        try {
            for (int64_t i; !failed.load(std::memory_order_relaxed) &&
                            (i = next.fetch_add(1)) < n;)
                fn(i);
        } catch (...) {
            failed = true;
        }
    };
    const int64_t t = std::max<int64_t>(1, std::min<int64_t>(n_threads, n));
    std::vector<std::thread> pool;
    for (int64_t j = 1; j < t; ++j) pool.emplace_back(work);
    work();
    for (auto &th : pool) th.join();
    return !failed;
}

}  // namespace

extern "C" {

// The minimizers of every read of a batch, each read's as
// mapping/seed.py::collect_minimizers computes them without SDUST: every
// segment sketched with rid = its index in the read, its y raised by
// seg_shift (twice the query bases of the read's earlier segments).
// seq: the batch's bases (bytes, coded here as SEQ_NT4 codes them),
// segment after segment; segment s is seq[seg_off[s], seg_off[s + 1]);
// read r is segments read_seg[r] .. read_seg[r + 1] - 1. n_mv[r]
// receives read r's count. Returns the handle for mm2t_batch_take
// (output 0: the (x, y) pairs), or null if memory ran out.
void *mm2t_sketch_batch(const uint8_t *seq, const int64_t *seg_off,
                        const uint64_t *seg_shift, const int64_t *read_seg,
                        int64_t n_reads, int32_t w, int32_t k, int32_t is_hpc,
                        int32_t n_threads, int64_t *n_mv) {
    Batch *b = new Batch();
    b->out[0].resize((size_t)n_reads);
    const bool ok = parallel_for(n_reads, n_threads, [&](int64_t r) {
        static thread_local std::vector<uint64_t> x, y;
        static thread_local std::vector<uint8_t> codes;
        std::vector<uint64_t> &mv = b->out[0][(size_t)r];
        for (int64_t s = read_seg[r]; s < read_seg[r + 1]; ++s) {
            const int64_t len = seg_off[s + 1] - seg_off[s];
            if (len <= 0) continue;   // an empty segment has none
            codes.resize((size_t)len);
            for (int64_t i = 0; i < len; ++i)
                codes[(size_t)i] = kNt4.code[seq[seg_off[s] + i]];
            int64_t cap = std::max<int64_t>(len, 64), n;
            for (;;) {   // a capacity miss returns -(the count needed)
                if ((int64_t)x.size() < cap) {
                    x.resize((size_t)cap);
                    y.resize((size_t)cap);
                }
                n = mm2_sketch(codes.data(), len, w, k,
                               (uint32_t)(s - read_seg[r]), is_hpc,
                               x.data(), y.data(), cap);
                if (n >= 0) break;
                cap = -n;
            }
            const size_t o = mv.size();
            mv.resize(o + 2 * (size_t)n);
            for (int64_t i = 0; i < n; ++i) {
                mv[o + 2 * i] = x[(size_t)i];
                mv[o + 2 * i + 1] = y[(size_t)i] + seg_shift[s];
            }
        }
        n_mv[r] = (int64_t)mv.size() / 2;
    });
    if (!ok) {
        delete b;
        return nullptr;
    }
    return b;
}

// The seed hits of every read of a batch, each read's exactly what
// mm2_seed_hits returns for its minimizers mv[mv_off[r], mv_off[r + 1])
// (pairs) and its query length qlen[r]; a read with no minimizers has no
// anchors, no mini_pos and rep_len 0. n_a[r], n_mini[r] and rep_len[r]
// receive read r's counts of anchors and mini_pos, and its rep_len.
// Returns the handle for mm2t_batch_take (output 0: the anchors' (x, y)
// pairs, output 1: mini_pos), or null if memory ran out.
void *mm2t_seed_hits_batch(const uint64_t *mv, const int64_t *mv_off,
                           int64_t n_reads, const int64_t *qlen, int64_t nk,
                           const uint64_t *keys, const int64_t *start,
                           const int32_t *cnt, int32_t lut_bits,
                           int32_t shift, const int64_t *lut,
                           const uint64_t *pos, int32_t max_occ,
                           int32_t skip_mode, int32_t n_threads,
                           int64_t *n_a, int64_t *n_mini, int64_t *rep_len) {
    Batch *b = new Batch();
    b->out[0].resize((size_t)n_reads);
    b->out[1].resize((size_t)n_reads);
    const bool ok = parallel_for(n_reads, n_threads, [&](int64_t r) {
        const int64_t n = mv_off[r + 1] - mv_off[r];
        n_a[r] = n_mini[r] = rep_len[r] = 0;
        if (n == 0) return;
        uint64_t *a = nullptr, *m = nullptr;
        // a and m point into this thread's scratch until its next call
        const int64_t na = mm2_seed_hits(
            n, mv + 2 * mv_off[r], nk, keys, start, cnt, lut_bits, shift,
            lut, pos, max_occ, qlen[r], skip_mode, &a, &m, &n_mini[r],
            &rep_len[r]);
        n_a[r] = na;
        b->out[0][(size_t)r].assign(a, a + 2 * na);
        b->out[1][(size_t)r].assign(m, m + n_mini[r]);
    });
    if (!ok) {
        delete b;
        return nullptr;
    }
    return b;
}

// Copies every read's words of output i, in read order, into dst_i (a
// null dst_i skips output i), on n_threads threads, and frees the handle.
void mm2t_batch_take(void *handle, int32_t n_threads, uint64_t *dst0,
                     uint64_t *dst1) {
    Batch *b = (Batch *)handle;
    uint64_t *dst[2] = {dst0, dst1};
    for (int o = 0; o < 2; ++o) {
        std::vector<std::vector<uint64_t>> &v = b->out[o];
        if (!dst[o] || v.empty()) continue;
        std::vector<int64_t> off(v.size() + 1, 0);
        for (size_t r = 0; r < v.size(); ++r)
            off[r + 1] = off[r] + (int64_t)v[r].size();
        parallel_for((int64_t)v.size(), n_threads, [&](int64_t r) {
            if (!v[(size_t)r].empty())
                memcpy(dst[o] + off[(size_t)r], v[(size_t)r].data(),
                       v[(size_t)r].size() * sizeof(uint64_t));
        });
    }
    delete b;
}

}  // extern "C"
