#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card: -x map-ont
(PAF, host-seeded and device-seeded, and SAM), -x sr read pairs and -x
splice spliced reads (PAF, and SAM and PAF with CIGARs through the splice
kernel) in batch mode, and -x map-ont in stream mode (each chaining task
placed on the host or the card on its own), with --split-prefix.

Run from the root of a checkout, with no arguments, for the gate (every
phase but the deep parity runs, 7 and 10):

    python3 chip_smoke.py

with `--deep` for every phase, the deep parity runs included:

    python3 chip_smoke.py --deep

or with `--phases LIST` (for example `--phases 1,3` to build and try
the extd2 kernel, `--phases 1,3,5,6` to add the map-ont SAM path,
`--phases 1,3b,9` for the splice kernel and the spliced-read path,
`--phases 1,2,4` for the chaining kernel's K1 and K2, `--phases 1,5,5s`
for the seeding kernels K5 and K6 and the device-seeded path, `--phases
1,5,5r` for the stream mode) to run
phase 0, the named phases and phase 11's import check only; the kernel
JSON line then lists only the kernels whose phase ran (launches null
where their path's phase did not run). Phases 5s, 5r and 6 need 5, 7 needs
5 and 6, and 10 needs 8 and 9: a list that names one without the other
is refused. Phases 8 and 9 generate the genome of phase 5 themselves.

Phases (any failure exits non-zero; no phase's failure is caught):
  0. the card's name, power limit and SM clock; no CUDA device -> error
  1. the port's native runtime (native/mm2tpu_native.cpp, forced: a
     stale library corrupts chains silently) and the nvcc build of
     mm2tpu_torch/csrc/*.cu, one nvcc per source, side by side, with each
     kernel's ptxas register and spill report
  2. the chaining kernel K1 (csrc/chain.cu, single-segment contract)
     against its plain PyTorch version on the card, on seeded synthetic
     batches from (8, 1024) up to the map-ont path's largest bucket
     (128, 65536), under four settings (the map-ont one only at the
     largest shape), and on a batch shaped like the pipeline's launches
     (B = 128: 100 rows of ragged n, 28 empty rows) under all four; f
     and p equal, with both timed (and the kernel's us a step: its ms
     over the batch's largest n)
  3. the extd2 kernel K3 (extension DP, backtrack start and trace)
     against its plain version on the card: seeded fills of 300-1000 and
     2000-5000 bases (10% substitutions, 5% indels), B = 8 and 64,
     map-ont scoring, w = 500 (and w = -1 at the small size), five flag
     sets, and one launch of 3 fills too wide for the kernel's
     shared-memory ring (2300-2600 bases at w = -1; they run on state in
     device memory, which ksw2_extd2.wide_fills must count) beside 2 that
     fit it; every ez register, op code and CIGAR equal; both timed at
     the largest shape at w = 500 and at map-ont's extension band w =
     751, where the kernel's own %globaltimer stamps give its DP time a
     row and its trace time a step
 3b. the exts2 splice kernel K4 (splice DP, backtrack start and trace)
     against its plain version on the card: seeded two-exon fills across
     a GT-AG intron under the splice preset's scoring, B = 8 (introns of
     100-1000 bp) under six flag sets (one with --junc-bed flags), B = 64
     (exons of 200-400 bp, introns of 2000-8000 bp), with Z-drops and N
     bases, and one launch of 3 fills too wide for the kernel's
     shared-memory ring (exons of 2800-3000 bp; they run on state in
     device memory, which ksw2_exts2.wide_fills must count) beside 2 that
     fit it; every ez register, op code and CIGAR equal, both timed at
     the B = 64 shape, where the kernel's own %globaltimer stamps give
     its DP time a row and its trace time a step
  4. the chaining kernel K2 (csrc/chain.cu, general contract) against its
     plain version: two-segment batches (read pairs, with cross-segment
     pairs at dr = 0) and single-segment cDNA batches, contracts
     (is_cdna, n_segs) in {(F, 2), (T, 1), (T, 2)}, shapes (8, 1024),
     (128, 1024) and (64, 16384), under -x sr's and -x splice's chaining
     settings, gap_scale 0.8 and iter_cap 500, and a pipeline-shaped
     batch as in phase 2 for each contract; f and p equal, both timed at
     the largest shape (with the kernel's us a step)
  5. the map-ont PAF path: `mm2tpu_torch.cli.main -x map-ont --device
     cuda` on a seeded 48 Mb genome with 1000 ONT-like reads; >= 95% of
     the reads must map, and only K1 may have chained (its launches,
     anchors, padded anchors and card time from the chain.* counters)
 5s. device seeding on phase 5's genome and reads: (i) the index probe K5
     and the anchor build K6 (mm2tpu_torch/csrc/seed.cu) against their
     plain versions on the card, on the full-size index and every read in
     the contract bucketed as the path buckets it: (start, cnt) of every
     count probe, the sorted anchors and n of every fused dispatch, and
     K1's f and p on them for the dispatches of the smallest N (up to
     SEED_PLAIN_STEPS plain steps) all equal; K5, K6, the sort step,
     torch.searchsorted and torch.sort timed at the largest dispatch;
     (ii) `--seed-backend gpu`: its PAF byte-identical to phase 5's, only
     K5, K6 and K1 launched, with the seed.* counters, seed.gpu_busy,
     chain.gpu_busy and the idle share
 5r. the stream mode on phase 5's genome and reads: (i) K1 and K2 (cDNA
     contract) at B = 1 on scripts/train_router_torch.py's synthetic
     tasks, n = 512 to 32768, each timed end to end (pack, upload,
     launch, readback) beside the committed H100 cost model's
     predict_dev, and held against its plain version (f and p equal) at
     four of the sizes, and the model's predictions and placement held
     against the first 100 reads' real tasks, each timed on the card and
     in the host DP (printed, not gated: times vary); (ii) `--map-mode stream --chain-backend gpu -t
     8`: its PAF byte-identical to phase 5's batch PAF, every task one K1
     launch, none on the host; (iii) `--chain-backend native`: no kernel
     launched; (iv) `auto` with the committed H100 constants: >= 95% of
     the reads mapped, route.gpu, route.gpu_anchors and route.host
     printed, each read's lines equal to (ii)'s or (iii)'s except at
     most the rechained reads, and the walls, chain.gpu_busy and idle
     shares of (ii)-(iv) beside phase 5's; (v) `-a --align-backend gpu
     --align-tpu-min-mat 1` in stream mode on the first 100 map-ont
     reads (K3) and on 50 seeded spliced reads (`-x splice`, K4), both
     chained on the card: each fill one launch, none on the host, and
     the SAMs byte-identical to `--align-backend host`'s; (vi)
     `--split-prefix` with -I so that the index comes in two parts: two,
     >= 95% of the reads mapped, no .tmp file left
  6. the map-ont SAM path: the same reads with `-a --align-backend gpu
     --align-tpu-min-mat 1`, every extension fill on K3 (the flushes'
     serial rows ext.d2_rows, the wide fills ext.d2_wide, K3's card time
     a row, ext.gpu_busy / ext.d2_rows, and its own time from its
     stamps, ext.d2_kernel), then with `--align-backend host` (the
     native extension): the SAMs must be byte-identical without @PG, and
     only the kernels may have run
  7. (deep) the first 60 reads of at most 8 kb mapped again through the PAF
     path with the plain chaining on CUDA tensors, and the first 20 of
     them through the SAM path with the plain extd2 on CUDA tensors:
     their PAF and SAM lines must be byte-identical to the kernels'
  8. the -x sr paired path on the same genome: 10,000 seeded read pairs
     of 2 x 150 bp to PAF, and the first 2000 of them to SAM with `-a
     --align-backend gpu --align-tpu-min-mat 1` (K3's counters as in
     phase 6) and to SAM with `--align-backend host`; the SAMs
     byte-identical without @PG, >= 90% of the pairs mapped, only K2 (and
     K3) launched and no plain version run
  9. the -x splice path: 1000 seeded spliced reads to PAF (only K2
     launched), to SAM with `-a --align-backend gpu --align-tpu-min-mat 1`
     (every splice fill on K4: only K2 and K4 launched, no fill left on
     the host; the flushes' serial rows ext.s2_rows, the wide fills
     ext.s2_wide, K4's card time a row, ext.gpu_busy / ext.s2_rows, and
     its own time from its stamps, ext.s2_kernel),
     to SAM with `--align-backend host` (byte-identical without @PG), and
     the first 250 to PAF with CIGARs (`-c`) through K4; >= 90% of the
     reads mapped
 10. (deep) the first 500 pairs and the first 10 spliced reads mapped
     again with the plain chaining of both contracts on CUDA tensors:
     their PAF lines must be byte-identical to the kernels'; the first 2
     spliced reads through the SAM path with the plain exts2 on CUDA
     tensors: their SAM records must be byte-identical to K4's
 11. no module of jax or of the JAX package loaded; a JSON line per
     kernel (times, launches, bound, stream-mode launches and, from 5r,
     B = 1 times), the card's name and power limit,
     then {"ok": true, "device": {...}} last

Everything runs through `mm2tpu_torch`; the script imports nothing of
JAX and nothing of the JAX package. The plain versions' agreement with
the NumPy oracles and with the Pallas kernels is held in the CPU tests
(tests/test_torch_chain_v3.py, tests/test_torch_chain_v2.py,
tests/test_torch_ksw2_extd2.py, tests/test_torch_ksw2_exts2.py).
"""
from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"
WORKLOAD = dict(genome_mb=48, n_reads=1000, seed=0)
MIN_MAPPED = 0.95
# map-ont reads mapped again through the plain versions (phase 7), few
# enough that the script with --deep stays near 900 s of its 1200 s limit
PARITY_READS, PARITY_MAX_LEN = 60, 8000
SAM_READS = 1000          # reads of the SAM path (all of the workload)
EXT_PARITY_READS = 20     # of the parity reads, through the plain extd2
# (B, N) of the kernel-vs-plain batches: the main path's buckets run
# from N = 1024 to 65536 with B up to 128. The last shape is the one the
# kernel line of the JSON reports; it runs the map-ont setting only (its
# plain version takes ~30 s a call), the others every setting.
SHAPES = [(8, 1024), (32, 8192), (64, 16384), (128, 65536)]
# the batch shaped like the pipeline's launches (B_SIZES' largest, the
# chunk's tasks then empty rows): (B, real rows, N) for K1 and for K2
PIPELINE_BATCH = {"chain_v3": (128, 100, 8192), "chain_v2": (128, 100, 1024)}
CONFIGS = {
    "map-ont": dict(max_dist_x=5000, max_dist_y=5000, bw=500, iter_cap=5000,
                    gap_scale=1.0),
    "iter_cap500": dict(max_dist_x=5000, max_dist_y=5000, bw=500,
                        iter_cap=500, gap_scale=1.0),
    "gap_scale0.8": dict(max_dist_x=5000, max_dist_y=5000, bw=500,
                         iter_cap=5000, gap_scale=0.8),
    "mdx>mdy": dict(max_dist_x=5000, max_dist_y=800, bw=500, iter_cap=5000,
                    gap_scale=1.0),
}
# extd2 kernel-vs-plain fills: (B, shortest, longest target, bands). The
# last shape is the one the kernel line of the JSON reports.
EXT_SHAPES = [(8, 300, 1000, (500, -1)), (64, 300, 1000, (500, -1)),
              (64, 2000, 5000, (500,))]
# the bands K3 is timed at on the last shape: the kernel line's, and
# map-ont's extension band, int(1.5 * 500 + 1)
EXT_TIMED_BANDS = (500, 751)
# K3's fills too wide for its shared-memory ring (ring_need > RING_MAX =
# 2048 columns at w = -1), launched beside fills that fit it: (number,
# shortest, longest target) of each part, all global fills
EXTD2_WIDE = [(3, 2300, 2600), (2, 300, 1000)]
# map-ont scoring: match 2, mismatch 4, N -1; gaps (4, 2) and (24, 1)
EXT_GAPS = dict(q=4, e=2, q2=24, e2=1)
EXT_ZDROP = 400
KSW_EZ_RIGHT, KSW_EZ_APPROX_MAX, KSW_EZ_APPROX_DROP = 0x02, 0x08, 0x10
KSW_EZ_EXTZ_ONLY, KSW_EZ_REV_CIGAR = 0x40, 0x80
EXT_FLAGS = {
    "0": 0,
    "APPROX_MAX": KSW_EZ_APPROX_MAX,
    "APPROX_MAX|APPROX_DROP": KSW_EZ_APPROX_MAX | KSW_EZ_APPROX_DROP,
    "EXTZ_ONLY": KSW_EZ_EXTZ_ONLY,
    "EXTZ_ONLY|RIGHT|REV_CIGAR": KSW_EZ_EXTZ_ONLY | KSW_EZ_RIGHT
    | KSW_EZ_REV_CIGAR,
}
EZ_FIELDS = ("max", "zdropped", "max_q", "max_t", "mqe", "mqe_t", "mte",
             "mte_q", "score", "reach_end", "cigar")
# K2 kernel-vs-plain batches: the contracts (is_cdna, n_segs) of read
# pairs, spliced reads and spliced pairs, at the shapes of the short-read
# buckets and of a long-read bucket, under the settings of -x sr (2 x 150
# bp pairs: gap_ref 500, gap_qry 300, bw 100) and -x splice, and two more.
# At the last shape each contract is timed under its own path's setting;
# the JSON line reports (cDNA, 1 segment) under -x splice's.
V2_SHAPES = [(8, 1024), (128, 1024), (64, 16384)]
V2_CONTRACTS = [(False, 2), (True, 1), (True, 2)]
V2_CONFIGS = {
    "sr": dict(max_dist_x=500, max_dist_y=300, bw=100, iter_cap=1024,
               gap_scale=1.0),
    "splice": dict(max_dist_x=200000, max_dist_y=2000, bw=200000,
                   iter_cap=1024, gap_scale=1.0),
    "gap_scale0.8": dict(max_dist_x=5000, max_dist_y=5000, bw=500,
                         iter_cap=1024, gap_scale=0.8),
    "iter_cap500": dict(max_dist_x=5000, max_dist_y=5000, bw=500,
                        iter_cap=500, gap_scale=1.0),
}
V2_TIMED = {(False, 2): "sr", (True, 1): "splice", (True, 2): "splice"}
# the -x sr paired path: read pairs on the smoke genome; the first
# SR_PARITY_PAIRS of them again through the plain chaining
SR_PAIRS, SR_PARITY_PAIRS = 10000, 500
# the pairs of the two -x sr SAM runs (the PAF maps all SR_PAIRS): the
# first 2000, so that the script stays under ~1000 s of its limit
SR_SAM_PAIRS = 2000
# the -x splice path: spliced reads on the smoke genome; the first
# SPLICE_PARITY_READS of them again through the plain chaining
SPLICE_READS, SPLICE_PARITY_READS = 1000, 10
# of the spliced reads, the first few through the SAM path with the plain
# exts2 on CUDA tensors (a flush of it takes seconds)
EXTS2_PARITY_READS = 2
# the spliced reads of the -c run through K4 (the SAM runs map all)
SPLICE_CIGAR_READS = 250
MIN_MAPPED_SR_SPLICE = 0.90
# The bound of a kernel (the least time the card could take for the same
# work): the larger of its bytes over the H100's 3.35 TB/s and its int32
# instructions over 132 SMs x 64 int32 lanes at the SM clock. Instructions
# a chaining candidate takes (gates, gap, key, max; counted from the first
# design of csrc/chain.cu, one warp a task, and kept so that the bounds of
# later designs compare) and a DP cell in csrc/ksw2_extd2.cu, counted
# from the source.
SMS, INT32_LANES, HBM_BYTES_S = 132, 64, 3.35e12
# csrc/seed.cu, counted from the source: a step of K5's search (the key's
# load and address, the 64-bit compare, two selects, the halving), and
# K6's work for a slot (the search of the tile's scanned counts, the pos
# load, the strand test, x, y_pos, the sort key and y, two stores) and
# for a minimizer (its loads, the kept test, its part of the scan)
OPS_PER_PROBE_STEP, OPS_PER_SLOT, OPS_PER_MINIMIZER = 10, 70, 25
# phase 5s holds K1 against its plain version on the seeded anchors of the
# path's dispatches with the smallest N, up to this many serial steps of
# the plain version in all (~0.5 ms a step on the card: ~20 s)
SEED_PLAIN_STEPS = 40960
OPS_PER_CANDIDATE = {"chain_v3": 32, "chain_v2": 45}
OPS_PER_CELL = 50
# a K4 cell in csrc/ksw2_exts2.cu: the score refresh, seven state and
# site loads, the four-way max with its direction, three gate compares,
# five state stores and the direction byte, the H update and the
# (value, priority) compare of the exact max
OPS_PER_CELL_EXTS2 = 60
# K4 kernel-vs-plain fills: two exons around one GT-AG intron, (B, exon
# lengths, intron lengths); the last shape is the timed one, which the
# kernel line of the JSON reports
EXTS2_SHAPES = [(8, (80, 400), (100, 1000)), (64, (200, 400), (2000, 8000))]
# K4's fills too wide for its shared-memory ring (min(qlen, tlen) + 16 >
# ksw2_exts2.RING_MAX columns, the third one cut to 3/4 of its query),
# launched beside fills that fit it: (B, exons, introns) of each part
EXTS2_WIDE = [(3, (2800, 3000), (200, 500)), (2, (80, 400), (100, 1000))]
# the splice preset's scoring (options.py: -x splice): match 1, mismatch
# 2, N -1; q, e = 2, 1, intron open q2 = 32, non-canonical 9, junction
# bonus 9, zdrop 200
SPLICE_MAT = dict(a=1, b=2)
SPLICE_GAPS = dict(q=2, e=1, q2=32, noncan=9)
SPLICE_ZDROP, SPLICE_JUNC_BONUS = 200, 9
KSW_EZ_SPLICE_FOR, KSW_EZ_SPLICE_REV, KSW_EZ_SPLICE_FLANK = 0x100, 0x200, \
    0x400
FOR_FLANK = KSW_EZ_SPLICE_FOR | KSW_EZ_SPLICE_FLANK
# the flag sets of align1's splice fills: a global fill, the reverse
# strand, the left extension (RIGHT|REV_CIGAR|EXTZ_ONLY), the right
# extension, the gap fills (APPROX_MAX) and APPROX_MAX|APPROX_DROP with
# --junc-bed flags
EXTS2_FLAGS = {
    "SPLICE_FOR|FLANK": (FOR_FLANK, False),
    "SPLICE_REV|FLANK": (KSW_EZ_SPLICE_REV | KSW_EZ_SPLICE_FLANK, False),
    "EXTZ_ONLY|RIGHT|REV_CIGAR": (FOR_FLANK | KSW_EZ_EXTZ_ONLY | KSW_EZ_RIGHT
                                  | KSW_EZ_REV_CIGAR, False),
    "EXTZ_ONLY": (FOR_FLANK | KSW_EZ_EXTZ_ONLY, False),
    "APPROX_MAX": (FOR_FLANK | KSW_EZ_APPROX_MAX, False),
    "APPROX_MAX|APPROX_DROP, junc": (FOR_FLANK | KSW_EZ_APPROX_MAX
                                     | KSW_EZ_APPROX_DROP, True),
}


_T0 = time.monotonic()


def say(phase, msg):
    """One line of a phase's report, with the seconds since the script
    started."""
    print("[chip_smoke] phase %s (%.1f s): %s" % (
        phase, time.monotonic() - _T0, msg), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def synth_anchors(n, seed=0, n_rids=1, rev_frac=0.0, span=15, scale=50,
                  collinear=False):
    """x-sorted (n, 2) uint64 anchors: a copy of the generator in
    tests/test_chain_pallas.py, whose module imports pytest. `collinear`
    puts every anchor on one diagonal, `span` apart: f then grows by
    `span` a step, to about 2^20 at n = 65536, near the limit of the
    kernel's sc * 1024 key packing."""
    rng = np.random.default_rng(seed)
    if collinear:
        refpos = qpos = span * np.arange(n, dtype=np.int64)
    else:
        refpos = np.sort(rng.integers(0, scale * n, n))
        qpos = np.clip(refpos + rng.integers(-400, 400, n), 0, None)
    rid = rng.integers(0, n_rids, n).astype(np.uint64)
    strand = (rng.random(n) < rev_frac).astype(np.uint64)
    x = (strand << np.uint64(63)) | (rid << np.uint64(32)) | \
        refpos.astype(np.uint64)
    y = (np.uint64(span) << np.uint64(32)) | qpos.astype(np.uint64)
    a = np.stack([x, y], axis=1)
    return a[np.argsort(a[:, 0], kind="stable")]


def synth_batch(B, N, seed):
    """Rows cycle through multi-rid reverse-strand, dense (scale 2:
    windows hit the 1024 cap), tie-heavy, sparse and collinear anchors,
    with uneven n in [N/2, N] and padded tails. Returns the CUDA planes
    hi, lo, qi, span, n, avg."""
    from mm2tpu_torch.ops.chain_packed import (derive_qss, pack_tasks16,
                                               planes_to_torch)
    kinds = [dict(n_rids=3, rev_frac=0.4), dict(scale=2),
             dict(scale=1, span=19), dict(scale=200, n_rids=2, rev_frac=1.0),
             dict(collinear=True)]
    rng = np.random.default_rng(seed)
    tasks = [synth_anchors(int(rng.integers(N // 2, N + 1)), seed=seed + b,
                           **kinds[b % len(kinds)]) for b in range(B)]
    hi, lo, yhi, ylo, n, avg = planes_to_torch(*pack_tasks16(tasks, N),
                                               DEVICE)
    qi, span, _ = derive_qss(yhi, ylo)
    return hi, lo, qi.contiguous(), span.contiguous(), n, avg


def pipeline_batch(B, n_real, N, seed, n_segs=1, cdna=False):
    """B rows as the pipeline launches them: `n_real` tasks of ragged n in
    [1, N] (every fourth one near N, so that the window hits its cap),
    then empty rows. Returns the CUDA planes hi, lo, qi, span, sid, n,
    avg."""
    from mm2tpu_torch.ops.chain_packed import (derive_qss, pack_tasks16,
                                               planes_to_torch)
    kinds = [dict(n_rids=3, rev_frac=0.4), dict(scale=1, span=19),
             dict(scale=400 if cdna else 200, n_rids=2, rev_frac=1.0),
             dict(scale=2)]
    rng = np.random.default_rng(seed)
    tasks = []
    for b in range(n_real):
        n = int(rng.integers(N - 31, N + 1) if b % 4 == 3
                else rng.integers(1, N + 1))
        a = synth_anchors(n, seed=seed + b, **kinds[b % 4])
        tasks.append(two_segment(a, seed + b) if n_segs > 1 else a)
    tasks += [np.zeros((0, 2), np.uint64)] * (B - n_real)
    hi, lo, yhi, ylo, n, avg = planes_to_torch(*pack_tasks16(tasks, N),
                                               DEVICE)
    qi, span, sid = derive_qss(yhi, ylo)
    return (hi, lo, qi.contiguous(), span.contiguous(), sid.contiguous(), n,
            avg)


def chain_err(what, f, p, f2, p2):
    """The max abs error of a chaining kernel's (f, p) against its plain
    version's; raises unless they are equal."""
    err = max(int((f - f2).abs().max()), int((p - p2).abs().max()))
    if not (torch.equal(f, f2) and torch.equal(p, p2)):
        raise AssertionError("%s: max abs err %d" % (what, err))
    return err


def cuda_ms(fn, reps, warmup=True):
    """Mean CUDA-event time of `reps` calls of `fn`, in ms, and the last
    call's result."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, out


def sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return float(out)


def bound(n_bytes, n_ops, clock_mhz):
    """(bound ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = n_ops / (SMS * INT32_LANES * clock_mhz * 1e6)
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def chain_work(n, N, cap, planes, ops_per_candidate):
    """(bytes, int32 instructions) of one chaining call on rows of n
    anchors padded to N: `planes` int32 input planes and avg read once, f
    and p written once; min(cap, i) candidates for each real anchor i."""
    n = [int(k) for k in n.reshape(-1).tolist()]
    cands = sum(int(np.minimum(np.arange(k), cap).sum()) for k in n)
    return (4 * planes * len(n) * N + 4 * len(n) + 8 * len(n) * N,
            cands * ops_per_candidate)


def phase_build():
    """The port's native runtime (forced: a stale library corrupts chains
    silently) and the CUDA kernels, built side by side."""
    from concurrent.futures import ThreadPoolExecutor

    from mm2tpu_torch.native import lib as native
    from mm2tpu_torch.ops import _build

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(2) as ex:
        host = ex.submit(timed, lambda: native.build(force=True))
        kern = ex.submit(timed, _build.load)
        (so, native_s), (_, kernel_s) = host.result(), kern.result()
    if not native.available() or native.loaded_from != so:
        raise RuntimeError("the native library %s did not load after the "
                           "build" % so)
    say(1, "native runtime built into %s in %.3f s; CUDA kernels built and "
        "loaded in %.3f s" % (so.relative_to(REPO), native_s, kernel_s))
    if _build.build_log:
        for ln in _build.build_log.strip().splitlines():
            if "entry function" in ln or "registers" in ln or "spill" in ln:
                say(1, "ptxas: " + ln.strip())


def phase_kernel_vs_plain():
    """Returns ({(B, N): (kernel ms, plain ms)}, max abs error, the work
    of the timed call at the last shape). Each shape but the last runs
    every setting of CONFIGS; the map-ont setting is timed: the kernel
    over 5 calls after a warm-up, the plain version over the one call
    that is compared."""
    from mm2tpu_torch.ops import chain_v3
    times, max_err = {}, 0
    for si, (B, N) in enumerate(SHAPES):
        planes = synth_batch(B, N, seed=100 + si)
        last = si == len(SHAPES) - 1
        for name, cfg in CONFIGS.items():
            if last and name != "map-ont":
                continue
            kernel = functools.partial(chain_v3.chain_scores_v3, *planes,
                                       **cfg)
            plain = functools.partial(chain_v3.chain_scores_v3_reference,
                                      *planes, **cfg)
            if name == "map-ont":
                ms, (f, p) = cuda_ms(kernel, 5)
                plain_ms, (f2, p2) = cuda_ms(plain, 1, warmup=False)
                times[(B, N)] = (ms, plain_ms)
                work = chain_work(planes[4], N, min(cfg["iter_cap"], 1024),
                                  4, OPS_PER_CANDIDATE["chain_v3"])
            else:
                f, p = kernel()
                f2, p2 = plain()
            max_err = max(max_err, chain_err(
                "kernel != plain at (%d, %d) %s" % (B, N, name), f, p, f2,
                p2))
            say(2, "kernel == plain at (B, N) = (%d, %d), %s; max f %d"
                % (B, N, name, int(f.max())))
        steps = int(planes[4].max())
        say(2, "time at (%d, %d), map-ont: kernel %.3f ms, plain %.3f ms; "
            "largest n %d: %.3f us a step" % (
                B, N, *times[(B, N)], steps, times[(B, N)][0] * 1e3 / steps))
    B, n_real, N = PIPELINE_BATCH["chain_v3"]
    hi, lo, qi, span, _, n, avg = pipeline_batch(B, n_real, N, seed=150)
    for name, cfg in CONFIGS.items():
        f, p = chain_v3.chain_scores_v3(hi, lo, qi, span, n, avg, **cfg)
        f2, p2 = chain_v3.chain_scores_v3_reference(hi, lo, qi, span, n, avg,
                                                    **cfg)
        max_err = max(max_err, chain_err(
            "kernel != plain on the pipeline-shaped batch, %s" % name, f, p,
            f2, p2))
    say(2, "kernel == plain on the pipeline-shaped batch (B, N) = (%d, %d): "
        "%d rows of n %d-%d and %d empty rows, under %s" % (
            B, N, n_real, int(n[:n_real].min()), int(n.max()), B - n_real,
            ", ".join(CONFIGS)))
    return times, max_err, work


def two_segment(a, seed):
    """`a` with segment ids 0/1 in y's segment bits (bits 48-55, as
    chain_ref.unpack_anchors reads them), drawn anchor by anchor, and one
    anchor in ten moved onto its predecessor's x (dr == 0: across
    segments, the pair bonus). A copy of tests/test_torch_chain_v2.py's."""
    rng = np.random.default_rng(seed)
    a = a.copy()
    n = len(a)
    sid = (rng.random(n) < 0.5).astype(np.uint64)
    a[:, 1] |= sid << np.uint64(48)
    dup = np.flatnonzero(rng.random(n) < 0.1)
    dup = dup[dup > 0]
    a[dup, 0] = a[dup - 1, 0]
    return a


def synth_batch_v2(B, N, seed, n_segs):
    """synth_batch's rows (collinear ones swapped for sparse rows with
    gaps of tens of kb, where the cDNA cost differs), as two segments
    when n_segs > 1. Returns the CUDA planes hi, lo, qi, span, sid, n,
    avg."""
    from mm2tpu_torch.ops.chain_packed import (derive_qss, pack_tasks16,
                                               planes_to_torch)
    kinds = [dict(n_rids=3, rev_frac=0.4), dict(scale=2),
             dict(scale=1, span=19), dict(scale=400, n_rids=2, rev_frac=1.0)]
    rng = np.random.default_rng(seed)
    tasks = []
    for b in range(B):
        a = synth_anchors(int(rng.integers(N // 2, N + 1)), seed=seed + b,
                          **kinds[b % len(kinds)])
        tasks.append(two_segment(a, seed + b) if n_segs > 1 else a)
    hi, lo, yhi, ylo, n, avg = planes_to_torch(*pack_tasks16(tasks, N),
                                               DEVICE)
    qi, span, sid = derive_qss(yhi, ylo)
    return (hi, lo, qi.contiguous(), span.contiguous(), sid.contiguous(), n,
            avg)


def phase_v2_kernel_vs_plain():
    """K2 against its plain version on every contract, shape and setting
    of V2_*, and on a pipeline-shaped batch for each contract. Returns
    ({contract: (kernel ms, plain ms)} at the last shape under V2_TIMED's
    settings, max abs error, the work of the timed (cDNA, 1 segment)
    call)."""
    from mm2tpu_torch.ops import chain_v2
    times, max_err, work = {}, 0, None
    for si, (B, N) in enumerate(V2_SHAPES):
        for ci, (is_cdna, n_segs) in enumerate(V2_CONTRACTS):
            planes = synth_batch_v2(B, N, 300 + 10 * si + ci, n_segs)
            for name, cfg in V2_CONFIGS.items():
                kw = dict(cfg, is_cdna=is_cdna, n_segs=n_segs)
                kernel = functools.partial(chain_v2.chain_scores_v2, *planes,
                                           **kw)
                plain = functools.partial(
                    chain_v2.chain_scores_v2_reference, *planes, **kw)
                timed = si == len(V2_SHAPES) - 1 and \
                    name == V2_TIMED[(is_cdna, n_segs)]
                if timed:
                    ms, (f, p) = cuda_ms(kernel, 5)
                    plain_ms, (f2, p2) = cuda_ms(plain, 1, warmup=False)
                    times[(is_cdna, n_segs)] = (ms, plain_ms)
                    if (is_cdna, n_segs) == (True, 1):
                        work = chain_work(planes[5], N, cfg["iter_cap"], 5,
                                          OPS_PER_CANDIDATE["chain_v2"])
                else:
                    f, p = kernel()
                    f2, p2 = plain()
                max_err = max(max_err, chain_err(
                    "K2 != plain at (%d, %d), is_cdna=%s, n_segs=%d, %s"
                    % (B, N, is_cdna, n_segs, name), f, p, f2, p2))
                chained = int((p >= 0).sum())
                steps = int(planes[5].max())
                say(4, "K2 == plain at (B, N) = (%d, %d), is_cdna=%s, "
                    "n_segs=%d, %s: max f %d, %d anchors chained%s" % (
                        B, N, is_cdna, n_segs, name, int(f.max()), chained,
                        "; kernel %.3f ms, plain %.3f ms; largest n %d: "
                        "%.3f us a step" % (
                            *times[(is_cdna, n_segs)], steps,
                            times[(is_cdna, n_segs)][0] * 1e3 / steps)
                        if timed else ""))
    B, n_real, N = PIPELINE_BATCH["chain_v2"]
    for ci, (is_cdna, n_segs) in enumerate(V2_CONTRACTS):
        planes = pipeline_batch(B, n_real, N, 350 + ci, n_segs, is_cdna)
        for name, cfg in V2_CONFIGS.items():
            kw = dict(cfg, is_cdna=is_cdna, n_segs=n_segs)
            f, p = chain_v2.chain_scores_v2(*planes, **kw)
            f2, p2 = chain_v2.chain_scores_v2_reference(*planes, **kw)
            max_err = max(max_err, chain_err(
                "K2 != plain on the pipeline-shaped batch, is_cdna=%s, "
                "n_segs=%d, %s" % (is_cdna, n_segs, name), f, p, f2, p2))
        say(4, "K2 == plain on the pipeline-shaped batch (B, N) = (%d, %d), "
            "is_cdna=%s, n_segs=%d: %d rows of n %d-%d and %d empty rows, "
            "under %s" % (B, N, is_cdna, n_segs, n_real,
                          int(planes[5][:n_real].min()),
                          int(planes[5].max()), B - n_real,
                          ", ".join(V2_CONFIGS)))
    return times, max_err, work


def mutate(seq, rng, sub=0.1, ind=0.05):
    """A copy of `seq` with substitutions and indels (the generator of
    tests/test_ksw2_pallas.py, whose module imports pytest)."""
    out = []
    for c in seq:
        x = rng.random()
        if x < sub:
            out.append(rng.integers(0, 4))
        elif x < sub + ind / 2:
            continue
        elif x < sub + ind:
            out.append(int(c))
            out.append(rng.integers(0, 4))
        else:
            out.append(int(c))
    return np.array(out, dtype=np.uint8)


def synth_fills(B, lo, hi, seed):
    """B (query, target) fills with targets of lo..hi bases. Even fills
    are global (the query is the whole target, mutated), odd ones
    extension-shaped (a mutated 2/3 prefix); every fourth query carries
    two N bases."""
    rng = np.random.default_rng(seed)
    tasks = []
    for b in range(B):
        t8 = rng.integers(0, 4, int(rng.integers(lo, hi + 1))).astype(
            np.uint8)
        q8 = mutate(t8 if b % 2 == 0 else t8[: len(t8) * 2 // 3], rng)
        if b % 4 == 3:
            q8[rng.integers(0, len(q8), 2)] = 4
        tasks.append((q8, t8))
    return tasks


def ext_matrix():
    mat = np.full((5, 5), -4, np.int8)
    np.fill_diagonal(mat, 2)
    mat[4, :] = mat[:, 4] = -1
    return mat


def kernel_and_plain(batch, args, kernel_fn, plain_fn):
    """`batch(*args, fn=...)` on the card through a kernel's wrapper, then
    through its plain version. Returns (the kernel's results, max abs
    error over the raw outputs (ez, op codes, i, j), whether those are
    equal, the (fill, field) pairs of the results that differ, kernel
    s, plain s)."""
    raw, secs = {}, {}

    def run(tag, fn):
        def call(*a, **kw):
            raw[tag] = fn(*a, **kw)
            return raw[tag]
        t0 = time.perf_counter()
        out = batch(*args, device=DEVICE, fn=call)
        torch.cuda.synchronize()
        secs[tag] = time.perf_counter() - t0
        return out

    kern, plain = run("kernel", kernel_fn), run("plain", plain_fn)
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              for a, b in zip(raw["kernel"], raw["plain"]))
    same = all(torch.equal(a, b) for a, b in zip(raw["kernel"], raw["plain"]))
    bad = [(i, f) for i, (k, p) in enumerate(zip(kern, plain))
           for f in EZ_FIELDS if getattr(k, f) != getattr(p, f)]
    return kern, err, same, bad, secs["kernel"], secs["plain"]


def phase_ext_kernel_vs_plain():
    """K3 against its plain version on the card, on every shape, band
    and flag set of EXT_SHAPES and EXT_FLAGS, on the timed calls at
    EXT_TIMED_BANDS and on the wide launch (`phase_ext_wide`). Returns
    (kernel ms, plain ms) at the last of EXT_SHAPES (flag 0, w = 500),
    the max abs error over every ez register, op code and final (i, j)
    compared, and the timed call's work: (bytes, int32 instructions) for
    the fills' bases in, ez, op codes and (i, j) out, and the band's
    cells (min(2w + 1, qlen) x tlen a fill)."""
    from mm2tpu_torch.ops import ksw2_extd2 as X
    mat = ext_matrix()
    max_err, timed, work = 0, None, None
    for si, (B, lo, hi, bands) in enumerate(EXT_SHAPES):
        tasks = synth_fills(B, lo, hi, seed=200 + si)
        for w in bands:
            for name, flag in EXT_FLAGS.items():
                end_bonus = 10 if flag & KSW_EZ_EXTZ_ONLY else -1
                args = (tasks, mat, *EXT_GAPS.values(), w, EXT_ZDROP,
                        end_bonus, flag)
                kern, err, same, bad, _, _ = kernel_and_plain(
                    X.extd2_batch, args, X.extd2_traced,
                    X.extd2_traced_reference)
                max_err = max(max_err, err)
                if not same or bad:
                    raise AssertionError(
                        "extd2 kernel != plain at B=%d, %d-%d bp, w=%d, "
                        "flag %s: max abs err %d, fields %s"
                        % (B, lo, hi, w, name, err, bad[:5]))
                say(3, "kernel == plain at B=%d, %d-%d bp, w=%d, flag %s: "
                    "%d CIGARs, %d z-dropped" % (
                        B, lo, hi, w, name, sum(bool(r.cigar) for r in kern),
                        sum(r.zdropped for r in kern)))
        if si == len(EXT_SHAPES) - 1:
            pk = X.pack_fills(tasks, mat, **EXT_GAPS)
            planes = [torch.from_numpy(a).to(DEVICE)
                      for a in (pk.lens, pk.tsf, pk.qcol)]
            qlens = [len(q8) for q8, _ in tasks]
            tlens = [len(t8) for _, t8 in tasks]
            smax = int(pk.lens.sum(1).max()) - 1
            for w in EXT_TIMED_BANDS:
                kw = dict(**EXT_GAPS, zdrop=EXT_ZDROP, sc_mch=pk.sc_mch,
                          sc_mis=pk.sc_mis, sc_N=pk.sc_N, w=w, right=False,
                          approx=False, approx_drop=False, extz_only=False,
                          end_bonus=-1)
                ms, out = cuda_ms(functools.partial(
                    X.extd2_traced, *planes, **kw, lens_h=pk.lens), 3)
                stamps = X.launch_stamps().cpu().numpy()
                plain_ms, ref = cuda_ms(functools.partial(
                    X.extd2_traced_reference, *planes, **kw), 1,
                    warmup=False)
                err = max(int((a.to(torch.int64) - b.to(torch.int64))
                              .abs().max()) for a, b in zip(out, ref))
                if err:
                    raise AssertionError("extd2 kernel != plain in the "
                                         "timed call at w=%d: max abs err "
                                         "%d" % (w, err))
                max_err = max(max_err, err)
                if w == EXT_TIMED_BANDS[0]:
                    timed = (ms, plain_ms)
                    work = (sum(qlens) + sum(tlens)
                            + B * (4 * X.NREG + smax + 8),
                            OPS_PER_CELL * sum(min(2 * w + 1, q) * t
                                               for q, t in zip(qlens,
                                                               tlens)))
                W, smem, _ = X.ring_plan(pk.lens, w)
                say(3, "time at B=%d, %d-%d bp, w=%d, flag 0 (%d rows at "
                    "most, a ring of W = %d): kernel %.3f ms, plain %.3f "
                    "ms; kernel == plain" % (B, lo, hi, w, smax, W, ms,
                                             plain_ms))
                say(3, stamp_split(pk.lens, out, stamps))
    return timed, max(max_err, phase_ext_wide(mat)), work


def phase_ext_wide(mat):
    """K3 against its plain version on one launch of EXTD2_WIDE's fills
    at w = -1 under flag 0: the wide part's fills exceed the
    shared-memory ring and must run on state in device memory
    (ksw2_extd2.wide_fills counts them), the rest on the ring; every ez
    register, op code, (i, j) and CIGAR equal. Returns the max abs
    error."""
    from mm2tpu_torch.ops import ksw2_extd2 as X
    rng = np.random.default_rng(203)
    tasks = []
    for n, lo, hi in EXTD2_WIDE:
        for _ in range(n):
            t8 = rng.integers(0, 4, int(rng.integers(lo, hi + 1))).astype(
                np.uint8)
            tasks.append((mutate(t8, rng), t8))
    nw = EXTD2_WIDE[0][0]
    lens = np.array([(len(q8), len(t8)) for q8, t8 in tasks])
    W, smem, wide = X.ring_plan(lens, -1)
    if list(wide) != [True] * nw + [False] * (len(tasks) - nw):
        raise AssertionError("EXTD2_WIDE: ring_plan's wide mask %s for "
                             "lengths %s" % (wide, lens.tolist()))
    args = (tasks, mat, *EXT_GAPS.values(), -1, EXT_ZDROP, -1, 0)
    before = X.wide_fills
    kern, err, same, bad, k_s, p_s = kernel_and_plain(
        X.extd2_batch, args, X.extd2_traced, X.extd2_traced_reference)
    counted = X.wide_fills - before
    if not same or bad or counted != nw:
        raise AssertionError("extd2 wide launch: kernel == plain %s, fields "
                             "%s, wide_fills counted %d of %d"
                             % (same, bad[:5], counted, nw))
    say(3, "K3 == plain on one launch of %d wide fills (lengths %s, on "
        "state in device memory, wide_fills +%d) and %d that fit a ring "
        "of W = %d (%d B of shared memory), w = -1: %d CIGARs; %.3f s with "
        "the kernel, %.3f s with the plain version" % (
            nw, lens[:nw].tolist(), counted, len(tasks) - nw, W, smem,
            sum(bool(r.cigar) for r in kern), k_s, p_s))
    return err


def splice_matrix():
    mat = np.full((5, 5), -SPLICE_MAT["b"], np.int8)
    np.fill_diagonal(mat, SPLICE_MAT["a"])
    mat[4, :] = mat[:, 4] = -1
    return mat


def synth_splice_fills(B, exon, intron, seed):
    """B (query, target, junc) splice fills: the target is exon 1, a
    GT...AG intron and exon 2, the query both exons with 5% substitutions
    and 2% indels. Every third query stops inside exon 2 (extension
    shape), every fifth has a random tail after exon 1, 250 bases longer
    than exon 2 (a Z-drop), every
    fourth carries two N bases; junc marks the intron's ends (the
    --junc-bed flags of a donor and an acceptor)."""
    rng = np.random.default_rng(seed)
    tasks = []
    for b in range(B):
        e1, e2 = (rng.integers(0, 4, int(rng.integers(exon[0], exon[1] + 1)))
                  .astype(np.uint8) for _ in range(2))
        it = rng.integers(0, 4, int(rng.integers(intron[0], intron[1] + 1))
                          ).astype(np.uint8)
        it[:2], it[-2:] = (2, 3), (0, 2)
        t8 = np.concatenate([e1, it, e2])
        q8 = mutate(np.concatenate([e1, e2]), rng, sub=0.05, ind=0.02)
        if b % 5 == 4:
            q8 = np.concatenate([mutate(e1, rng, sub=0.05, ind=0.02),
                                 rng.integers(0, 4, len(e2) + 250).astype(
                                     np.uint8)])
        elif b % 3 == 2:
            q8 = q8[: len(q8) * 3 // 4]
        if b % 4 == 3:
            q8[rng.integers(0, len(q8), 2)] = 4
        junc = np.zeros(len(t8), np.uint8)
        junc[len(e1)] |= 1
        junc[len(e1) + len(it) - 1] |= 2
        tasks.append((q8, t8, junc))
    return tasks


def phase_exts2_kernel_vs_plain():
    """K4 against its plain version on the card, on every shape of
    EXTS2_SHAPES and flag set of EXTS2_FLAGS (the last shape under the
    first flag set only: its plain version takes seconds), every ez
    register, op code, final (i, j) and CIGAR equal. Returns (kernel ms,
    plain ms) at the last shape, the max abs error and the timed call's
    work: (bytes, int32 instructions) for the inputs read once (lens, the
    sf image, the query, the donor and acceptor rows) and ez, the op
    codes and (i, j) written once, and Σ qlen·tlen cells."""
    from mm2tpu_torch.ops import ksw2_exts2 as S
    mat = splice_matrix()
    max_err, timed, work = 0, None, None
    for si, (B, exon, intron) in enumerate(EXTS2_SHAPES):
        fills = synth_splice_fills(B, exon, intron, seed=400 + si)
        last = si == len(EXTS2_SHAPES) - 1
        for name, (flag, with_junc) in EXTS2_FLAGS.items():
            if last and name != "SPLICE_FOR|FLANK":
                continue
            tasks = [(q8, t8, junc if with_junc else None)
                     for q8, t8, junc in fills]
            args = (tasks, mat, *SPLICE_GAPS.values(), SPLICE_ZDROP,
                    SPLICE_JUNC_BONUS, flag)
            kern, err, same, bad, _, _ = kernel_and_plain(
                S.exts2_batch, args, S.exts2_traced, S.exts2_traced_reference)
            max_err = max(max_err, err)
            if not same or bad:
                raise AssertionError(
                    "exts2 kernel != plain at B=%d, introns %d-%d bp, flag "
                    "%s: max abs err %d, fields %s"
                    % (B, *intron, name, err, bad[:5]))
            say("3b", "K4 == plain at B=%d, exons %d-%d, introns %d-%d bp, "
                "flag %s: %d CIGARs, %d with an intron (N), %d z-dropped"
                % (B, *exon, *intron, name, sum(bool(r.cigar) for r in kern),
                   sum(any(c & 15 == 3 for c in r.cigar) for r in kern),
                   sum(r.zdropped for r in kern)))
        if last:
            flag = EXTS2_FLAGS["SPLICE_FOR|FLANK"][0]
            pk = S.pack_splice_fills(fills, mat, **SPLICE_GAPS,
                                     junc_bonus=SPLICE_JUNC_BONUS, flag=flag)
            planes = [torch.from_numpy(a).to(DEVICE) for a in pk.planes()]
            kw = dict(q=SPLICE_GAPS["q"], e=SPLICE_GAPS["e"],
                      q2=SPLICE_GAPS["q2"], zdrop=SPLICE_ZDROP,
                      sc_mch=pk.sc_mch, sc_mis=pk.sc_mis, sc_N=pk.sc_N,
                      right=False, approx=False, approx_drop=False,
                      extz_only=False)
            ms, out = cuda_ms(functools.partial(S.exts2_traced, *planes,
                                                **kw, lens_h=pk.lens), 3)
            stamps = S.launch_stamps().cpu().numpy()
            plain_ms, _ = cuda_ms(functools.partial(
                S.exts2_traced_reference, *planes, **kw), 1, warmup=False)
            timed = (ms, plain_ms)
            smax = int(pk.lens.sum(1).max()) - 1
            work = (sum(a.nbytes for a in pk.planes())
                    + B * (4 * S.NREG + smax + 8),
                    OPS_PER_CELL_EXTS2 * int(
                        (pk.lens[:, 0].astype(np.int64) * pk.lens[:, 1]).sum()))
            say("3b", "time at B=%d, exons %d-%d, introns %d-%d bp, flag "
                "SPLICE_FOR|FLANK (%d rows at most): kernel %.3f ms, plain "
                "%.3f ms" % (B, *exon, *intron, smax, ms, plain_ms))
            say("3b", stamp_split(pk.lens, out, stamps))
    return timed, max(max_err, phase_exts2_wide(mat)), work


def stamp_split(lens, out, stamps):
    """A ksw2 kernel's (K3's or K4's) DP time a row and trace time a
    step, from its %globaltimer stamps (start, after the last row, after
    the trace) of each fill of one launch: the DP over the fills that ran
    every row (not z-dropped), the trace over every fill's steps (op
    codes != 255)."""
    ez, ops = (t.cpu().numpy() for t in out[:2])
    rows = lens.astype(np.int64).sum(1) - 1
    full = ez[:, 0] == 0
    dp_ns, tr_ns = stamps[:, 1] - stamps[:, 0], stamps[:, 2] - stamps[:, 1]
    steps = (ops != 255).sum(1)
    k = int(np.argmax(np.where(full, rows, -1)))
    return ("kernel stamps: DP %.3f us a row (%d fills that ran every row, "
            "%d rows); its longest fill %d rows in %.3f ms, %.3f us a row; "
            "trace %.1f ns a step (%d steps over %d fills); whole launch "
            "%.3f ms from the first start to the last stamp" % (
                dp_ns[full].sum() / 1e3 / rows[full].sum(), int(full.sum()),
                int(rows[full].sum()), rows[k], dp_ns[k] / 1e6,
                dp_ns[k] / 1e3 / rows[k], tr_ns.sum() / max(steps.sum(), 1),
                int(steps.sum()), len(steps),
                (stamps[:, 2].max() - stamps[:, 0].min()) / 1e6))


def phase_exts2_wide(mat):
    """K4 against its plain version on one launch of EXTS2_WIDE's fills:
    the wide part's fills exceed the shared-memory ring and must run on
    state in device memory (ksw2_exts2.wide_fills counts them), the rest
    on the ring; every ez register, op code, (i, j) and CIGAR equal.
    Returns the max abs error."""
    from mm2tpu_torch.ops import ksw2_exts2 as S
    (nw, exon_w, intron_w), (nn, exon_n, intron_n) = EXTS2_WIDE
    fills = synth_splice_fills(nw, exon_w, intron_w, seed=402) + \
        synth_splice_fills(nn, exon_n, intron_n, seed=403)
    flag = EXTS2_FLAGS["SPLICE_FOR|FLANK"][0]
    lens = np.array([(len(q8), len(t8)) for q8, t8, _ in fills])
    W, smem, wide = S.ring_plan(lens)
    if list(wide) != [True] * nw + [False] * nn:
        raise AssertionError("EXTS2_WIDE: ring_plan's wide mask %s for "
                             "lengths %s" % (wide, lens.tolist()))
    args = (fills, mat, *SPLICE_GAPS.values(), SPLICE_ZDROP,
            SPLICE_JUNC_BONUS, flag)
    before = S.wide_fills
    kern, err, same, bad, k_s, p_s = kernel_and_plain(
        S.exts2_batch, args, S.exts2_traced, S.exts2_traced_reference)
    counted = S.wide_fills - before
    if not same or bad or counted != nw:
        raise AssertionError("exts2 wide launch: kernel == plain %s, fields "
                             "%s, wide_fills counted %d of %d"
                             % (same, bad[:5], counted, nw))
    say("3b", "K4 == plain on one launch of %d wide fills (lengths %s, on "
        "state in device memory, wide_fills +%d) and %d that fit a ring "
        "of W = %d (%d B of shared memory): %d CIGARs, %d with an intron "
        "(N); %.3f s with the kernel, %.3f s with the plain version" % (
            nw, lens[:nw].tolist(), counted, nn, W, smem,
            sum(bool(r.cigar) for r in kern),
            sum(any(c & 15 == 3 for c in r.cigar) for r in kern), k_s, p_s))
    return err


def load_make_workload():
    spec = importlib.util.spec_from_file_location(
        "make_workload", REPO / "scripts" / "make_workload.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_workloads = {}


def workload(tmp, phase):
    """(genome FASTA, reads FASTA) of WORKLOAD in `tmp`, generated once."""
    if tmp not in _workloads:
        t0 = time.perf_counter()
        _workloads[tmp] = load_make_workload().make(tmp, **WORKLOAD)
        say(phase, "workload generated in %.3f s: %s" % (
            time.perf_counter() - t0,
            ", ".join(os.path.basename(f) for f in _workloads[tmp])))
    return _workloads[tmp]


# phase 5's wall and stage seconds, which phase 5r compares with
PH5 = {}


def phase_main_path(tmp):
    from mm2tpu_torch import cli
    from mm2tpu_torch.ops import chain_v3
    from mm2tpu_torch.utils import profiling
    ref, reads = workload(tmp, 5)
    paf = os.path.join(tmp, "out.paf")
    chain_v3.launches = 0
    chain_v3.reference_calls = 0
    t0 = time.perf_counter()
    rc = cli.main(["-x", "map-ont", "--device", DEVICE, "--profile",
                   "-o", paf, ref, reads])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, ref_calls = chain_v3.launches, chain_v3.reference_calls
    stages, counters = profiling.snapshot(), dict(profiling.counters)
    profiling.disable()
    if rc != 0:
        raise AssertionError("mm2tpu_torch.cli.main returned %d" % rc)
    if launches <= 0 or ref_calls != 0:
        raise AssertionError("main path: launches=%d reference_calls=%d"
                             % (launches, ref_calls))
    with open(paf) as fh:
        lines = fh.read().splitlines()
    mapped = {ln.split("\t", 1)[0] for ln in lines if ln}
    n_reads = WORKLOAD["n_reads"]
    for ln in lines:
        cols = ln.split("\t")
        if len(cols) < 12 or not (0 <= int(cols[11]) <= 60):
            raise AssertionError("malformed PAF line: %r" % ln[:200])
    if len(mapped) < MIN_MAPPED * n_reads:
        raise AssertionError("only %d of %d reads mapped"
                             % (len(mapped), n_reads))
    say(5, "mapped %d of %d reads (%d PAF lines) in %.3f s wall: %.3f "
        "reads/s; kernel launches %d, plain-version calls %d"
        % (len(mapped), n_reads, len(lines), wall, n_reads / wall,
           launches, ref_calls))
    say(5, "stage seconds: " + ", ".join(
        "%s %.3f" % (k, v[0]) for k, v in sorted(stages.items())))
    say(5, "counters: " + ", ".join(
        "%s %d" % (k, v) for k, v in sorted(counters.items())))
    say(5, "chaining: " + chain_line(stages, counters))
    PH5.update(wall=wall, stages=stages)
    busy = stages["chain.gpu_busy"][0]
    mapping_wall = wall - stages["index"][0]
    say(5, "card busy %.3f s (chain.gpu_busy) of %.3f s wall: idle share "
        "%.3f; of the %.3f s after the index build: idle share %.3f"
        % (busy, wall, 1 - busy / wall, mapping_wall,
           1 - busy / mapping_wall))
    return ref, reads, lines, launches, counters


def tensors_equal(what, got, want):
    """Raises unless each pair of tensors is equal (dtype and shape too);
    returns the max abs error, 0."""
    for k, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError("%s: output %d is %s %s, want %s %s" % (
                what, k, g.dtype, tuple(g.shape), w.dtype, tuple(w.shape)))
        if not torch.equal(g, w):
            d = (g.to(torch.float64) - w.to(torch.float64)).abs().max()
            raise AssertionError("%s: output %d differs, max abs err %g"
                                 % (what, k, float(d)))
    return 0


def phase_seed_kernels(tmp, ref, reads, clock):
    """Phase 5s (i): K5 and K6 against their plain versions on the card,
    on phase 5's index at full size and every eligible read's minimizers
    bucketed as the path buckets them (`mapping/pipeline.py`'s helpers):
    every count probe's (start, cnt), every fused dispatch's sorted
    anchors and n, and f and p of K1 on them for the dispatches of the
    smallest N within SEED_PLAIN_STEPS; then each timed at the largest
    dispatch, with the sort step, torch.searchsorted and torch.sort.
    Returns ({"seed_probe": ..., "seed_build": ...} of (ms, plain ms,
    library ms, work, max abs err), the reads outside the contract and
    the reads over the largest bucket)."""
    from mm2tpu_torch import cli
    from mm2tpu_torch.mapping import pipeline as pl
    from mm2tpu_torch.ops import chain_v3
    from mm2tpu_torch.ops import seed_device as sd
    t0 = time.perf_counter()
    io, mo = cli.set_opt(None)
    io, mo = cli.set_opt("map-ont", io, mo)
    mi = next(cli.index_parts(ref, io, n_threads=3))
    cli.mapopt_update(mo, mi)
    index = sd.prepare_index_device(mi, DEVICE)
    keys, start, cnt, pos = (index[k] for k in ("keys", "start", "cnt",
                                                "pos"))
    torch.cuda.synchronize()
    ctxs, names, outside = {}, {}, []
    for i, (name, seq) in enumerate(read_fasta(reads)):
        ctx = pl._prepare(mi, [seq], mo, name, seed_hits=False)
        if isinstance(ctx, pl.FragResult):
            continue
        if pl._seed_device_eligible(mo, ctx):
            ctxs[i], names[i] = ctx, name
        else:
            outside.append(name)
    idxs = sorted(ctxs)
    mid_occ = int(mo.mid_occ)
    prep = {i: sd.split_query_minimizers(ctxs[i].mv) for i in idxs}
    say("5s", "index on the card: %d keys, %d positions (%.1f MB); %d reads "
        "in the contract, %d outside it; mid_occ %d; %.3f s" % (
            keys.numel(), pos.numel(),
            sum(t.numel() * t.element_size() for t in index.values()) / 1e6,
            len(idxs), len(outside), mid_occ, time.perf_counter() - t0))
    max_err, n_q, cnts = 0, 0, {}
    probes = pl._probe_chunks(ctxs, idxs)
    for M, chunk, B in probes:
        q = np.full((B, M), sd.PAD_Q, np.int64)
        for r, i in enumerate(chunk):
            q[r, :len(prep[i][0])] = prep[i][0]
        q = torch.from_numpy(q).to(DEVICE)
        got = sd.probe_counts(keys, start, cnt, q)
        max_err = max(max_err, tensors_equal(
            "K5 != plain at (%d, %d)" % (B, M), got,
            sd.probe_counts_reference(keys, start, cnt, q)))
        c = got[1].cpu().numpy()
        for r, i in enumerate(chunk):
            cnts[i] = c[r, :len(ctxs[i].mv)]
        n_q += B * M
    say("5s", "K5 == plain on the %d count probes' %d queries (start and "
        "cnt)" % (len(probes), n_q))
    meta = {i: pl._seed_meta(prep[i], cnts[i], mid_occ) for i in idxs}
    plan, big = pl._chain_chunks(ctxs, idxs, meta)
    budget, with_k1 = SEED_PLAIN_STEPS, set()
    for k in sorted(range(len(plan)), key=lambda k: plan[k][0][1]):
        if plan[k][0][1] <= budget:
            with_k1.add(k)
            budget -= plan[k][0][1]
    iter_cap = min(1024, mo.max_chain_iter)
    anchors = 0
    for k, ((M, N, gap_ref, gap_qry), chunk, B) in enumerate(plan):
        planes = [torch.from_numpy(a).to(DEVICE)
                  for a in pl._seed_planes(prep, ctxs, meta, chunk, B, M)]
        what = "dispatch %d, (B, M, N) = (%d, %d, %d)" % (k, B, M, N)
        if k in with_k1:
            kw = dict(N=N, mid_occ=mid_occ, max_dist_x=gap_ref,
                      max_dist_y=gap_qry, bw=mo.bw, iter_cap=iter_cap,
                      gap_scale=float(mo.chain_gap_scale))
            got = sd.seed_chain(index, *planes, **kw)
            want = sd.seed_chain_plain(index, *planes, **kw)
            n = got[6]
        else:
            got = sd.seed_anchors(index, *planes[:4], N=N, mid_occ=mid_occ)
            want = sd.seed_anchors_reference(index, *planes[:4], N=N,
                                             mid_occ=mid_occ)
            n = got[5]
        max_err = max(max_err, tensors_equal("K6 != plain, " + what, got,
                                             want))
        totals = [meta[i][2] for i in chunk]
        if n[:len(chunk), 0].tolist() != totals or int(n[len(chunk):].sum()):
            raise AssertionError("%s: n %s, the counts give %s" % (
                what, n[:, 0].tolist(), totals))
        anchors += sum(totals)
    say("5s", "K6 + sort == plain on all %d fused dispatches (%d anchors: "
        "sorted anchors and n), and K1 == plain on the anchors of the %d "
        "of smallest N (f, p; %d plain steps); %d reads over the largest "
        "bucket" % (len(plan), anchors, len(with_k1),
                    SEED_PLAIN_STEPS - budget, len(big)))
    # timed at the largest dispatch
    (M, N, gap_ref, gap_qry), chunk, B = max(
        plan, key=lambda job: (job[0][1], job[0][0], len(job[1])))
    q, qpos, qyhi, qlen, _ = (torch.from_numpy(a).to(DEVICE) for a in
                              pl._seed_planes(prep, ctxs, meta, chunk, B, M))
    k5_ms, (s, c) = cuda_ms(lambda: sd.probe_counts(keys, start, cnt, q), 20)
    k5_plain, _ = cuda_ms(
        lambda: sd.probe_counts_reference(keys, start, cnt, q), 3)
    k5_lib, _ = cuda_ms(lambda: torch.searchsorted(keys, q), 20)
    build = functools.partial(sd.build_anchors, s, c, qpos, qyhi, qlen, pos,
                              N=N, mid_occ=mid_occ)
    k6_ms, (key, y, n) = cuda_ms(build, 20)
    k6_plain, _ = cuda_ms(functools.partial(
        sd.build_anchors_reference, s, c, qpos, qyhi, qlen, pos, N=N,
        mid_occ=mid_occ), 3)
    sort_ms, _ = cuda_ms(lambda: sd.sort_anchors(key, y, n), 20)
    lib_sort, _ = cuda_ms(lambda: torch.sort(key, dim=1, stable=True), 20)
    total = int(n.sum())
    steps = max(1, int(np.ceil(np.log2(keys.numel() + 1))))
    # K5's bytes: each query read and its (start, cnt) written, and what
    # its search must read at least: the key it ends on and, on a hit,
    # that key's start and cnt (not the whole index: a search reads
    # log2(keys) of them)
    k5_work = (24 * q.numel() + 8 * int((c > 0).sum()),
               OPS_PER_PROBE_STEP * steps * q.numel())
    k6_work = (16 * B * M + 4 * B + 8 * total + 16 * B * N + 4 * B,
               OPS_PER_SLOT * total + OPS_PER_MINIMIZER * B * M)
    say("5s", "timed at the largest dispatch (B, M, N) = (%d, %d, %d), %d "
        "anchors: K5 %.3f ms (plain %.3f, torch.searchsorted %.3f; bound "
        "%.4f ms, %s), K6 %.3f ms (plain %.3f; bound %.4f ms, %s), sort "
        "step %.3f ms (torch.sort %.3f ms)" % (
            B, M, N, total, k5_ms, k5_plain, k5_lib,
            *bound(*k5_work, clock), k6_ms, k6_plain,
            *bound(*k6_work, clock), sort_ms, lib_sort))
    return ({"seed_probe": (k5_ms, k5_plain, k5_lib, k5_work, max_err),
             "seed_build": (k6_ms, k6_plain, lib_sort, k6_work, max_err)},
            outside, [names[i] for i in big])


def phase_seed_path(tmp, ref, reads, lines, ph5_counters, why):
    """Phase 5s (ii): map-ont PAF with --seed-backend gpu, byte-identical
    to phase 5's host-seeded PAF; only K5, K6 and K1 launched, no plain
    version. Returns the launches of K5 and K6."""
    paf = os.path.join(tmp, "seed_gpu.paf")
    wall, counts, stages, counters = drive(
        ["-x", "map-ont", "--seed-backend", "gpu", "--device", DEVICE, "-o",
         paf, ref, reads])
    want_on = ("chain_v3", "seed_probe", "seed_build")
    for k, (launches, plain) in counts.items():
        if plain or (launches > 0) != (k in want_on):
            raise AssertionError("seeded path: launches/plain-version calls "
                                 "%s" % counts)
    with open(paf) as fh:
        got = fh.read().splitlines()
    if got != lines:
        raise AssertionError("PAF with --seed-backend gpu differs from the "
                             "host-seeded PAF of phase 5")
    mapped = {ln.split("\t", 1)[0] for ln in got if ln}
    n_reads = WORKLOAD["n_reads"]
    if len(mapped) < MIN_MAPPED * n_reads or \
            counters.get("seed.launches", 0) <= 0:
        raise AssertionError("seeded path: %d reads mapped, seed.launches "
                             "%s" % (len(mapped), counters.get(
                                 "seed.launches")))
    say("5s", "PAF with --seed-backend gpu (%d lines, %d of %d reads mapped) "
        "is byte-identical to phase 5's host-seeded PAF; launches %s; "
        "plain-version calls 0" % (len(got), len(mapped), n_reads, ", ".join(
            "%s %d" % (k, c[0]) for k, c in counts.items())))
    report("5s", "map-ont PAF, --seed-backend gpu", wall, n_reads, stages,
           counters)
    seed_busy = stages["seed.gpu_busy"][0]
    chain_busy = stages["chain.gpu_busy"][0]
    say("5s", "seeding: stages %s; seed.gpu_busy %.3f s, chain.gpu_busy "
        "%.3f s; seed.bytes_up %d (%.3f B a seeded anchor) against phase "
        "5's chain.bytes_up %d (16 B an anchor); seed.bytes_down %d; "
        "seed.host_frags %d%s" % (
            ", ".join("%s %.3f" % (k, v[0]) for k, v in sorted(stages.items())
                      if k.startswith("seed")), seed_busy, chain_busy,
            counters["seed.bytes_up"],
            counters["seed.bytes_up"] / max(counters["seed.anchors"], 1),
            ph5_counters["chain.bytes_up"], counters["seed.bytes_down"],
            counters.get("seed.host_frags", 0),
            "" if not counters.get("seed.host_frags") else
            " (outside the contract: %s; over the largest bucket: %s)" % why))
    return counts["seed_probe"][0], counts["seed_build"][0]


# ---- phase 5r: the stream mode's per-task routing ----

# the trainer's synthetic tasks (scripts/train_router_torch.py, map
# regime) on which K1 and K2 are timed at B = 1 end to end, and the sizes
# at which each is also held against its plain version (~0.5 ms a plain
# step on the card: ~22 s a kernel)
STREAM_NS = (512, 1024, 2048, 4096, 8192, 16384, 32768)
STREAM_PLAIN_NS = (512, 2048, 8192, 32768)
STREAM_DENSITY = 0.3
# the trainer's chaining settings: max_dist_x, max_dist_y, bw, max_iter,
# gap_scale
STREAM_CHAIN = (5000, 5000, 500, 1024, 1.0)
# the stream runs' mapping threads, and the reads of (v)
STREAM_THREADS = 8
STREAM_SAM_READS, STREAM_SPLICE_READS = 100, 50
# phase 5's reads whose chaining tasks hold the cost model to account
STREAM_MODEL_TASKS = 100


def load_trainer():
    spec = importlib.util.spec_from_file_location(
        "train_router_torch", REPO / "scripts" / "train_router_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_stream_kernels():
    """Phase 5r (i): K1 (single segment) and K2 (cDNA, one segment) at
    B = 1 on the trainer's synthetic tasks: each timed end to end through
    `chain_scores_task` (pack, upload, launch, readback, v) beside the
    committed H100 cost model's predict_dev, and held against its plain
    version on the same planes at STREAM_PLAIN_NS. Returns {kernel: {n:
    ms}}."""
    from mm2tpu_torch.mapping.costmodel import get_default_model
    from mm2tpu_torch.ops import chain_ref
    from mm2tpu_torch.ops.chain_packed import (chain_scores,
                                               chain_scores_task, derive_qss,
                                               pack_tasks16, planes_to_torch)
    model = get_default_model("map-ont")
    if model is None:
        raise AssertionError("no committed H100 cost model "
                             "(mm2tpu_torch/data/router_params_h100.json)")
    say("5r", "cost model (map regime): t_dev = %.4g n + %.4g subparts + "
        "%.4g ms, t_host = %.4g trips + %.4g ms" % (
            model.k1_dev, model.k2_dev, model.c_dev, model.k_host,
            model.c_host))
    mdx, mdy, bw, max_iter, gs = STREAM_CHAIN
    synth = load_trainer().synth_task
    rng = np.random.default_rng(0)
    times = {"chain_v3": {}, "chain_v2": {}}
    for n in STREAM_NS:
        a = synth(n, STREAM_DENSITY, rng)
        _, sub, trip = chain_ref.num_subparts(a, mdx)
        for name, cdna in (("chain_v3", False), ("chain_v2", True)):
            def task():
                return chain_scores_task(a, mdx, mdy, bw, max_iter, gs, cdna,
                                         1, device=DEVICE)
            task()
            reps = []
            for _ in range(5):
                t0 = time.perf_counter()
                task()
                reps.append((time.perf_counter() - t0) * 1e3)
            ms = float(np.median(reps))
            times[name][n] = ms
            check = ""
            if n in STREAM_PLAIN_NS:
                N = max(1024, -(-n // 1024) * 1024)
                hi, lo, yhi, ylo, nn, avg = planes_to_torch(
                    *pack_tasks16([a], N), DEVICE)
                qi, span, sid = derive_qss(yhi, ylo)
                args = (hi, lo, qi.contiguous(), span.contiguous(),
                        sid.contiguous(), nn, avg)
                kw = dict(max_dist_x=mdx, max_dist_y=mdy, bw=bw,
                          iter_cap=min(1024, max_iter), gap_scale=gs,
                          is_cdna=cdna, n_segs=1)
                f, p = chain_scores(*args, **kw)
                f2, p2 = chain_scores(*args, plain=True, **kw)
                chain_err("%s at B = 1, n = %d" % (name, n), f[:, :n],
                          p[:, :n], f2[:, :n], p2[:, :n])
                check = "; f and p equal the plain version's"
            say("5r", "%s at B = 1, n = %d (subparts %d, trips %d): %.3f ms "
                "a task end to end (median of 5), predict_dev %.3f ms, "
                "predict_host %.3f ms%s" % (
                    name, n, sub, trip, ms, model.predict_dev(n, sub),
                    model.predict_host(trip), check))
    return times


def phase_stream_model(ref, reads):
    """Phase 5r (i b): the committed H100 cost model held against phase
    5's real tasks: the first STREAM_MODEL_TASKS reads' chaining tasks,
    each timed on the card at B = 1 and in the native host DP as the
    trainer times them (`time_task`), beside predict_dev and
    predict_host, and the time its placement would take against the
    faster side of each task's and against all on the host."""
    from mm2tpu_torch.mapping.costmodel import get_default_model
    trainer = load_trainer()
    model = get_default_model("map-ont")
    tasks = trainer.real_tasks(ref, reads, limit=STREAM_MODEL_TASKS)
    rows = np.array([trainer.time_task(a, kw, torch.device(DEVICE), 3)
                     for a, kw in tasks], np.float64)
    n, sub, trip, dev, host = rows.T
    p_dev = np.array([model.predict_dev(a, b) for a, b in zip(n, sub)])
    p_host = np.array([model.predict_host(t) for t in trip])
    to_dev = p_dev < p_host
    chosen = np.where(to_dev, dev, host).sum()
    miss_d = np.maximum(p_dev / dev, dev / p_dev)
    miss_h = np.maximum(p_host / host, host / p_host)
    say("5r", "(i) the cost model on phase 5's first %d real tasks (n %d to "
        "%d, median %d; trips a anchor median %.1f): measured at B = 1 "
        "median %.3f ms on the card, %.3f ms in the host DP; predict_dev "
        "misses by median %.3fx, worst %.3fx, %.3f within 2x; predict_host "
        "by median %.3fx, worst %.3fx, %.3f within 2x; the model sends %d "
        "to the card and picks the faster side for %.3f of them; its "
        "placement takes %.3f ms of device+host time, the faster side of "
        "each %.3f ms, all on the host %.3f ms, all on the card %.3f ms" % (
            len(rows), n.min(), n.max(), np.median(n),
            np.median(trip / n), np.median(dev), np.median(host),
            np.median(miss_d), miss_d.max(), np.mean(miss_d <= 2),
            np.median(miss_h), miss_h.max(), np.mean(miss_h <= 2),
            int(to_dev.sum()), np.mean(to_dev == (dev < host)), chosen,
            np.minimum(dev, host).sum(), host.sum(), dev.sum()))


def paf_by_read(lines):
    out = {}
    for ln in lines:
        out.setdefault(ln.split("\t", 1)[0], []).append(ln)
    return out


def stream_run(tmp, tag, ref, reads, *extra):
    """One -x map-ont PAF run in stream mode on STREAM_THREADS threads:
    (PAF lines, wall, counts, stages, counters)."""
    paf = os.path.join(tmp, "stream_%s.paf" % tag)
    wall, counts, stages, counters = drive(
        ["-x", "map-ont", "--map-mode", "stream", "-t", str(STREAM_THREADS),
         *extra, "--device", DEVICE, "-o", paf, ref, reads])
    with open(paf) as fh:
        return fh.read().splitlines(), wall, counts, stages, counters


def only(phase, what, counts, *on):
    """Exactly the kernels `on` launched, and no plain version ran."""
    for k, (launches, plain) in counts.items():
        if plain or (launches > 0) != (k in on):
            raise AssertionError("%s: launches/plain-version calls %s"
                                 % (what, counts))
    say(phase, "%s: launches %s; plain-version calls 0" % (what, ", ".join(
        "%s %d" % (k, c[0]) for k, c in counts.items())))


def busy_line(what, wall, stages):
    busy = sum(stages[k][0] for k in ("chain.gpu_busy", "ext.gpu_busy")
               if k in stages)
    return "%s: wall %.3f s, chain.gpu_busy %.3f s, card busy %.3f s, idle " \
        "share %.3f" % (what, wall, stages.get("chain.gpu_busy", (0.0,))[0],
                        busy, 1 - busy / wall)


def phase_stream_path(tmp, ref, reads, lines):
    """Phase 5r (ii)-(iv) on phase 5's genome and reads, beside phase 5's
    batch run. Returns K1's launches in (ii)."""
    ph5 = PH5
    n_reads = WORKLOAD["n_reads"]
    # (ii) every task on the card
    gpu, wall2, counts, stages2, c2 = stream_run(
        tmp, "gpu", ref, reads, "--chain-backend", "gpu")
    only("5r", "(ii) --chain-backend gpu", counts, "chain_v3")
    k1_launches = counts["chain_v3"][0]
    tasks = c2.get("route.host", 0) + c2.get("chain.launches", 0)
    if c2.get("route.host", 0) or counts["chain_v3"][0] != \
            c2.get("chain.launches") or tasks <= 0:
        raise AssertionError("(ii): route.host %s, chain.launches %s, K1 "
                             "launches %d" % (c2.get("route.host"),
                                              c2.get("chain.launches"),
                                              counts["chain_v3"][0]))
    if gpu != lines:
        raise AssertionError("(ii): the stream PAF with --chain-backend gpu "
                             "differs from phase 5's batch PAF")
    say("5r", "(ii) --map-mode stream --chain-backend gpu -t %d: PAF (%d "
        "lines) byte-identical to phase 5's batch PAF; %d tasks, each one "
        "K1 launch at B = 1, none on the host; %s" % (
            STREAM_THREADS, len(gpu), tasks, chain_line(stages2, c2)))
    # (iii) every task on the host
    native, wall3, counts, stages3, c3 = stream_run(
        tmp, "native", ref, reads, "--chain-backend", "native")
    only("5r", "(iii) --chain-backend native", counts)
    if c3.get("route.gpu") or c3.get("chain.launches"):
        raise AssertionError("(iii): %s" % c3)
    # (iv) placed by the committed H100 constants and the card's queue
    auto, wall4, counts, stages4, c4 = stream_run(tmp, "auto", ref, reads)
    for k, (launches, plain) in counts.items():
        if plain or (launches and k != "chain_v3"):
            raise AssertionError("(iv): launches/plain-version calls %s"
                                 % counts)
    mapped = paf_by_read(auto)
    if len(mapped) < MIN_MAPPED * n_reads:
        raise AssertionError("(iv): only %d of %d reads mapped"
                             % (len(mapped), n_reads))
    g, h = paf_by_read(gpu), paf_by_read(native)
    names = set(g) | set(h) | set(mapped)
    neither = sorted(r for r in names if mapped.get(r) not in
                     (g.get(r), h.get(r)))
    as_gpu = sum(mapped.get(r) == g.get(r) != h.get(r) for r in names)
    as_host = sum(mapped.get(r) == h.get(r) != g.get(r) for r in names)
    rechained = int(c4.get("chain.rechained", 0))
    if len(neither) > rechained:
        raise AssertionError("(iv): %d reads match neither (ii) nor (iii) "
                             "but only %d were rechained: %s" % (
                                 len(neither), rechained, neither[:10]))
    n_gpu = int(c4.get("route.gpu", 0))
    n_host = int(c4.get("route.host", 0))
    say("5r", "(iv) auto, H100 constants, -t %d: %d of %d reads mapped; "
        "route.gpu %d tasks (%d anchors), route.host %d tasks: %.3f of the "
        "tasks on the card; K1 launches %d; reads whose lines differ between "
        "(ii) and (iii): %d, of them as (ii) %d, as (iii) %d; reads matching "
        "neither %d, rechained reads %d; route stage %.3f s" % (
            STREAM_THREADS, len(mapped), n_reads, n_gpu,
            c4.get("route.gpu_anchors", 0), n_host,
            n_gpu / max(n_gpu + n_host, 1), counts["chain_v3"][0],
            sum(g.get(r) != h.get(r) for r in names), as_gpu, as_host,
            len(neither), rechained, stages4.get("route", (0.0,))[0]))
    for what, wall, st in (("phase 5 batch", ph5["wall"], ph5["stages"]),
                           ("(ii) stream gpu", wall2, stages2),
                           ("(iii) stream native", wall3, stages3),
                           ("(iv) stream auto", wall4, stages4)):
        say("5r", busy_line(what, wall, st))
    for what, wall, st, c in (("(ii)", wall2, stages2, c2),
                              ("(iii)", wall3, stages3, c3),
                              ("(iv)", wall4, stages4, c4)):
        report("5r", "%s stream" % what, wall, n_reads, st, c)
    return k1_launches


def phase_stream_ext(tmp, ref, reads):
    """Phase 5r (v): SAM in stream mode with one fill a launch, K3 on the
    first map-ont reads and K4 on seeded spliced reads (chained on K1
    and K2), each against --align-backend host. Returns the launches of
    K3, K4 and K2 in the device runs."""
    recs = read_fasta(reads)[:STREAM_SAM_READS]
    sub = os.path.join(tmp, "stream_sam_reads.fa")
    write_reads(sub, recs)
    tx = make_spliced_reads(ref, os.path.join(tmp, "stream_tx.fa"),
                            STREAM_SPLICE_READS, seed=13)
    out = {}
    for preset, qry, chain, ext in (("map-ont", sub, "chain_v3",
                                     "ksw2_extd2"),
                                    ("splice", tx, "chain_v2",
                                     "ksw2_exts2")):
        sams, walls = {}, {}
        for backend in ("gpu", "host"):
            path = os.path.join(tmp, "stream_%s_%s.sam" % (preset, backend))
            walls[backend], counts, stages, c = drive(
                ["-x", preset, "-a", "--map-mode", "stream", "-t",
                 str(STREAM_THREADS), "--chain-backend", "gpu",
                 "--align-backend", backend, "--align-tpu-min-mat", "1",
                 "--device", DEVICE, "-o", path, ref, qry])
            with open(path) as fh:
                sams[backend] = fh.read()
            if backend == "gpu":
                only("5r", "(v) -x %s -a, stream, --align-backend gpu"
                     % preset, counts, chain, ext)
                fills = int(c.get("ext.fills", 0))
                if fills <= 0 or counts[ext][0] != fills or \
                        c.get("ext.dispatches") != fills or \
                        c.get("ext.host_fills", 0):
                    raise AssertionError("(v) %s: %s launches %d, ext.fills "
                                         "%s, ext.dispatches %s, "
                                         "ext.host_fills %s" % (
                                             preset, ext, counts[ext][0],
                                             c.get("ext.fills"),
                                             c.get("ext.dispatches"),
                                             c.get("ext.host_fills")))
                out[ext] = counts[ext][0]
                if chain == "chain_v2":
                    out[chain] = counts[chain][0]
                busy = stages.get("ext.gpu_busy", (0.0,))[0]
                say("5r", "(v) -x %s -a: %d fills, each one %s launch, none "
                    "on the host; ext.gpu_busy %.3f s (%.3f ms a launch)" % (
                        preset, fills, ext, busy, busy * 1e3 / fills))
        if strip_pg(sams["gpu"]) != strip_pg(sams["host"]):
            raise AssertionError("(v) -x %s: the stream SAM through %s "
                                 "differs from the host extension's"
                                 % (preset, ext))
        body = [ln for ln in sams["gpu"].splitlines()
                if ln and not ln.startswith("@")]
        say("5r", "(v) -x %s -a on %d reads: SAM through %s (%d records) "
            "byte-identical to the host extension's without @PG; walls %.3f "
            "s against %.3f s" % (preset, STREAM_SAM_READS if preset ==
                                  "map-ont" else STREAM_SPLICE_READS, ext,
                                  len(body), walls["gpu"], walls["host"]))
    return out


def phase_split_prefix(tmp, ref, reads):
    """Phase 5r (vi): --split-prefix on phase 5's genome with -I one base
    short of its first contigs that hold half of it (all but the last,
    if the last holds more), so that the index comes in two parts: a
    part takes contigs until it holds more than -I bases."""
    from mm2tpu_torch import cli
    cum = np.cumsum([len(sq) for _, sq in read_fasta(ref)])
    if len(cum) < 2:
        raise AssertionError("(vi): the genome has one contig")
    k = min(int(np.searchsorted(cum, cum[-1] / 2)), len(cum) - 2)
    size = int(cum[k]) - 1
    prefix = os.path.join(tmp, "split")
    paf = os.path.join(tmp, "split.paf")
    parts = []
    merge = cli._split_merge

    def counted(query, mo, n_parts, rg, out):
        parts.append(n_parts)
        return merge(query, mo, n_parts, rg, out)

    cli._split_merge = counted
    try:
        wall, counts, stages, c = drive(
            ["-x", "map-ont", "--split-prefix", prefix, "-I", str(size),
             "--device", DEVICE, "-o", paf, ref, reads])
    finally:
        cli._split_merge = merge
    left = [f for f in os.listdir(tmp) if f.endswith(".tmp")]
    with open(paf) as fh:
        mapped = paf_by_read(fh.read().splitlines())
    n_reads = WORKLOAD["n_reads"]
    if parts != [2] or left or len(mapped) < MIN_MAPPED * n_reads:
        raise AssertionError("(vi): parts %s, .tmp files left %s, %d of %d "
                             "reads mapped" % (parts, left, len(mapped),
                                               n_reads))
    only("5r", "(vi) --split-prefix", counts, "chain_v3")
    say("5r", "(vi) --split-prefix, -I %d: 2 index parts, %d of %d reads "
        "mapped, no .tmp file left; wall %.3f s" % (
            size, len(mapped), n_reads, wall))



def read_fasta(path):
    """(name, sequence) pairs of a FASTA file."""
    recs = []
    with open(path) as fh:
        for ln in fh:
            ln = ln.rstrip("\n")
            if ln.startswith(">"):
                recs.append([ln[1:].split()[0], []])
            elif recs:
                recs[-1][1].append(ln)
    return [(name, "".join(parts)) for name, parts in recs]


def write_reads(path, recs):
    with open(path, "w") as fh:
        fh.writelines(">%s\n%s\n" % r for r in recs)


_RC = str.maketrans("ACGT", "TGCA")


def revcomp(s):
    return s.translate(_RC)[::-1]


def mutate_str(rng, s, sub, indel):
    """`s` with iid substitutions at rate `sub` and deletions and
    one-base insertions at `indel` / 2 each."""
    r = rng.random(len(s))
    out = []
    for c, x in zip(s, r):
        if x < sub:
            out.append("ACGT"["ACGT".index(c) + int(rng.integers(1, 4)) & 3]
                       if c in "ACGT" else c)
        elif x < sub + indel / 2:
            continue
        elif x < sub + indel:
            out.append(c)
            out.append("ACGT"[int(rng.integers(0, 4))])
        else:
            out.append(c)
    return "".join(out)


def make_sr_pairs(ref, out_prefix, n_pairs, seed, read_len=150,
                  insert_mean=450, insert_sd=50, insert_range=(300, 600),
                  sub=0.01, indel=0.001):
    """Illumina-like read pairs from the FASTA `ref`: inserts normal
    (mean 450, sd 50) clipped to 300-600 bp, from a random contig and
    strand; read 1 is the insert's first `read_len` bases, read 2 the
    reverse complement of its last (FR), each with 1% substitutions and
    0.1% indels. Writes `<out_prefix>_1.fq` and `<out_prefix>_2.fq` with
    matching names and returns their paths. Seeded."""
    rng = np.random.default_rng(seed)
    ctgs = [(name, seq) for name, seq in read_fasta(ref)
            if len(seq) > insert_range[1] + 100]
    lens = np.array([len(s) for _, s in ctgs], np.float64)
    paths = [out_prefix + "_1.fq", out_prefix + "_2.fq"]
    with open(paths[0], "w") as f1, open(paths[1], "w") as f2:
        for k in range(n_pairs):
            ci = int(rng.choice(len(ctgs), p=lens / lens.sum()))
            name, g = ctgs[ci]
            ins = int(np.clip(round(rng.normal(insert_mean, insert_sd)),
                              *insert_range))
            st = int(rng.integers(0, len(g) - ins))
            frag = g[st:st + ins]
            if rng.integers(0, 2):
                frag = revcomp(frag)
            qn = "pair%d_%s_%d" % (k, name, st)
            pad = read_len + 10   # deletions must not shorten a read
            r1 = mutate_str(rng, frag[:pad], sub, indel)[:read_len]
            r2 = mutate_str(rng, revcomp(frag)[:pad], sub, indel)[:read_len]
            for fh, r in ((f1, r1), (f2, r2)):
                fh.write("@%s\n%s\n+\n%s\n" % (qn, r, "I" * len(r)))
    return paths


def make_spliced_reads(ref, path, n_reads, seed, exons=(3, 10),
                       exon_len=(80, 400), intron_len=(100, 10000),
                       err=0.05):
    """cDNA-like reads from the FASTA `ref`: 3-10 exons of 80-400 bp,
    taken in order from one contig, each intron starting at the first GT
    at or after its exon's end and ending at the first AG that keeps it
    at least a drawn 100-10,000 bp long (a canonical GT-AG junction);
    5% error (half substitutions, a quarter each deletions and
    insertions); the reverse complement half of the time. Writes a FASTA
    and returns its path. Seeded."""
    rng = np.random.default_rng(seed)
    ctgs = [(name, seq) for name, seq in read_fasta(ref)
            if len(seq) > 200000]
    recs = []
    while len(recs) < n_reads:
        name, g = ctgs[int(rng.integers(0, len(ctgs)))]
        pos = start = int(rng.integers(0, len(g) - 100000))
        parts = []
        for e in range(int(rng.integers(exons[0], exons[1] + 1))):
            end = pos + int(rng.integers(exon_len[0], exon_len[1] + 1))
            donor = g.find("GT", end)
            acceptor = g.find("AG", donor + int(rng.integers(*intron_len)))
            if donor < 0 or acceptor < 0:
                break
            parts.append(g[pos:donor])
            pos = acceptor + 2
        if len(parts) < exons[0]:
            continue
        s = mutate_str(rng, "".join(parts), err / 2, err / 2)
        if rng.integers(0, 2):
            s = revcomp(s)
        recs.append(("tx%d_%s_%d" % (len(recs), name, start), s))
    write_reads(path, recs)
    return path


def strip_pg(text):
    return "".join(ln for ln in text.splitlines(True)
                   if not ln.startswith("@PG"))


def sam_args(backend, out, ref, reads, *extra):
    return ["-x", "map-ont", "-a", "--align-backend", backend,
            "--align-tpu-min-mat", "1", "--device", DEVICE, *extra, "-o",
            out, ref, reads]


def phase_sam(tmp, ref, reads):
    """The SAM path through the extd2 kernel, then through the host's
    native extension; returns the kernel run's SAM text and its count of
    extd2 launches."""
    from mm2tpu_torch import cli
    from mm2tpu_torch.ops import chain_v3
    from mm2tpu_torch.ops import ksw2_extd2 as X
    from mm2tpu_torch.utils import profiling
    recs = read_fasta(reads)[:SAM_READS]
    sub = os.path.join(tmp, "sam_reads.fa")
    write_reads(sub, recs)
    gpu_sam, host_sam = (os.path.join(tmp, n) for n in ("gpu.sam",
                                                        "host.sam"))
    chain_v3.launches = chain_v3.reference_calls = 0
    X.launches = X.reference_calls = 0
    t0 = time.perf_counter()
    rc = cli.main(sam_args("gpu", gpu_sam, ref, sub, "--profile"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(chain_launches=chain_v3.launches,
                  chain_plain=chain_v3.reference_calls,
                  ext_launches=X.launches, ext_plain=X.reference_calls)
    stages, counters = profiling.snapshot(), dict(profiling.counters)
    profiling.disable()
    if rc != 0:
        raise AssertionError("SAM path: mm2tpu_torch.cli.main returned %d"
                             % rc)
    if counts["chain_launches"] <= 0 or counts["ext_launches"] <= 0 or \
            counts["chain_plain"] or counts["ext_plain"] or \
            counters.get("ext.fills", 0) <= 0:
        raise AssertionError("SAM path: %s, ext.fills %s" % (
            counts, counters.get("ext.fills")))
    t0 = time.perf_counter()
    rc = cli.main(sam_args("host", host_sam, ref, sub))
    torch.cuda.synchronize()
    host_wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError("host-extension run returned %d" % rc)
    with open(gpu_sam) as fh:
        got = fh.read()
    with open(host_sam) as fh:
        want = fh.read()
    if strip_pg(got) != strip_pg(want):
        raise AssertionError("SAM through the extd2 kernel differs from "
                             "SAM through the host extension")
    body = [ln.split("\t") for ln in got.splitlines()
            if ln and not ln.startswith("@")]
    mapped = {c[0] for c in body if not int(c[1]) & 4}
    if len(mapped) < MIN_MAPPED * len(recs):
        raise AssertionError("SAM path: only %d of %d reads mapped"
                             % (len(mapped), len(recs)))
    say(6, "%d reads (n = %d): SAM through the extd2 kernel (%d records, "
        "%d reads mapped) is byte-identical to SAM through the host "
        "extension, without @PG" % (len(recs), len(recs), len(body),
                                    len(mapped)))
    say(6, "wall: kernels %.3f s (%.3f reads/s), host extension %.3f s "
        "(%.3f reads/s)" % (wall, len(recs) / wall, host_wall,
                            len(recs) / host_wall))
    say(6, "launches: chain_v3 %d, ksw2_extd2 %d; plain-version calls: "
        "chain %d, extd2 %d" % (counts["chain_launches"],
                                counts["ext_launches"],
                                counts["chain_plain"], counts["ext_plain"]))
    say(6, "stage seconds: " + ", ".join(
        "%s %.3f" % (k, v[0]) for k, v in sorted(stages.items())))
    say(6, "counters: " + ", ".join(
        "%s %d" % (k, v) for k, v in sorted(counters.items())))
    say(6, d2_line(stages, counters))
    busy = stages["chain.gpu_busy"][0] + stages["ext.gpu_busy"][0]
    say(6, "card busy %.3f s (chain.gpu_busy %.3f + ext.gpu_busy %.3f) of "
        "%.3f s wall: idle share %.3f" % (
            busy, stages["chain.gpu_busy"][0], stages["ext.gpu_busy"][0],
            wall, 1 - busy / wall))
    return got, counts["ext_launches"]


def phase_parity(tmp, ref, reads, lines):
    from mm2tpu_torch import cli
    from mm2tpu_torch.ops import chain_v3
    from mm2tpu_torch.ops.chain_packed import chain_scores_plain
    recs = [r for r in read_fasta(reads)
            if len(r[1]) <= PARITY_MAX_LEN][:PARITY_READS]
    names = {name for name, _ in recs}
    sub = os.path.join(tmp, "parity.fa")
    with open(sub, "w") as fh:
        fh.writelines(">%s\n%s\n" % r for r in recs)
    paf = os.path.join(tmp, "parity.paf")
    t0 = time.perf_counter()
    calls, launches = chain_v3.reference_calls, chain_v3.launches
    rc = cli.main(["-x", "map-ont", "--device", DEVICE, "-o", paf, ref, sub],
                  chain_fn=chain_scores_plain)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError("parity run: mm2tpu_torch.cli.main returned %d"
                             % rc)
    if chain_v3.reference_calls == calls or chain_v3.launches != launches:
        raise AssertionError("parity run did not use the plain version only")
    with open(paf) as fh:
        got = fh.read()
    want = "".join(ln + "\n" for ln in lines
                   if ln.split("\t", 1)[0] in names)
    if got != want:
        raise AssertionError("plain-version PAF differs from the kernel's "
                             "on the %d parity reads" % len(recs))
    say(7, "%d reads <= %d bp: plain-version PAF (%d bytes, %.3f s) is "
        "byte-identical to the kernel's" % (
            len(recs), PARITY_MAX_LEN, len(got), time.perf_counter() - t0))
    return recs


def phase_ext_parity(tmp, ref, recs, sam):
    """The first EXT_PARITY_READS parity reads through the SAM path with
    the plain extd2 on CUDA tensors: their SAM records must equal the
    kernel run's."""
    from mm2tpu_torch import cli
    from mm2tpu_torch.ops import ksw2_extd2 as X
    recs = recs[:EXT_PARITY_READS]
    names = {name for name, _ in recs}
    sub = os.path.join(tmp, "ext_parity.fa")
    write_reads(sub, recs)
    out = os.path.join(tmp, "ext_parity.sam")
    calls, launches = X.reference_calls, X.launches
    t0 = time.perf_counter()
    rc = cli.main(sam_args("gpu", out, ref, sub),
                  ext_fn=X.extd2_traced_reference)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError("extension parity run returned %d" % rc)
    if X.reference_calls == calls or X.launches != launches:
        raise AssertionError("extension parity run did not use the plain "
                             "extd2 only")
    with open(out) as fh:
        got = [ln for ln in fh.read().splitlines()
               if ln and not ln.startswith("@")]
    want = [ln for ln in sam.splitlines()
            if ln and not ln.startswith("@") and ln.split("\t", 1)[0] in names]
    if got != want:
        raise AssertionError("plain-extd2 SAM differs from the kernel's on "
                             "the %d parity reads" % len(recs))
    say(7, "%d reads: plain-extd2 SAM (%d records, %d flushes, %.3f s) is "
        "byte-identical to the kernel's" % (
            len(recs), len(got), X.reference_calls - calls,
            time.perf_counter() - t0))


def chain_counts():
    from mm2tpu_torch.ops import chain_v2, chain_v3
    from mm2tpu_torch.ops import ksw2_extd2 as X
    from mm2tpu_torch.ops import ksw2_exts2 as S
    return {"chain_v3": chain_v3, "chain_v2": chain_v2, "ksw2_extd2": X,
            "ksw2_exts2": S}


def drive(argv, profile=True, **main_kw):
    """`mm2tpu_torch.cli.main(argv)` with every kernel's launch and
    plain-version count set to 0 just before and read just after. Returns
    (wall s, {kernel: (launches, plain calls)}, stage seconds, counters)."""
    from mm2tpu_torch import cli
    from mm2tpu_torch.utils import profiling
    from mm2tpu_torch.ops import seed_device as sd
    mods = chain_counts()
    for m in mods.values():
        m.launches = m.reference_calls = 0
    sd.reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(argv + (["--profile"] if profile else []), **main_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: (m.launches, m.reference_calls) for k, m in mods.items()}
    for k in ("probe", "build"):
        counts["seed_" + k] = (sd.launches[k], sd.reference_calls[k])
    stages, counters = profiling.snapshot(), dict(profiling.counters)
    profiling.disable()
    if rc != 0:
        raise AssertionError("mm2tpu_torch.cli.main%s returned %d"
                             % (tuple(argv), rc))
    return wall, counts, stages, counters


def chain_line(stages, counters):
    """The chaining counters of one --profile run: launches, anchors, the
    anchors the launches carried with their padding, the launches'
    serial steps, and the card's time from the first op after each
    upload to the last before the copy back (chain.gpu_busy)."""
    launches = counters.get("chain.launches", 0)
    anchors = counters.get("chain.anchors", 0)
    padded = counters.get("chain.padded_anchors", 0)
    steps = counters.get("chain.steps", 0)
    busy = stages["chain.gpu_busy"][0] if "chain.gpu_busy" in stages else 0.0
    return ("chain.launches %d, chain.anchors %d, chain.padded_anchors %d "
            "(%.3f of them real), chain.steps %d (each launch's longest "
            "row), chain.gpu_busy %.3f s (%.3f ms a launch, %.3f us a step)"
            % (launches, anchors, padded, anchors / max(padded, 1), steps,
               busy, busy * 1e3 / max(launches, 1),
               busy * 1e6 / max(steps, 1)))


def report(phase, what, wall, n_reads, stages, counters):
    say(phase, "%s: %d reads in %.3f s wall: %.3f reads/s" % (
        what, n_reads, wall, n_reads / wall))
    say(phase, "%s stage seconds: %s" % (what, ", ".join(
        "%s %.3f" % (k, v[0]) for k, v in sorted(stages.items()))))
    say(phase, "%s counters: %s" % (what, ", ".join(
        "%s %d" % (k, v) for k, v in sorted(counters.items()))))
    if counters.get("chain.launches"):
        say(phase, "%s chaining: %s" % (what, chain_line(stages, counters)))
    busy = sum(stages[k][0] for k in ("chain.gpu_busy", "ext.gpu_busy",
                                      "seed.gpu_busy") if k in stages)
    say(phase, "%s: card busy %.3f s (the *.gpu_busy stages) of "
        "%.3f s wall: idle share %.3f; of the %.3f s after the index "
        "build: idle share %.3f" % (
            what, busy, wall, 1 - busy / wall, wall - stages["index"][0],
            1 - busy / (wall - stages["index"][0])))


def d2_line(stages, counters):
    """K3's counters of one --profile run: the flushes' serial rows, the
    wide fills, and its card time a row by ext.gpu_busy (events around
    upload and launch) and by its own stamps (ext.d2_kernel)."""
    rows = counters["ext.d2_rows"]
    return ("through K3: ext.d2_rows %d (the flushes' longest fills' rows) "
            "over %d flushes, ext.d2_wide %d, ext.gpu_busy %.3f s, %.3f us "
            "a row; the kernel's own time (its stamps) ext.d2_kernel %.3f "
            "s, %.3f us a row" % (
                rows, counters["ext.dispatches"],
                counters.get("ext.d2_wide", 0), stages["ext.gpu_busy"][0],
                stages["ext.gpu_busy"][0] * 1e6 / rows,
                stages["ext.d2_kernel"][0],
                stages["ext.d2_kernel"][0] * 1e6 / rows))


def sam_records(text):
    return [ln.split("\t") for ln in text.splitlines()
            if ln and not ln.startswith("@")]


def head_fastq(path, n, out):
    """The first n records of a 4-line FASTQ file, written to `out`."""
    with open(path) as fh, open(out, "w") as fo:
        for k, ln in enumerate(fh):
            if k >= 4 * n:
                break
            fo.write(ln)
    return out


def phase_sr(tmp, ref):
    """The -x sr paired path: PAF of SR_PAIRS pairs, then SAM of the first
    SR_SAM_PAIRS with every extension fill on K3, then SAM through the
    host extension; the SAMs must be identical and only K2 (and K3) may
    have run. Returns the pairs' files, the PAF lines and K2's launches
    in the PAF run."""
    t0 = time.perf_counter()
    r1, r2 = make_sr_pairs(ref, os.path.join(tmp, "sr"), SR_PAIRS, seed=1)
    say(8, "%d read pairs of 2 x 150 bp (inserts 450 +- 50 bp, 1%% "
        "substitutions, 0.1%% indels) generated in %.3f s" % (
            SR_PAIRS, time.perf_counter() - t0))
    paf = os.path.join(tmp, "sr.paf")
    wall, counts, stages, counters = drive(
        ["-x", "sr", "--device", DEVICE, "-o", paf, ref, r1, r2])
    only(8, "PAF", counts, "chain_v2")
    with open(paf) as fh:
        lines = fh.read().splitlines()
    mapped = {ln.split("\t", 1)[0] for ln in lines if ln}
    if len(mapped) < MIN_MAPPED_SR_SPLICE * SR_PAIRS:
        raise AssertionError("-x sr: only %d of %d pairs mapped"
                             % (len(mapped), SR_PAIRS))
    say(8, "PAF: %d of %d pairs mapped (%d PAF lines)" % (
        len(mapped), SR_PAIRS, len(lines)))
    report(8, "PAF", wall, 2 * SR_PAIRS, stages, counters)
    sams = {}
    sam_q = [head_fastq(r, SR_SAM_PAIRS, os.path.join(tmp, "sr_sam_%d.fq"
                                                        % k))
             for k, r in ((1, r1), (2, r2))]
    for backend in ("gpu", "host"):
        out = os.path.join(tmp, "sr.%s.sam" % backend)
        w, c, st, ctr = drive(["-x", "sr", "-a", "--align-backend", backend,
                               "--align-tpu-min-mat", "1", "--device",
                               DEVICE, "-o", out, ref, *sam_q])
        if backend == "gpu":
            only(8, "SAM through K3", c, "chain_v2", "ksw2_extd2")
            if ctr.get("ext.fills", 0) <= 0:
                raise AssertionError("-x sr SAM: no fill reached K3")
            report(8, "SAM through K3", w, 2 * SR_SAM_PAIRS, st, ctr)
            say(8, d2_line(st, ctr))
        else:
            only(8, "SAM through the host extension", c, "chain_v2")
            say(8, "SAM through the host extension: %.3f s wall, %.3f "
                "reads/s" % (w, 2 * SR_SAM_PAIRS / w))
        with open(out) as fh:
            sams[backend] = strip_pg(fh.read())
    if sams["gpu"] != sams["host"]:
        raise AssertionError("-x sr: SAM through K3 differs from SAM "
                             "through the host extension")
    mates = {}
    for c in sam_records(sams["gpu"]):
        flag = int(c[1])
        if not flag & 0x904:   # a mapped primary record
            mates.setdefault(c[0], set()).add(flag & 0xC0)
    both = sum(1 for v in mates.values() if len(v) == 2)
    if both < MIN_MAPPED_SR_SPLICE * SR_SAM_PAIRS:
        raise AssertionError("-x sr SAM: both mates mapped for only %d of "
                             "%d pairs" % (both, SR_SAM_PAIRS))
    say(8, "SAM through K3 is byte-identical to SAM through the host "
        "extension, without @PG; both mates mapped for %d of %d pairs"
        % (both, SR_SAM_PAIRS))
    return r1, r2, lines, counts["chain_v2"][0]


def phase_splice(tmp, ref):
    """The -x splice path: PAF (only K2 may have chained), then SAM with
    every fill on K4 (`-a --align-backend gpu --align-tpu-min-mat 1`:
    only K2 and K4 may have launched, no fill left on the host), SAM
    through the host's splice extension (byte-identical without @PG) and
    PAF with CIGARs through K4 (`-c`) of the first SPLICE_CIGAR_READS.
    Returns the reads' FASTA, the PAF lines, K2's launches in the PAF
    run, K4's in the SAM run and that run's SAM text."""
    t0 = time.perf_counter()
    reads = make_spliced_reads(ref, os.path.join(tmp, "tx.fa"),
                               SPLICE_READS, seed=2)
    say(9, "%d spliced reads (3-10 exons of 80-400 bp, GT-AG introns of "
        "100-10,000 bp, 5%% error) generated in %.3f s" % (
            SPLICE_READS, time.perf_counter() - t0))
    paf = os.path.join(tmp, "tx.paf")
    wall, counts, stages, counters = drive(
        ["-x", "splice", "--device", DEVICE, "-o", paf, ref, reads])
    only(9, "PAF", counts, "chain_v2")
    with open(paf) as fh:
        lines = fh.read().splitlines()
    mapped = {ln.split("\t", 1)[0] for ln in lines if ln}
    if len(mapped) < MIN_MAPPED_SR_SPLICE * SPLICE_READS:
        raise AssertionError("-x splice: only %d of %d reads mapped"
                             % (len(mapped), SPLICE_READS))
    say(9, "PAF: %d of %d reads mapped (%d PAF lines)" % (
        len(mapped), SPLICE_READS, len(lines)))
    report(9, "PAF", wall, SPLICE_READS, stages, counters)
    sams, k4 = {}, 0
    for backend in ("gpu", "host"):
        out = os.path.join(tmp, "tx.%s.sam" % backend)
        w, c, st, ctr = drive(["-x", "splice", "-a", "--align-backend",
                               backend, "--align-tpu-min-mat", "1",
                               "--device", DEVICE, "-o", out, ref, reads])
        if backend == "gpu":
            only(9, "SAM through K4", c, "chain_v2", "ksw2_exts2")
            if ctr.get("ext.fills", 0) <= 0 or ctr.get("ext.host_fills", 0):
                raise AssertionError(
                    "-x splice SAM: ext.fills %s, ext.host_fills %s" % (
                        ctr.get("ext.fills"), ctr.get("ext.host_fills")))
            report(9, "SAM through K4", w, SPLICE_READS, st, ctr)
            say(9, "SAM through K4: ext.s2_rows %d (the flushes' longest "
                "fills' rows), ext.s2_wide %d, ext.gpu_busy / ext.s2_rows "
                "%.3f us a row; the kernel's own time (its stamps) "
                "ext.s2_kernel %.3f s, %.3f us a row" % (
                    ctr["ext.s2_rows"], ctr.get("ext.s2_wide", 0),
                    st["ext.gpu_busy"][0] * 1e6 / ctr["ext.s2_rows"],
                    st["ext.s2_kernel"][0],
                    st["ext.s2_kernel"][0] * 1e6 / ctr["ext.s2_rows"]))
            k4 = c["ksw2_exts2"][0]
        else:
            only(9, "SAM through the host splice extension", c, "chain_v2")
            report(9, "SAM through the host splice extension", w,
                   SPLICE_READS, st, ctr)
        with open(out) as fh:
            sams[backend] = fh.read()
    if strip_pg(sams["gpu"]) != strip_pg(sams["host"]):
        raise AssertionError("-x splice: SAM through K4 differs from SAM "
                             "through the host splice extension")
    primary = [r for r in sam_records(sams["gpu"]) if not int(r[1]) & 0x904]
    spliced = sum(1 for r in primary if "N" in r[5])
    if len({r[0] for r in primary}) < MIN_MAPPED_SR_SPLICE * SPLICE_READS:
        raise AssertionError("-x splice SAM: only %d of %d reads mapped"
                             % (len(primary), SPLICE_READS))
    say(9, "SAM through K4 is byte-identical to SAM through the host "
        "splice extension, without @PG: %d primary records, %d with an "
        "intron (N) in the CIGAR" % (len(primary), spliced))
    cpaf = os.path.join(tmp, "tx.c.paf")
    c_reads = os.path.join(tmp, "tx_c.fa")
    c_recs = read_fasta(reads)[:SPLICE_CIGAR_READS]
    write_reads(c_reads, c_recs)
    w, c, st, ctr = drive(["-x", "splice", "-c", "--align-backend", "gpu",
                           "--align-tpu-min-mat", "1", "--device", DEVICE,
                           "-o", cpaf, ref, c_reads])
    only(9, "PAF with CIGARs (-c) through K4", c, "chain_v2", "ksw2_exts2")
    if ctr.get("ext.fills", 0) <= 0 or ctr.get("ext.host_fills", 0):
        raise AssertionError("-x splice -c: ext.fills %s, ext.host_fills %s"
                             % (ctr.get("ext.fills"),
                                ctr.get("ext.host_fills")))
    with open(cpaf) as fh:
        body = [ln.split("\t") for ln in fh.read().splitlines() if ln]
    cg = [f for ln in body for f in ln[12:] if f.startswith("cg:Z:")]
    if len(cg) != len(body) or sum("N" in f for f in cg) < len(c_recs) // 2:
        raise AssertionError("-x splice -c: %d lines, %d with cg:Z:, %d "
                             "spliced" % (len(body), len(cg),
                                          sum("N" in f for f in cg)))
    say(9, "-c through K4: %d PAF lines, every one with cg:Z:, %d with an "
        "intron (N)" % (len(body), sum("N" in f for f in cg)))
    report(9, "PAF with CIGARs (-c) through K4", w, len(c_recs), st, ctr)
    return reads, lines, counts["chain_v2"][0], k4, sams["gpu"]


def phase_exts2_parity(tmp, ref, tx):
    """The first EXTS2_PARITY_READS spliced reads through the SAM path
    with the plain exts2 on CUDA tensors (`main(..., exts2_fn=)`): their
    SAM records must equal K4's."""
    from mm2tpu_torch.ops import ksw2_exts2 as S
    reads, _, _, _, sam = tx
    recs = read_fasta(reads)[:EXTS2_PARITY_READS]
    names = {name for name, _ in recs}
    sub = os.path.join(tmp, "exts2_parity.fa")
    write_reads(sub, recs)
    out = os.path.join(tmp, "exts2_parity.sam")
    wall, counts, _, counters = drive(
        ["-x", "splice", "-a", "--align-backend", "gpu",
         "--align-tpu-min-mat", "1", "--device", DEVICE, "-o", out, ref,
         sub], exts2_fn=S.exts2_traced_reference)
    launches, plain = counts["ksw2_exts2"]
    if launches or plain <= 0 or counters.get("ext.host_fills", 0):
        raise AssertionError("exts2 parity run did not use the plain exts2 "
                             "only: %s, ext.host_fills %s"
                             % (counts, counters.get("ext.host_fills")))
    with open(out) as fh:
        got = [ln for ln in fh.read().splitlines()
               if ln and not ln.startswith("@")]
    want = [ln for ln in sam.splitlines()
            if ln and not ln.startswith("@") and ln.split("\t", 1)[0] in names]
    if got != want:
        raise AssertionError("plain-exts2 SAM differs from K4's on the %d "
                             "parity reads" % len(recs))
    say(10, "%d spliced reads: plain-exts2 SAM (%d records, %d flushes, "
        "%d fills, %.3f s) is byte-identical to K4's" % (
            len(recs), len(got), plain, counters.get("ext.fills", 0), wall))


def phase_v2_parity(tmp, ref, sr, tx):
    """The first SR_PARITY_PAIRS pairs and SPLICE_PARITY_READS spliced
    reads again through the plain chaining on CUDA tensors: their PAF
    lines must equal the kernels'."""
    from mm2tpu_torch.ops.chain_packed import chain_scores_plain
    r1, r2, sr_lines, _ = sr
    tx_reads, tx_lines = tx[:2]
    sub = [head_fastq(r, SR_PARITY_PAIRS, os.path.join(tmp, "par_%d.fq" % k))
           for k, r in ((1, r1), (2, r2))]
    with open(sub[0]) as fh:
        sr_names = {ln[1:].split()[0] for k, ln in enumerate(fh)
                    if k % 4 == 0}
    recs = read_fasta(tx_reads)[:SPLICE_PARITY_READS]
    tx_sub = os.path.join(tmp, "par_tx.fa")
    write_reads(tx_sub, recs)
    for what, preset, queries, names, lines in (
            ("%d pairs" % SR_PARITY_PAIRS, "sr", sub, sr_names, sr_lines),
            ("%d spliced reads" % SPLICE_PARITY_READS, "splice", [tx_sub],
             {n for n, _ in recs}, tx_lines)):
        out = os.path.join(tmp, "par_%s.paf" % preset)
        wall, counts, _, _ = drive(
            ["-x", preset, "--device", DEVICE, "-o", out, ref, *queries],
            profile=False, chain_fn=chain_scores_plain)
        if counts["chain_v2"][1] <= 0 or \
                any(c[0] for c in counts.values()):
            raise AssertionError("%s parity run did not use the plain "
                                 "versions only: %s" % (preset, counts))
        with open(out) as fh:
            got = fh.read()
        want = "".join(ln + "\n" for ln in lines
                       if ln.split("\t", 1)[0] in names)
        if got != want:
            raise AssertionError("plain-chaining PAF differs from K2's on "
                                 "the %s" % what)
        say(10, "%s (-x %s): plain-chaining PAF (%d lines, %d plain "
            "calls, %.3f s) is byte-identical to K2's" % (
                what, preset, len(got.splitlines()), counts["chain_v2"][1],
                wall))


def kernel_line(name, source, replaces, launches, max_err, times, work,
                clock):
    bound_ms, bound_by = bound(*work, clock)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_err, "ms": times[0], "plain_ms": times[1],
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no single PyTorch call computes a chaining DP or a ksw2
            # extension, splice-aware or not
            "library_ms": None}


PHASES = ("1", "2", "3", "3b", "4", "5", "5s", "5r", "6", "7", "8", "9",
          "10")
# the deep parity runs (paths mapped again through the plain versions):
# run with --deep or when named in --phases
DEEP = ("7", "10")
# phases that take another phase's outputs
NEEDS = {"5s": ("5",), "5r": ("5",), "6": ("5",), "7": ("5", "6"),
         "10": ("8", "9")}


def parse_phases(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", help="comma-separated phases to run "
                    "besides 0 and 11 (default: all of %s but the deep "
                    "parity runs %s)" % (",".join(PHASES), ",".join(DEEP)))
    ap.add_argument("--deep", action="store_true",
                    help="with no --phases: also the deep parity runs %s"
                    % ",".join(DEEP))
    opts = ap.parse_args(argv)
    if opts.phases is None:
        return set(PHASES) - (set() if opts.deep else set(DEEP))
    sel = {x.strip() for x in opts.phases.split(",")} - {"", "0", "11"}
    if sel - set(PHASES):
        ap.error("unknown phases %s (phases: %s)"
                 % (",".join(sorted(sel - set(PHASES))), ",".join(PHASES)))
    for ph in sorted(sel):
        missing = [n for n in NEEDS.get(ph, ()) if n not in sel]
        if missing:
            ap.error("phase %s needs the outputs of phase %s: name it too"
                     % (ph, " and ".join(missing)))
    return sel


def main(argv=None) -> int:
    run = parse_phases(argv)
    say(0, card_line())
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script "
                           "runs the port on a CUDA card only")
    clock = sm_clock_mhz()
    say(0, "torch %s, CUDA %s, %s, max SM clock %g MHz; phases %s" % (
        torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
        clock, ",".join(p for p in PHASES if p in run)))
    if "1" in run:
        phase_build()
    k1 = phase_kernel_vs_plain() if "2" in run else None
    k3 = phase_ext_kernel_vs_plain() if "3" in run else None
    k4 = phase_exts2_kernel_vs_plain() if "3b" in run else None
    k2 = phase_v2_kernel_vs_plain() if "4" in run else None
    launches = ext_launches = sr = tx = seed = stream = None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if "5" in run:
            ref, reads, lines, launches, ph5 = phase_main_path(tmp)
        if "5s" in run:
            seed, outside, big = phase_seed_kernels(tmp, ref, reads, clock)
            seed_launches = phase_seed_path(tmp, ref, reads, lines, ph5,
                                            (outside, big))
        if "5r" in run:
            stream_times = phase_stream_kernels()
            phase_stream_model(ref, reads)
            stream = {"chain_v3": phase_stream_path(tmp, ref, reads, lines)}
            stream.update(phase_stream_ext(tmp, ref, reads))
            phase_split_prefix(tmp, ref, reads)
        if "6" in run:
            sam, ext_launches = phase_sam(tmp, ref, reads)
        if "7" in run:
            recs = phase_parity(tmp, ref, reads, lines)
            phase_ext_parity(tmp, ref, recs, sam)
        if "8" in run:
            sr = phase_sr(tmp, workload(tmp, 8)[0])
        if "9" in run:
            tx = phase_splice(tmp, workload(tmp, 9)[0])
        if "10" in run:
            phase_v2_parity(tmp, ref, sr, tx)
            phase_exts2_parity(tmp, ref, tx)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "mm2tpu"))
    if bad:
        raise AssertionError("modules of jax or of the JAX package were "
                             "imported: %s" % bad[:20])
    say(11, "no module named jax, mm2tpu or mm2tpu.* is in sys.modules "
        "(%d modules, %d of mm2tpu_torch)" % (
            len(sys.modules),
            sum(m.split(".")[0] == "mm2tpu_torch" for m in sys.modules)))
    B, N = SHAPES[-1]
    say(11, "K1 at (%d, %d), K2 at (%d, %d) (cDNA, 1 segment, -x splice), "
        "K3 at B = %d, %d-%d bp, K4 at B = %d, exons %d-%d, introns %d-%d "
        "bp, K5 and K6 at phase 5s's largest dispatch: bound = max(bytes / "
        "%.3g B/s, int32 instructions / (%d SMs x "
        "%d lanes x %g MHz))" % (
            B, N, *V2_SHAPES[-1], *EXT_SHAPES[-1][:3], EXTS2_SHAPES[-1][0],
            *EXTS2_SHAPES[-1][1], *EXTS2_SHAPES[-1][2], HBM_BYTES_S, SMS,
            INT32_LANES, clock))
    k2_launches = None if sr is None and tx is None else \
        (sr[3] if sr else 0) + (tx[2] if tx else 0)
    lines = []
    if k1:
        times, max_err, work = k1
        lines.append(kernel_line(
            "chain_v3", "mm2tpu_torch/csrc/chain.cu",
            "mm2tpu/ops/chain_pallas_v3.py:48", launches, max_err,
            times[SHAPES[-1]], work, clock))
    if k2:
        v2_times, v2_err, v2_work = k2
        lines.append(kernel_line(
            "chain_v2", "mm2tpu_torch/csrc/chain.cu",
            "mm2tpu/ops/chain_pallas_v2.py:142", k2_launches, v2_err,
            v2_times[(True, 1)], v2_work, clock))
    if k3:
        ext_times, ext_err, ext_work = k3
        lines.append(kernel_line(
            "ksw2_extd2", "mm2tpu_torch/csrc/ksw2_extd2.cu",
            "mm2tpu/ops/ksw2_pallas.py:86", ext_launches, ext_err,
            ext_times, ext_work, clock))
    if k4:
        s2_times, s2_err, s2_work = k4
        lines.append(kernel_line(
            "ksw2_exts2", "mm2tpu_torch/csrc/ksw2_exts2.cu",
            "mm2tpu/ops/ksw2_pallas.py:847", tx[3] if tx else None, s2_err,
            s2_times, s2_work, clock))
    if seed:
        for (name, replaces), n in zip(
                (("seed_probe", "mm2tpu/parallel/mesh.py:137"),
                 ("seed_build", "mm2tpu/ops/seed_device.py:73")),
                seed_launches):
            ms, plain_ms, lib_ms, work, err = seed[name]
            line = kernel_line(name, "mm2tpu_torch/csrc/seed.cu", replaces,
                               n, err, (ms, plain_ms), work, clock)
            # torch.searchsorted (K5's search); for K6, torch.sort of its
            # output: the sort step that follows the build
            line["library_ms"] = lib_ms
            lines.append(line)
    for line in lines:
        # launches in phase 5r's stream runs: K1 in (ii), K2, K3 and K4 in
        # (v); the stream mode seeds on the host
        line["stream_launches"] = None if stream is None else \
            stream.get(line["name"], 0)
        if stream is not None and line["name"] in stream_times:
            # B = 1, end to end, on the trainer's tasks (phase 5r (i))
            line["b1_ms"] = {str(n): ms for n, ms in
                             stream_times[line["name"]].items()}
    print(json.dumps({"kernels": lines}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
