#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card: -x map-ont
(PAF, host-seeded and device-seeded, and SAM), -x sr read pairs and -x
splice spliced reads (PAF, and SAM and PAF with CIGARs through the splice
kernel) in batch mode, -x map-ont in stream mode (each chaining task
placed on the host or the card on its own), with --split-prefix,
-x map-ont over a data-parallel mesh (--mesh) on the 8 B delta wire, in
several host processes (--hosts) and through the mappy-compatible API
(mm2tpu_torch.mappy); under a torch.profiler trace (--profile-trace), in
the default map mode (stream), through the entry points and paftools.
Every run of a batch path names --map-mode batch.

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
1,5,5r` for the stream mode, `--phases 1,5,5m` for the mesh, `--phases
1,5,5h,5p` for the host processes and the API, `--phases 1,5,5t` for
the trace, the default mode, the entry points and paftools) to run
phase 0, the named phases and phase 11's import check only; the kernel
JSON line then lists only the kernels whose phase ran (launches null
where their path's phase did not run). Phases 5s, 5r, 5m, 5h, 5p, 5t
and 6 need 5, 7 needs 5 and 6, and 10 needs 8 and 9: a list that names one
without the other is refused. Phases 8 and 9 generate the genome of phase 5 themselves.

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
     over the batch's largest n); then rows whose span sum passes
     KEY_SCORE_MAX (2^21 - 2), which the kernel keys in int64, beside
     rows keyed in int32 in one launch: f and p equal to the plain
     version's and to chain_ref.chain_scores_window's, each key width
     timed alone, and a task of 143360 anchors of span 15 timed and held
     against chain_scores_window
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
     the largest shape (with the kernel's us a step); and phase 2's rows
     over the score bound under each contract (the second row in two
     segments where n_segs = 2)
  5. the map-ont PAF path: `mm2tpu_torch.cli.main -x map-ont --map-mode
     batch --device cuda` on a seeded 48 Mb genome with 1000 ONT-like
     reads; >= 95% of the reads must map, and only K1 may have chained
     (its launches, anchors, padded anchors and card time from the
     chain.* counters)
 5s. device seeding on phase 5's genome and reads: (i) the index probe K5
     and the anchor pipeline K6 (mm2tpu_torch/csrc/seed.cu: probe,
     count, expand and radix sort into K1's planes) against their plain
     versions on the card, on the full-size index and every read in the
     contract bucketed as the path buckets it: (start, cnt) of every
     count probe, the planes and n of every fused dispatch, and K1's f
     and p on them for the dispatches of the smallest N (up to
     SEED_PLAIN_STEPS plain steps) all equal, with the slots K6 sorted
     (sum n) beside B x N; K5 and torch.searchsorted timed in turns on
     the largest count probe and the largest dispatch, K6, the old sort
     step (sort_anchors) and torch.sort of K6's real-slot keys at the
     largest dispatch, each by the card's own time (a CUDA graph's
     replay) and by the wrapper's call time, and the launches of one K6
     call and of the old sort step (torch.profiler); (ii) `--seed-backend
     gpu`: its PAF byte-identical to phase 5's, only K5, K6 and K1
     launched, with the seed.* counters, seed.gpu_busy, chain.gpu_busy
     and the idle share
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
 5m. the data-parallel mesh (K7) and the 8 B delta wire (K1a) on phase
     5's genome and reads: (i) `--mesh 1`: its PAF byte-identical to
     phase 5's, with mesh.wire8 and chain.bytes_up; (ii) the batch
     pipeline over two shards of cuda:0 (`main(..., mesh=)`): its PAF
     byte-identical to phase 5's, every bucket a K7 launch a shard and a
     K1a launch a shard on the 8 B wire, only K1 launched; (iii) the
     sharded probe at 2 and 4 shards of cuda:0 over the full index, every
     read's minimizers as queries: (start, cnt) equal to the replicated
     K5's, both timed; (iv) at the largest map-ont bucket decode8 of
     pack_tasks8 on the card equal to the 16 B planes, and upload +
     decode + K1 timed against upload + K1 on the 16 B wire (median of
     5), f and prel equal, as the two-shard mesh step's; K1a and the
     mesh step held against their plain version (decode8, the plain K1)
     on the bucket of most padded anchors with N <= MESH_PLAIN_MAX_N;
     (v) `torch.cuda.device_count()`, and where it is above 1 `--mesh
     <count>` as (i), the sharded probe as (iii) and the dry run over the
     cards; then `dryrun_multichip` on two shards of cuda:0
 5h. several host processes of this machine (`--hosts N`, a
     torch.distributed TCPStore on 127.0.0.1), each a `python -m
     mm2tpu_torch.cli` with its kernels' counts printed at its exit:
     (i) two hosts on cuda:0 map phase 5's reads; the merged PAF
     byte-identical to phase 5's, only K1 launched, each host's wall,
     chain.gpu_busy and host 0's merge stage; (ii) the same with -a
     --align-backend gpu --align-tpu-min-mat 1 on the first 200 reads:
     the SAM equal to one host's, @PG aside, only K1 and K3 launched;
     (iii) two hosts each splitting its buckets over two shards of
     cuda:0 (`cli.main(..., mesh=)` in the child): the PAF byte-identical
     to phase 5's, K1a and K7 launched, and with four cards or more
     `--mesh 2` a host on CUDA_VISIBLE_DEVICES 0,1 and 2,3; (v) two hosts
     with --seed-backend gpu on the first 200 reads: phase 5's lines of
     them, K5, K6 and K1 launched; (iv), beside the others: three hosts
     on 30 reads with --host-timeout 15, one stopped by SIGSTOP right
     after its spawn: both survivors exit non-zero and no merged output
     exists
 5p. the mappy-compatible API on the card: `mm2tpu_torch.mappy.Aligner(
     genome, preset="map-ont")` (device cuda, its default) maps phase 5's
     first 100 reads at the default routing and with chain_backend "gpu"
     (every task one K1 launch at B = 1): every hit's coordinates,
     strand, mlen, blen, mapq, tp, cg and NM equal to the rows of a
     `--map-mode stream -c` CLI run of the same reads, with route.gpu,
     route.host and K1's launches
 5t. the trace and the port's other entry points, on phase 5's genome
     (its index written once to an MMX file with -d, which every run
     maps) and its first 100 reads: (i) `--map-mode batch -a
     --align-backend gpu --align-tpu-min-mat 1 --seed-backend gpu`; (ii)
     the same with `--profile-trace DIR`: the SAM byte-identical to
     (i)'s without @PG, K1's, K5's and K6's launches and ext.fills equal
     to (i)'s, the trace's device events of each kernel (chain_kernel,
     extd2_kernel, seed_probe, seed_count, seed_offsets, seed_expand,
     seed_sort_pass) equal to the launches its wrapper counted, and stage
     ranges from the main thread and the align threads; both walls and
     the trace's size; (iii) `--map-mode stream -t 4 --chain-backend gpu
     -a --align-backend gpu --align-tpu-min-mat 1 --profile-trace` on the
     first 15 reads: its SAM records (i)'s of those reads, the trace held
     as in (ii), with ranges from the pool's threads; (iv) no --map-mode:
     the PAF byte-identical to `--map-mode stream --chain-backend
     native`'s; (v) `python -m mm2tpu_torch.entry`, in this process (K1
     at (32, 4096) and the dry run over the cards); (vi)
     `mm2tpu_torch.tools.paftools` stat and sam2paf on (i)'s SAM
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
     B = 1 times; the launches of 5h's hosts and of 5p's second pass;
     the device events of 5t (ii)'s trace),
     the card's name and power limit,
     then {"ok": true, "device": {...}} last

Everything runs through `mm2tpu_torch`; the script imports nothing of
JAX and nothing of the JAX package. The plain versions' agreement with
the NumPy oracles and with the Pallas kernels is held in the CPU tests
(tests/test_torch_chain_v3.py, tests/test_torch_chain_v2.py,
tests/test_torch_ksw2_extd2.py, tests/test_torch_ksw2_exts2.py).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import glob
import importlib.util
import io
import json
import os
import runpy
import signal
import subprocess
import sys
import tempfile
import threading
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
# rows whose span sum passes chain_v3.KEY_SCORE_MAX (2^21 - 2), which
# K1/K2 key in int64: collinear tasks of span 255, 300 bp apart, whose
# scores pass the bound at anchor 8224. One launch at N = WIDE_N holds the
# task of WIDE_OVER anchors, a second task (the same in two segments for
# K2, else one of span 15 under the bound), the task of its first
# WIDE_UNDER anchors (span sum 2,097,120: the int32 key) and an empty row
WIDE_OVER, WIDE_UNDER, WIDE_N = 9000, 8224, 9216
# a map-ont-sized task over the bound: WIDE_LONG[0] anchors of span 15
# (k = 15) at N = WIDE_LONG[1], on K1 against the oracle (~15 s of NumPy)
WIDE_LONG = (143360, 147456)
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
# K5 and K6 (csrc/seed.cu) are bounded by their bytes alone, counted from
# what the function must read and write whatever implements it (phase
# 5s): no instruction count of one algorithm's steps
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


def collinear_task(n, span, gap=300):
    """(n, 2) uint64 anchors on one diagonal, `gap` apart, of span `span`:
    f grows by `span` a step."""
    pos = gap * np.arange(n, dtype=np.uint64)
    return np.stack([pos, (np.uint64(span) << np.uint64(32)) | pos], axis=1)


def wide_key_check(phase, cfg, is_cdna=False, n_segs=1, long=False):
    """K1 (or K2 under (is_cdna, n_segs)) on rows whose span sum passes
    KEY_SCORE_MAX, which the kernel keys in int64, in one launch with
    rows keyed in int32 (WIDE_*): f and p equal to the plain version's on
    every row and to chain_ref.chain_scores_window's, the contract's
    oracle; the row over the bound must pass it. Each collinear row is
    timed alone at B = 1. With `long`, the map-ont-sized task of
    WIDE_LONG on K1, timed and held against the oracle. Returns (max abs
    err, {what: (ms, steps)})."""
    from mm2tpu_torch.ops import chain_ref
    from mm2tpu_torch.ops.chain_packed import (KEY_SCORE_MAX, chain_scores,
                                               derive_qss, pack_tasks16,
                                               planes_to_torch)
    over = collinear_task(WIDE_OVER, 255)
    tasks = [over, two_segment(over, 77) if n_segs > 1 else
             synth_anchors(WIDE_OVER, seed=77, n_rids=3, rev_frac=0.4),
             over[:WIDE_UNDER], np.zeros((0, 2), np.uint64)]
    kw = dict(cfg, is_cdna=is_cdna, n_segs=n_segs)
    what = "K1" if n_segs == 1 and not is_cdna else \
        "K2 (is_cdna=%s, n_segs=%d)" % (is_cdna, n_segs)

    def planes_of(rows, N):
        hi, lo, yhi, ylo, n, avg = planes_to_torch(*pack_tasks16(rows, N),
                                                   DEVICE)
        qi, span, sid = derive_qss(yhi, ylo)
        return (hi, lo, qi.contiguous(), span.contiguous(), sid.contiguous(),
                n, avg)

    def oracle(a, f, p, tag):
        fw, pw, _ = chain_ref.chain_scores_window(
            a, cfg["max_dist_x"], cfg["max_dist_y"], cfg["bw"],
            min(cfg["iter_cap"], 1024), cfg["gap_scale"], is_cdna, n_segs)
        if not (np.array_equal(f[:len(a)].cpu().numpy(), fw) and
                np.array_equal(p[:len(a)].cpu().numpy(), pw)):
            raise AssertionError("%s %s: %s differs from "
                                 "chain_scores_window" % (phase, what, tag))

    planes = planes_of(tasks, WIDE_N)
    f, p = chain_scores(*planes, **kw)
    f2, p2 = chain_scores(*planes, plain=True, **kw)
    err = chain_err("%s %s != plain on rows over the score bound"
                    % (phase, what), f, p, f2, p2)
    for r in range(3):
        oracle(tasks[r], f[r], p[r], "row %d" % r)
    if int(f[0].max()) <= KEY_SCORE_MAX:
        raise AssertionError("%s %s: the row over the bound reached f %d"
                             % (phase, what, int(f[0].max())))
    times = {}
    for tag, r in (("int64 key", 0), ("int32 key", 2)):
        one = planes_of([tasks[r]], WIDE_N)
        times[tag] = (cuda_ms(lambda: chain_scores(*one, **kw), 5)[0],
                      len(tasks[r]))
    if long:
        a = collinear_task(WIDE_LONG[0], 15)
        one = planes_of([a], WIDE_LONG[1])
        ms, (fl, pl) = cuda_ms(lambda: chain_scores(*one, **kw), 3)
        oracle(a, fl[0], pl[0], "the task of %d anchors of span 15"
               % len(a))
        times["int64 key, %d anchors of span 15" % len(a)] = (ms, len(a))
    say(phase, "%s == plain on rows over the score bound (f up to %d > "
        "KEY_SCORE_MAX %d, int64 key) beside int32-keyed rows at (B, N) = "
        "(4, %d), and == chain_scores_window on every real row; alone at "
        "B = 1: %s" % (what, int(f[0].max()), KEY_SCORE_MAX, WIDE_N,
                       "; ".join("%s %.3f ms, %.3f us a step over %d steps"
                                 % (k, ms, ms * 1e3 / n, n)
                                 for k, (ms, n) in times.items())))
    return err, times


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
    max_err = max(max_err, wide_key_check(2, CONFIGS["map-ont"],
                                          long=True)[0])
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
    for is_cdna, n_segs in V2_CONTRACTS:
        max_err = max(max_err, wide_key_check(
            4, V2_CONFIGS[V2_TIMED[(is_cdna, n_segs)]], is_cdna, n_segs)[0])
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
    rc = cli.main(["-x", "map-ont", "--map-mode", "batch", "--device",
                   DEVICE, "--profile", "-o", paf, ref, reads])
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


def graph_ms(fn, reps=20):
    """The card's own time of one call of `fn`: `reps` calls captured in
    a CUDA graph, the replay timed with CUDA events (median of 5 replays)
    over reps, in ms; no host time between the launches. Returns it and
    the last call's result."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            out = fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return float(np.median(times)), out


def card_launches(fn):
    """(launches, card ms, {name: [launches, ms]}) of one call of `fn` as
    torch.profiler traces it on the card: kernels, memsets and copies,
    their summed durations, and both by name (cut to 40 characters);
    (None, None, {}) where the trace shows no device activity (not
    measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        return None, None, {}
    by_name = {}
    for e in evs:
        row = by_name.setdefault(e.name.replace("(anonymous namespace)::",
                                                "")[:40], [0, 0.0])
        row[0] += 1
        row[1] += e.time_range.elapsed_us() / 1e3
    return len(evs), sum(r[1] for r in by_name.values()), by_name


def packed_sort_keys(key, n, index):
    """The flat real-slot keys that K6 sorts, from the plain build's (B,
    N) keys (x ^ 2^63) and n: (row, strand, rid, rpos) in the index's
    widths, as one int64 (every dispatch's width here is below 63)."""
    B, N = key.shape
    x = key ^ (-(1 << 63))
    rid_bits, pos_bits = index["rid_bits"], index["pos_bits"]
    rows = torch.arange(B, device=key.device)[:, None].expand(B, N)
    real = torch.arange(N, device=key.device)[None, :] < n.reshape(B, 1)
    packed = (rows << (rid_bits + pos_bits + 1)) | \
        (((x >> 63) & 1) << (rid_bits + pos_bits)) | \
        (((x >> 32) & 0x7FFFFFFF) << pos_bits) | (x & 0xFFFFFFFF)
    return packed[real].contiguous()


def phase_seed_kernels(tmp, ref, reads, clock):
    """Phase 5s (i): K5 and K6 against their plain versions on the card,
    on phase 5's index at full size and every eligible read's minimizers
    bucketed as the path buckets them (`mapping/pipeline.py`'s helpers):
    every count probe's (start, cnt), every fused dispatch's planes and
    n, and f and p of K1 on them for the dispatches of the smallest N
    within SEED_PLAIN_STEPS; the slots K6 sorted (sum n) beside B x N.
    Then timed in turns, each by the card's own time (`graph_ms`) and by
    the wrapper's call time (`cuda_ms`, 20 calls back to back): K5 and
    torch.searchsorted on the largest count probe's and the largest
    dispatch's queries; at the largest dispatch K6 (probe to K1's
    planes), the old sort step (`sort_anchors` on the plain build's
    keys) and torch.sort of the same real-slot keys K6 sorts; the
    launches of one K6 call and of the old sort step by torch.profiler.
    Returns ({"seed_probe": ..., "seed_build": ...} of (ms, plain ms,
    library ms, work, max abs err, extra keys), the reads outside the
    contract and the reads over the largest bucket)."""
    from mm2tpu_torch import cli
    from mm2tpu_torch.mapping import pipeline as pl
    from mm2tpu_torch.ops import seed_device as sd
    t0 = time.perf_counter()
    io, mo = cli.set_opt(None)
    io, mo = cli.set_opt("map-ont", io, mo)
    mi = next(cli.index_parts(ref, io, n_threads=3))
    cli.mapopt_update(mo, mi)
    index = sd.prepare_index_device(mi, DEVICE)
    keys, start, cnt, pos, table = (index[k] for k in (
        "keys", "start", "cnt", "pos", "table"))
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
    on_card = sum(t.numel() * t.element_size() for t in (
        table.keys, table.sc, table.lut, pos))
    say("5s", "index on the card: %d keys, %d positions, a bucket table of "
        "2^%d buckets (shift %d; %.1f MB in all); sort key widths: rid %d "
        "bits, rpos %d bits; %d reads in the contract, %d outside it; "
        "mid_occ %d; %.3f s" % (
            keys.numel(), pos.numel(), table.bits, table.shift,
            on_card / 1e6, index["rid_bits"], index["pos_bits"], len(idxs),
            len(outside), mid_occ, time.perf_counter() - t0))
    max_err, n_q, cnts, probe_qs = 0, 0, {}, []
    probes = pl._probe_chunks(ctxs, idxs)
    for M, chunk, B in probes:
        q = np.full((B, M), sd.PAD_Q, np.int64)
        for r, i in enumerate(chunk):
            q[r, :len(prep[i][0])] = prep[i][0]
        q = torch.from_numpy(q).to(DEVICE)
        got = sd.probe_index(index, q)
        max_err = max(max_err, tensors_equal(
            "K5 != plain at (%d, %d)" % (B, M), got,
            sd.probe_counts_reference(keys, start, cnt, q)))
        c = got[1].cpu().numpy()
        for r, i in enumerate(chunk):
            cnts[i] = c[r, :len(ctxs[i].mv)]
        n_q += B * M
        probe_qs.append(q)
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
    anchors = padded = 0
    for k, ((M, N, gap_ref, gap_qry), chunk, B) in enumerate(plan):
        planes = [torch.from_numpy(a).to(DEVICE)
                  for a in pl._seed_planes(prep, ctxs, meta, chunk, B, M)]
        what = "dispatch %d, (B, M, N) = (%d, %d, %d)" % (k, B, M, N)
        totals = [meta[i][2] for i in chunk]
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
        if n[:len(chunk), 0].tolist() != totals or int(n[len(chunk):].sum()):
            raise AssertionError("%s: n %s, the counts give %s" % (
                what, n[:, 0].tolist(), totals))
        anchors += sum(min(t, N) for t in totals)
        padded += B * N
    say("5s", "K6 == plain on all %d fused dispatches (planes hi, lo, qi, "
        "span, yhi and n), and K1 == plain on the anchors of the %d of "
        "smallest N (f, p; %d plain steps); K6 sorted %d real slots (sum "
        "n) of the dispatches' B x N = %d; %d reads over the largest "
        "bucket" % (len(plan), len(with_k1), SEED_PLAIN_STEPS - budget,
                    anchors, padded, len(big)))

    # K5 timed on the largest count probe's queries and the largest
    # dispatch's, beside torch.searchsorted on the same keys and queries
    (M, N, gap_ref, gap_qry), chunk, B = max(
        plan, key=lambda job: (job[0][1], job[0][0], len(job[1])))
    q, qpos, qyhi, qlen, _ = (torch.from_numpy(a).to(DEVICE) for a in
                              pl._seed_planes(prep, ctxs, meta, chunk, B, M))
    largest_probe = max(probe_qs, key=lambda t: t.numel())
    k5 = {}
    for tag, qq in (("count probe", largest_probe), ("dispatch", q)):
        row = {}
        for turn in range(2):   # in turns: K5, library, library, K5
            order = ("k5", "lib") if turn == 0 else ("lib", "k5")
            for who in order:
                fn = (lambda qq=qq: sd.probe_index(index, qq)) \
                    if who == "k5" else \
                    (lambda qq=qq: torch.searchsorted(keys, qq))
                dev_ms, out = graph_ms(fn)
                call_ms, _ = cuda_ms(fn, 20)
                row.setdefault(who, []).append((dev_ms, call_ms))
                if who == "k5":
                    hits = int((out[1] > 0).sum())
        k5[tag] = ({w: tuple(float(np.median([t[j] for t in v]))
                            for j in (0, 1))
                    for w, v in row.items()}, qq.numel(), hits)
        (kd, kc), (ld, lc) = k5[tag][0]["k5"], k5[tag][0]["lib"]
        say("5s", "K5 on the %s's %d queries (%s, %d hits): card time "
            "%.4f ms (CUDA graph), call time %.4f ms; torch.searchsorted "
            "card %.4f ms, call %.4f ms (each the median of two turns)" % (
                tag, qq.numel(), "x".join(map(str, qq.shape)),
                k5[tag][2], kd, kc, ld, lc))
    k5_plain, _ = cuda_ms(
        lambda: sd.probe_counts_reference(keys, start, cnt, q), 3)
    # bytes in and out once: the queries and their (start, cnt), and each
    # hit's key, start and cnt
    Q, hits = k5["dispatch"][1], k5["dispatch"][2]
    k5_work = (16 * Q + 16 * hits, 0)

    # K6 at the largest dispatch, beside the old sort step and torch.sort
    slots = sum(min(meta[i][2], N) for i in chunk)
    pipe = functools.partial(sd.seed_anchors, index, q, qpos, qyhi, qlen,
                             N=N, mid_occ=mid_occ)
    s_ref, c_ref = sd.probe_counts_reference(keys, start, cnt, q)
    key, y, n = sd.build_anchors_reference(s_ref, c_ref, qpos, qyhi, qlen,
                                           pos, N=N, mid_occ=mid_occ)
    flat = packed_sort_keys(key, n, index)
    total = int(n.sum())
    if flat.numel() != slots or total != slots:
        raise AssertionError("K6 timing: %d real slots, the counts give %d"
                             % (flat.numel(), slots))
    old_step = functools.partial(sd.sort_anchors, key, y, n)
    lib_sort = functools.partial(torch.sort, flat, stable=True)
    times = {}
    for who in ("k6", "old", "lib", "lib", "old", "k6"):
        fn = {"k6": pipe, "old": old_step, "lib": lib_sort}[who]
        dev_ms, _ = graph_ms(fn)
        call_ms, _ = cuda_ms(fn, 20)
        times.setdefault(who, []).append((dev_ms, call_ms))
    med = {w: tuple(float(np.median([t[j] for t in v])) for j in (0, 1))
           for w, v in times.items()}
    k6_plain, _ = cuda_ms(functools.partial(
        sd.seed_anchors_reference, index, q, qpos, qyhi, qlen, N=N,
        mid_occ=mid_occ), 3)
    k6_launches = card_launches(pipe)
    old_launches = card_launches(old_step)
    # the bytes K6 must move: the minimizer planes in (q, qpos, qyhi) and
    # qlen, 8 B of pos an anchor, the planes out (hi, lo, qi, span int32,
    # yhi int16: 18 B a slot) and n
    k6_work = (16 * B * M + 4 * B + 8 * total + 18 * B * N + 4 * B, 0)
    say("5s", "K6 at the largest dispatch (B, M, N) = (%d, %d, %d): sorted "
        "%d real slots (sum n) of B x N = %d; card time %.4f ms, call "
        "time %.4f ms (plain %.3f ms; bound %.4f ms, %s); the old sort "
        "step (sort_anchors on the B x N keys) card %.4f ms, call %.4f "
        "ms; torch.sort of the %d real-slot keys card %.4f ms, call %.4f "
        "ms (medians of two turns)" % (
            B, M, N, total, B * N, *med["k6"], k6_plain,
            *bound(*k6_work, clock), *med["old"], total, *med["lib"]))
    for what, (nl, ms, kinds) in (("K6", k6_launches),
                                  ("the old sort step", old_launches)):
        say("5s", "launches of one call of %s (torch.profiler): %s%s" % (
            what, "not measured" if nl is None else
            "%d, %.4f ms on the card" % (nl, ms), "".join(
                "; %s x%d %.4f ms" % (k, c, t)
                for k, (c, t) in sorted(kinds.items(),
                                        key=lambda kv: -kv[1][1]))))
    kd, kc = k5["dispatch"][0]["k5"]
    return ({"seed_probe": (kd, k5_plain, k5["dispatch"][0]["lib"][0],
                            k5_work, max_err,
                            {"call_ms": kc,
                             "library_call_ms": k5["dispatch"][0]["lib"][1],
                             "count_probe": {
                                 "queries": k5["count probe"][1],
                                 "ms": k5["count probe"][0]["k5"][0],
                                 "call_ms": k5["count probe"][0]["k5"][1],
                                 "library_ms":
                                     k5["count probe"][0]["lib"][0]}}),
             "seed_build": (med["k6"][0], k6_plain, med["lib"][0], k6_work,
                            max_err,
                            {"call_ms": med["k6"][1],
                             "library_call_ms": med["lib"][1],
                             "old_sort_step_ms": med["old"][0],
                             "sorted_slots": total, "slots": B * N,
                             "card_launches": k6_launches[0],
                             "card_kernels": k6_launches[2],
                             "old_sort_step_launches": old_launches[0]})},
            outside, [names[i] for i in big])


def phase_seed_path(tmp, ref, reads, lines, ph5_counters, why):
    """Phase 5s (ii): map-ont PAF with --seed-backend gpu, byte-identical
    to phase 5's host-seeded PAF; only K5, K6 and K1 launched, no plain
    version. Returns the launches of K5 and K6."""
    paf = os.path.join(tmp, "seed_gpu.paf")
    wall, counts, stages, counters = drive(
        ["-x", "map-ont", "--map-mode", "batch", "--seed-backend", "gpu",
         "--device", DEVICE, "-o", paf, ref, reads])
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
            ["-x", "map-ont", "--map-mode", "batch", "--split-prefix",
             prefix, "-I", str(size), "--device", DEVICE, "-o", paf, ref,
             reads])
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



# ---- phase 5m: the data-parallel mesh (K7) and the 8 B delta wire (K1a) ----

# two shards of the batch pipeline, and of the dry run, on one card
MESH_ONE_CARD = ("cuda:0", "cuda:0")
# the sharded probe's meshes: D shards, all on cuda:0
MESH_PROBE_SHARDS = (2, 4)
# K1a and K7 are held against their plain version (decode8, then the
# plain K1) on the map-ont bucket of the most padded anchors among those
# of N <= MESH_PLAIN_MAX_N: the plain K1 takes ~0.5 ms a step on the card
MESH_PLAIN_MAX_N = 8192


def median_ms(fn, reps=5, warmup=True):
    """Median CUDA-event time of `reps` calls of `fn`, each timed alone
    (events before and after, then a synchronise), in ms, and the last
    call's result."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times)), out


def mesh_run(tmp, tag, what, ref, reads, lines, ph5_counters, argv=(),
             **main_kw):
    """One map-ont PAF run through the mesh path, with K1a's and K7's
    counts set to 0 just before it and read just after: its PAF must
    equal phase 5's, only K1 may have launched, and every bucket must
    have gone through the mesh (a K7 launch a shard, a K1a launch a shard
    of each bucket on the 8 B wire). Returns (K1a launches, K7
    launches)."""
    from mm2tpu_torch.ops import chain_packed as cp
    from mm2tpu_torch.parallel import mesh as pm
    paf = os.path.join(tmp, "mesh_%s.paf" % tag)
    cp.launches8 = pm.launches = 0
    wall, counts, stages, counters = drive(
        ["-x", "map-ont", "--map-mode", "batch", "--device", DEVICE, *argv,
         "-o", paf, ref, reads], **main_kw)
    k1a, k7 = cp.launches8, pm.launches
    only("5m", what, counts, "chain_v3")
    with open(paf) as fh:
        if fh.read().splitlines() != lines:
            raise AssertionError("5m %s: PAF differs from phase 5's" % what)
    buckets = counters.get("chain.launches", 0)
    shards = counters.get("mesh.shards", 0)
    wire8 = counters.get("mesh.wire8", 0)
    D = shards // max(buckets, 1)
    if buckets <= 0 or k7 != shards or k1a != wire8 * D or k1a <= 0:
        raise AssertionError("5m %s: %d buckets, mesh.shards %d, mesh.wire8 "
                             "%d, K7 launches %d, K1a launches %d" % (
                                 what, buckets, shards, wire8, k7, k1a))
    padded = counters["chain.padded_anchors"]
    say("5m", "%s: PAF (%d lines) byte-identical to phase 5's; %d buckets "
        "over %d shards (mesh.shards %d = K7 shard launches), %d on the 8 B "
        "wire (mesh.wire8; K1a launches %d); chain.bytes_up %d, %.3f B a "
        "padded anchor (phase 5: %d, %.3f); chain.gpu_busy %.3f s (phase "
        "5: %.3f s); wall %.3f s (phase 5: %.3f s)" % (
            what, len(lines), buckets, D, shards, wire8, k1a,
            counters["chain.bytes_up"], counters["chain.bytes_up"] / padded,
            ph5_counters["chain.bytes_up"],
            ph5_counters["chain.bytes_up"] /
            ph5_counters["chain.padded_anchors"],
            stages.get("chain.gpu_busy", (0.0,))[0],
            PH5["stages"].get("chain.gpu_busy", (0.0,))[0], wall, PH5["wall"]))
    report("5m", what, wall, WORKLOAD["n_reads"], stages, counters)
    return k1a, k7


def phase_mesh_path(tmp, ref, reads, lines, ph5_counters):
    """Phase 5m (i), (ii), (v) and the dry run: `--mesh 1` through the
    CLI, the batch pipeline over two shards of cuda:0, `--mesh <cards>`
    where there is more than one card, and `dryrun_multichip` on two
    shards of cuda:0. Returns (ii)'s K1a and K7 launches."""
    from mm2tpu_torch.parallel.dryrun import dryrun_multichip
    from mm2tpu_torch.parallel.mesh import make_mesh
    args = (ref, reads, lines, ph5_counters)
    mesh_run(tmp, "i", "(i) --mesh 1", *args, argv=("--mesh", "1"))
    launches = mesh_run(tmp, "ii", "(ii) two shards on cuda:0", *args,
                        mesh=make_mesh(2, devices=MESH_ONE_CARD))
    n = torch.cuda.device_count()
    if n > 1:
        mesh_run(tmp, "v", "(v) --mesh %d" % n, *args,
                 argv=("--mesh", str(n)))
    else:
        say("5m", "(v) torch.cuda.device_count() = 1: a mesh over more than "
            "one card is unverified (every mesh here is shards of cuda:0)")
    say("5m", dryrun_multichip(2, devices=list(MESH_ONE_CARD)))
    if n > 1:
        say("5m", "(v) " + dryrun_multichip(n))
    return launches


def wire8_work(p8, N, cap):
    """(bytes, int32 instructions) of K1a on `pack_tasks8`'s planes: the
    planes read once and f and prel (6 B an anchor) written once; K1's
    candidates."""
    _, ops = chain_work(p8[6], N, cap, 0, OPS_PER_CANDIDATE["chain_v3"])
    return sum(a.nbytes for a in p8) + 6 * p8[0].size, ops


def phase_mesh_kernels(ref, reads, clock):
    """Phase 5m (iii) and (iv) on phase 5's index and reads: the sharded
    probe at MESH_PROBE_SHARDS shards of cuda:0 against the replicated
    K5, every read's minimizers as queries; at the largest map-ont bucket
    decode8 against the 16 B planes and both wires timed (upload, decode,
    K1); K1a and the mesh step held against their plain version on the
    check bucket. Returns {name: (ms, plain ms, work, max abs err)}."""
    from mm2tpu_torch import cli
    from mm2tpu_torch.mapping import pipeline as pl
    from mm2tpu_torch.ops import chain_packed as cp
    from mm2tpu_torch.ops import seed_device as sd
    from mm2tpu_torch.parallel import mesh as pm
    t0 = time.perf_counter()
    io, mo = cli.set_opt(None)
    io, mo = cli.set_opt("map-ont", io, mo)
    mi = next(cli.index_parts(ref, io, n_threads=3))
    cli.mapopt_update(mo, mi)
    ctxs = [c for c in (pl._prepare(mi, [seq], mo, name)
                        for name, seq in read_fasta(reads))
            if not isinstance(c, pl.FragResult)]
    say("5m", "index (%d keys) and host seeding of %d reads in %.3f s" % (
        len(mi.keys), len(ctxs), time.perf_counter() - t0))

    # (iii) the sharded probe against the replicated one
    qs = [sd.split_query_minimizers(c.mv)[0] for c in ctxs if len(c.mv)]
    B = -(-len(qs) // max(MESH_PROBE_SHARDS)) * max(MESH_PROBE_SHARDS)
    q = np.full((B, max(len(x) for x in qs)), sd.PAD_Q, np.int64)
    for r, x in enumerate(qs):
        q[r, :len(x)] = x
    index = sd.prepare_index_device(mi, DEVICE)
    qt = torch.from_numpy(q).to(DEVICE)
    rep_ms, want = median_ms(lambda: sd.probe_index(index, qt))
    want = tuple(t.cpu() for t in want)
    Q = q.size
    meshes = [pm.make_mesh(D, devices=[MESH_ONE_CARD[0]] * D)
              for D in MESH_PROBE_SHARDS]
    if torch.cuda.device_count() > 1:   # (v): over the cards as well
        meshes.append(pm.make_mesh())
    for mesh in meshes:
        D = len(mesh)
        keys, st, cnt, _ = pm.shard_index_arrays(mi.keys, mi.start, mi.cnt,
                                                 D)
        shards = pm.shard_index(mesh, keys, st, cnt)   # on the card once
        step = pm.sharded_probe_step(mesh)
        ms, got = median_ms(lambda: step(shards, q).result())
        tensors_equal("sharded probe at D = %d != the replicated K5" % D,
                      got, want)
        # each shard reads every query and writes its (start, cnt), each
        # hit reads its key, start and cnt once; the all-gather and the
        # reduce-scatter move (D - 1) x 8 B a query each
        hits = int((want[1] > 0).sum())
        work = (D * 16 * Q + 16 * hits + (D - 1) * 16 * Q, 0)
        say("5m", "(iii) sharded probe, D = %d shards (%s), %d queries "
            "(%d reads' minimizers, %d hits): (start, cnt) == the replicated "
            "K5's; %.3f ms a step (upload of the queries, all-gather, D K5 "
            "launches, reduce-scatter, gather; the key shards on the card; "
            "median of 5) against the replicated K5 %.3f ms (index and "
            "queries on the card); bound %.4f ms (%s, "
            "collectives %d B)" % (
                D, ",".join(str(d) for d in mesh), Q, len(qs),
                int((want[1] > 0).sum()), ms, rep_ms,
                *bound(*work, clock), (D - 1) * 16 * Q))

    # (iv) the 8 B wire at the largest bucket, K1a and K7 at the check one
    iter_cap = min(1024, mo.max_chain_iter)
    groups = {}
    for c in ctxs:
        if len(c.sr.anchors):
            groups.setdefault((c.gap_ref, c.gap_qry,
                               pl.bucket_for(len(c.sr.anchors))),
                              []).append(c.sr.anchors)

    def bucket(key):
        tasks = groups[key][:pl.B_SIZES[-1]]
        B = next(b for b in pl.B_SIZES if b >= len(tasks))
        tasks += [np.zeros((0, 2), np.uint64)] * (B - len(tasks))
        kw = dict(max_dist_x=key[0], max_dist_y=key[1], bw=mo.bw,
                  iter_cap=iter_cap, gap_scale=float(mo.chain_gap_scale),
                  is_cdna=False, n_segs=1)
        p8 = cp.pack_tasks8(tasks, key[2])
        if p8 is None:
            raise AssertionError("the bucket (%d, %d) does not fit the 8 B "
                                 "wire" % (B, key[2]))
        return tasks, kw, p8

    def k1a(p8, kw, **extra):
        return cp.chain_scores_packed8(*cp.planes_to_torch(*p8, DEVICE),
                                       **kw, **extra)

    largest = max(groups, key=lambda k: (k[2], len(groups[k])))
    tasks, kw, p8 = bucket(largest)
    N = largest[2]
    p16 = cp.pack_tasks16(tasks, N)
    dec = cp.decode8(*cp.planes_to_torch(*p8[:6], DEVICE))
    hi, lo, yhi, ylo, n16 = cp.planes_to_torch(*p16[:5], DEVICE)
    live = torch.arange(N, device=DEVICE) < n16
    tensors_equal("decode8 hi, lo != the 16 B planes'", dec[:2], (hi, lo))
    tensors_equal("decode8 qi, span, sid != the 16 B planes' within n",
                  [torch.where(live, t, 0) for t in dec[2:]],
                  [torch.where(live, t, 0)
                   for t in cp.derive_qss(yhi, ylo)])
    planes8 = cp.planes_to_torch(*p8[:6], DEVICE)
    dec_ms, _ = median_ms(lambda: cp.decode8(*planes8))
    ms8, out8 = median_ms(lambda: k1a(p8, kw))
    ms16, out16 = median_ms(lambda: cp.chain_scores_packed(
        *cp.planes_to_torch(*p16, DEVICE), **kw))
    tensors_equal("K1a != K1 on the 16 B wire", out8, out16)
    step8 = pm.sharded_chain_step8(pm.make_mesh(2, devices=MESH_ONE_CARD),
                                   **kw)
    ms_mesh, got = median_ms(lambda: step8(*p8).result())
    tensors_equal("the mesh step over two shards != K1a", got,
                  tuple(t.cpu() for t in out8))
    up8, up16 = sum(a.nbytes for a in p8), sum(a.nbytes for a in p16)
    say("5m", "(iv) the largest map-ont bucket (B, N) = (%d, %d), %d "
        "anchors: decode8(pack_tasks8) on the card == the 16 B planes; up "
        "%d B on the 8 B wire (%.3f B a padded anchor) against %d B (%.3f); "
        "upload + decode + K1 %.3f ms against upload + K1 %.3f ms on the "
        "16 B wire (median of 5; the decode alone %.3f ms), f and prel "
        "equal; the mesh step over two shards of cuda:0 %.3f ms (upload, "
        "decode, K1 a shard, gather), equal" % (
            len(tasks), N, sum(len(t) for t in tasks), up8,
            up8 / (len(tasks) * N), up16, up16 / (len(tasks) * N), ms8, ms16,
            dec_ms, ms_mesh))
    check = max((k for k in groups if k[2] <= MESH_PLAIN_MAX_N),
                key=lambda k: (min(len(groups[k]), pl.B_SIZES[-1]) * k[2]))
    tasks, kw, p8 = bucket(check)
    N = check[2]
    ms, out = median_ms(lambda: k1a(p8, kw))
    plain_ms, want = median_ms(
        lambda: k1a(p8, kw, chain_fn=cp.chain_scores_plain), reps=1,
        warmup=False)
    err = chain_err("K1a at (%d, %d)" % (len(tasks), N), *out, *want)
    ms7, got = median_ms(lambda: step8(*p8).result())
    want = tuple(t.cpu() for t in want)
    err7 = chain_err("the mesh step at (%d, %d)" % (len(tasks), N), *got,
                     *want)
    work = wire8_work(p8, N, iter_cap)
    say("5m", "K1a and the two-shard mesh step at the check bucket (B, N) = "
        "(%d, %d), %d anchors: f and prel equal their plain version "
        "(decode8, then the plain K1); K1a %.3f ms, the mesh step %.3f ms, "
        "the plain version %.3f ms (one call); bound %.4f ms (%s)" % (
            len(tasks), N, sum(len(t) for t in tasks), ms, ms7, plain_ms,
            *bound(*work, clock)))
    return {"chain_packed8": (ms, plain_ms, work, err),
            "mesh_chain_step8": (ms7, plain_ms, work, err7),
            "shapes": ((len(tasks), N), largest[2], ms8, ms16)}


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
    return ["-x", "map-ont", "--map-mode", "batch", "-a", "--align-backend",
            backend, "--align-tpu-min-mat", "1", "--device", DEVICE, *extra,
            "-o", out, ref, reads]


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
    rc = cli.main(["-x", "map-ont", "--map-mode", "batch", "--device",
                   DEVICE, "-o", paf, ref, sub], chain_fn=chain_scores_plain)
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
    (wall s, {kernel: (launches, plain calls)}, stage seconds, counters).
    `argv` must name its --map-mode: the default, stream, runs one
    extension fill a launch, so a run that meant batch would silently
    take much longer."""
    if "--map-mode" not in argv:
        raise ValueError("drive(): the argv names no --map-mode: %s"
                         % (argv,))
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
        ["-x", "sr", "--map-mode", "batch", "--device", DEVICE, "-o", paf,
         ref, r1, r2])
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
        w, c, st, ctr = drive(["-x", "sr", "--map-mode", "batch", "-a",
                               "--align-backend", backend,
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
        ["-x", "splice", "--map-mode", "batch", "--device", DEVICE, "-o",
         paf, ref, reads])
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
        w, c, st, ctr = drive(["-x", "splice", "--map-mode", "batch", "-a",
                               "--align-backend", backend,
                               "--align-tpu-min-mat", "1", "--device",
                               DEVICE, "-o", out, ref, reads])
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
    w, c, st, ctr = drive(["-x", "splice", "--map-mode", "batch", "-c",
                           "--align-backend", "gpu", "--align-tpu-min-mat",
                           "1", "--device", DEVICE, "-o", cpaf, ref,
                           c_reads])
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
        ["-x", "splice", "--map-mode", "batch", "-a", "--align-backend",
         "gpu", "--align-tpu-min-mat", "1", "--device", DEVICE, "-o", out,
         ref, sub], exts2_fn=S.exts2_traced_reference)
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
            ["-x", preset, "--map-mode", "batch", "--device", DEVICE, "-o",
             out, ref, *queries], profile=False, chain_fn=chain_scores_plain)
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


# phase 5h: the multi-host runs, host processes of this machine joined by
# a torch.distributed.TCPStore on 127.0.0.1, every host on cuda:0 (or,
# under CUDA_VISIBLE_DEVICES, on its own cards). (ii) and (v) map the
# first HOSTS_SUB_READS reads; (iv) stops one of three hosts on the first
# HOSTS_STOP_READS reads under --host-timeout HOSTS_STOP_TIMEOUT
HOSTS_SUB_READS = 200
HOSTS_STOP_READS, HOSTS_STOP_TIMEOUT = 30, 15
# a host process: `python -m mm2tpu_torch.cli ARGV` (with SHARDS > 0,
# `cli.main(ARGV, mesh=make_mesh(SHARDS, devices=["cuda:0"] * SHARDS))`)
# with every kernel's launch and plain-version count set to 0 just before
# the run; it prints them as a HOST_COUNTS line as it exits
HOST_CHILD = r"""
import atexit, json, runpy, sys
from mm2tpu_torch.ops import (chain_packed, chain_v2, chain_v3, ksw2_extd2,
                              ksw2_exts2, seed_device)
from mm2tpu_torch.parallel import mesh
mods = {"chain_v3": chain_v3, "chain_v2": chain_v2,
        "ksw2_extd2": ksw2_extd2, "ksw2_exts2": ksw2_exts2}
for m in mods.values():
    m.launches = m.reference_calls = 0
seed_device.reset_counts()
chain_packed.launches8 = mesh.launches = 0
def counts():
    c = {k: [m.launches, m.reference_calls] for k, m in mods.items()}
    for k in ("probe", "build"):
        c["seed_" + k] = [seed_device.launches[k],
                          seed_device.reference_calls[k]]
    c["chain_packed8"] = [chain_packed.launches8, 0]
    c["mesh_chain_step8"] = [mesh.launches, 0]
    print("HOST_COUNTS " + json.dumps(c), flush=True)
atexit.register(counts)
argv, shards = json.loads(sys.argv[1]), int(sys.argv[2])
if shards:
    from mm2tpu_torch.cli import main
    from mm2tpu_torch.parallel.mesh import make_mesh
    sys.exit(main(argv, mesh=make_mesh(shards, devices=["cuda:0"] * shards)))
sys.argv = ["mm2tpu_torch.cli", *argv]
runpy.run_module("mm2tpu_torch.cli", run_name="__main__", alter_sys=True)
"""


def free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_hosts(tmp, tag, n, argv, shards=0, envs=None, timeout_s=300):
    """n host processes of one `--hosts n` run of `argv`, with --profile:
    (processes, their stderr paths, their start time)."""
    coord = "127.0.0.1:%d" % free_port()
    procs, errs = [], []
    t0 = time.perf_counter()
    for h in range(n):
        full = [*argv, "--hosts", str(n), "--host-id", str(h),
                "--coordinator", coord, "--host-timeout", str(timeout_s),
                "--profile"]
        env = dict(os.environ, **(envs[h] if envs else {}))
        errs.append(os.path.join(tmp, "host_%s_%d.err" % (tag, h)))
        with open(errs[-1], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", HOST_CHILD, json.dumps(full),
                 str(shards)], cwd=str(REPO), env=env, stderr=err,
                stdout=subprocess.PIPE, text=True))
    return procs, errs, t0


def prof_lines(path):
    """(stage seconds, counters) from the [PROF] table of a host's
    stderr."""
    stages, counters = {}, {}
    with open(path) as fh:
        for ln in fh:
            f = ln.split()
            if not ln.startswith("[PROF] ") or f[1] in ("stage", "SUM"):
                continue
            if len(f) == 5:
                stages[f[1]] = int(f[3]) * float(f[4]) / 1e3
            elif len(f) == 3:
                counters[f[1]] = int(float(f[2]))
    return stages, counters


def finish_hosts(what, procs, errs, t0, timeout=600):
    """Wait for the hosts of one run; each must exit 0. Returns, a host,
    (wall s, {kernel: (launches, plain calls)}, stages, counters)."""
    walls = [None] * len(procs)
    outs = [None] * len(procs)
    deadline = time.monotonic() + timeout
    while None in walls:
        for h, p in enumerate(procs):
            if walls[h] is None and p.poll() is not None:
                walls[h] = time.perf_counter() - t0
                outs[h] = p.stdout.read()
        if time.monotonic() > deadline:
            for p in procs:
                p.kill()
            raise AssertionError("5h %s: hosts still running after %d s"
                                 % (what, timeout))
        time.sleep(0.05)
    res = []
    for h, p in enumerate(procs):
        if p.returncode != 0:
            with open(errs[h]) as fh:
                tail = fh.read()[-3000:]
            raise AssertionError("5h %s: host %d exited %d: %s"
                                 % (what, h, p.returncode, tail))
        line = [ln for ln in outs[h].splitlines()
                if ln.startswith("HOST_COUNTS ")][-1]
        counts = {k: tuple(v) for k, v in
                  json.loads(line.split(" ", 1)[1]).items()}
        res.append((walls[h], counts, *prof_lines(errs[h])))
    return res


def hosts_line(what, res):
    """Each host's wall, chain.gpu_busy and launches; host 0's merge."""
    parts = []
    for h, (wall, counts, stages, counters) in enumerate(res):
        parts.append("host %d: wall %.3f s, chain.gpu_busy %.3f s, %s" % (
            h, wall, stages.get("chain.gpu_busy", 0.0), ", ".join(
                "%s %d" % (k, c[0]) for k, c in sorted(counts.items())
                if c[0])))
    return "%s: %s; host 0's merge stage %.6f s" % (
        what, "; ".join(parts), res[0][2].get("merge", float("nan")))


def hosts_only(what, res, *on):
    """On every host exactly the kernels `on` launched, no plain version."""
    for h, (_, counts, _, _) in enumerate(res):
        for k, (launches, plain) in counts.items():
            if plain or (launches > 0) != (k in on):
                raise AssertionError("5h %s, host %d: launches/plain-version "
                                     "calls %s" % (what, h, counts))


def add_launches(total, res):
    for _, counts, _, _ in res:
        for k, (launches, _) in counts.items():
            total[k] = total.get(k, 0) + launches


def phase_hosts(tmp, ref, reads, lines):
    """Phase 5h: (i) two hosts on phase 5's reads, (ii) two hosts with -a
    through K3 on the first reads, (iii) two hosts each with a mesh of
    two shards of cuda:0 (and on four cards, --mesh 2 a host on cards of
    its own), (iv) a stopped host of three, (v) two hosts with
    --seed-backend gpu on the first reads. Returns each kernel's launches
    in the runs (i), (ii), (iii) and (v), summed over their hosts."""
    launches = {}
    names = [name for name, _ in read_fasta(reads)]
    sub = os.path.join(tmp, "hosts_sub.fa")
    write_reads(sub, read_fasta(reads)[:HOSTS_SUB_READS])
    stop_reads = os.path.join(tmp, "hosts_stop.fa")
    write_reads(stop_reads, read_fasta(reads)[:HOSTS_STOP_READS])
    # (iv) runs beside (i)-(iii): its survivors wait for its timeout
    stop_out = os.path.join(tmp, "hosts_stop.paf")
    stop = start_hosts(tmp, "iv", 3, ["-x", "map-ont", "--map-mode", "batch",
                                      "--device", DEVICE, "-o", stop_out,
                                      ref, stop_reads],
                       timeout_s=HOSTS_STOP_TIMEOUT)
    time.sleep(0.5)
    stop[0][2].send_signal(signal.SIGSTOP)
    t_stop = time.perf_counter()
    ended = {}

    def watch(h):
        ended[h] = (stop[0][h].wait(), time.perf_counter() - t_stop)

    watchers = [threading.Thread(target=watch, args=(h,), daemon=True)
                for h in range(2)]
    for t in watchers:
        t.start()

    # (i) phase 5's reads over two hosts, both on cuda:0
    paf = os.path.join(tmp, "hosts_i.paf")
    res = finish_hosts("(i)", *start_hosts(
        tmp, "i", 2, ["-x", "map-ont", "--map-mode", "batch", "--device",
                      DEVICE, "-o", paf, ref, reads]))
    hosts_only("(i)", res, "chain_v3")
    with open(paf) as fh:
        if fh.read().splitlines() != lines:
            raise AssertionError("5h (i): the merged PAF differs from "
                                 "phase 5's")
    if glob.glob(paf + ".host*.part"):
        raise AssertionError("5h (i): part files left behind")
    add_launches(launches, res)
    say("5h", "(i) -x map-ont --hosts 2, both on cuda:0, %d reads: merged "
        "PAF (%d lines) byte-identical to phase 5's, no part file left "
        "(phase 5: wall %.3f s, chain.gpu_busy %.3f s)" % (
            len(names), len(lines), PH5["wall"],
            PH5["stages"].get("chain.gpu_busy", (0.0,))[0]))
    say("5h", hosts_line("(i)", res))

    # (ii) SAM through K3 on the first reads, against one host
    sam = os.path.join(tmp, "hosts_ii.sam")
    one = os.path.join(tmp, "hosts_ii_one.sam")
    sam_args = ["-x", "map-ont", "--map-mode", "batch", "-a",
                "--align-backend", "gpu", "--align-tpu-min-mat", "1",
                "--device", DEVICE]
    started = start_hosts(tmp, "ii", 2, [*sam_args, "-o", sam, ref, sub])
    # the single host runs here while the two host processes start
    wall1, counts1, _, _ = drive([*sam_args, "-o", one, ref, sub])
    only("5h", "(ii) one host", counts1, "chain_v3", "ksw2_extd2")
    res = finish_hosts("(ii)", *started)
    hosts_only("(ii)", res, "chain_v3", "ksw2_extd2")
    with open(sam) as fh, open(one) as fo:
        got, want = strip_pg(fh.read()), strip_pg(fo.read())
    if got != want:
        raise AssertionError("5h (ii): the merged SAM differs from one "
                             "host's")
    add_launches(launches, res)
    say("5h", "(ii) -a --align-backend gpu --hosts 2 on the first %d reads: "
        "merged SAM (%d records) byte-identical to one host's without @PG "
        "(one host, in this process beside the hosts' start: wall %.3f s)"
        % (HOSTS_SUB_READS,
                                     len(sam_records(got)), wall1))
    say("5h", hosts_line("(ii)", res))

    # (iii) a mesh of two shards of cuda:0 in each host, and beside it (v)
    # device seeding in each host of another run, on the first reads
    paf = os.path.join(tmp, "hosts_iii.paf")
    started = start_hosts(tmp, "iii", 2, ["-x", "map-ont", "--map-mode",
                                          "batch", "--device", DEVICE, "-o",
                                          paf, ref, reads],
                          shards=2)
    paf_v = os.path.join(tmp, "hosts_v.paf")
    started_v = start_hosts(tmp, "v", 2, ["-x", "map-ont", "--map-mode",
                                          "batch", "--seed-backend", "gpu",
                                          "--device", DEVICE, "-o", paf_v,
                                          ref, sub])
    res = finish_hosts("(iii)", *started)
    hosts_only("(iii)", res, "chain_v3", "chain_packed8", "mesh_chain_step8")
    with open(paf) as fh:
        if fh.read().splitlines() != lines:
            raise AssertionError("5h (iii): the merged PAF differs from "
                                 "phase 5's")
    add_launches(launches, res)
    say("5h", "(iii) --hosts 2, each host's buckets over two shards of "
        "cuda:0 (beside (v)'s hosts): merged PAF byte-identical to phase "
        "5's")
    say("5h", hosts_line("(iii)", res))
    if torch.cuda.device_count() >= 4:
        paf = os.path.join(tmp, "hosts_iii4.paf")
        res = finish_hosts("(iii) four cards", *start_hosts(
            tmp, "iii4", 2, ["-x", "map-ont", "--map-mode", "batch", "--mesh",
                             "2", "--device", DEVICE, "-o", paf, ref, reads],
            envs=[{"CUDA_VISIBLE_DEVICES": "0,1"},
                  {"CUDA_VISIBLE_DEVICES": "2,3"}]))
        hosts_only("(iii) four cards", res, "chain_v3", "chain_packed8",
                   "mesh_chain_step8")
        with open(paf) as fh:
            if fh.read().splitlines() != lines:
                raise AssertionError("5h (iii): the merged PAF of --mesh 2 "
                                     "on cards 0,1 and 2,3 differs")
        say("5h", "(iii) --hosts 2 --mesh 2 on CUDA_VISIBLE_DEVICES 0,1 and "
            "2,3: merged PAF byte-identical to phase 5's")
        say("5h", hosts_line("(iii) four cards", res))
    else:
        say("5h", "(iii) torch.cuda.device_count() = %d: --mesh 2 a host on "
            "cards of its own (0,1 and 2,3) not run" %
            torch.cuda.device_count())

    res = finish_hosts("(v)", *started_v)
    hosts_only("(v)", res, "chain_v3", "seed_probe", "seed_build")
    first = set(names[:HOSTS_SUB_READS])
    with open(paf_v) as fh:
        if fh.read().splitlines() != [ln for ln in lines
                                      if ln.split("\t", 1)[0] in first]:
            raise AssertionError("5h (v): the merged device-seeded PAF "
                                 "differs from phase 5's lines of its reads")
    add_launches(launches, res)
    say("5h", "(v) --seed-backend gpu --hosts 2 on the first %d reads "
        "(beside (iii)'s hosts): merged PAF byte-identical to phase 5's "
        "lines of them" %
        HOSTS_SUB_READS)
    say("5h", hosts_line("(v)", res))

    # (iv) the stopped host
    procs, errs, _ = stop
    for t in watchers:
        t.join(HOSTS_STOP_TIMEOUT + 300)
    procs[2].kill()
    procs[2].wait(timeout=60)
    for p in procs:
        p.stdout.close()
    if len(ended) < 2:
        raise AssertionError("5h (iv): a survivor still runs %d s after "
                             "the stop" % (HOSTS_STOP_TIMEOUT + 300))
    rcs = [ended[h][0] for h in range(2)]
    if any(rc == 0 for rc in rcs) or os.path.exists(stop_out):
        raise AssertionError("5h (iv): survivors exited %s, merged output "
                             "%s" % (rcs, "left behind" if os.path.exists(
                                 stop_out) else "absent"))
    errors = []
    for e in errs[:2]:
        with open(e) as fh:
            errors += [ln.strip()[:160] for ln in fh
                       if ln.startswith("[ERROR]")]
    say("5h", "(iv) 3 hosts on %d reads, --host-timeout %d, host 2 stopped "
        "(SIGSTOP) 0.5 s after its spawn, beside (i)-(iii) and (v): both "
        "survivors exited non-zero (%s), %.3f and %.3f s after the stop, "
        "and no merged output exists: %s" % (
            HOSTS_STOP_READS, HOSTS_STOP_TIMEOUT, rcs, ended[0][1],
            ended[1][1], " | ".join(errors)))
    return launches


# phase 5p: the reads the API maps
API_READS = 100


def hit_fields(name, h):
    """The fields of a PAF -c row that an Alignment exposes."""
    return (name, h.q_st, h.q_en, "+" if h.strand > 0 else "-", h.ctg,
            h.ctg_len, h.r_st, h.r_en, h.mlen, h.blen, h.mapq,
            "P" if h.is_primary else "S", h.cigar_str, h.NM)


def paf_fields(ln):
    c = ln.split("\t")
    tags = {t[:2]: t[5:] for t in c[12:]}
    return (c[0], int(c[2]), int(c[3]), c[4], c[5], int(c[6]), int(c[7]),
            int(c[8]), int(c[9]), int(c[10]), int(c[11]), tags["tp"],
            tags["cg"], int(tags["NM"]))


def phase_api(tmp, ref, reads):
    """Phase 5p: `mm2tpu_torch.mappy.Aligner(ref, preset="map-ont")` on
    its default device (cuda) maps the first API_READS reads at the
    default routing and with every task on K1 (chain_backend "gpu"); every
    hit's fields equal the rows of a `--map-mode stream -c` CLI run of the
    same reads. Returns K1's launches in the second pass."""
    from mm2tpu_torch import mappy
    from mm2tpu_torch.ops import seed_device as sd
    from mm2tpu_torch.utils import profiling
    recs = read_fasta(reads)[:API_READS]
    sub = os.path.join(tmp, "api_reads.fa")
    write_reads(sub, recs)
    paf = os.path.join(tmp, "api_stream_c.paf")
    cli_wall, _, _, _ = drive(["-x", "map-ont", "--map-mode", "stream", "-c",
                               "--device", DEVICE, "-o", paf, ref, sub])
    with open(paf) as fh:
        want = [paf_fields(ln) for ln in fh.read().splitlines()]
    t0 = time.perf_counter()
    aligner = mappy.Aligner(ref, preset="map-ont")
    build = time.perf_counter() - t0
    if not aligner or aligner._device.type != "cuda":
        raise AssertionError("5p: Aligner(ref) holds no index or is not on "
                             "cuda (%s)" % aligner._device)
    k1 = None
    for what, backend in (("default routing", None),
                          ("chain_backend gpu", "gpu")):
        if backend:
            aligner.map_opt.chain_backend = backend
        mods = chain_counts()
        for m in mods.values():
            m.launches = m.reference_calls = 0
        sd.reset_counts()
        profiling.enable()
        t0 = time.perf_counter()
        got = [hit_fields(name, h) for name, seq in recs
               for h in aligner.map(seq)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: (m.launches, m.reference_calls) for k, m in mods.items()}
        counts.update({"seed_" + k: (sd.launches[k], sd.reference_calls[k])
                       for k in ("probe", "build")})
        counters = dict(profiling.counters)
        profiling.disable()
        if got != want:
            bad = sorted({g[0] for g in got} ^ {w[0] for w in want} |
                         {g[0] for g in got if g not in want})
            raise AssertionError("5p %s: the hits differ from the CLI's -c "
                                 "rows on reads %s" % (what, bad[:10]))
        if backend:
            only("5p", "(%s)" % what, counts, "chain_v3")
            k1 = counts["chain_v3"][0]
            if k1 != counters.get("chain.launches") or \
                    counters.get("route.host"):
                raise AssertionError("5p %s: K1 launches %d, counters %s"
                                     % (what, k1, counters))
        else:
            only("5p", "(%s)" % what, counts,
                 *(["chain_v3"] if counts["chain_v3"][0] else []))
        say("5p", "Aligner.map, %s, %d reads: %d hits, every field (coords, "
            "strand, mlen, blen, mapq, tp, cg, NM) equal to the CLI's "
            "--map-mode stream -c rows; route.gpu %d, route.host %d, K1 "
            "launches %d; %.3f s (the CLI run: %.3f s with its index "
            "build; the Aligner's index: %.3f s)" % (
                what, len(recs), len(got), counters.get("route.gpu", 0),
                counters.get("route.host", 0), counts["chain_v3"][0], wall,
                cli_wall, build))
    return k1


# ---- phase 5t: the torch.profiler trace, the default map mode, the entry
# points and paftools ----

# phase 5's first reads, mapped to SAM in batch mode untraced and traced;
# the first TRACE_STREAM_READS of them in stream mode, traced (one fill a
# K3 launch, ~60 a read, and ~2.8 MB of trace a read: fewer reads)
TRACE_READS, TRACE_STREAM_READS, TRACE_THREADS = 100, 15, 4
# the kernels of csrc/ by the names a trace gives their launches, and the
# name that stands for each kernel of the JSON line
TRACE_KERNELS = ("chain_kernel", "extd2_kernel", "exts2_kernel",
                 "seed_probe", "seed_count", "seed_offsets", "seed_expand",
                 "seed_sort_pass")
TRACE_NAMES = {"chain_v3": "chain_kernel", "ksw2_extd2": "extd2_kernel",
               "ksw2_exts2": "exts2_kernel", "seed_probe": "seed_probe",
               "seed_build": "seed_count"}


def trace_read(phase, what, d):
    """The one trace file in `d`: (kernel events by TRACE_KERNELS name,
    the stage ranges as (thread id, name), its bytes)."""
    import re
    from collections import Counter
    files = glob.glob(os.path.join(d, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError("%s %s: %d trace files in %s" % (
            phase, what, len(files), d))
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    pat = re.compile(r"\b(%s)\b" % "|".join(TRACE_KERNELS))
    kernels = Counter()
    for e in events:
        if e.get("cat") == "kernel":
            m = pat.search(e.get("name", ""))
            if m:
                kernels[m.group(1)] += 1
    ranges = [(e["tid"], e["name"]) for e in events
              if e.get("cat") == "user_annotation"]
    return kernels, ranges, os.path.getsize(files[0])


def trace_check(phase, what, d, counts, sort_passes, threaded):
    """The trace's device events of each kernel equal the launches its
    wrapper counted in the run (a K6 launch is seed_count, seed_offsets,
    seed_expand and its sort passes), and its stage ranges come from the
    main thread and the threads of `threaded` stages. Returns (kernel
    events, bytes)."""
    kernels, ranges, size = trace_read(phase, what, d)
    build = counts["seed_build"][0]
    want = {"chain_kernel": counts["chain_v3"][0] + counts["chain_v2"][0],
            "extd2_kernel": counts["ksw2_extd2"][0],
            "exts2_kernel": counts["ksw2_exts2"][0],
            "seed_probe": counts["seed_probe"][0], "seed_count": build,
            "seed_offsets": build, "seed_expand": build,
            "seed_sort_pass": sort_passes}
    got = {k: kernels.get(k, 0) for k in TRACE_KERNELS}
    if got != want:
        raise AssertionError("%s %s: the trace's kernel events %s, the "
                             "wrappers' launches %s" % (phase, what, got,
                                                        want))
    tids = {}
    for tid, name in ranges:
        tids.setdefault(tid, set()).add(name)
    main = [t for t, names in tids.items() if "emit" in names]
    others = set().union(*(n for t, n in tids.items() if t not in main))
    if len(main) != 1 or len(tids) < 2 or not threaded <= others:
        raise AssertionError("%s %s: stage ranges by thread %s" % (
            phase, what, {t: sorted(n) for t, n in tids.items()}))
    say(phase, "%s: the trace (%d bytes) holds a device event for each "
        "counted launch (%s) and stage ranges from %d threads (the "
        "others' stages: %s)" % (
            what, size, ", ".join("%s %d" % kv for kv in got.items()),
            len(tids), ", ".join(sorted(others))))
    return got, size


def traced_drive(tmp, tag, argv):
    """`drive(argv)` with --profile-trace into a new directory: (wall,
    counts, counters, K6's sort passes, the directory, the seconds of
    the trace's start and of its end)."""
    from mm2tpu_torch.ops import seed_device as sd
    d = os.path.join(tmp, "trace_" + tag)
    wall, counts, stages, counters = drive([*argv, "--profile-trace", d])
    return (wall, counts, counters, sd.sort_passes, d,
            stages["trace.start"][0], stages["trace.write"][0])


def phase_trace(tmp, ref, reads):
    """Phase 5t. Returns the trace's kernel events of (ii) by kernel."""
    from mm2tpu_torch import cli
    from mm2tpu_torch.tools import paftools
    recs = read_fasta(reads)[:TRACE_READS]
    sub, sub_s = (os.path.join(tmp, n) for n in ("trace_reads.fa",
                                                 "trace_stream_reads.fa"))
    write_reads(sub, recs)
    write_reads(sub_s, recs[:TRACE_STREAM_READS])
    # the index once, as an MMX file that each run maps in milliseconds
    mmx = os.path.join(tmp, "trace_index.mmx")
    t0 = time.perf_counter()
    if cli.main(["-x", "map-ont", "-d", mmx, "--device", DEVICE, ref]) != 0:
        raise AssertionError("5t: -d %s returned non-zero" % mmx)
    say("5t", "index of phase 5's genome written to an MMX file in %.3f s "
        "(%d bytes)" % (time.perf_counter() - t0, os.path.getsize(mmx)))
    sam_argv = ["-x", "map-ont", "--map-mode", "batch", "-a",
                "--align-backend", "gpu", "--align-tpu-min-mat", "1",
                "--seed-backend", "gpu", "--device", DEVICE]
    kernels = ("chain_v3", "ksw2_extd2", "seed_probe", "seed_build")
    outs = [os.path.join(tmp, "trace_%s.sam" % t) for t in ("i", "ii")]
    w1, c1, _, k1 = drive([*sam_argv, "-o", outs[0], mmx, sub])
    w2, c2, k2, passes, d2, start2, write2 = traced_drive(tmp, "ii", [
        *sam_argv, "-o", outs[1], mmx, sub])
    sams = []
    for tag, c, out in (("(i)", c1, outs[0]), ("(ii)", c2, outs[1])):
        only("5t", tag, c, *kernels)
        with open(out) as fh:
            sams.append(strip_pg(fh.read()))
    if sams[1] != sams[0]:
        raise AssertionError("5t (ii): the traced SAM differs from the "
                             "untraced one")
    fixed = ("chain_v3", "seed_probe", "seed_build")
    if any(c1[k] != c2[k] for k in fixed) or k1["ext.fills"] != \
            k2["ext.fills"]:
        raise AssertionError("5t (ii): launches %s and ext.fills %d traced, "
                             "%s and %d untraced" % (
                                 c2, k2["ext.fills"], c1, k1["ext.fills"]))
    events, size = trace_check("5t", "(ii) batch SAM, traced", d2, c2,
                               passes, {"post", "align"})
    n_rec = len(sam_records(sams[0]))
    say("5t", "(i), (ii) -a --align-backend gpu --seed-backend gpu, %d "
        "reads, %d SAM records: untraced %.3f s, traced %.3f s (+%.3f s; "
        "the trace's start %.3f s, the first in this process, and its "
        "end %.3f s); the SAMs byte-identical without @PG; K1, K5, K6 "
        "launches and ext.fills equal (K3's launches, the flushes, follow "
        "how the align threads meet: %d and %d); trace %d bytes" % (
            len(recs), n_rec, w1, w2, w2 - w1, start2, write2,
            c1["ksw2_extd2"][0], c2["ksw2_extd2"][0], size))
    # (iii) stream mode on a pool, every task on K1 and every fill one K3
    # launch
    out = os.path.join(tmp, "trace_iii.sam")
    w3, c3, _, passes3, d3, start3, write3 = traced_drive(tmp, "iii", [
        "-x", "map-ont", "--map-mode", "stream", "-t", str(TRACE_THREADS),
        "--chain-backend", "gpu", "-a", "--align-backend", "gpu",
        "--align-tpu-min-mat", "1", "--device", DEVICE, "-o", out, mmx,
        sub_s])
    only("5t", "(iii)", c3, "chain_v3", "ksw2_extd2")
    names = {name for name, _ in recs[:TRACE_STREAM_READS]}
    with open(out) as fh:
        got = strip_pg(fh.read())
    want = [r for r in sam_records(sams[0]) if r[0] in names]
    if sam_records(got) != want:
        raise AssertionError("5t (iii): the traced stream SAM differs from "
                             "(i)'s records of its reads")
    _, size3 = trace_check("5t", "(iii) stream SAM, -t %d, traced"
                           % TRACE_THREADS, d3, c3, passes3,
                           {"seed", "chain", "post"})
    say("5t", "(iii) --map-mode stream -t %d --chain-backend gpu, %d reads: "
        "SAM records equal to (i)'s, K1 %d and K3 %d launches; traced %.3f "
        "s (the trace's start %.3f s, its end %.3f s), trace %d bytes" % (
            TRACE_THREADS, TRACE_STREAM_READS, c3["chain_v3"][0],
            c3["ksw2_extd2"][0], w3, start3, write3, size3))
    # (iv) no --map-mode: the default, stream, as in the JAX package
    pafs = {k: os.path.join(tmp, "trace_iv_%s.paf" % k)
            for k in ("default", "native")}
    t0 = time.perf_counter()
    if cli.main(["-x", "map-ont", "--device", DEVICE, "-o",
                 pafs["default"], mmx, sub]) != 0:
        raise AssertionError("5t (iv): the run with no --map-mode failed")
    w4 = time.perf_counter() - t0
    w5, c5, _, _ = drive(["-x", "map-ont", "--map-mode", "stream",
                          "--chain-backend", "native", "--device", DEVICE,
                          "-o", pafs["native"], mmx, sub])
    only("5t", "(iv) native", c5)
    with open(pafs["default"]) as fa, open(pafs["native"]) as fb:
        lines = fa.read()
        if lines != fb.read():
            raise AssertionError("5t (iv): the PAF of no --map-mode differs "
                                 "from --map-mode stream --chain-backend "
                                 "native's")
    say("5t", "(iv) no --map-mode, %d reads: PAF (%d lines) byte-identical "
        "to --map-mode stream --chain-backend native's (%.3f s, %.3f s)" % (
            len(recs), len(lines.splitlines()), w4, w5))
    # (v) the entry points, as `python -m mm2tpu_torch.entry` runs them
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            runpy.run_module("mm2tpu_torch.entry", run_name="__main__")
            rc = None
        except SystemExit as e:
            rc = e.code
    out = buf.getvalue()
    if rc != 0 or "entry OK: [(32, 4096), (32, 4096)]" not in out or \
            "dryrun_multichip OK" not in out:
        raise AssertionError("5t (v): python -m mm2tpu_torch.entry: exit "
                             "%s\n%s" % (rc, out[-2000:]))
    for ln in out.splitlines():
        say("5t", "(v) python -m mm2tpu_torch.entry: " + ln)
    say("5t", "(v) python -m mm2tpu_torch.entry: %.3f s" % (
        time.perf_counter() - t0))
    # (vi) paftools on (i)'s SAM
    sam = os.path.join(tmp, "trace_i.sam")
    text = {}
    for cmd in ("stat", "sam2paf"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = paftools.main([cmd, sam])
        text[cmd] = buf.getvalue()
        if rc != 0 or not text[cmd]:
            raise AssertionError("5t (vi): paftools %s returned %d" % (cmd,
                                                                      rc))
    mapped = [r for r in sam_records(sams[0]) if not int(r[1]) & 4]
    stat = dict(ln.split(": ", 1) for ln in text["stat"].splitlines()
                if ": " in ln)
    n_paf = len(text["sam2paf"].splitlines())
    if int(stat["Number of mapped sequences"]) < MIN_MAPPED * len(recs) or \
            n_paf != len(mapped):
        raise AssertionError("5t (vi): paftools stat %s, sam2paf %d lines "
                             "for %d mapped records" % (stat, n_paf,
                                                        len(mapped)))
    say("5t", "(vi) paftools stat: %d mapped sequences, %s primary "
        "alignments; paftools sam2paf: %d PAF lines, one a mapped record" % (
            int(stat["Number of mapped sequences"]),
            stat.get("Number of primary alignments"), n_paf))
    return events


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


PHASES = ("1", "2", "3", "3b", "4", "5", "5s", "5r", "5m", "5h", "5p", "5t",
          "6", "7", "8", "9", "10")
# the deep parity runs (paths mapped again through the plain versions):
# run with --deep or when named in --phases
DEEP = ("7", "10")
# phases that take another phase's outputs
NEEDS = {"5s": ("5",), "5r": ("5",), "5m": ("5",), "5h": ("5",),
         "5p": ("5",), "5t": ("5",), "6": ("5",),
         "7": ("5", "6"),
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
    launches = ext_launches = sr = tx = seed = stream = mesh = None
    hosts = api = trace = None
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
        if "5m" in run:
            mesh_launches = phase_mesh_path(tmp, ref, reads, lines, ph5)
            mesh = phase_mesh_kernels(ref, reads, clock)
        if "5h" in run:
            hosts = phase_hosts(tmp, ref, reads, lines)
        if "5p" in run:
            api = {"chain_v3": phase_api(tmp, ref, reads)}
        if "5t" in run:
            trace = phase_trace(tmp, ref, reads)
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
    if mesh:
        (B8, N8), n_large, ms8, ms16 = mesh["shapes"]
        say(11, "K1a (decode8 + K1) and K7 (the mesh step over two shards "
            "of cuda:0) at the check bucket (%d, %d); at the largest "
            "bucket, N = %d: the 8 B wire %.3f ms, the 16 B wire %.3f ms "
            "(upload included)" % (B8, N8, n_large, ms8, ms16))
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
            ms, plain_ms, lib_ms, work, err, extra = seed[name]
            line = kernel_line(name, "mm2tpu_torch/csrc/seed.cu", replaces,
                               n, err, (ms, plain_ms), work, clock)
            # ms: the card's own time (CUDA graph replay); library_ms:
            # torch.searchsorted on K5's keys and queries, and for K6
            # torch.sort of the real-slot keys it sorts, timed alike
            line["library_ms"] = lib_ms
            line.update(extra)
            lines.append(line)
    if mesh:
        for (name, source, replaces), n in zip(
                (("chain_packed8", "mm2tpu_torch/ops/chain_packed.py",
                  "mm2tpu/ops/chain_packed.py:191"),
                 ("mesh_chain_step8", "mm2tpu_torch/parallel/mesh.py",
                  "mm2tpu/parallel/mesh.py:95")), mesh_launches):
            ms, plain_ms, work, err = mesh[name]
            # launches: in phase 5m (ii), the batch pipeline over two
            # shards of cuda:0 (K1a: a shard of a bucket on the 8 B wire;
            # K7: a shard of a bucket)
            lines.append(kernel_line(name, source, replaces, n, err,
                                     (ms, plain_ms), work, clock))
    for line in lines:
        # launches in phase 5h's host processes (summed over the hosts of
        # its runs (i)-(iii) and (v)) and in phase 5p's second pass
        line["hosts_launches"] = None if hosts is None else \
            hosts.get(line["name"], 0)
        line["api_launches"] = None if api is None else \
            api.get(line["name"], 0)
        # device events in phase 5t (ii)'s trace (K6: its seed_count
        # events, one a launch)
        line["trace_events"] = None if trace is None else trace.get(
            TRACE_NAMES.get(line["name"]), 0)
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
