#!/usr/bin/env python3
"""Time the chaining kernel (mm2tpu_torch/csrc/chain.cu: K1 and K2) built
for several block sizes (CHAIN_THREADS: each thread owns 1024 /
CHAIN_THREADS slots of a task's window) on one CUDA card, on the same
batches in turns, and hold every build's f and p against the default
build's (1024 threads).

Shapes: chip_smoke.py's timed K1 batch ((128, 65536), map-ont setting),
a mid-size map-ont bucket ((32, 8192)), its timed K2 batch ((64,
16384), cDNA, -x splice's setting) and a launch like the -x sr path's
((128, 1024): 100 read pairs of 500-900 anchors on two segments, then
28 empty rows; -x sr's setting). For each build: the launch's ms (CUDA
events, mean of 3 after a warm-up) and us a step (ms over the batch's
largest n), and the same for 3 launches each made after the card has
idled IDLE_S seconds, as the mapping paths' launches are (the card is
idle 90-99% of their wall). Run from the root of a checkout:

    python3 scripts/chain_threads.py [--threads 1024,512,256]

The last line is a JSON object with every time; the line before it the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from mm2tpu_torch.ops import _build, chain_v2, chain_v3  # noqa: E402

IDLE_S = 0.5


def sr_launch(seed=400):
    """A -x sr launch: 100 two-segment tasks of 500-900 anchors in a
    (128, 1024) bucket, then 28 empty rows."""
    from mm2tpu_torch.ops.chain_packed import (derive_qss, pack_tasks16,
                                               planes_to_torch)
    rng = np.random.default_rng(seed)
    tasks = [cs.two_segment(cs.synth_anchors(int(rng.integers(500, 901)),
                                             seed=seed + b), seed + b)
             for b in range(100)]
    tasks += [np.zeros((0, 2), np.uint64)] * 28
    hi, lo, yhi, ylo, n, avg = planes_to_torch(*pack_tasks16(tasks, 1024),
                                               "cuda")
    qi, span, sid = derive_qss(yhi, ylo)
    return (hi, lo, qi.contiguous(), span.contiguous(), sid.contiguous(), n,
            avg)


def batches():
    """(name, kernel call, largest n) of each timed shape."""
    B, N = cs.SHAPES[-1]
    k1 = cs.synth_batch(B, N, seed=100 + len(cs.SHAPES) - 1)
    yield ("K1_%dx%d_map-ont" % (B, N), functools.partial(
        chain_v3.chain_scores_v3, *k1, **cs.CONFIGS["map-ont"]),
        int(k1[4].max()))
    B, N = cs.SHAPES[1]
    mid = cs.synth_batch(B, N, seed=101)
    yield ("K1_%dx%d_map-ont" % (B, N), functools.partial(
        chain_v3.chain_scores_v3, *mid, **cs.CONFIGS["map-ont"]),
        int(mid[4].max()))
    B, N = cs.V2_SHAPES[-1]
    si, ci = len(cs.V2_SHAPES) - 1, cs.V2_CONTRACTS.index((True, 1))
    k2 = cs.synth_batch_v2(B, N, 300 + 10 * si + ci, 1)
    yield ("K2_%dx%d_cdna_splice" % (B, N), functools.partial(
        chain_v2.chain_scores_v2, *k2, **cs.V2_CONFIGS["splice"],
        is_cdna=True, n_segs=1), int(k2[5].max()))
    sr = sr_launch()
    yield ("K2_128x1024_sr_pairs", functools.partial(
        chain_v2.chain_scores_v2, *sr, **cs.V2_CONFIGS["sr"], is_cdna=False,
        n_segs=2), int(sr[5].max()))


def after_idle_ms(call, reps=3):
    """Mean CUDA-event time of `reps` calls, each made after the card has
    idled IDLE_S seconds."""
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        time.sleep(IDLE_S)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        call()
        t1.record()
        torch.cuda.synchronize()
        total += t0.elapsed_time(t1)
    return total / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", default="1024,512,256",
                    help="block sizes, multiples of 32 that divide 1024; "
                    "the first is the reference build (default "
                    "%(default)s)")
    threads = [int(x) for x in ap.parse_args(argv).threads.split(",")]
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script "
                           "times the kernel on a CUDA card only")
    results = {}
    with tempfile.TemporaryDirectory(prefix="chain_threads_") as d:
        libs = _build.build_variants("chain.cu", "CHAIN_THREADS", threads,
                                     Path(d), "chain_threads")
        load = _build.load
        try:
            for name, call, steps in batches():
                ref = None
                # in turns: every build, then every build again
                for rep in range(2):
                    for n, lib in libs.items():
                        _build.load = lambda lib=lib: lib
                        ms, out = cs.cuda_ms(call, 3)
                        idle_ms = after_idle_ms(call)
                        if ref is None:
                            ref = [t.clone() for t in out]
                        elif not all(torch.equal(a, b)
                                     for a, b in zip(out, ref)):
                            raise AssertionError(
                                "%s: %d threads differ from %d" % (
                                    name, n, threads[0]))
                        results.setdefault(name, {}).setdefault(
                            str(n), []).append(
                                {"ms": ms, "us_step": ms * 1e3 / steps,
                                 "after_idle_ms": idle_ms})
                        print("[chain_threads] %s (largest n %d): %d "
                              "threads %.3f ms, %.3f us a step; after "
                              "%g s idle %.3f ms, %.3f us a step" % (
                                  name, steps, n, ms, ms * 1e3 / steps,
                                  IDLE_S, idle_ms, idle_ms * 1e3 / steps),
                              flush=True)
        finally:
            _build.load = load
    print(cs.card_line(), flush=True)
    print(json.dumps({"chain_threads": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
