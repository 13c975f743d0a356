#!/usr/bin/env python3
"""Drive the PyTorch port's map-ont batch path once on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):
  0. the card's name and power limit; no CUDA device -> error
  1. `make -B -C native` (a stale native library corrupts chains
     silently) and the nvcc build of mm2tpu_torch/csrc/*.cu
  2. the chaining kernel against its plain PyTorch version on the card,
     on seeded synthetic batches from (8, 1024) up to the main path's
     largest bucket (128, 65536), f and p equal, with both timed
  3. the main path: `mm2tpu_torch.cli.main -x map-ont --device cuda` on a
     seeded 48 Mb genome with 1000 ONT-like reads; >= 95% of the reads
     must map, and only the kernel may have chained
  4. the first 200 reads of at most 8 kb mapped again through the same
     CLI with the plain chaining on CUDA tensors: their PAF lines must be
     byte-identical
  5. a JSON line per kernel, then {"ok": true, "device": {...}} last

Everything runs through `mm2tpu_torch`; the script imports nothing of
JAX and nothing of the JAX package. The plain version's agreement with
the NumPy window oracle and with the Pallas kernel is held in the CPU
tests (tests/test_torch_chain_v3.py).
"""
from __future__ import annotations

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
WORKLOAD = dict(genome_mb=48, n_reads=1000, seed=0)
MIN_MAPPED = 0.95
PARITY_READS, PARITY_MAX_LEN = 200, 8000
# (B, N) of the kernel-vs-plain batches: the main path's buckets run
# from N = 1024 to 65536 with B up to 128. The last shape is the one the
# kernel line of the JSON reports.
SHAPES = [(8, 1024), (32, 8192), (64, 16384), (128, 65536)]
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


def say(phase, msg):
    print("[chip_smoke] phase %s: %s" % (phase, msg), flush=True)


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
                                               "cuda")
    qi, span, _ = derive_qss(yhi, ylo)
    return hi, lo, qi.contiguous(), span.contiguous(), n, avg


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


def phase_build():
    t0 = time.perf_counter()
    r = subprocess.run(["make", "-B", "-C", str(REPO / "native")],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError("make -B -C native failed:\n" + r.stderr)
    native_s = time.perf_counter() - t0
    from mm2tpu_torch.utils import native
    if not native.available():
        raise RuntimeError("native library did not load after the build")
    from mm2tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load()
    kernel_s = time.perf_counter() - t0
    say(1, "native runtime built in %.3f s; CUDA kernels built and loaded "
        "in %.3f s" % (native_s, kernel_s))
    if _build.build_log:
        for ln in _build.build_log.strip().splitlines():
            if "registers" in ln or "spill" in ln:
                say(1, "ptxas: " + ln.strip())


def phase_kernel_vs_plain():
    """Returns ({(B, N): (kernel ms, plain ms)}, max abs error). Each
    shape runs every setting of CONFIGS; the map-ont setting is timed:
    the kernel over 5 calls after a warm-up, the plain version over the
    one call that is compared."""
    from mm2tpu_torch.ops import chain_v3
    times, max_err = {}, 0
    for si, (B, N) in enumerate(SHAPES):
        planes = synth_batch(B, N, seed=100 + si)
        for name, cfg in CONFIGS.items():
            kernel = functools.partial(chain_v3.chain_scores_v3, *planes,
                                       **cfg)
            plain = functools.partial(chain_v3.chain_scores_v3_reference,
                                      *planes, **cfg)
            if name == "map-ont":
                ms, (f, p) = cuda_ms(kernel, 5)
                plain_ms, (f2, p2) = cuda_ms(plain, 1, warmup=False)
                times[(B, N)] = (ms, plain_ms)
            else:
                f, p = kernel()
                f2, p2 = plain()
            err = max(int((f - f2).abs().max()), int((p - p2).abs().max()))
            max_err = max(max_err, err)
            if not (torch.equal(f, f2) and torch.equal(p, p2)):
                raise AssertionError("kernel != plain at (%d, %d) %s: max "
                                     "abs err %d" % (B, N, name, err))
            say(2, "kernel == plain at (B, N) = (%d, %d), %s; max f %d"
                % (B, N, name, int(f.max())))
        say(2, "time at (%d, %d), map-ont: kernel %.3f ms, plain %.3f ms"
            % (B, N, *times[(B, N)]))
    return times, max_err


def load_make_workload():
    spec = importlib.util.spec_from_file_location(
        "make_workload", REPO / "scripts" / "make_workload.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_main_path(tmp):
    from mm2tpu_torch import cli
    from mm2tpu_torch.ops import chain_v3
    from mm2tpu_torch.utils import profiling
    t0 = time.perf_counter()
    ref, reads = load_make_workload().make(tmp, **WORKLOAD)
    say(3, "workload generated in %.3f s: %s, %s"
        % (time.perf_counter() - t0, os.path.basename(ref),
           os.path.basename(reads)))
    paf = os.path.join(tmp, "out.paf")
    chain_v3.launches = 0
    chain_v3.reference_calls = 0
    t0 = time.perf_counter()
    rc = cli.main(["-x", "map-ont", "--device", "cuda", "--profile",
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
    say(3, "mapped %d of %d reads (%d PAF lines) in %.3f s wall: %.3f "
        "reads/s; kernel launches %d, plain-version calls %d"
        % (len(mapped), n_reads, len(lines), wall, n_reads / wall,
           launches, ref_calls))
    say(3, "stage seconds: " + ", ".join(
        "%s %.3f" % (k, v[0]) for k, v in sorted(stages.items())))
    say(3, "counters: " + ", ".join(
        "%s %d" % (k, v) for k, v in sorted(counters.items())))
    busy = stages["chain.gpu_busy"][0]
    mapping_wall = wall - stages["index"][0]
    say(3, "card busy %.3f s (chain.gpu_busy) of %.3f s wall: idle share "
        "%.3f; of the %.3f s after the index build: idle share %.3f"
        % (busy, wall, 1 - busy / wall, mapping_wall,
           1 - busy / mapping_wall))
    return ref, reads, lines, launches


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


def phase_parity(tmp, ref, reads, lines):
    from mm2tpu_torch import cli
    from mm2tpu_torch.ops import chain_v3
    recs = [r for r in read_fasta(reads)
            if len(r[1]) <= PARITY_MAX_LEN][:PARITY_READS]
    names = {name for name, _ in recs}
    sub = os.path.join(tmp, "parity.fa")
    with open(sub, "w") as fh:
        fh.writelines(">%s\n%s\n" % r for r in recs)
    paf = os.path.join(tmp, "parity.paf")
    t0 = time.perf_counter()
    calls, launches = chain_v3.reference_calls, chain_v3.launches
    rc = cli.main(["-x", "map-ont", "--device", "cuda", "-o", paf, ref, sub],
                  chain_fn=chain_v3.chain_scores_v3_reference)
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
    say(4, "%d reads <= %d bp: plain-version PAF (%d bytes, %.3f s) is "
        "byte-identical to the kernel's" % (
            len(recs), PARITY_MAX_LEN, len(got), time.perf_counter() - t0))


def main() -> int:
    say(0, card_line())
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script "
                           "runs the port on a CUDA card only")
    say(0, "torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                      torch.cuda.get_device_name(0)))
    phase_build()
    times, max_err = phase_kernel_vs_plain()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ref, reads, lines, launches = phase_main_path(tmp)
        phase_parity(tmp, ref, reads, lines)
    ms, plain_ms = times[SHAPES[-1]]
    print(json.dumps({"kernels": [{
        "name": "chain_v3",
        "route": "cuda",
        "source": "mm2tpu_torch/csrc/chain_v3.cu",
        "replaces": "mm2tpu/ops/chain_pallas_v3.py:48",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
