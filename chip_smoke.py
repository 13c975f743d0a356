#!/usr/bin/env python3
"""Drive the PyTorch port's map-ont batch paths once on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):
  0. the card's name and power limit; no CUDA device -> error
  1. `make -B -C native` (a stale native library corrupts chains
     silently) and the nvcc build of mm2tpu_torch/csrc/*.cu, one nvcc
     per source, with each kernel's ptxas register and spill report
  2. the chaining kernel against its plain PyTorch version on the card,
     on seeded synthetic batches from (8, 1024) up to the main path's
     largest bucket (128, 65536), f and p equal, with both timed
  3. the extd2 kernel (extension DP, backtrack start and trace) against
     its plain version on the card: seeded fills of 300-1000 and
     2000-5000 bases (10% substitutions, 5% indels), B = 8 and 64,
     map-ont scoring, w = 500 (and w = -1 at the small size), five flag
     sets; every ez register, op code and CIGAR equal, both timed at the
     largest shape
  4. the PAF path: `mm2tpu_torch.cli.main -x map-ont --device cuda` on a
     seeded 48 Mb genome with 1000 ONT-like reads; >= 95% of the reads
     must map, and only the chaining kernel may have chained
  5. the SAM path: the same reads with `-a --align-backend gpu
     --align-tpu-min-mat 1`, every extension fill on the extd2 kernel,
     then with `--align-backend host` (the native extension): the SAMs
     must be byte-identical without @PG, and only the kernels may have
     run
  6. the first 200 reads of at most 8 kb mapped again through the PAF
     path with the plain chaining on CUDA tensors, and the first 50 of
     them through the SAM path with the plain extd2 on CUDA tensors:
     their PAF and SAM lines must be byte-identical to the kernels'
  7. a JSON line per kernel, the card's name and power limit, then
     {"ok": true, "device": {...}} last

Everything runs through `mm2tpu_torch`; the script imports nothing of
JAX and nothing of the JAX package. The plain versions' agreement with
the NumPy oracles and with the Pallas kernels is held in the CPU tests
(tests/test_torch_chain_v3.py, tests/test_torch_ksw2_extd2.py).
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
DEVICE = "cuda"
WORKLOAD = dict(genome_mb=48, n_reads=1000, seed=0)
MIN_MAPPED = 0.95
PARITY_READS, PARITY_MAX_LEN = 200, 8000
SAM_READS = 1000          # reads of the SAM path (all of the workload)
EXT_PARITY_READS = 50     # of the parity reads, through the plain extd2
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
# extd2 kernel-vs-plain fills: (B, shortest, longest target, bands). The
# last shape is the one the kernel line of the JSON reports.
EXT_SHAPES = [(8, 300, 1000, (500, -1)), (64, 300, 1000, (500, -1)),
              (64, 2000, 5000, (500,))]
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
                                               DEVICE)
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
            if "entry function" in ln or "registers" in ln or "spill" in ln:
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


def phase_ext_kernel_vs_plain():
    """Returns (kernel ms, plain ms) at the last of EXT_SHAPES (flag 0,
    w = 500) and the max abs error over every ez register, op code and
    final (i, j) compared."""
    from mm2tpu_torch.ops import ksw2_extd2 as X
    mat = ext_matrix()
    max_err, timed = 0, None
    for si, (B, lo, hi, bands) in enumerate(EXT_SHAPES):
        tasks = synth_fills(B, lo, hi, seed=200 + si)
        for w in bands:
            for name, flag in EXT_FLAGS.items():
                end_bonus = 10 if flag & KSW_EZ_EXTZ_ONLY else -1
                raw = {}

                def keep(tag, fn):
                    def run(*a, **kw):
                        raw[tag] = fn(*a, **kw)
                        return raw[tag]
                    return run

                args = (tasks, mat, *EXT_GAPS.values(), w, EXT_ZDROP,
                        end_bonus, flag)
                kern = X.extd2_batch(*args, device=DEVICE,
                                     fn=keep("kernel", X.extd2_traced))
                plain = X.extd2_batch(
                    *args, device=DEVICE,
                    fn=keep("plain", X.extd2_traced_reference))
                err = max(int((a.to(torch.int64) - b.to(torch.int64))
                              .abs().max())
                          for a, b in zip(raw["kernel"], raw["plain"]))
                max_err = max(max_err, err)
                same = all(torch.equal(a, b)
                           for a, b in zip(raw["kernel"], raw["plain"]))
                bad = [(i, f) for i, (k, p) in enumerate(zip(kern, plain))
                       for f in EZ_FIELDS if getattr(k, f) != getattr(p, f)]
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
            kw = dict(**EXT_GAPS, zdrop=EXT_ZDROP, sc_mch=pk.sc_mch,
                      sc_mis=pk.sc_mis, sc_N=pk.sc_N, w=bands[0],
                      right=False, approx=False, approx_drop=False,
                      extz_only=False, end_bonus=-1)
            ms, _ = cuda_ms(functools.partial(X.extd2_traced, *planes, **kw),
                            3)
            plain_ms, _ = cuda_ms(functools.partial(
                X.extd2_traced_reference, *planes, **kw), 1, warmup=False)
            timed = (ms, plain_ms)
            say(3, "time at B=%d, %d-%d bp, w=%d, flag 0 (%d rows at most): "
                "kernel %.3f ms, plain %.3f ms" % (
                    B, lo, hi, bands[0], int(pk.lens.sum(1).max()) - 1, ms,
                    plain_ms))
    return timed, max_err


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
    say(4, "workload generated in %.3f s: %s, %s"
        % (time.perf_counter() - t0, os.path.basename(ref),
           os.path.basename(reads)))
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
    say(4, "mapped %d of %d reads (%d PAF lines) in %.3f s wall: %.3f "
        "reads/s; kernel launches %d, plain-version calls %d"
        % (len(mapped), n_reads, len(lines), wall, n_reads / wall,
           launches, ref_calls))
    say(4, "stage seconds: " + ", ".join(
        "%s %.3f" % (k, v[0]) for k, v in sorted(stages.items())))
    say(4, "counters: " + ", ".join(
        "%s %d" % (k, v) for k, v in sorted(counters.items())))
    busy = stages["chain.gpu_busy"][0]
    mapping_wall = wall - stages["index"][0]
    say(4, "card busy %.3f s (chain.gpu_busy) of %.3f s wall: idle share "
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


def write_reads(path, recs):
    with open(path, "w") as fh:
        fh.writelines(">%s\n%s\n" % r for r in recs)


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
    say(5, "%d reads (n = %d): SAM through the extd2 kernel (%d records, "
        "%d reads mapped) is byte-identical to SAM through the host "
        "extension, without @PG" % (len(recs), len(recs), len(body),
                                    len(mapped)))
    say(5, "wall: kernels %.3f s (%.3f reads/s), host extension %.3f s "
        "(%.3f reads/s)" % (wall, len(recs) / wall, host_wall,
                            len(recs) / host_wall))
    say(5, "launches: chain_v3 %d, ksw2_extd2 %d; plain-version calls: "
        "chain %d, extd2 %d" % (counts["chain_launches"],
                                counts["ext_launches"],
                                counts["chain_plain"], counts["ext_plain"]))
    say(5, "stage seconds: " + ", ".join(
        "%s %.3f" % (k, v[0]) for k, v in sorted(stages.items())))
    say(5, "counters: " + ", ".join(
        "%s %d" % (k, v) for k, v in sorted(counters.items())))
    busy = stages["chain.gpu_busy"][0] + stages["ext.gpu_busy"][0]
    say(5, "card busy %.3f s (chain.gpu_busy %.3f + ext.gpu_busy %.3f) of "
        "%.3f s wall: idle share %.3f" % (
            busy, stages["chain.gpu_busy"][0], stages["ext.gpu_busy"][0],
            wall, 1 - busy / wall))
    return got, counts["ext_launches"]


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
    rc = cli.main(["-x", "map-ont", "--device", DEVICE, "-o", paf, ref, sub],
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
    say(6, "%d reads <= %d bp: plain-version PAF (%d bytes, %.3f s) is "
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
    say(6, "%d reads: plain-extd2 SAM (%d records, %d flushes, %.3f s) is "
        "byte-identical to the kernel's" % (
            len(recs), len(got), X.reference_calls - calls,
            time.perf_counter() - t0))


def main() -> int:
    say(0, card_line())
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script "
                           "runs the port on a CUDA card only")
    say(0, "torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                      torch.cuda.get_device_name(0)))
    phase_build()
    times, max_err = phase_kernel_vs_plain()
    ext_times, ext_err = phase_ext_kernel_vs_plain()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ref, reads, lines, launches = phase_main_path(tmp)
        sam, ext_launches = phase_sam(tmp, ref, reads)
        recs = phase_parity(tmp, ref, reads, lines)
        phase_ext_parity(tmp, ref, recs, sam)
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
    }, {
        "name": "ksw2_extd2",
        "route": "cuda",
        "source": "mm2tpu_torch/csrc/ksw2_extd2.cu",
        "replaces": "mm2tpu/ops/ksw2_pallas.py:86",
        "launches": ext_launches,
        "max_abs_err": ext_err,
        "ms": ext_times[0],
        "plain_ms": ext_times[1],
    }]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
