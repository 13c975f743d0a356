"""One run of one cell: set-up, the window, the judgement, the result.

`run_cell` is the whole run after the look for a card, which `run.py`
makes; the CPU tests call it with `device="cpu"` at small sizes (the
program then runs its kernels' plain versions).

Set-up, in order: the configuration's genome and the program's index,
from the checkout's cache or built into it (the index as the program's
own MMX file, as users keep a prebuilt index, `-d`); the run's reads
from `--seed`; the mapping options from the configuration's and the
traffic's command-line flags, through the program's own parser; the
pool's first batch mapped once as the warm-up, not counted, which loads
the index onto the card and builds every kernel (a traced run starts
`torch.profiler` before it).

The window drives `mm2tpu_torch.cli.map_batch`, one mini-batch after
another from the pool of two distinct batches, in a closed loop, each batch's
records formatted by `mm2tpu_torch.cli.emit` into a file under TMPDIR.
It starts a batch while fewer than `--seconds` have passed since it
opened, and closes when the last batch it started has ended, its
records written: the rate counts every batch the window starts, over
all of the window's time (`window_rate`).
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from . import check
from .gen import genome as ggen
from .gen import reads as greads
from .tracefile import Trace

CACHE = "gpubench_cache"


# ---- the specification, by name -------------------------------------


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(root: str, workload: str):
    """(cell, config, traffic, metrics of the cell) for a cell of
    BENCHMARK.json, each file found by its name; the metrics are the
    end-to-end and the per-layer ones that name the cell, or name no
    cells."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError("no workload %r in BENCHMARK.json" % workload)
    cell = cells[workload]
    here = os.path.join(root, "gpubench")
    with open(os.path.join(here, "configs", cell["config"] + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(here, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    metrics = {k: [m for m in spec[k]
                   if workload in m.get("workloads", [workload])]
               for k in ("end_to_end", "per_layer")}
    return cell, cfg, traffic, metrics


def metric_reader(root: str, name: str):
    """The `read(run)` of `gpubench/metrics/<name>.py`."""
    import importlib.util
    path = os.path.join(root, "gpubench", "metrics", name + ".py")
    sp = importlib.util.spec_from_file_location("gpubench_metric_" +
                                                name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


# ---- the window -----------------------------------------------------


def closed_loop(batch, seconds: float, min_batches: int = 1,
                clock=time.perf_counter):
    """Run `batch(k)` (which returns the bases it mapped) for k = 0, 1,
    ... while fewer than `seconds` have passed since the loop opened, and
    at least `min_batches` times: (t0, [(start, end, bases), ...])."""
    timeline = []
    t0 = clock()
    k = 0
    while k < min_batches or clock() - t0 < seconds:
        s0 = clock()
        b = batch(k)
        timeline.append((s0, clock(), b))
        k += 1
    return t0, timeline


def window_rate(t0: float, timeline, seconds: float):
    """(Mb/s, window seconds, seconds past `seconds`) of a closed-loop
    window opened at t0: `timeline` holds (start, end, bases) of each
    batch it ran, in order. Every batch counts, the window closing when
    the last one ended."""
    if not timeline:
        raise ValueError("the window ran no batch")
    t1 = timeline[-1][1]
    bases = sum(b for _, _, b in timeline)
    return bases / (t1 - t0) / 1e6, t1 - t0, (t1 - t0) - seconds


class _Ranges:
    """The harness's own ranges in a traced run (no-ops otherwise), and
    the garbage collector's pauses, which gc.callbacks open and close as
    `gc` ranges on the thread that collects."""

    def __init__(self, on: bool):
        self.on = on
        self.gc_s = 0.0
        self.gc_n = 0
        self._tls = threading.local()

    def __call__(self, name: str):
        if not self.on:
            return _null
        import torch
        return torch.profiler.record_function(name)

    def gc_callback(self, phase, info):
        if phase == "start":
            self._tls.t = time.perf_counter()
            if self.on:
                import torch
                rf = torch.autograd.profiler.record_function("gc")
                rf.__enter__()
                self._tls.rf = rf
        else:
            t = getattr(self._tls, "t", None)
            if t is not None:
                self.gc_s += time.perf_counter() - t
                self.gc_n += 1
                self._tls.t = None
            rf = getattr(self._tls, "rf", None)
            if rf is not None:
                rf.__exit__(None, None, None)
                self._tls.rf = None


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_null = _Null()


def _cache_root(root: str) -> str:
    d = os.path.join(root, CACHE)
    os.makedirs(d, exist_ok=True)
    return d


def _index(root: str, genome, gcfg: dict, io, n_threads: int):
    """The program's index of the genome: its MMX file in the cache,
    built and saved there the first time."""
    from mm2tpu_torch.index.build import build_index, load_index, save_index
    d = os.path.join(_cache_root(root), ggen.genome_key(gcfg))
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "index_k%d_w%d_f%d.mmx" % (io.k, io.w, io.flag))
    if not os.path.exists(path):
        seqs = [genome.contig(i).tobytes().decode()
                for i in range(len(genome.lens))]
        mi = build_index(genome.names, seqs, w=io.w, k=io.k, flag=io.flag,
                         bucket_bits=io.bucket_bits, n_threads=n_threads)
        del seqs
        save_index(mi, path + ".part")
        _fsync(path + ".part")
        os.replace(path + ".part", path)
    return load_index(path)


def _fsync(path: str) -> None:
    """Write a new cache file through to the disk in set-up, not in a
    window."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _options(flags: List[str], cfg: dict):
    """(IdxOptions, MapOptions) of the command line, as the CLI's `_main`
    makes them; the reference's numbers in the configuration must be the
    deployment's."""
    from mm2tpu_torch import cli
    from mm2tpu_torch.index.build import MM_I_NO_SEQ
    from mm2tpu_torch.options import (MM_F_ALL_CHAINS, MM_F_HARD_MLEVEL,
                                      MM_F_NO_LJOIN, MM_F_SPLICE, MM_F_SR,
                                      check_opt, set_opt)
    args = cli.build_torch_parser().parse_args(flags)
    io, mo = set_opt(None)
    io, mo = set_opt(args.preset, io, mo)
    cli.apply_args(args, io, mo)
    io.flag &= ~MM_I_NO_SEQ
    check_opt(io, mo)
    r = cfg["reference"]
    have = dict(k=io.k, w=io.w, bw=mo.bw, max_gap=mo.max_gap,
                max_gap_ref=mo.max_gap_ref, max_chain_iter=mo.max_chain_iter,
                min_cnt=mo.min_cnt, min_chain_score=mo.min_chain_score,
                mid_occ_frac=mo.mid_occ_frac, min_mid_occ=mo.min_mid_occ,
                splice=bool(mo.flag & MM_F_SPLICE), a=mo.a, seed=mo.seed,
                mask_level=mo.mask_level, mask_len=mo.mask_len,
                pri_ratio=mo.pri_ratio, best_n=mo.best_n, max_occ=mo.max_occ,
                max_join_long=mo.max_join_long,
                max_join_short=mo.max_join_short,
                min_join_flank_sc=mo.min_join_flank_sc,
                min_join_flank_ratio=mo.min_join_flank_ratio)
    diff = {k: (v, r[k]) for k, v in have.items() if r[k] != v}
    if mo.flag & (MM_F_ALL_CHAINS | MM_F_HARD_MLEVEL | MM_F_NO_LJOIN |
                  MM_F_SR):
        diff["flag"] = mo.flag   # post-chain modes the reference has not
    if diff:
        raise ValueError("the flags give other options than the "
                         "configuration states: %s" % diff)
    return io, mo


def card_facts() -> dict:
    """The card's name, clocks and power limit (nvidia-smi), and the CPUs
    this process may run on."""
    facts = {"cpus": sorted(os.sched_getaffinity(0))}
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        name, pl, sm, smax = [s.strip() for s in
                              q.stdout.splitlines()[0].split(",")]
        facts.update(smi_name=name, power_limit_w=float(pl),
                     sm_clock_mhz=float(sm), sm_clock_max_mhz=float(smax))
    except (OSError, subprocess.SubprocessError, ValueError, IndexError) as e:
        facts["nvidia_smi"] = "unread: %s" % e
    return facts


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: Optional[float] = None,
             control: bool = False, faults: Optional[dict] = None,
             log=print) -> dict:
    """One run of `workload`; returns the result line's object. `log`
    takes the earlier lines of standard output."""
    import torch
    from mm2tpu_torch import cli
    from mm2tpu_torch.options import MM_F_OUT_SAM, mapopt_update
    from mm2tpu_torch.utils import profiling

    t_start = time.perf_counter() if t_start is None else t_start
    cell, cfg, traffic, metrics = cell_spec(root, workload)
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    n_threads = max(1, len(os.sched_getaffinity(0)))

    # ---- set-up ----
    phases = {"start": time.perf_counter() - t_start}
    mark = _phase_marker(phases)
    genome, built = ggen.load_genome(cfg["genome"], _cache_root(root))
    mark("genome")
    flags = list(cfg["cli"]) + list(traffic["cli"]) + ["--device", device]
    io, mo = _options(flags, cfg)
    mi = _index(root, genome, cfg["genome"], io, n_threads)
    mapopt_update(mo, mi)
    mark("index")
    pool = greads.make_pool(seed, genome, traffic)
    frags = [[[_seq(n, s)] for n, s in zip(*b)] for b in pool]
    mark("reads")
    bases = [int(sum(len(s) for s in b[1])) for b in pool]
    fmt = "sam" if (mo.flag & MM_F_OUT_SAM) else "paf"
    rng = np.random.default_rng([abs(int(seed)), int(seed < 0), 23])
    sample_k = int(rng.integers(0, 2))
    n_b = len(pool[0][0])
    sample_idx = sorted(set(rng.choice(n_b, min(traffic["check_reads"], n_b),
                                       replace=False).tolist()) |
                        {int(np.argmax([len(s) for s in
                                        pool[sample_k % len(pool)][1]]))})

    tmp = tempfile.mkdtemp(prefix="gpubench_", dir=os.environ.get("TMPDIR"))
    obs = check.Observer(faults)
    ranges = _Ranges(trace)
    out_path = os.path.join(tmp, "out." + fmt)
    out = open(out_path, "w", buffering=1 << 20)
    try:
        if fmt == "sam":
            out.write(cli.sam_header(mi, None, cli.MM_VERSION,
                                     "minimap2 " + " ".join(flags)) + "\n")
        trace_dir = os.path.join(tmp, "trace")
        if trace:
            profiling.enable(trace_dir)
        mb = cli.map_batch

        def consume(frag, res):
            if faults:
                _alter_records(faults, res)
            with profiling.stage("emit"):
                cli.emit(mi, mo, frag, res, out)

        def one(batch, capture):
            obs.capture = capture
            kw = {}
            if capture or obs.count:
                kw = dict(chain_fn=obs.chain_fn, seed_fn=obs.seed_fn)
            mb(mi, mo, batch, consume, dev, **kw)
            obs.capture = False
            with ranges("bench.flush"):
                out.flush()

        if faults and faults.get("drop_half"):
            mb = _drop_half(mb)
        gc.freeze()
        gc.callbacks.append(ranges.gc_callback)
        with profiling.trace_if_enabled(dev), obs.on_batcher():
            with ranges("bench.warmup"):
                obs.count = False
                one(frags[0], capture=True)       # warms the capture's
                obs.rows, obs.fills = [], []      # pinned buffers too
                if dev.type == "cuda":
                    torch.cuda.synchronize()
            mark("warmup")
            profiling.reset()
            obs.count = trace
            setup_s = time.perf_counter() - t_start
            text_span = []

            def batch(k):
                pos0 = out.tell()
                one(frags[k % len(pool)], capture=(k == sample_k))
                if k == sample_k:
                    text_span[:] = [pos0, out.tell()]
                return bases[k % len(pool)]

            with ranges("bench.window"):
                cpu0, steal0, thr0 = os.times(), _steal(), _threads_cpu()
                t0, timeline = closed_loop(batch, seconds, sample_k + 1)
            cpu1, steal1, thr1 = os.times(), _steal(), _threads_cpu()
            rate, window_s, past = window_rate(t0, timeline, seconds)
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        stages = profiling.snapshot()
        counters = dict(profiling.counters)
        log(json.dumps({"window": {
            "batches": len(timeline), "seconds_past": past,
            "window_s": window_s, "batch_s": [round(e - s, 4)
                                              for s, e, _ in timeline],
            "sample_batch": sample_k, "gc_pauses": ranges.gc_n,
            "gc_s": ranges.gc_s,
            "cpu_s": (cpu1.user + cpu1.system) - (cpu0.user + cpu0.system),
            "host_steal_s": steal1 - steal0,
            "threads_cpu_s": sorted(
                ([n, round(v - thr0.get(n, 0.0), 2)] for n, v in thr1.items()
                 if v - thr0.get(n, 0.0) > 0.05), key=lambda t: -t[1])},
            "setup": dict(phases, genome_built=built)}))
        out.close()
        with open(out_path) as f:
            f.seek(text_span[0])
            text = f.read(text_span[1] - text_span[0])

        # ---- the judgement, the program's state freed ----
        mi.__dict__.pop("_torch_dev_idx", None)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        sb = sample_k % len(pool)
        compared, extra = check.judge(obs, text, fmt, pool[sb], sample_idx,
                                      genome, dict(cfg, **traffic), dev,
                                      rng, control=control)
        extra["reference_s"] = time.perf_counter() - t_ref
        log(json.dumps({"checked": extra}))
        n_reads = sum(len(frags[k % len(pool)])
                      for k in range(len(timeline)))
        result = {"correct": all(v <= check.LIMITS[k]
                                 for k, v in compared.items()),
                  "attempted": n_reads, "failed": 0}
        facts = card_facts() if dev.type == "cuda" else {}
        log(json.dumps({"machine": facts}))
        device_obj = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)}
        if not trace:
            e2e = {"query_Mb_per_s": rate, "peak_device_GiB": peak / 2 ** 30,
                   "setup_s": setup_s}
            result["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                             "unit": m["unit"]}
                                 for m in metrics["end_to_end"]}
        else:
            tr = Trace.load(trace_dir)
            for w in obs.work.values():
                w.settle()
            run = _Run(cell, stages, counters, tr, obs.work,
                       sum(b for _, _, b in timeline) / 1e6, facts, dev)
            vals = {}
            for m in metrics["per_layer"]:
                v = metric_reader(root, m["name"])(run)
                if v is not None:
                    vals[m["name"]] = {"value": v, "unit": m["unit"]}
            result["metrics"] = vals
            device_obj.update(busy_s=tr.busy_s(), window_s=tr.window_s)
            result["breakdown"] = {"device_ops": tr.device_ops(),
                                   "idle_gaps": tr.idle_gaps()}
        result["device"] = device_obj
        result["compared"] = {k: {"value": v, "limit": check.LIMITS[k]}
                              for k, v in compared.items()}
        return result
    finally:
        if ranges.gc_callback in gc.callbacks:
            gc.callbacks.remove(ranges.gc_callback)
        if trace:
            profiling.disable()
            profiling.end_trace()
        if not out.closed:
            out.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _threads_cpu() -> Dict[str, float]:
    """CPU seconds of each of this process's threads so far
    (/proc/self/task), under `name:tid`."""
    out: Dict[str, float] = {}
    tck = os.sysconf("SC_CLK_TCK")
    for tid in os.listdir("/proc/self/task"):
        try:
            with open("/proc/self/task/%s/stat" % tid) as f:
                st = f.read()
        except OSError:
            continue
        name = "%s:%s" % (st[st.index("(") + 1:st.rindex(")")], tid)
        cols = st[st.rindex(")") + 2:].split()
        out[name] = (int(cols[11]) + int(cols[12])) / tck
    return out


def _steal() -> float:
    """Seconds the hypervisor took from this machine's CPUs so far
    (/proc/stat), or 0 where it cannot be read."""
    try:
        with open("/proc/stat") as f:
            cols = f.readline().split()
        return int(cols[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


def _phase_marker(phases: dict):
    """mark(name): the seconds since the last mark, under `name`."""
    last = [time.perf_counter()]

    def mark(name):
        t = time.perf_counter()
        phases[name] = t - last[0]
        last[0] = t
    return mark


def _seq(name: str, s: np.ndarray):
    from mm2tpu_torch.io.bseq import Seq
    return Seq(name=name, seq=s.tobytes().decode())


def _alter_records(faults: dict, res) -> None:
    """Faults for the tests, in a read's regions just before they are
    written: every target start and end one base on (`shift_ts`), or
    every strand turned over (`flip_strand`)."""
    for regs in res.regs:
        for r in regs:
            if faults.get("shift_ts"):
                r.rs, r.re = r.rs + 1, r.re + 1
            if faults.get("flip_strand"):
                r.rev = not r.rev


def _drop_half(map_batch):
    """A fault for the tests: every batch maps and emits only its first
    half."""
    def mb(mi, mo, batch, consume, dev, **kw):
        return map_batch(mi, mo, batch[:len(batch) // 2], consume, dev, **kw)
    return mb


class _Run:
    """What a per-layer metric reads: the window's `--profile` stages
    (`stages[name] = (seconds, calls)`) and counters, the trace, the
    kernels' counted work (`work["k1"].ops` ...), the query megabases
    (`query_Mb`), the card's int32 peak (`ops_peak`)."""

    def __init__(self, cell, stages, counters, tr, work, query_Mb, facts,
                 dev):
        import torch
        from .counts import int32_peak
        self.cell = cell["name"]
        self.stages = stages
        self.counters = counters
        self.trace = tr
        self.work = work
        self.query_Mb = query_Mb
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count \
            if dev.type == "cuda" else 0
        self.ops_peak = int32_peak(n_sm, facts.get("sm_clock_max_mhz", 0.0))

    def stage_s(self, name: str) -> float:
        return self.stages.get(name, (0.0, 0))[0]
