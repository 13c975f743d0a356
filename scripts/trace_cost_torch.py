"""What a `--profile-trace` costs on one CUDA card.

On chip_smoke.py's seeded 48 Mb genome (its index written once to an MMX
file) and the first 100 of its map-ont reads, runs `mm2tpu_torch.cli` in
turns untraced and traced: batch SAM with every fill on K3 and device
seeding (the first run warms the process up), the same traced with
`trace_only` (where this torch has it) and with the main thread's ranges
only, batch PAF, and stream SAM with every task on K1 on the first 30
reads. Prints each run's wall, the threads' `align` seconds and, for a
traced run, the trace's bytes, its `trace.write` seconds and its events
by category. Run from the repository root on a machine with a card:

    python3 scripts/trace_cost_torch.py
"""
import collections
import glob
import importlib.util
import json
import os
import sys
import tempfile
import time

import torch
import torch._C._profiler as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORIG = P._ExperimentalConfig
# the profiler's configs: the port's (every thread), trace_only on top of
# it, and the main thread's ranges only
VARIANTS = {
    "default": ORIG,
    "trace_only": lambda **kw: ORIG(trace_only=True, **kw),
    "main_thread": lambda **kw: ORIG(),
}


def run(cli, profiling, tmp, tag, argv, trace):
    d = os.path.join(tmp, "tr_" + tag)
    t0 = time.perf_counter()
    rc = cli.main(argv + (["--profile-trace", d] if trace else ["--profile"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = profiling.snapshot()
    profiling.disable()
    if rc != 0:
        raise RuntimeError("%s: mm2tpu_torch.cli.main returned %d" % (tag, rc))
    info = ""
    if trace:
        f = glob.glob(d + "/*.pt.trace.json")[0]
        with open(f) as fh:
            ev = json.load(fh)["traceEvents"]
        cats = collections.Counter(e.get("cat") for e in ev)
        info = "size %d, start %.3f s, write %.3f s, cats %s" % (
            os.path.getsize(f), st["trace.start"][0], st["trace.write"][0],
            dict(cats))
    print("[cost] %-28s wall %.3f s; align(threads) %.1f s; %s" % (
        tag, wall, st.get("align", (0,))[0], info), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script "
                           "times the port on a CUDA card only")
    sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from mm2tpu_torch import cli
    from mm2tpu_torch.utils import profiling
    print(cs.card_line(), flush=True)
    print(ORIG.__init__.__doc__.splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ref, reads = cs.workload(tmp, "cost")
        recs = cs.read_fasta(reads)[:100]
        sub, sub30 = (os.path.join(tmp, n) for n in ("sub.fa", "sub30.fa"))
        cs.write_reads(sub, recs)
        cs.write_reads(sub30, recs[:30])
        mmx = os.path.join(tmp, "i.mmx")
        if cli.main(["-x", "map-ont", "-d", mmx, ref]) != 0:
            raise RuntimeError("-d %s failed" % mmx)
        sam = ["-x", "map-ont", "--map-mode", "batch", "-a",
               "--align-backend", "gpu", "--align-tpu-min-mat", "1",
               "--seed-backend", "gpu", "-o", os.path.join(tmp, "o.sam"),
               mmx, sub]
        paf = ["-x", "map-ont", "--map-mode", "batch", "-o",
               os.path.join(tmp, "o.paf"), mmx, sub]
        stream = ["-x", "map-ont", "--map-mode", "stream", "-t", "4",
                  "--chain-backend", "gpu", "-a", "--align-backend", "gpu",
                  "--align-tpu-min-mat", "1", "-o",
                  os.path.join(tmp, "s.sam"), mmx, sub30]
        for k, (tag, argv, trace, var) in enumerate([
                ("warm", sam, False, "default"),
                ("sam untraced", sam, False, "default"),
                ("sam traced", sam, True, "default"),
                ("sam traced trace_only", sam, True, "trace_only"),
                ("sam traced main thread", sam, True, "main_thread"),
                ("sam untraced", sam, False, "default"),
                ("sam traced", sam, True, "default"),
                ("paf untraced", paf, False, "default"),
                ("paf traced", paf, True, "default"),
                ("stream untraced", stream, False, "default"),
                ("stream traced", stream, True, "default")]):
            P._ExperimentalConfig = VARIANTS[var]
            try:
                run(cli, profiling, tmp, "%d_%s" % (k, tag.replace(" ", "_")),
                    argv, trace)
            except TypeError as e:   # a config this torch does not take
                print("[cost] %s: %s" % (tag, str(e).splitlines()[0]),
                      flush=True)
            finally:
                P._ExperimentalConfig = ORIG
    return 0


if __name__ == "__main__":
    sys.exit(main())
