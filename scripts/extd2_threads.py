#!/usr/bin/env python3
"""Time the extd2 kernel K3 (mm2tpu_torch/csrc/ksw2_extd2.cu) built for
several block sizes (EXTD2_THREADS: a control warp and the rest compute
warps) on one CUDA card, on the same fills in turns, and hold every
build's output against the default build's (1024 threads).

Shapes: chip_smoke.py's timed shape (B = 64, fills of 2000-5000 bases)
under map-ont's bands w = 500 and 751, and a flush like the map-ont SAM
path's (B = 16, fills of 200-800 bases, w = 751), flag 0. For each
build: the launch's ms (CUDA events, mean of 3 after a warm-up) and the
kernel's own DP us a row and trace ns a step from its %globaltimer
stamps. Run from the root of a checkout:

    python3 scripts/extd2_threads.py [--threads 1024,512,256]

The last line is a JSON object with every time; the line before it the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from mm2tpu_torch.ops import _build  # noqa: E402
from mm2tpu_torch.ops import ksw2_extd2 as X  # noqa: E402

# (name, B, shortest, longest target, w, seed): the first two are
# chip_smoke.py's timed fills
SHAPES = [("B64_2000-5000_w500", 64, 2000, 5000, 500, 202),
          ("B64_2000-5000_w751", 64, 2000, 5000, 751, 202),
          ("B16_200-800_w751", 16, 200, 800, 751, 7)]


def stamp_numbers(lens, out, stamps):
    """(DP us a row over the fills that ran every row, trace ns a step)."""
    ez, ops = (t.cpu().numpy() for t in out[:2])
    rows = lens.astype(np.int64).sum(1) - 1
    full = ez[:, 0] == 0
    dp = (stamps[:, 1] - stamps[:, 0])[full].sum() / 1e3 / rows[full].sum()
    steps = max(int((ops != 255).sum()), 1)
    return dp, (stamps[:, 2] - stamps[:, 1]).sum() / steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", default="1024,512,256",
                    help="block sizes, multiples of 32 from 64 up; the "
                    "first is the reference build (default %(default)s)")
    threads = [int(x) for x in ap.parse_args(argv).threads.split(",")]
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script "
                           "times the kernel on a CUDA card only")
    mat = cs.ext_matrix()
    results = {}
    with tempfile.TemporaryDirectory(prefix="extd2_threads_") as d:
        libs = _build.build_variants("ksw2_extd2.cu", "EXTD2_THREADS", threads,
                                     Path(d), "extd2_threads")
        load = _build.load
        try:
            for name, B, lo, hi, w, seed in SHAPES:
                tasks = cs.synth_fills(B, lo, hi, seed=seed)
                pk = X.pack_fills(tasks, mat, **cs.EXT_GAPS)
                planes = [torch.from_numpy(a).to("cuda")
                          for a in (pk.lens, pk.tsf, pk.qcol)]
                kw = dict(**cs.EXT_GAPS, zdrop=cs.EXT_ZDROP,
                          sc_mch=pk.sc_mch, sc_mis=pk.sc_mis, sc_N=pk.sc_N,
                          w=w, right=False, approx=False, approx_drop=False,
                          extz_only=False, end_bonus=-1, lens_h=pk.lens)
                ref = None
                # in turns: every build, then every build again
                for rep in range(2):
                    for n, lib in libs.items():
                        _build.load = lambda lib=lib: lib
                        ms, out = cs.cuda_ms(functools.partial(
                            X.extd2_traced, *planes, **kw), 3)
                        stamps = X.launch_stamps().cpu().numpy()
                        if ref is None:
                            ref = [t.clone() for t in out]
                        elif not all(torch.equal(a, b)
                                     for a, b in zip(out, ref)):
                            raise AssertionError(
                                "%s: %d threads differ from %d" % (
                                    name, n, threads[0]))
                        dp, tr = stamp_numbers(pk.lens, out, stamps)
                        results.setdefault(name, {}).setdefault(
                            str(n), []).append(
                                {"ms": ms, "dp_us_row": dp,
                                 "trace_ns_step": tr})
                        print("[extd2_threads] %s (%d rows at most): %d "
                              "threads %.3f ms, DP %.3f us a row, trace "
                              "%.1f ns a step" % (
                                  name, int(pk.lens.sum(1).max()) - 1, n,
                                  ms, dp, tr), flush=True)
        finally:
            _build.load = load
    print(cs.card_line(), flush=True)
    print(json.dumps({"extd2_threads": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
