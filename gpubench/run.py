"""Run one cell of BENCHMARK.json once, on one CUDA card:

    python3 gpubench/run.py --workload splice.paf --seed 7 --seconds 30 \
        --trace 0

from the root of a checkout. The last line of standard output is the
result's JSON object; the numbers that decided `correct`, each with its
limit, are the last lines of standard error and the result's last key.
`--trace 1` reports the cell's per-layer metrics from a torch.profiler
trace instead of its end-to-end metrics. `--control 1` runs the
comparison's control in the program's place (it must come out not
correct). Exits non-zero, printing no result, without a CUDA card, or
when the process has loaded JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT     # the package's modules are not top-level ones
else:
    sys.path.insert(0, ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "mm2tpu")


def _caches():
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        d = os.path.join(ROOT, "gpubench_cache", sub)
        os.makedirs(d, exist_ok=True)
        os.environ[var] = d
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    _caches()
    import torch
    from gpubench import harness
    cell = harness.cell_spec(ROOT, a.workload)[0]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print("[gpubench] needs %d CUDA card(s); torch.cuda.is_available() "
              "= %s, device_count() = %d"
              % (cell["chips"], torch.cuda.is_available(),
                 torch.cuda.device_count() if torch.cuda.is_available()
                 else 0), file=sys.stderr)
        return 3
    try:
        res = harness.run_cell(ROOT, a.workload, a.seed, a.seconds,
                               bool(a.trace), "cuda", t_start=T_START,
                               control=bool(a.control))
    except Exception:  # noqa: BLE001 - the run fails, with its traceback
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print("[gpubench] the process loaded %s" % ", ".join(bad),
              file=sys.stderr)
        return 4
    for k, v in res["compared"].items():
        print("compared %s %s limit %s" % (k, v["value"], v["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
