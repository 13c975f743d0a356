"""The port's entry points: the flagship step and the multi-card dry run.

Counterpart of `__graft_entry__.py`:

- `entry(device="cuda")` returns `(fn, example_args)`. `fn` is the
  chaining kernel K1 through `ops/chain_v3.py`, the production uniseg
  batch path of `mapping/pipeline.py`, at the JAX entry's settings
  (map-ont geometry: max_dist_x = max_dist_y = 5000, bw = 500, iter_cap
  = 1024, gap_scale = 1.0); the arguments are the seeded planes of
  `parallel/dryrun.py::_example_batch` at a production bucket shape,
  (B, N) = (32, 4096), as torch tensors on `device`. `fn` takes the
  planes (hi, lo, qi, span, sid, n, avg) in that order and returns (f,
  p); sid, a single-segment row's zeros, is not read. "cuda" without a
  card raises (`device.py`): nothing falls back to the CPU.
- `python -m mm2tpu_torch.entry` runs `fn` on the card, prints its
  output shapes, then runs `parallel.dryrun.dryrun_multichip` over NDEV
  shards (the environment's NDEV, as `__graft_entry__.py` reads it; by
  default the number of cards). Where fewer cards are visible than
  NDEV, the shards all lie on cuda:0.
"""
from __future__ import annotations

import os
import sys

import torch

from .device import resolve_device

B, N = 32, 4096
SETTINGS = dict(max_dist_x=5000, max_dist_y=5000, bw=500, iter_cap=1024,
                gap_scale=1.0)


def entry(device="cuda"):
    """(fn, example_args): K1 at the flagship bucket shape (module
    docstring)."""
    from .ops.chain_v3 import chain_scores_v3
    from .parallel.dryrun import _example_batch

    dev = resolve_device(device)

    def fn(hi, lo, qi, span, sid, n, avg):
        return chain_scores_v3(hi, lo, qi, span, n, avg, **SETTINGS)

    example_args = tuple(torch.from_numpy(a).to(dev)
                         for a in _example_batch(B, N))
    return fn, example_args


def main() -> int:
    from .parallel.dryrun import dryrun_multichip

    fn, args = entry("cuda")
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry OK: %s" % [tuple(o.shape) for o in out], flush=True)
    n_cards = torch.cuda.device_count()
    ndev = int(os.environ.get("NDEV", n_cards))
    devices = None if ndev <= n_cards else ["cuda:0"] * ndev
    print(dryrun_multichip(ndev, "cuda", devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
