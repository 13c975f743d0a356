"""A dry run of the data-parallel mesh: one full mapping step over a mesh
of shards, the index-sharded probe against the replicated one, and the
production batch pipeline over the mesh against one device.

Counterpart of `__graft_entry__.py::dryrun_multichip`, with the same
three checks and the same seeded inputs:

1. `sharded_map_step`: K5 on the replicated index, K1 (8 tasks a shard)
   and K3 on tiny fills; every query hits (cnt 1);
2. `sharded_probe_step` over the same mesh, the index range-partitioned
   (`shard_index_arrays`): (start, cnt) equal to the replicated probe's;
3. `mapping.pipeline.map_frags_batched` over the mesh on a 60 kb genome
   and 10 reads of uneven length: its PAF byte-identical to the run on
   the mesh's first device alone, with at least 8 reads mapped.

Run it as

    python -m mm2tpu_torch.parallel.dryrun [--shards N] [--device cuda|cpu]
        [--devices cuda:0,cuda:0,...]

With `--device cuda` the mesh takes the cards cuda:0 .. N-1 and fails
when fewer are visible; it repeats a card only where `--devices` names
it so, as `(cuda:0, cuda:0)` does on a machine with one card. With
`--device cpu` it takes N CPU shards.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

# extension fills of the dry run: (query rows, target columns + 32)
RMAX, TPAD = 64, 128


def _example_batch(B, N, seed=0):
    """The chaining planes of `__graft_entry__._example_batch`: sorted
    random lo, qi near lo, one contig, span 15, full rows."""
    rng = np.random.default_rng(seed)
    lo = np.sort(rng.integers(0, 40 * N, (B, N)), axis=1).astype(np.int32)
    qi = np.clip(lo + rng.integers(-400, 400, (B, N)), 0,
                 None).astype(np.int32)
    hi = np.zeros((B, N), np.int32)
    span = np.full((B, N), 15, np.int32)
    sid = np.zeros((B, N), np.int32)
    n = np.full((B, 1), N, np.int32)
    avg = np.full((B, 1), 0.15, np.float32)
    return hi, lo, qi, span, sid, n, avg


def _mesh(n_shards: int, device: str, devices):
    from .mesh import make_mesh
    if devices is not None:
        return make_mesh(n_shards, devices=devices)
    if device == "cpu":
        return make_mesh(n_shards, devices=["cpu"] * n_shards)
    return make_mesh(n_shards)


def dryrun_multichip(n_shards: int, device: str = "cuda",
                     devices=None) -> str:
    """Run the three checks over a mesh of `n_shards` shards (see the
    module docstring); raises on a failure, returns the report line."""
    from ..index.build import build_index
    from ..io.format import write_paf
    from ..mapping.pipeline import map_frags_batched
    from ..options import mapopt_update, set_opt
    from .mesh import replicate_index, shard_index, shard_index_arrays, \
        sharded_map_step, sharded_probe_step, split_keys

    mesh = _mesh(n_shards, device, devices)
    ext_params = dict(q=4, e=2, q2=24, e2=1, zdrop=400, sc_mch=2,
                      sc_mis=-4, sc_N=-1, w=32, right=False, approx=True,
                      approx_drop=True, extz_only=False, end_bonus=0)
    step = sharded_map_step(mesh, max_dist_x=5000, max_dist_y=5000, bw=500,
                            iter_cap=1024, gap_scale=1.0, is_cdna=False,
                            n_segs=1, ext_params=ext_params)
    # 8 tasks a shard, as the JAX dry run gives each shard
    B, N = n_shards * 8, 1024
    planes = _example_batch(B, N, seed=1)
    erng = np.random.default_rng(4)
    elens = np.stack([np.full(B, RMAX, np.int32),
                      np.full(B, TPAD - 32, np.int32)], axis=1)
    etsf = erng.integers(0, 4, (B, TPAD)).astype(np.uint8)
    eqcol = erng.integers(0, 4, (B, RMAX)).astype(np.uint8)
    # a small replicated index, and each row's query minimizers
    keys = np.unique(np.random.default_rng(2).integers(
        0, 2**40, 4096).astype(np.uint64))
    kstart = np.arange(len(keys), dtype=np.int32)
    kcnt = np.ones(len(keys), dtype=np.int32)
    q = split_keys(keys[np.random.default_rng(3).integers(
        0, len(keys), (B, 64))])
    hs, hc, f, p, ez, ops, i_fin, j_fin = step(
        replicate_index(mesh, split_keys(keys), kstart, kcnt), q, *planes,
        elens, etsf, eqcol).result()
    if f.shape != (B, N) or p.shape != (B, N) or hc.shape != (B, 64) or \
            ez.shape[0] != B or ops.shape[0] != B:
        raise AssertionError("sharded map step: output shapes f %s, p %s, "
                             "cnt %s, ez %s, ops %s" % (
                                 tuple(f.shape), tuple(p.shape),
                                 tuple(hc.shape), tuple(ez.shape),
                                 tuple(ops.shape)))
    if not bool((hc == 1).all()):
        raise AssertionError("replicated index probe failed")

    # the index-sharded probe over the same mesh
    ks, sts, cs, _ = shard_index_arrays(keys, kstart, kcnt, n_shards)
    ss, cs = sharded_probe_step(mesh)(shard_index(mesh, ks, sts, cs),
                                      q).result()
    if not bool((cs == 1).all()):
        raise AssertionError("sharded index probe failed")
    if not torch.equal(ss, hs):
        raise AssertionError("sharded probe disagrees with the replicated "
                             "probe")

    # the production batch pipeline over the mesh, against one device
    grng = np.random.default_rng(7)
    genome = "".join(np.array(list("ACGT"))[grng.integers(0, 4, 60000)])
    mi = build_index(["c0"], [genome], w=10, k=15)
    _, mo = set_opt("map-ont")
    mapopt_update(mo, mi)
    frags, names = [], []
    for i in range(10):
        L = int(grng.integers(300, 3000))           # uneven shard loads
        st = int(grng.integers(0, len(genome) - L))
        s = list(genome[st:st + L])
        for _ in range(L // 20):
            s[int(grng.integers(0, L))] = "ACGT"[grng.integers(0, 4)]
        frags.append(["".join(s)])
        names.append("r%d" % i)
    res_mesh = map_frags_batched(mi, frags, mo, names, mesh[0], mesh=mesh)
    res_one = map_frags_batched(mi, frags, mo, names, mesh[0])

    def paf(res):
        lines = []
        for name, fr, frag in zip(names, res, frags):
            regs = fr.regs[0]
            if not regs:
                lines.append(write_paf(mi, name, len(frag[0]), None,
                                       mo.flag, fr.rep_len))
            for r in regs:
                lines.append(write_paf(mi, name, len(frag[0]), r, mo.flag,
                                       fr.rep_len, qseq=frag[0]))
        return "\n".join(lines)

    paf_mesh, paf_one = paf(res_mesh), paf(res_one)
    if paf_mesh != paf_one:
        raise AssertionError("mesh and single-device PAF differ")
    n_mapped = sum(1 for fr in res_mesh if fr.regs[0])
    if n_mapped < 8:
        raise AssertionError("only %d of 10 reads mapped" % n_mapped)
    return ("dryrun_multichip OK: mesh of %d shards on %s; sharded map "
            "step: f/p %s, index hits %s, K3 ez/ops %s/%s; sharded probe "
            "== replicated; batch pipeline: %d/10 uneven reads mapped, mesh "
            "PAF byte-identical to one device's (%d bytes)" % (
                len(mesh), ",".join(str(d) for d in mesh), tuple(f.shape),
                tuple(hc.shape), tuple(ez.shape), tuple(ops.shape),
                n_mapped, len(paf_mesh)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--devices", help="comma-separated devices of the "
                    "mesh, in order (a device may repeat)")
    args = ap.parse_args(argv)
    devices = args.devices.split(",") if args.devices else None
    print(dryrun_multichip(args.shards, args.device, devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
