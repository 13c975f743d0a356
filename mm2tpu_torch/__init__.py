"""mm2tpu_torch — the PyTorch/CUDA port of mm2tpu for one NVIDIA H100.

The JAX package `mm2tpu` stays the reference; this package sits beside
it, mirrors its layout, and imports nothing of it. The framework-free
host code it needs (options, IO, index, seeding, hits, alignment,
`est_err`, the native C++ runtime's binding, PAF/SAM writers, profiler,
logger) is the port's own copy, at the same relative path, each naming
its original. It imports `torch` and never `jax`.

The port does everything the JAX package does. The CLI maps in stream
mode by default, as the JAX package's does (each read on its own, each
chaining task placed on the host DP or on the card by the cost model),
or in batch mode (a size bucket of reads a chaining launch); on the
card: chaining on K1 (single-segment presets) and K2 (`-x sr` read
pairs, `-x splice` spliced reads), with `-a`/`-c --align-backend gpu`
the extension fills on K3 and the splice fills on K4, with
`--seed-backend gpu` (batch) the index probe K5 and the anchor build K6,
with `--mesh N` the buckets split over a mesh (K7, the 8 B wire K1a);
`--hosts N` host processes; `--profile-trace` a torch.profiler trace.

Layer map (counterpart in `mm2tpu` in brackets):
  cli.py               entry point: stream or batch     [cli.py]
                       mode, --mesh, --hosts
  entry.py             the flagship step and the dry    [__graft_entry__.py]
                       run
  mapping/pipeline.py  bucketed batch chaining, the     [mapping/pipeline.py]
                       device seeding round, stream
                       mode's map_frag, the per-fragment
                       stages
  mapping/chain.py,    stream mode's per-task routing   [mapping/chain.py,
  mapping/costmodel.py and its H100 cost model           mapping/costmodel.py]
  ops/chain_packed.py  16 B and 8 B wire planes, p_rel, [ops/chain_packed.py]
                       dispatch by contract, B = 1 tasks
  ops/chain_v3.py      K1 wrapper + plain version       [ops/chain_pallas_v3]
  ops/chain_v2.py      K2 wrapper + plain version       [ops/chain_pallas_v2]
  mapping/extbatch.py  cross-read extension batcher     [mapping/extbatch.py]
  ops/ksw2_extd2.py    extd2 packing, wrapper + plain   [ops/ksw2_pallas.py,
                       version, CIGARs                   extd2 half]
  ops/ksw2_exts2.py    exts2 (splice) likewise          [ops/ksw2_pallas.py,
                                                         exts2 half]
  ops/seed_device.py   K5 and K6 wrappers + plain       [ops/seed_device.py]
                       versions
  ops/_build.py        nvcc build + ctypes binding of csrc/
  csrc/chain.cu        the Hopper chaining kernel: K1   [_chain_kernel_v3,
                       and K2 specialisations            _chain_kernel_v2]
  csrc/ksw2_extd2.cu   the Hopper extension kernel with [_extd2_kernel,
                       its traceback                     trace_device]
  csrc/ksw2_exts2.cu   the Hopper splice kernel with    [_exts2_kernel]
                       its traceback
  csrc/seed.cu         the index probe and the anchor   [seed_chain_device]
                       build and sort
  device.py            explicit cpu/cuda device choice
  parallel/mesh.py     --mesh: the mesh steps (K7)      [parallel/mesh.py]
  parallel/dryrun.py   the mesh's dry run               [__graft_entry__.py]
  parallel/multihost.py  --hosts: a TCPStore rendezvous, [parallel/multihost.py]
                       barriers, the ordered merge
  mappy.py             the mappy-compatible Python API  [mappy.py]
                       (Aligner(..., device="cuda"))
  utils/profiling.py   --profile's stages and counters, [utils/profiling.py]
                       --profile-trace's torch.profiler
                       trace
  tools/               paftools, verbatim copies        [tools/]
  options.py, index/, io/, mapping/{hit,seed,sdust,esterr,seg,pe,align}.py,
  ops/{chain_ref,ksw2_ref,ksw2_splice_ref}.py, utils/, native/
                       the copied host path             [same paths]

A wrapper runs its plain PyTorch version only for tensors on the CPU; on
a CUDA tensor it launches its kernel or raises.
"""

__version__ = "0.1.0"
