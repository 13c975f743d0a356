"""mm2tpu_torch — the PyTorch/CUDA port of mm2tpu for one NVIDIA H100.

The JAX package `mm2tpu` stays the reference; this package sits beside
it, mirrors its layout, and imports nothing of it. The framework-free
host code it needs (options, IO, index, seeding, hits, alignment,
`est_err`, the native C++ runtime's binding, PAF/SAM writers, profiler,
logger) is the port's own copy, at the same relative path, each naming
its original. It imports `torch` and never `jax`.

Slices covered, in batch mode with the chaining DP on the device:
`-x map-ont` (and the other single-segment presets) on kernel K1,
`-x sr` read pairs and `-x splice` spliced reads on kernel K2, and with
`-a`/`-c --align-backend gpu` the extension fills on kernel K3 (splice
fills stay on the host).

Layer map (counterpart in `mm2tpu` in brackets):
  cli.py               entry point, always batch mode   [cli.py]
  mapping/pipeline.py  bucketed batch chaining and the  [mapping/pipeline.py]
                       per-fragment stages
  ops/chain_packed.py  16 B/anchor wire planes, p_rel,  [ops/chain_packed.py]
                       dispatch by contract
  ops/chain_v3.py      K1 wrapper + plain version       [ops/chain_pallas_v3]
  ops/chain_v2.py      K2 wrapper + plain version       [ops/chain_pallas_v2]
  mapping/extbatch.py  cross-read extension batcher     [mapping/extbatch.py]
  ops/ksw2_extd2.py    extd2 packing, wrapper + plain   [ops/ksw2_pallas.py,
                       version, CIGARs                   extd2 half]
  ops/_build.py        nvcc build + ctypes binding of csrc/
  csrc/chain.cu        the Hopper chaining kernel: K1   [_chain_kernel_v3,
                       and K2 specialisations            _chain_kernel_v2]
  csrc/ksw2_extd2.cu   the Hopper extension kernel with [_extd2_kernel,
                       its traceback                     trace_device]
  device.py            explicit cpu/cuda device choice
  options.py, index/, io/, mapping/{hit,seed,sdust,esterr,seg,pe,align,
  chain}.py, ops/{chain_ref,ksw2_ref,ksw2_splice_ref}.py, utils/,
  native/              the copied host path             [same paths]

A wrapper runs its plain PyTorch version only for tensors on the CPU; on
a CUDA tensor it launches its kernel or raises.
"""

__version__ = "0.1.0"
