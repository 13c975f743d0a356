"""mm2tpu_torch — the PyTorch/CUDA port of mm2tpu for one NVIDIA H100.

The JAX package `mm2tpu` stays the reference; this package sits beside
it, mirrors its layout, and imports its framework-free host code (IO,
index, options, seeding, hits, `est_err`, the native C++ runtime, PAF/SAM
writers) instead of rewriting it. It imports `torch` and never `jax`.

Slices covered: `-x map-ont` in batch mode with the chaining DP on the
device, and with `-a`/`-c --align-backend gpu` the extension fills too.

Layer map (counterpart in `mm2tpu` in brackets):
  cli.py               entry point, always batch mode   [cli.py]
  mapping/pipeline.py  bucketed batch chaining          [mapping/pipeline.py]
  ops/chain_packed.py  16 B/anchor wire planes, p_rel   [ops/chain_packed.py]
  ops/chain_v3.py      chaining wrapper + plain version [ops/chain_pallas_v3]
  mapping/extbatch.py  cross-read extension batcher     [mapping/extbatch.py]
  ops/ksw2_extd2.py    extd2 packing, wrapper + plain   [ops/ksw2_pallas.py,
                       version, CIGARs                   extd2 half]
  ops/_build.py        nvcc build + ctypes binding of csrc/
  csrc/chain_v3.cu     the Hopper chaining kernel       [_chain_kernel_v3]
  csrc/ksw2_extd2.cu   the Hopper extension kernel with [_extd2_kernel,
                       its traceback                     trace_device]
  device.py            explicit cpu/cuda device choice
  utils/               mm2tpu's native runtime, profiler and logger,
                       re-exported                      [native, utils]

A wrapper runs its plain PyTorch version only for tensors on the CPU; on
a CUDA tensor it launches its kernel or raises.
"""

__version__ = "0.1.0"
