"""Host utilities of the port, re-exported so that its callers reach them
as `mm2tpu_torch.utils.X`: the native C++ runtime (`native`), the stage
profiler behind `--profile` (`profiling`) and the `[M::...]` logger
(`timing`). All are the port's own copies of the JAX package's
framework-free modules (`hashing` is one more, imported directly).
"""
from ..native import lib as native
from . import profiling, timing

__all__ = ["native", "profiling", "timing"]
