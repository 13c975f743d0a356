"""Host utilities the port shares with `mm2tpu`, re-exported so that its
callers reach them through the port: the native C++ runtime (`native`),
the stage profiler behind `--profile` (`profiling`) and the `[M::...]`
logger (`timing`). All three are framework-free.
"""
from mm2tpu.native import lib as native
from mm2tpu.utils import profiling, timing

__all__ = ["native", "profiling", "timing"]
