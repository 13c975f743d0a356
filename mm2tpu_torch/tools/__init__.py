"""Post-processing toolkit (reference: misc/paftools.js).

The port's copy of `mm2tpu/tools/`: `paftools.py` and `paftools_asm.py`
are verbatim copies of the JAX package's modules of the same names, apart
from their docstrings. Host code only: nothing in them touches a device."""
