"""Minimizer sketch, CSR index, .mmi reader/writer and junction BED: the
port's copies of `mm2tpu/index/`."""
