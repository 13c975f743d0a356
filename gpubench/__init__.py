"""The benchmark of `mm2tpu_torch`, the PyTorch and CUDA port of mm2tpu.

`python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once on one CUDA card
and prints one JSON line. Everything of one configuration, traffic mix
or per-layer metric lives in a file of its own (`configs/`, `traffic/`,
`metrics/`), found by its name. The yardstick (generators, the plain
reference, the counts behind the rooflines, the comparison that decides
`correct`) imports nothing of the program.
"""
