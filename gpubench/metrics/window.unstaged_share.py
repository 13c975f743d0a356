"""Host time that no stage covers: the share of the window in which no
range is open on any thread (the program's `--profile` stages, the
harness's `bench.*` steps and `gc`), from the trace, in %."""


def read(run):
    tr = run.trace
    return 100.0 * (1.0 - tr.covered_s() / tr.window_s)
