"""Device (H100): the share of the window with no kernel, memcpy or
memset on the card, from the trace, in %."""


def read(run):
    tr = run.trace
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
