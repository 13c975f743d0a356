"""Align pool (mapping/align.py on up to 32 threads): seconds of the
`align` stage a megabase of query. A sum over the threads, not a wall:
it can pass the window's length."""


def read(run):
    s = run.stage_s("align")
    return s / run.query_Mb if s > 0 else None
