"""Emit (`cli.emit`, io/format.py): seconds of the `emit` stage a
megabase of query."""


def read(run):
    s = run.stage_s("emit")
    return s / run.query_Mb if s > 0 else None
