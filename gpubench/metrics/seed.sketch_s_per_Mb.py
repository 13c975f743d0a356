"""Host seeding, the sketch: seconds of the stage `seed.sketch`
(mapping/seed.py::collect_minimizers: each segment's nt4 codes, the
native sketch, the offsets) a megabase of query. It nests in `seed`."""


def read(run):
    s = run.stage_s("seed.sketch")
    return s / run.query_Mb if s > 0 else None
