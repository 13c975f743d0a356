"""Host seeding: seconds of the `seed` stage (mapping/pipeline.py::_prepare,
the sketch of index/sketch.py, and host seed hits) a megabase of query.
In the map_ont cells it holds the reads' sketch; their hits are the
card's."""


def read(run):
    s = run.stage_s("seed")
    return s / run.query_Mb if s > 0 else None
