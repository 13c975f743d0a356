"""Host seeding, the seed hits: seconds of the stage `seed.hits`
(mapping/seed.py::collect_seed_hits: the native one-pass index probe,
anchors and sort, and the Python around it) a megabase of query. It
nests in `seed`, but for the re-seed at max_occ of the reads whose best
chain misses segments, which follows their first chaining."""


def read(run):
    s = run.stage_s("seed.hits")
    return s / run.query_Mb if s > 0 else None
