"""Device seeding round, the host's glue around K5 and K6: seconds of
the stages `seed.split` (every read's minimizers split into the
device's planes), `seed.meta` (rep_len, mini_pos, the anchor totals and
the dispatch plan from the counts) and `seed.pack` (each dispatch's
host planes) a megabase of query. None where the program has none of
these stages."""

STAGES = ("seed.split", "seed.meta", "seed.pack")


def read(run):
    if not any(s in run.stages for s in STAGES):
        return None
    return sum(run.stage_s(s) for s in STAGES) / run.query_Mb
