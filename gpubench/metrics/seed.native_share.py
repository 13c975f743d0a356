"""Host seeding: the share of the stages `seed.sketch` and `seed.hits`
spent in the calls into the native runtime (the accumulator-only stage
`seed.native`: `native.lib.sketch`, `native.lib.seed_hits`), in %. The
rest is the interpreter's. None where the program times no such call."""


def read(run):
    if "seed.native" not in run.stages:
        return None
    s = run.stage_s("seed.sketch") + run.stage_s("seed.hits")
    return 100.0 * run.stage_s("seed.native") / s if s > 0 else None
