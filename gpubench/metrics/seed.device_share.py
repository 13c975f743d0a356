"""Device seeding round: the share of the reads whose anchors the card
built (`seed.device_reads` / `seed.reads`), in %. The rest are seeded
on the host: outside device seeding's contract, or handed back past its
anchor cap (`seed.capped`). None where the program counts no such
reads, as a program without the counter does not."""


def read(run):
    n = run.counters.get("seed.reads", 0)
    if not n or "seed.device_reads" not in run.counters:
        return None
    return 100.0 * run.counters["seed.device_reads"] / n
