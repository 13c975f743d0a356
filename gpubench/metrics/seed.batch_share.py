"""Host seeding: the share of the reads that the batch path's first
seeding pass seeds on the host through the native runtime's two batch
calls (`mapping/seed_batch.py`: `seed.batched` / `seed.reads`), in %.
The rest are seeded a read at a time. None where the program counts no
such reads, as a program without the batch calls does not."""


def read(run):
    n = run.counters.get("seed.reads", 0)
    if not n:
        return None
    return 100.0 * run.counters.get("seed.batched", 0) / n
