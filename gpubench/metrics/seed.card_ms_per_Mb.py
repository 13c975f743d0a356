"""Device seeding round (`_seed_device_round`, ops/seed_device.py, K5
and K6): milliseconds of card time (`seed.gpu_busy`, the program's CUDA
events around each K5 launch and each K6 chain) a megabase of query."""


def read(run):
    s = run.stage_s("seed.gpu_busy")
    return 1e3 * s / run.query_Mb if s > 0 else None
