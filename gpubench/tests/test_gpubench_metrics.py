"""The per-layer metrics that read the program's host seeding split
(`seed.sketch`, `seed.hits`) and its native runtime's time
(`seed.native`, `post.native`): each returns None where the program has
no such stage, as a program without them has not, and its value on a
run that has them."""
import pytest

from gpubench import harness

from conftest import REPO

# a window's stages (seconds, calls) as the program reports them
STAGES = {"seed": (2.0, 3600), "seed.sketch": (0.8, 3600),
          "seed.hits": (1.1, 3610), "seed.native": (0.95, 7210),
          "chain.backtrack": (0.5, 30), "post": (1.5, 7200),
          "post.native": (0.4, 18000)}
OLD = {k: STAGES[k] for k in ("seed", "chain.backtrack", "post")}
QUERY_MB = 4.0


def fake_run(stages):
    run = harness._Run.__new__(harness._Run)
    run.stages, run.query_Mb = stages, QUERY_MB
    return run


@pytest.mark.parametrize("name,want", [
    ("seed.sketch_s_per_Mb", 0.8 / QUERY_MB),
    ("seed.hits_s_per_Mb", 1.1 / QUERY_MB),
    ("seed.native_share", 100.0 * 0.95 / (0.8 + 1.1)),
    ("post.native_share", 100.0 * 0.4 / (0.5 + 1.5)),
])
def test_reader_value_and_absence(name, want):
    read = harness.metric_reader(REPO, name)
    assert read(fake_run(STAGES)) == pytest.approx(want)
    assert read(fake_run(OLD)) is None


@pytest.mark.parametrize("name,dropped", [
    ("seed.native_share", "seed.native"),
    ("post.native_share", "post.native"),
])
def test_share_without_native_time_is_none(name, dropped):
    """A run whose native runtime timed no call (its `fallback.*`
    counters then say why) reads None, not a share of 0."""
    stages = {k: v for k, v in STAGES.items() if k != dropped}
    assert harness.metric_reader(REPO, name)(fake_run(stages)) is None
