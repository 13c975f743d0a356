"""`seed.batch_share`, the share of the reads that the host seeds
through the batch calls: its value on a run that counts them, and None
on a run without the counters, as a program without the batch calls
has not."""
import pytest

from gpubench import harness

from conftest import REPO


def fake_run(counters):
    run = harness._Run.__new__(harness._Run)
    run.stages, run.counters, run.query_Mb = {}, counters, 4.0
    return run


@pytest.mark.parametrize("counters,want", [
    ({"seed.reads": 7200.0, "seed.batched": 7200.0}, 100.0),
    ({"seed.reads": 7200.0, "seed.batched": 1800.0}, 25.0),
    ({"seed.reads": 7200.0}, 0.0),
    ({"chain.anchors": 10.0}, None),
    ({}, None),
])
def test_batch_share(counters, want):
    read = harness.metric_reader(REPO, "seed.batch_share")
    assert read(fake_run(counters)) == want
