"""The window: every batch it starts counts, and its time runs to the
end of the last one."""
import pytest

from gpubench.harness import closed_loop, window_rate


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("durations,seconds,want_batches", [
    ([3.0] * 10, 10.0, 4),        # starts at 0, 3, 6, 9; ends at 12
    ([0.5, 4.0, 0.4, 9.0], 5.0, 4),  # the 4th starts at 4.9
    ([12.0, 1.0], 10.0, 1),       # one batch longer than the window
])
def test_closed_loop_counts_every_started_batch(durations, seconds,
                                                want_batches):
    clock = FakeClock()

    def batch(k):
        clock.t += durations[k]
        return 1000 * (k + 1)

    t0, timeline = closed_loop(batch, seconds, 1, clock)
    assert len(timeline) == want_batches
    assert all(s - t0 < seconds for s, _, _ in timeline)
    end = t0 + sum(durations[:want_batches])
    rate, window_s, past = window_rate(t0, timeline, seconds)
    bases = sum(1000 * (k + 1) for k in range(want_batches))
    assert window_s == pytest.approx(end - t0)
    assert rate == pytest.approx(bases / (end - t0) / 1e6)
    assert past == pytest.approx(end - t0 - seconds)


def test_closed_loop_runs_the_sampled_batch():
    clock = FakeClock()

    def batch(k):
        clock.t += 20.0
        return 1

    t0, timeline = closed_loop(batch, 5.0, 3, clock)
    assert len(timeline) == 3


def test_window_rate_needs_a_batch():
    with pytest.raises(ValueError):
        window_rate(0.0, [], 1.0)
