"""The port's straggler watchdog (a copy of repro.training.watchdog), fed
step times by patching ``time.perf_counter``, not by sleeping, so that a
loaded host cannot make the test flaky; the reference's module gets the
same times and must flag the same steps."""
import pytest

from repro.training import watchdog as JW
from repro_torch.training import watchdog as W


class Clock:
    """A perf_counter that moves only when told."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _drive(module, monkeypatch, durations, **kw):
    clock = Clock()
    monkeypatch.setattr(module.time, "perf_counter", clock)
    seen = []
    wd = module.Watchdog(on_straggle=lambda *a: seen.append(a), **kw)
    flags = []
    for step, dt in enumerate(durations):
        wd.start()
        clock.now += dt
        flags.append(wd.stop(step))
    return flags, wd.straggles, seen


STEADY = [0.010, 0.011, 0.009, 0.010, 0.012, 0.010, 0.011, 0.009]


@pytest.mark.parametrize("durations,flagged", [
    (STEADY + [0.150], [8]),                       # one straggler
    (STEADY + [0.013], []),                        # within the spread
    (STEADY[:3] + [0.150], []),                    # too few samples
    (STEADY + [0.150, 0.010, 0.200], [8, 10]),     # two, baseline kept
])
def test_watchdog_flags_stragglers(monkeypatch, durations, flagged):
    flags, straggles, seen = _drive(W, monkeypatch, durations,
                                    min_samples=5, threshold=3.0)
    assert [i for i, f in enumerate(flags) if f] == flagged
    assert [s[0] for s in straggles] == flagged
    assert [s[0] for s in seen] == flagged
    want = _drive(JW, monkeypatch, durations, min_samples=5,
                  threshold=3.0)
    assert (flags, straggles) == want[:2]


def test_watchdog_window_drops_old_samples(monkeypatch):
    """Past ``window`` samples the oldest go: a slow era becomes the new
    baseline."""
    durations = [0.01] * 10 + [0.1] * 30 + [0.1]
    flags, _, _ = _drive(W, monkeypatch, durations, window=20,
                         min_samples=5)
    assert not flags[-1]
    assert flags == _drive(JW, monkeypatch, durations, window=20,
                           min_samples=5)[0]
