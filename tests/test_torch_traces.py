"""The port's trace generators (``repro_torch.scenario.traces``) against
the reference's: for the same arguments and seeds, every generator and
``compose`` give the same event stream (ticks, kinds, client arrays with
their dtypes, and args), exactly, and the port keeps the reference's
invariants (``tests/test_traces.py``).  The port's engine replays these
streams, so equal streams are the first half of equal scenario reports.
"""

import numpy as np
import pytest

from repro.scenario import traces as jtraces
from repro_torch.scenario import traces


def _stream(mod, n_clients, n_ticks, seed, leave_prob, return_prob):
    """One composed stream exercising every generator."""
    return mod.compose(
        mod.diurnal(n_ticks, n_regions=3, seed=seed, jitter=0.02),
        mod.churn(n_clients, n_ticks, leave_prob=leave_prob,
                  return_prob=return_prob, seed=seed + 1),
        mod.stragglers(n_clients, frac=0.1, fetch_every=4, seed=seed + 2),
        mod.flash_crowd(max(n_ticks // 2, 1), factor=4.0, width=2,
                        joiners=np.arange(n_clients, n_clients + 3)),
        mod.region_outage(0, 1, max(n_ticks - 1, 2)),
        mod.seasonal_drift(n_ticks, period=max(n_ticks, 2)),
    )


def assert_streams_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b, strict=True):
        assert (x.t, x.kind) == (y.t, y.kind)
        assert (x.clients is None) == (y.clients is None)
        if x.clients is not None:
            assert x.clients.dtype == y.clients.dtype == np.int64
            np.testing.assert_array_equal(x.clients, y.clients)
        assert set(x.args) == set(y.args)
        for k in x.args:
            xa, ya = np.asarray(x.args[k]), np.asarray(y.args[k])
            assert xa.dtype == ya.dtype
            np.testing.assert_array_equal(xa, ya)


CASES = [(1, 2, 0, 0.0, 0.0), (37, 9, 3, 0.2, 0.5), (400, 48, 11, 0.05, 0.3),
         (1000, 24, 101, 0.02, 0.3), (250, 17, 7, 0.5, 0.9)]


@pytest.mark.parametrize("n_clients,n_ticks,seed,leave,ret", CASES)
def test_composed_stream_equals_reference(n_clients, n_ticks, seed, leave,
                                          ret):
    a = _stream(traces, n_clients, n_ticks, seed, leave, ret)
    b = _stream(jtraces, n_clients, n_ticks, seed, leave, ret)
    assert_streams_equal(a, b)
    # the reference's invariants hold on the port's stream
    assert [ev.t for ev in a] == sorted(ev.t for ev in a)
    traces.replay_population(n_clients + 3, a)
    ta, tb = traces.by_tick(a), jtraces.by_tick(b)
    assert list(ta) == list(tb)
    for t in ta:
        assert_streams_equal(ta[t], tb[t])


@pytest.mark.parametrize("gen,args,kw", [
    ("diurnal", (30,), dict(n_regions=4, seed=2)),
    ("diurnal", (30,), dict(ticks_per_day=12, base=0.3, peak=0.9,
                            n_regions=2, seed=5, jitter=0.1)),
    ("churn", (500, 20), dict(leave_prob=0.02, return_prob=0.3, seed=3)),
    ("churn", (500, 20), dict(initial_frac=0.4, seed=4)),
    ("flash_crowd", (6,), dict(factor=8.0, width=2)),
    ("stragglers", (2000,), dict(frac=0.05, fetch_every=6, seed=9)),
    ("region_outage", (1, 4, 8), {}),
    ("seasonal_drift", (32,), dict(period=32, magnitude=1.0)),
    ("seasonal_drift", (50,), dict(period=96, magnitude=0.5)),
])
def test_each_generator_equals_reference(gen, args, kw):
    assert_streams_equal(getattr(traces, gen)(*args, **kw),
                         getattr(jtraces, gen)(*args, **kw))


@pytest.mark.parametrize("preset", ["diurnal_churn", "flash_crowd",
                                    "region_outage", "drift_ewc"])
def test_preset_streams_and_configs_equal_reference(preset):
    from repro.scenario import PRESETS as JPRESETS
    from repro_torch.scenario import PRESETS

    a, b = PRESETS[preset](3_000, 16, seed=21), JPRESETS[preset](3_000, 16,
                                                                 seed=21)
    assert vars(a.cfg) == vars(b.cfg)
    assert_streams_equal(a.events, b.events)


def test_validation_equals_reference():
    with pytest.raises(ValueError, match="unknown trace-event kind"):
        traces.TraceEvent(0, "explode")
    with pytest.raises(ValueError, match="must end after"):
        traces.region_outage(0, 5, 5)
    with pytest.raises(ValueError, match="double|already-present"):
        traces.replay_population(3, [
            traces.TraceEvent(0, "join", np.array([1])),
            traces.TraceEvent(1, "join", np.array([1]))])
    with pytest.raises(ValueError, match="absent"):
        traces.replay_population(3, [
            traces.TraceEvent(0, "leave", np.array([2]))])
    assert traces.KINDS == jtraces.KINDS
