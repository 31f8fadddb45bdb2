"""The readers of the program's spans on a hand-made trace: what each reads, worked out by hand."""

import pytest
import tiny  # noqa: F401  (puts the benchmark on the path)

from pcbench import harness, tracing

READERS = ("replay.sample_ms", "graphs.upload_ms", "graphs.rebuilds", "forward_async.dispatch_ms", "obs_fuse.ms",
           "rollout.env_wait_ms")


def _s(name, ts, dur, tid=1):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}


def _read(name, events):
    return harness.load_metric_reader(name)({"trace": tracing.Trace(events)})


def _window(*events):
    return [_s(tracing.WINDOW_SPAN, 100.0, 1000.0)] + list(events)


def test_updates_cell_per_update_and_the_windows_edges():
    events = _window(
        # an update that started before the window: none of its spans count
        _s("sac.update", 50.0, 60.0), _s("replay.sample", 55.0, 10.0), _s("graphs.upload", 70.0, 5.0),
        # two updates in it, the first at its very start
        _s("sac.update", 100.0, 300.0), _s("replay.sample", 110.0, 100.0), _s("graphs.upload", 220.0, 40.0),
        _s("graphs.replay", 270.0, 20.0),
        _s("sac.update", 500.0, 300.0), _s("replay.sample", 510.0, 300.0 - 100.0), _s("graphs.upload", 720.0, 80.0),
        _s("graphs.replay", 805.0, 20.0),
        # one that starts after the window's end
        _s("sac.update", 1200.0, 60.0), _s("replay.sample", 1205.0, 10.0), _s("graphs.upload", 1220.0, 5.0),
    )
    assert _read("replay.sample_ms", events) == pytest.approx((100.0 + 200.0) / 2 / 1e3)
    assert _read("graphs.upload_ms", events) == pytest.approx((40.0 + 80.0) / 2 / 1e3)
    assert _read("graphs.rebuilds", events) == 0.0


def test_rebuilds_count_eager_runs_and_captures_in_the_window():
    events = _window(_s("graphs.eager", 40.0, 30.0),  # set-up's, before the window
                     _s("graphs.eager", 200.0, 30.0), _s("graphs.capture", 300.0, 50.0), _s("graphs.replay", 360.0, 5.0),
                     _s("graphs.capture", 1150.0, 50.0))  # after it
    assert _read("graphs.rebuilds", events) == 2.0


def test_loop_cell_per_cycle_and_self_time():
    cycle = "rollout.forward_with_policy"
    events = _window(
        _s(cycle, 90.0, 200.0),  # a cycle that started before the window: not counted
        _s(cycle, 300.0, 300.0), _s(cycle, 700.0, 300.0),
        _s("forward_async.dispatch", 310.0, 20.0), _s("forward_async.dispatch", 710.0, 40.0),
        # each env wait holds a fusion; the second wait's fusion ran on another thread
        _s("rollout.env_wait", 340.0, 100.0), _s("obs_fuse", 400.0, 30.0),
        _s("rollout.env_wait", 760.0, 100.0), _s("obs_fuse", 800.0, 50.0, tid=2),
        _s("obs_fuse", 900.0, 10.0),  # a fusion outside any env wait (a reset)
    )
    assert _read("forward_async.dispatch_ms", events) == pytest.approx(60.0 / 2 / 1e3)
    assert _read("obs_fuse.ms", events) == pytest.approx((30.0 + 50.0 + 10.0) / 2 / 1e3)
    assert _read("rollout.env_wait_ms", events) == pytest.approx((100.0 - 30.0 + 100.0) / 2 / 1e3)


@pytest.mark.parametrize("name", READERS)
def test_no_reading_without_the_programs_spans(name):
    # the benchmark's own spans only, as a program without spans leaves them
    events = _window(_s("updates.scan", 200.0, 100.0), _s("rollout.forward_with_policy", 300.0, 300.0),
                     _s("agent.forward_async", 310.0, 20.0))
    assert _read(name, events) is None
    assert harness.load_metric_reader(name)({"trace": None}) is None


def test_no_reading_without_a_cycle_or_an_update_in_the_window():
    events = _window(_s("rollout.forward_with_policy", 1200.0, 100.0), _s("forward_async.dispatch", 300.0, 20.0),
                     _s("obs_fuse", 400.0, 20.0), _s("rollout.env_wait", 380.0, 60.0),
                     _s("sac.update", 20.0, 50.0), _s("replay.sample", 500.0, 10.0), _s("graphs.upload", 600.0, 5.0))
    for name in ("forward_async.dispatch_ms", "obs_fuse.ms", "rollout.env_wait_ms", "replay.sample_ms",
                 "graphs.upload_ms"):
        assert _read(name, events) is None, name
