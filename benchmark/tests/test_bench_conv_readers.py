"""``voxel_conv.ms`` and ``voxel_conv.roofline_pct`` on traces built from the
kernels a chip run of ``drq_voxel.updates`` named (``data/voxel_conv_replay.json``:
one replay's convolution kernels, with a LayerNorm and two GEMMs that no
reader counts), worked out by hand; and the cases that give no reading."""

import json
import os

import pytest
import tiny

from pcbench import harness, tracing
from pcbench.convs import kind_of
from pcbench.encoders import sparsecnn

with open(os.path.join(tiny.BENCH, "tests", "data", "voxel_conv_replay.json")) as _f:
    REPLAY = json.load(_f)["kernels"]
ONE_UPDATE = {"conv3d_fwd": 6, "conv3d_dgrad": 3, "conv3d_wgrad": 3}
CONV_US = sum(k["dur"] for k in REPLAY if kind_of(k["name"]))


def _trace(replays, extra=(), window=(0.0, 1e6)):
    """A window holding a graph replay at each start in ``replays`` (us), each
    the fixture's kernels (``replays[i] = (start, kernels)``), and ``extra`` kernels."""
    events = [{"cat": "user_annotation", "name": tracing.WINDOW_SPAN, "ts": window[0], "dur": window[1] - window[0]}]
    for corr, (start, kernels) in enumerate(replays, 100):
        events.append({"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": start - 5.0, "dur": 3.0,
                       "args": {"correlation": corr}})
        events += [{"cat": "kernel", "name": k["name"], "ts": start + k["ts"], "dur": k["dur"],
                    "args": {"correlation": corr}} for k in kernels]
    events += [dict(k, cat="kernel", args={"correlation": 7}) for k in extra]
    return tracing.Trace(events)


def _ctx(trace, updates=2):
    return {"trace": trace, "config": harness.Cell("drq_voxel.updates").config, "chips": 1,
            "traced_updates": updates}


@pytest.fixture
def programs(monkeypatch):
    """The port's record of what one replay of each captured program adds."""
    from pointcloud_rl_torch.algorithms import graphs

    monkeypatch.setattr(graphs, "replay_launches", {"phase 0": dict(ONE_UPDATE, pointnet_fused_bwd=0),
                                                    "phase 1": dict(ONE_UPDATE)})
    return graphs


def _read(name, ctx):
    return harness.load_metric_reader(name)(ctx)


def test_the_fixture_is_one_update():
    kinds = [kind_of(k["name"]) for k in REPLAY]
    assert {k: kinds.count(k) for k in ("fwd", "dgrad", "wgrad")} == {"fwd": 6, "dgrad": 3, "wgrad": 3}
    assert kinds.count(None) == 3  # the LayerNorm and the GEMMs


def test_ms_and_roofline_over_two_replays(programs):
    ctx = _ctx(_trace([(1000.0, REPLAY), (300000.0, REPLAY)]))
    assert _read("voxel_conv.ms", ctx) == pytest.approx(2 * CONV_US / 1e3 / 2)
    least = sparsecnn.least_ms(ctx["config"]["shapes"], 512, "float32")
    per_update_ms = sum(2 * least[(i, "fwd")] + least[(i, "dgrad")] + least[(i, "wgrad")] for i in range(3))
    assert per_update_ms == pytest.approx(17.492, abs=1e-3)  # 2.9e12 FLOP of convolutions at 495/3 TFLOP/s
    assert _read("voxel_conv.roofline_pct", ctx) == pytest.approx(100 * 2 * per_update_ms / (2 * CONV_US / 1e3))


def test_no_reading_when_a_replay_lost_a_kernel(programs):
    short = [k for k in REPLAY if "wgrad" not in k["name"]] + [k for k in REPLAY if "wgrad" in k["name"]][1:]
    ctx = _ctx(_trace([(1000.0, REPLAY), (300000.0, short)]))
    assert _read("voxel_conv.ms", ctx) is None and _read("voxel_conv.roofline_pct", ctx) is None


def test_no_reading_without_the_counters(programs, monkeypatch):
    from pointcloud_rl_torch.ops import conv

    ctx = _ctx(_trace([(1000.0, REPLAY)]), updates=1)
    assert _read("voxel_conv.ms", ctx) is not None
    monkeypatch.delattr(conv, "call_counts")
    assert _read("voxel_conv.ms", ctx) is None and _read("voxel_conv.roofline_pct", ctx) is None
    monkeypatch.undo()
    monkeypatch.delattr(programs, "replay_launches")
    assert _read("voxel_conv.ms", ctx) is None and _read("voxel_conv.roofline_pct", ctx) is None


def test_no_reading_without_convolutions_or_with_stray_ones(programs):
    others = [k for k in REPLAY if not kind_of(k["name"])]
    for ctx in (_ctx(_trace([(1000.0, others)])), _ctx(_trace([])), _ctx(None)):
        assert _read("voxel_conv.ms", ctx) is None and _read("voxel_conv.roofline_pct", ctx) is None
    # a convolution kernel that no launch of the window accounts for, and a launch made before the window opened
    stray = _ctx(_trace([(1000.0, REPLAY)], extra=[dict(REPLAY[-1], ts=500000.0)]))
    early = _ctx(_trace([(1000.0, REPLAY), (300000.0, REPLAY)], window=(1000.0, 1e6)))
    for ctx in (stray, early):
        assert _read("voxel_conv.ms", ctx) is None and _read("voxel_conv.roofline_pct", ctx) is None


def test_no_reading_when_the_programs_counts_differ(programs):
    programs.replay_launches["act"] = {"conv3d_fwd": 1, "conv3d_dgrad": 0, "conv3d_wgrad": 0}
    ctx = _ctx(_trace([(1000.0, REPLAY)]), updates=1)
    assert _read("voxel_conv.ms", ctx) is None and _read("voxel_conv.roofline_pct", ctx) is None
    programs.replay_launches["act"] = {"pointnet_fused_fwd_max": 1}  # a program that convolves nothing
    assert _read("voxel_conv.ms", ctx) == pytest.approx(CONV_US / 1e3)


def test_kernels_read_by_their_start_and_launches_by_the_hosts_clock(programs):
    """The last replay's kernels end past the window's close (an offset
    between the card's and the host's clocks): still read, as they start
    inside it and so does their launch."""
    end = 300000.0 + max(k["ts"] + k["dur"] for k in REPLAY)
    ctx = _ctx(_trace([(1000.0, REPLAY), (300000.0, REPLAY)], window=(0.0, end - 100.0)))
    assert _read("voxel_conv.ms", ctx) == pytest.approx(2 * CONV_US / 1e3 / 2)
