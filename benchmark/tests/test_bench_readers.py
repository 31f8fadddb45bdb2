"""The per-layer readers on a hand-made trace: what each reads, worked out by hand."""

import math

import pytest
import tiny  # noqa: F401  (puts the benchmark on the path)

from pcbench import flops, harness, tracing


def _k(name, ts, dur, corr=None, grid=(1, 1, 1)):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr, "grid": list(grid), "stream": 7}}


def _trace():
    body = "void (anonymous namespace)::pointnet_body_idx_kernel<__nv_bfloat16>((anonymous namespace)::Params)"
    events = [
        {"cat": "user_annotation", "name": tracing.WINDOW_SPAN, "ts": 0.0, "dur": 1000.0},
        {"cat": "user_annotation", "name": "updates.scan", "ts": 0.0, "dur": 50.0},
        {"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 1.0, "dur": 5.0, "args": {"correlation": 11}},
        # one graph replay: 100..400 us, busy 100..200 and 300..400 (idle 100 of 300)
        _k("void prep_weights_kernel<__nv_bfloat16>(...)", 100.0, 10.0, 11),
        _k(body, 110.0, 80.0, 11),
        _k("void merge_chunks_kernel<true>(...)", 190.0, 10.0, 11, grid=(512, 1, 1)),
        _k("ampere_sgemm", 300.0, 100.0, 11),
        # a kernel outside any graph: 600..700
        _k("elementwise", 600.0, 100.0, 99),
    ]
    return tracing.Trace(events)


def _ctx(trace):
    cfg = harness.Cell("drq_walker_pn.updates").config
    return {"trace": trace, "config": cfg, "kernel_rows": [16, 256, 512], "spans": {"collect_ms": 12.5},
            "launches": {"pointnet_fused_fwd_idx": 1, "pointnet_fused_fwd_max": 0},
            "window": {"updates": 320, "seconds": 2.0}, "chips": 1,
            "flops": flops.update_flops(cfg["shapes"], "pointnet")}


def test_device_and_graph_idle():
    ctx = _ctx(_trace())
    busy = 100 + 100 + 100  # [100, 200), [300, 400), [600, 700)
    assert harness.load_metric_reader("device.idle_pct")(ctx) == pytest.approx(100 * (1 - busy / 1000))
    assert harness.load_metric_reader("graphs.idle_pct")(ctx) == pytest.approx(100 * 100 / 300)


def test_roofline_counts_the_launch_at_its_rows():
    ctx = _ctx(_trace())
    want_ms = flops.bound_ms(512, 1536, 9, (64, 128, 256), "bfloat16", True)[0]
    read = harness.load_metric_reader("pointnet_fused.roofline_pct")
    assert read(ctx) == pytest.approx(100 * want_ms * 1e3 / 100.0)  # prep + body + merge = 100 us
    ctx["launches"]["pointnet_fused_fwd_max"] = 1  # the program counted a launch the trace lost
    assert read(ctx) is None


def test_mfu_and_collect():
    ctx = _ctx(_trace())
    want = 100 * ctx["flops"]["total"] * 320 / 2.0 / 989e12
    assert harness.load_metric_reader("update.mfu_pct")(ctx) == pytest.approx(want)
    assert harness.load_metric_reader("rollout.collect_ms")(ctx) == 12.5


def test_readers_find_nothing_without_a_trace():
    ctx = _ctx(None)
    for name in ("device.idle_pct", "graphs.idle_pct", "pointnet_fused.roofline_pct"):
        assert harness.load_metric_reader(name)(ctx) is None
    ctx["spans"] = {}
    assert harness.load_metric_reader("rollout.collect_ms")(ctx) is None


def test_breakdown():
    t = _trace()
    ops = dict(t.device_ops())
    assert ops["ampere_sgemm"] == pytest.approx(100e-6)
    gaps = t.idle_gaps()
    assert gaps[0][1] == pytest.approx(300e-6)  # 700..1000
    assert math.isclose(sum(g for _, g in gaps), 1e-3 - 300e-6)
