"""``pointnet_fused.bwd_ms`` on a hand-made trace, worked out by hand."""

import pytest
import tiny  # noqa: F401  (puts the benchmark on the path)

from pcbench import harness, tracing

PREP = "void (anonymous namespace)::winner_bwd_prep_kernel(float const*, float const*, (anonymous namespace)::BwdPlan, float*)"
MAIN = "void (anonymous namespace)::winner_bwd_kernel<__nv_bfloat16>((anonymous namespace)::BwdParams)"


def _k(name, ts, dur):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {"stream": 7}}


def _read(*kernels):
    events = [{"cat": "user_annotation", "name": tracing.WINDOW_SPAN, "ts": 100.0, "dur": 1000.0}, *kernels]
    return harness.load_metric_reader("pointnet_fused.bwd_ms")({"trace": tracing.Trace(events)})


def test_ms_per_call_leaves_out_a_chain_cut_by_the_windows_edge():
    got = _read(
        # a call whose first kernel ran before the window: its second kernel, inside, is not counted
        _k(PREP, 90.0, 5.0), _k(MAIN, 96.0, 700.0),
        _k("void at::native::elementwise_kernel<128, 2>(...)", 800.0, 50.0),
        # a whole call in the window, then another kernel
        _k(PREP, 860.0, 4.0), _k(MAIN, 865.0, 120.0),
        _k("ampere_sgemm", 990.0, 30.0),
    )
    assert got == pytest.approx((4.0 + 120.0) / 1 / 1e3)


def test_ms_per_call_over_two_calls():
    got = _read(_k(PREP, 200.0, 4.0), _k(MAIN, 205.0, 100.0), _k("ampere_sgemm", 310.0, 30.0),
                _k(PREP, 400.0, 6.0), _k(MAIN, 407.0, 140.0))
    assert got == pytest.approx((4.0 + 100.0 + 6.0 + 140.0) / 2 / 1e3)


def test_no_reading_without_the_backward_kernels():
    # the plain backward's ATen kernels alone, as a program before the kernel leaves them
    assert _read(_k("void at::native::elementwise_kernel<128, 2>(...)", 200.0, 50.0),
                 _k("void at::native::reduce_kernel<128, 4>(...)", 300.0, 40.0)) is None
    assert _read(_k(PREP, 50.0, 5.0), _k(MAIN, 56.0, 100.0)) is None  # only a call before the window
    assert harness.load_metric_reader("pointnet_fused.bwd_ms")({"trace": None}) is None
