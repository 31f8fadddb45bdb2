"""The port's 3D convolution (``ops/conv.py``): its CUDA kernels
(``csrc/conv3d.cu``) against the plain f64 convolution on the card, and
what the CPU can check of them.

On the CPU a convolution runs ``F.conv3d`` / ``aten.convolution_backward``
(the plain version); the tests here hold that path to ``F.conv3d``'s own
autograd, the kernel names to the benchmark's marks, the counter's keys to
the registry, and the wrapper's refusals.  The ``gpu`` tests build the
kernels with nvcc and run as
``python -m pytest --noconftest -m gpu tests/test_torch_conv3d.py``; this
file imports no JAX.
"""

import os
import re
import sys

import pytest
import torch
import torch.nn.functional as F

from pointcloud_rl_torch.models.voxel import same_padding
from pointcloud_rl_torch.ops import conv as tconv
from pointcloud_rl_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "pointcloud_rl_torch", "csrc", "conv3d.cu")
KINDS = ("fprop", "dgrad", "wgrad")  # the kernel of each kind of call


def _kind_of():
    sys.path.insert(0, os.path.join(REPO, "benchmark"))
    try:
        from pcbench.convs import HELPERS, MAIN, kind_of
    finally:
        sys.path.pop(0)
    return kind_of, MAIN, HELPERS


def _kernels():
    """Each ``__global__`` function of the source: (name, its argument's type)."""
    text = open(SOURCE).read()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\((\w+)", text)


# ------------------------------------------------------------------ CPU
def test_every_kernel_bears_one_mark_and_each_kind_has_one():
    """The benchmark counts a call's kernel by the mark of its kind in the
    name the profiler gives (the function and its argument's type): each
    kernel bears exactly one mark and no helper's, one kernel a kind."""
    kind_of, main, helpers = _kind_of()
    found = {}
    for name, arg in _kernels():
        shown = f"void (anonymous namespace)::{name}<64, 256>((anonymous namespace)::{arg})"
        assert sum(shown.count(mark) for mark in main.values()) == 1, shown
        assert not any(h in shown for h in helpers), shown
        found.setdefault(kind_of(shown), []).append(name)
    assert found == {"fwd": ["conv3d_fprop_kernel"], "dgrad": ["conv3d_dgrad_kernel"],
                     "wgrad": ["conv3d_wgrad_kernel"]}


def test_conv3d_launches_is_registered_apart_from_every_other_counter():
    """``conv3d_launches`` is the ops module's dict, under its name, with a
    key per kernel, none held by another counter (a replay adds each count
    back by its key alone), so ``pcbench/convs.replay_counts`` reads
    ``conv_calls`` as before."""
    assert trace.COUNTERS["conv3d_launches"] is tconv.launch_counts
    assert set(tconv.launch_counts) == {f"conv3d_{k}_launches" for k in KINDS}
    others = {key for name, c in trace.COUNTERS.items() if name != "conv3d_launches" for key in c}
    assert not others & set(tconv.launch_counts)
    assert set(trace.COUNTERS["conv_calls"]) == {"conv3d_fwd", "conv3d_dgrad", "conv3d_wgrad"}


CPU_CASES = {  # B, C_in, dims, C_out, k, s, padding, bias
    "encoder_like": (2, 8, (8, 8, 8), 12, 4, 2, (1, 1, 1), True),
    "odd_prepadded": (1, 4, (9, 10, 11), 8, 4, 2, (0, 0, 0), True),
    "no_bias": (2, 4, (6, 6, 6), 4, 2, 2, (0, 1, 0), False),
    "stride_one": (1, 3, (5, 6, 7), 5, 3, 1, (1, 0, 2), True),
}


@pytest.mark.parametrize("case", list(CPU_CASES))
def test_cpu_conv_equals_functional_with_gradients(case):
    """CPU tensors take the plain path: the output and the three gradients
    of a weighted sum equal ``F.conv3d``'s under autograd, and the calls are
    counted while no kernel launch is."""
    B, c_in, dims, c_out, k, s, pad, with_bias = CPU_CASES[case]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, c_in, *dims, generator=g, requires_grad=True)
    w = torch.randn(c_out, c_in, k, k, k, generator=g, requires_grad=True)
    b = torch.randn(c_out, generator=g, requires_grad=True) if with_bias else None
    leaves = [x, w] + ([b] if with_bias else [])
    before_calls, before_launches = dict(tconv.call_counts), dict(tconv.launch_counts)
    got = tconv.conv(x, w, b, (s,) * 3, pad)
    cot = torch.randn(got.shape, generator=g)
    got_grads = torch.autograd.grad((got * cot).sum(), leaves)
    want = F.conv3d(x, w, b, s, pad)
    want_grads = torch.autograd.grad((want * cot).sum(), leaves)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for gg, ww in zip(got_grads, want_grads):
        torch.testing.assert_close(gg, ww, rtol=1e-6, atol=1e-6)
    assert {k: v - before_calls[k] for k, v in tconv.call_counts.items()} == {
        "conv3d_fwd": 1, "conv3d_dgrad": 1, "conv3d_wgrad": 1}
    assert tconv.launch_counts == before_launches


def _cl(x):
    return x.contiguous(memory_format=torch.channels_last_3d)


REFUSED = {  # what the kernels do not take, each with the words of its refusal
    "f64": (lambda x, w: (x.double(), w.double()), (2, 2, 2), "f32"),
    "k_not_multiple_of_s": (lambda x, w: (x, w), (3, 3, 3), "2 on every axis"),
    "strides_per_axis": (lambda x, w: (x, w), (2, 2, 1), "2 on every axis"),
    "stride_one": (lambda x, w: (x, w), (1, 1, 1), "2 on every axis"),
    "channels_first": (lambda x, w: (x.contiguous(), w), (2, 2, 2), "channels_last_3d"),
    "channels_not_by_4": (lambda x, w: (_cl(x[:, :6]), w[:, :6].contiguous()), (2, 2, 2), "multiples of 4"),
    "kernel_of_5": (lambda x, w: (x, F.pad(w, (0, 1, 0, 1, 0, 1))), (1, 1, 1), "(4, 4, 4)"),
    "kernel_of_2": (lambda x, w: (x, w[..., :2, :2, :2].contiguous()), (2, 2, 2), "(4, 4, 4)"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_kernels_refuse_what_they_do_not_take(case):
    """``kernel_refusal`` (which a 5-D CUDA convolution raises with) names
    each input the kernels do not take, and passes the encoder's."""
    x = _cl(torch.randn(2, 8, 8, 8, 8))
    w = torch.randn(16, 8, 4, 4, 4)
    assert tconv.kernel_refusal(x, w, (2, 2, 2), (1, 1, 1)) == ""
    make, stride, words = REFUSED[case]
    bad_x, bad_w = make(x, w)
    assert words in tconv.kernel_refusal(bad_x, bad_w, stride, (1, 1, 1))


# ------------------------------------------------------------- on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


LAYERS = {  # the encoder's three convolutions (C_in, grid side, C_out), k 4, s 2, SAME padding 1
    "conv0": (32, 32, 64),
    "conv1": (64, 16, 64),
    "conv2": (64, 8, 128),
}
GRIDS = ("sparse", "dense", "odd")  # as sparse as the encoder's first grid, dense random, odd pre-padded
CLOUDS = 4
U = 2.0**-24  # f32's unit roundoff


def _grid_case(layer: str, grid: str, seed: int = 0):
    """x [B, C, D, H, W] and dy (views of channels-last grids), w and b, on
    the CPU, and the padding."""
    c_in, n, c_out = LAYERS[layer]
    g = torch.Generator().manual_seed(seed)
    dims = (n - 1, n, n + 1) if grid == "odd" else (n, n, n)
    x = torch.randn(CLOUDS, *dims, c_in, generator=g)
    if grid == "sparse":  # 1200 occupied voxels of 32^3, the encoder's first grid
        x = x * (torch.rand(CLOUDS, *dims, 1, generator=g) < 1200 / 32768)
    pad = (1, 1, 1)
    if grid == "odd":  # flax SAME on odd sizes: the model pads the high side itself and convolves with none
        sides = [same_padding(m, 4, 2) for m in dims]
        x = F.pad(x, (0, 0) + tuple(p for lo_hi in sides[::-1] for p in lo_hi))
        pad = (0, 0, 0)
    w = torch.randn(c_out, c_in, 4, 4, 4, generator=g) / (c_in * 64) ** 0.5
    b = torch.randn(c_out, generator=g) * 0.1
    x = x.permute(0, 4, 1, 2, 3)
    out = [(m + 2 * p - 4) // 2 + 1 for m, p in zip(x.shape[2:], pad)]
    dy = torch.randn(CLOUDS, *out, c_out, generator=g).permute(0, 4, 1, 2, 3)
    return x, w, b, dy, pad


def _plain(x, w, b, dy, pad, dtype, device):
    """Output and the three gradients by ``F.conv3d`` and
    ``convolution_backward`` (cuDNN with TF32 off on the card)."""
    x, w, b, dy = (t.to(device, dtype) for t in (x, w, b, dy))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv3d(x, w, b, 2, pad)
        dx, dw, db = torch.ops.aten.convolution_backward(dy, x, w, [w.shape[0]], [2] * 3, list(pad), [1] * 3, False,
                                                         [0] * 3, 1, [True, True, True])
    return y, dx, dw, db


def _kernels_run(x, w, b, dy, pad):
    x, w, b, dy = _cl(x.cuda()), w.cuda(), b.cuda(), _cl(dy.cuda())
    y = tconv._fprop(x, w, b, (2, 2, 2), pad)
    dx = tconv._dgrad(dy, x, w, (2, 2, 2), pad)
    dw, db = tconv._wgrad(dy, x, w, (2, 2, 2), pad, True)
    return y, dx, dw, db


def _gap(got, want):
    """The largest error over the largest magnitude of the f64 result."""
    want = want.double().cpu()
    return float((got.double().cpu() - want).abs().max() / want.abs().max().clamp_min(1e-300))


@pytest.mark.gpu
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("layer", list(LAYERS))
def test_kernels_match_f64_and_stay_within_twice_cudnn_on_gpu(layer, grid):
    """Forward, input and weight (and bias) gradients of the three kernels
    against the f64 CPU convolution, at the encoder's three shapes with 4
    clouds.  Each gap (the largest error over the largest f64 value) is
    held to n u, the relative error an f32 accumulation over n terms can
    reach, n the longest sum into one output (the forward 64 C_in <= 4096;
    the input gradient 8 C_out; the weight gradient a chunk of sites plus
    the chunks): a fault of indexing errs by the size of the values
    themselves.  Beside it, cuDNN's own f32 gap on the same inputs is the
    yardstick: the kernels' gap is at most twice it (and two units of
    roundoff, where cuDNN's reads next to nothing)."""
    _card()
    x, w, b, dy, pad = _grid_case(layer, grid)
    want = _plain(x, w, b, dy, pad, torch.float64, "cpu")
    library = _plain(_cl(x), w, b, _cl(dy), pad, torch.float32, "cuda")
    got = _kernels_run(x, w, b, dy, pad)
    torch.cuda.synchronize()
    plan = tconv.wgrad_plan(x, w, dy)
    c_in, c_out = w.shape[1], w.shape[0]
    chain = {"y": 64 * c_in, "dx": 8 * c_out, "dw": plan["chunk_len"] + plan["chunks"],
             "db": plan["chunk_len"] + plan["chunks"]}
    for name, g_, l_, w_ in zip(("y", "dx", "dw", "db"), got, library, want):
        assert g_.dtype == torch.float32 and g_.shape == w_.shape and bool(torch.isfinite(g_).all()), name
        gap, yard = _gap(g_, w_), _gap(l_, w_)
        assert gap <= chain[name] * U, (name, gap, chain[name] * U)
        assert gap <= 2 * yard + 2 * U, (name, gap, yard)


@pytest.mark.gpu
def test_repeat_calls_and_graph_replays_are_bitwise_on_gpu():
    """Each kernel's output is a fixed chain: two eager calls and two
    replays of a captured graph of all three give the same bits (the weight
    gradient's tickets reset themselves between calls)."""
    _card()
    x, w, b, dy, pad = (t.cuda() if torch.is_tensor(t) else t for t in _grid_case("conv1", "dense", seed=1))
    x, dy = _cl(x), _cl(dy)

    def run():
        return (tconv._fprop(x, w, b, (2, 2, 2), pad), tconv._dgrad(dy, x, w, (2, 2, 2), pad),
                *tconv._wgrad(dy, x, w, (2, 2, 2), pad, True))

    first, second = run(), run()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()  # the scratch is made outside the capture
        with torch.cuda.graph(graph, stream=stream):
            captured = run()
    torch.cuda.current_stream().wait_stream(stream)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([t.clone() for t in captured])
    for a, b_, c, d in zip(first, second, *replays):
        assert torch.equal(a, b_) and torch.equal(a, c) and torch.equal(a, d)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(REFUSED))
def test_unsupported_inputs_raise_on_gpu(case):
    """A 5-D CUDA convolution the kernels do not take raises, naming why:
    no fallback to cuDNN."""
    _card()
    x = _cl(torch.randn(2, 8, 8, 8, 8, device="cuda"))
    w = torch.randn(16, 8, 4, 4, 4, device="cuda")
    make, stride, words = REFUSED[case]
    bad_x, bad_w = make(x, w)
    with pytest.raises(ValueError, match=re.escape(words)):
        tconv.conv(bad_x, bad_w, None, stride, (1, 1, 1))


@pytest.mark.gpu
def test_a_card_conv_launches_one_kernel_a_call_on_gpu():
    """Forward and backward through ``conv`` on the card: each call adds one
    launch of its kind, as many as ``conv_calls`` counts."""
    _card()
    x, w, b, dy, pad = _grid_case("conv2", "dense")
    x = _cl(x.cuda()).requires_grad_()
    w, b = w.cuda().requires_grad_(), b.cuda().requires_grad_()
    calls, launches = dict(tconv.call_counts), dict(tconv.launch_counts)
    y = tconv.conv(x, w, b, (2, 2, 2), pad)
    assert y.is_contiguous(memory_format=torch.channels_last_3d)
    y.backward(_cl(dy.cuda()))
    added = {k.split("_")[1]: v - launches[k] for k, v in tconv.launch_counts.items()}
    assert added == {"fprop": 1, "dgrad": 1, "wgrad": 1}
    assert {k: v - calls[k] for k, v in tconv.call_counts.items()} == {
        "conv3d_fwd": 1, "conv3d_dgrad": 1, "conv3d_wgrad": 1}
