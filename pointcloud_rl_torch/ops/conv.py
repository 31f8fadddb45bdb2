"""Convolutions whose precision is the module's, not the process's.

cuDNN runs a float32 convolution in TF32 unless
``torch.backends.cudnn.allow_tf32`` is off, and that global flag is read
when each convolution runs: autograd's backward reads it again, later and
outside any ``with`` block of the forward.  ``conv`` therefore sets the
flag for its forward and for its backward, so an f32 encoder computes in
f32 whatever the process's flags say.  On the CPU the flag has no effect.

``call_counts`` (the counter ``conv_calls`` of ``utils/trace.py``) counts
the 3D convolution calls by kind: ``conv`` adds a
forward call, its backward an input-gradient call and a weight-gradient
call where it computes them.  A captured update program takes its calls
back and each replay adds them again (``algorithms/graphs.py``), as for
the fused PointNet kernels' launches, so the counts say what ran on the
card.  No span opens inside an encoder: the body of a captured program
never opens one (``utils/trace.py``), so a reader of a trace holds the
convolution kernels it finds to these counts instead.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..utils.trace import counter

# 3D convolution calls in this process, by kind (a reader takes the
# difference of two reads).
call_counts = counter("conv_calls", ("conv3d_fwd", "conv3d_dgrad", "conv3d_wgrad"))

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _f32():
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                       allow_tf32=False)


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, bias is not None)
        with _f32():
            out = _CONV[x.dim() - 2](x, weight, bias, stride, padding)
        if x.dim() == 5:
            call_counts["conv3d_fwd"] += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, has_bias = ctx.conf
        need = ctx.needs_input_grad
        with _f32():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]] if has_bias else None, list(stride), list(padding),
                [1] * len(stride), False, [0] * len(stride), 1, [need[0], need[1], need[2] and has_bias])
        if x.dim() == 5:
            call_counts["conv3d_dgrad"] += int(need[0])
            call_counts["conv3d_wgrad"] += int(need[1])
        return gx, gw, gb, None, None


def conv(x: torch.Tensor, weight: torch.Tensor, bias, stride: Sequence[int], padding: Sequence[int]) -> torch.Tensor:
    """``F.conv{1,2,3}d(x, weight, bias, stride, padding)`` (channel-first
    x, torch weight layout ``[C_out, C_in, k...]``) in f32, TF32 off in the
    forward and in the backward."""
    return _Conv.apply(x, weight, bias, tuple(stride), tuple(padding))
