"""Convolutions whose precision is the module's, not the process's.

cuDNN runs a float32 convolution in TF32 unless
``torch.backends.cudnn.allow_tf32`` is off, and that global flag is read
when each convolution runs: autograd's backward reads it again, later and
outside any ``with`` block of the forward.  ``conv`` therefore sets the
flag for its forward and for its backward, so an f32 encoder computes in
f32 whatever the process's flags say.  ``ALLOW_TF32`` is the setting; it is
False, and ``tools/profile_torch_slice.py`` flips it only to time the TF32
variant.  On the CPU the flag has no effect.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

ALLOW_TF32 = False

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _flags(allow_tf32: bool):
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                       allow_tf32=allow_tf32)


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, allow_tf32):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, allow_tf32, bias is not None)
        with _flags(allow_tf32):
            return _CONV[x.dim() - 2](x, weight, bias, stride, padding)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, allow_tf32, has_bias = ctx.conf
        need = ctx.needs_input_grad
        with _flags(allow_tf32):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]] if has_bias else None, list(stride), list(padding),
                [1] * len(stride), False, [0] * len(stride), 1, [need[0], need[1], need[2] and has_bias])
        return gx, gw, gb, None, None, None


def conv(x: torch.Tensor, weight: torch.Tensor, bias, stride: Sequence[int], padding: Sequence[int]) -> torch.Tensor:
    """``F.conv{1,2,3}d(x, weight, bias, stride, padding)`` (channel-first
    x, torch weight layout ``[C_out, C_in, k...]``) at the precision of
    ``ALLOW_TF32``, in the forward and in the backward."""
    return _Conv.apply(x, weight, bias, tuple(stride), tuple(padding), ALLOW_TF32)
