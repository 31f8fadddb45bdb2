"""Convolutions whose precision is the module's, not the process's.

A 3D convolution of f32 tensors on a card runs the port's own kernels
(``csrc/conv3d.cu``, built with nvcc at first use): one launch for the
forward (``conv3d_fprop_kernel``), one for the input gradient
(``conv3d_dgrad_kernel``) and one for the weight and bias gradients
(``conv3d_wgrad_kernel``), every product an f32 FFMA, the grids channels
last.  They take a ``[B, C, D, H, W]`` input with ``channels_last_3d``
strides, a ``[C_out, C_in, 4, 4, 4]`` weight, stride 2 on every axis (the
voxel encoder's convolution in every configuration), channels a multiple of
4; any other 5-D CUDA input raises (no fallback).  The output is channels last too, so the voxel encoder's
LayerNorm reads it without a copy.  CPU tensors run ``F.conv3d`` and
``aten.convolution_backward``: the plain version, which the tests hold the
kernels to.

1-D and 2-D convolutions (``models/cnn.py``) and the CPU path go through
cuDNN or ATen, which run a float32 convolution in TF32 unless
``torch.backends.cudnn.allow_tf32`` is off; that global flag is read when
each convolution runs, autograd's backward included.  ``conv`` therefore
sets it off for its forward and for its backward, so an f32 encoder
computes in f32 whatever the process's flags say.

``call_counts`` (the counter ``conv_calls`` of ``utils/trace.py``) counts
the 3D convolution calls by kind: ``conv`` adds a forward call, its
backward an input-gradient call and a weight-gradient call where it
computes them.  ``launch_counts`` (``conv3d_launches``) counts the kernels'
launches, one a call, so on a card the two agree where the main path went
through the kernels.  A captured update program takes both back and each
replay adds them again (``algorithms/graphs.py``), so the counts say what
ran on the card.  No span opens inside an encoder: the body of a captured
program never opens one (``utils/trace.py``), so a reader of a trace holds
the convolution kernels it finds to these counts instead.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils.trace import counter
from . import build

# 3D convolution calls in this process, by kind (a reader takes the
# difference of two reads).
call_counts = counter("conv_calls", ("conv3d_fwd", "conv3d_dgrad", "conv3d_wgrad"))

# The CUDA kernels' launches, by kind: one a call on a card.
launch_counts = counter("conv3d_launches", ("conv3d_fprop_launches", "conv3d_dgrad_launches",
                                            "conv3d_wgrad_launches"))

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_LIB_NAME = "conv3d"
_MAX_NUMEL = 2**30  # the kernels index the grids in 32 bits


def _f32():
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                       allow_tf32=False)


# ------------------------------------------------------------------ kernels
def load_library(verbose: bool = False) -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/conv3d.cu``."""
    lib = build.load_library(_LIB_NAME, verbose=verbose)
    if not getattr(lib, "_pcrl_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        geom = [ci] * 14  # B, D, H, W, Ci, Do, Ho, Wo, Co, k, s, pd, ph, pw
        lib.conv3d_fprop.argtypes = [vp, vp, vp, vp] + geom + [vp]
        lib.conv3d_fprop.restype = ci
        lib.conv3d_dgrad.argtypes = [vp, vp, vp] + geom + [vp]
        lib.conv3d_dgrad.restype = ci
        lib.conv3d_wgrad.argtypes = [vp] * 7 + geom + [ci, ci, vp]
        lib.conv3d_wgrad.restype = ci
        lib.conv3d_wgrad_plan.argtypes = [ci] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
        lib.conv3d_wgrad_plan.restype = ci
        lib.conv3d_error_string.argtypes = [ci]
        lib.conv3d_error_string.restype = ctypes.c_char_p
        lib._pcrl_bound = True
    return lib


def _geom(x: torch.Tensor, weight: torch.Tensor, stride, padding, out_shape) -> Tuple[int, ...]:
    B, c_in, D, H, W = x.shape
    c_out, Do, Ho, Wo = out_shape
    return (B, D, H, W, c_in, Do, Ho, Wo, c_out, weight.shape[-1], stride[0], *padding)


def _out_shape(x, weight, stride, padding):
    k, s = weight.shape[-1], stride[0]
    return (x.shape[0], weight.shape[0], *((n + 2 * p - k) // s + 1 for n, p in zip(x.shape[2:], padding)))


def kernel_refusal(x: torch.Tensor, weight: torch.Tensor, stride, padding) -> str:
    """Why the kernels do not take this 5-D CUDA convolution ('' when they do)."""
    if x.dtype != torch.float32 or weight.dtype != torch.float32:
        return f"dtype {x.dtype} / {weight.dtype}: the kernels are f32"
    if tuple(weight.shape[2:]) != (4, 4, 4):
        return f"kernel {tuple(weight.shape[2:])}: the kernels take (4, 4, 4)"
    if tuple(stride) != (2, 2, 2):
        return f"stride {tuple(stride)}: the kernels take 2 on every axis"
    if min(padding) < 0:
        return f"padding {tuple(padding)}"
    if x.shape[1] % 4 or weight.shape[0] % 4 or weight.shape[1] != x.shape[1]:
        return f"channels {x.shape[1]} -> {weight.shape[0]}: multiples of 4"
    if not x.is_contiguous(memory_format=torch.channels_last_3d):
        return f"input strides {x.stride()}: channels_last_3d"
    if not weight.is_contiguous():
        return "the weight is not contiguous"
    out = _out_shape(x, weight, stride, padding)
    if min(out[2:]) < 1 or max(x.numel(), weight.numel(), torch.Size(out).numel()) >= _MAX_NUMEL:
        return f"output {out}: empty, or a tensor of 2^30 elements or more"
    return ""


def _check(err: int, lib, name: str) -> None:
    if err == -1:
        raise ValueError(f"{name}: a shape the kernel does not take")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.conv3d_error_string(err).decode()} (cudaError {err})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _fprop(x, weight, bias, stride, padding):
    lib = load_library()
    out = torch.empty(_out_shape(x, weight, stride, padding), device=x.device, dtype=torch.float32,
                      memory_format=torch.channels_last_3d)
    with torch.cuda.device(x.device):
        err = lib.conv3d_fprop(x.data_ptr(), weight.data_ptr(), bias.data_ptr() if bias is not None else None,
                               out.data_ptr(), *_geom(x, weight, stride, padding, out.shape[1:]), _stream(x))
    _check(err, lib, "conv3d_fprop")
    launch_counts["conv3d_fprop_launches"] += 1
    return out


def _dgrad(grad, x, weight, stride, padding):
    lib = load_library()
    dx = torch.empty_like(x, memory_format=torch.channels_last_3d)
    with torch.cuda.device(x.device):
        err = lib.conv3d_dgrad(grad.data_ptr(), weight.data_ptr(), dx.data_ptr(),
                               *_geom(x, weight, stride, padding, grad.shape[1:]), _stream(x))
    _check(err, lib, "conv3d_dgrad")
    launch_counts["conv3d_dgrad_launches"] += 1
    return dx


# The weight gradient's scratch by (device, shape): its split-K partials and
# the tickets that find each tile's last CTA, zero between calls.  Made by
# the first call outside a capture; a call inside a capture that finds none
# makes its own in the graph's pool, which the graph keeps.
_scratch: Dict[tuple, tuple] = {}


def wgrad_plan(x, weight, grad) -> Dict[str, int]:
    """The weight gradient's split: ``tiles``, ``chunks`` (of at most 8192
    output sites), ``chunk_len`` and the scratch floats."""
    lib = load_library()
    out = (ctypes.c_longlong * 5)()
    B, c_in = x.shape[:2]
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    lib.conv3d_wgrad_plan(B, *grad.shape[2:], c_in, weight.shape[0], weight.shape[-1], sms, out)
    return dict(zip(("tiles", "chunks", "chunk_len", "part", "part_db"), out))


def _wgrad(grad, x, weight, stride, padding, with_bias):
    lib = load_library()
    key = (x.device, tuple(x.shape), tuple(weight.shape), tuple(stride), tuple(padding))
    scratch = _scratch.get(key)
    if scratch is None:
        plan = wgrad_plan(x, weight, grad)
        scratch = (plan, torch.empty(plan["part"], device=x.device), torch.empty(plan["part_db"], device=x.device),
                   torch.zeros(plan["tiles"], device=x.device, dtype=torch.int32))
        if not torch.cuda.is_current_stream_capturing():
            _scratch[key] = scratch
    plan, part, part_db, tickets = scratch
    dw = torch.empty_like(weight)
    db = torch.empty(weight.shape[0], device=x.device) if with_bias else None
    with torch.cuda.device(x.device):
        err = lib.conv3d_wgrad(x.data_ptr(), grad.data_ptr(), dw.data_ptr(), db.data_ptr() if with_bias else None,
                               part.data_ptr(), part_db.data_ptr(), tickets.data_ptr(),
                               *_geom(x, weight, stride, padding, grad.shape[1:]), plan["chunks"],
                               plan["chunk_len"], _stream(x))
    _check(err, lib, "conv3d_wgrad")
    launch_counts["conv3d_wgrad_launches"] += 1
    return dw, db


def _on_card(x: torch.Tensor) -> bool:
    return x.dim() == 5 and x.device.type == "cuda"


# -------------------------------------------------------------------- conv
class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, bias is not None)
        if _on_card(x):
            why = kernel_refusal(x, weight, stride, padding)
            if why:
                raise ValueError(f"conv3d on {x.device}: {why}")
            out = _fprop(x, weight, bias, stride, padding)
        else:
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
        wgrad = need[1] or (need[2] and has_bias)
        if _on_card(x):
            grad = grad.contiguous(memory_format=torch.channels_last_3d)
            gx = _dgrad(grad, x, weight, stride, padding) if need[0] else None
            gw, gb = _wgrad(grad, x, weight, stride, padding, has_bias) if wgrad else (None, None)
        else:
            with _f32():
                gx, gw, gb = torch.ops.aten.convolution_backward(
                    grad, x, weight, [weight.shape[0]] if has_bias else None, list(stride), list(padding),
                    [1] * len(stride), False, [0] * len(stride), 1, [need[0], need[1], need[2] and has_bias])
        if x.dim() == 5:
            call_counts["conv3d_dgrad"] += int(need[0])
            call_counts["conv3d_wgrad"] += int(wgrad)
        return gx, gw if need[1] else None, gb if need[2] else None, None, None


def conv(x: torch.Tensor, weight: torch.Tensor, bias, stride: Sequence[int], padding: Sequence[int]) -> torch.Tensor:
    """``F.conv{1,2,3}d(x, weight, bias, stride, padding)`` (channel-first
    x, torch weight layout ``[C_out, C_in, k...]``) in f32: the port's
    kernels for a 3D convolution on a card, cuDNN or ATen with TF32 off
    otherwise."""
    return _Conv.apply(x, weight, bias, tuple(stride), tuple(padding))
