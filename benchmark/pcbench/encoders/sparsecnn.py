"""SparseCNN: the reference encode of the paper's voxel encoder, its FLOPs,
the least time of each convolution call, and how its leaves are seeded.

This is the dense semantics of the repo's ``SparseCNN`` (the port's
``VoxelCNN`` with ``impl="dense"``, after the paper's SparseConvNet,
``pyrl/networks/backbones/sp_resnet.py``), written from its equations:

- a stem over every point: Dense, ReLU, Dense, LayerNorm, ReLU (in -> 32 -> 32);
- each cloud shifted by its own least corner, each point put in a voxel
  of ``VOXEL_SIZE`` of a ``GRID`` grid, coordinates clipped into the grid
  on every axis (a point past the far face lands in the last voxel);
- the mean stem feature of each voxel, 0 where it is empty;
- three strided Conv3d (kernel 4, stride 2, flax ``SAME`` padding: ``ceil(n /
  s)`` outputs, the low side padded by half the total), each followed by a
  LayerNorm (eps 1e-6) over its channels and a ReLU;
- the occupancy carried through the strides by a max-pool of the 0/1 grid;
- the max over the occupied sites of the last grid (0 where none is), then
  Dense and LayerNorm.

It is not torchsparse's semantics: the convolutions run over the whole
grid, so an empty site carries ``relu(LN(bias))``, and what its neighbours
spread into it, into the next convolution; only the final pool masks
empty sites out.

Every product follows ``precision``: the dense layers through
``reference.matmul``; the convolutions round their operands as it does
and run under ``torch.backends.cudnn.flags(allow_tf32=...)``, in the
forward and in the backward, so that the ``tf32`` control computes in
TF32 on a card and ``float32`` in IEEE f32 whatever the process's flags say.

``encode`` takes no shapes (the signature of every encoder here): the
voxel size, the grid and the stride are the configuration's
(``VOXEL_SIZE``, ``GRID``, ``STRIDE``; its ``shapes`` state the same, and
the benchmark's tests hold them equal), the widths and the kernel come
from the leaves.  ``encode_grid`` takes the three as arguments.

Leaves: ``visual.MLP_0.{Dense_0,Dense_1,LayerNorm_0}``,
``visual.Conv_{0,1,2}`` (``[out, in, k, k, k]``), ``visual.LayerNorm_{0,1,2}``,
``visual.Dense_0``, ``visual.LayerNorm_3``.  ``shapes`` keys read:
``points``, ``channels``, ``stem``, ``widths``, ``grid``, ``kernel``,
``stride``, ``feature``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..convs import KINDS
from ..flops import PEAK_BYTES, peak_flops
from ..reference import linear, round_operand

VOXEL_SIZE = 0.05  # m
GRID = (32, 32, 32)
STRIDE = 2
_EPS = 1e-6  # the stem's, every conv's and the final LayerNorm's epsilon
_F32 = 4  # bytes


# ------------------------------------------------------------------ the encode
def _cudnn_flags(precision: str):
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                       allow_tf32=precision == "tf32")


class _Conv3d(torch.autograd.Function):
    """``F.conv3d`` with its operands (and the backward's incoming gradient)
    rounded to ``precision``, under cuDNN's TF32 flag of that precision in
    the forward and in the backward."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, precision):
        qx, qw = round_operand(x, precision), round_operand(w, precision)
        ctx.save_for_backward(qx, qw)
        ctx.conf = (stride, padding, precision)
        with _cudnn_flags(precision):
            return F.conv3d(qx, qw, b, stride, padding)

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        stride, padding, precision = ctx.conf
        qg = round_operand(g.contiguous(), precision)
        need = ctx.needs_input_grad
        with _cudnn_flags(precision):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                qg, qx, qw, [qw.shape[0]], [stride] * 3, list(padding), [1, 1, 1], False, [0, 0, 0], 1,
                [need[0], need[1], need[2]])
        return gx, gw, gb, None, None, None


def same_padding(n: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax ``SAME`` along an axis of ``n``: (low, high)."""
    total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


def voxelize(xyz: torch.Tensor, feat: torch.Tensor, voxel_size: float,
             grid: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean of ``feat [R, N, C]`` per voxel, ``[R, X, Y, Z, C]`` (0 where
    empty), and the occupancy ``[R, X, Y, Z]``: each cloud shifted by its
    least corner, voxel coordinates floored and clipped into the grid."""
    R, N, C = feat.shape
    gx, gy, gz = (int(g) for g in grid)
    origin = xyz.detach().amin(dim=1, keepdim=True)
    coords = torch.floor((xyz - origin) / voxel_size).to(torch.int32)
    cx, cy, cz = (coords[..., i].clamp(0, g - 1).long() for i, g in enumerate((gx, gy, gz)))
    cells = gx * gy * gz
    flat = ((cx * gy + cy) * gz + cz) + cells * torch.arange(R, device=feat.device)[:, None]
    sums = feat.new_zeros((R * cells, C)).index_add_(0, flat.reshape(-1), feat.reshape(R * N, C))
    counts = feat.new_zeros((R * cells,)).index_add_(0, flat.reshape(-1), feat.new_ones((R * N,)))
    mean = sums / counts.clamp_min(1.0)[:, None]
    return mean.reshape(R, gx, gy, gz, C), (counts > 0).reshape(R, gx, gy, gz)


def encode_grid(P: Dict[str, torch.Tensor], pcd: torch.Tensor, precision: str, voxel_size: float,
                grid: Sequence[int], stride: int) -> torch.Tensor:
    """The feature of each cloud of ``pcd [R, N, C]`` (xyz first) on a
    ``grid`` of ``voxel_size`` voxels, convolved at ``stride``."""
    p = "visual."
    x = pcd.float()
    h = torch.relu(linear(x, P[p + "MLP_0.Dense_0.weight"], P[p + "MLP_0.Dense_0.bias"], precision))
    h = linear(h, P[p + "MLP_0.Dense_1.weight"], P[p + "MLP_0.Dense_1.bias"], precision)
    h = torch.relu(F.layer_norm(h, h.shape[-1:], P[p + "MLP_0.LayerNorm_0.weight"], P[p + "MLP_0.LayerNorm_0.bias"],
                                _EPS))
    g, occ = voxelize(x[..., :3], h, voxel_size, grid)
    g = g.permute(0, 4, 1, 2, 3).contiguous()  # [R, C, X, Y, Z]
    occ = occ[:, None].float()
    layers = sum(1 for k in P if k.startswith(p + "Conv_") and k.endswith(".weight"))
    for i in range(layers):
        w = P[f"{p}Conv_{i}.weight"]
        k = int(w.shape[-1])
        pads = [same_padding(int(n), k, stride) for n in g.shape[2:]]
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:  # odd sizes: one more on the high side
            flat = tuple(v for lo_hi in pads[::-1] for v in lo_hi)
            g, occ, padding = F.pad(g, flat), F.pad(occ, flat), (0, 0, 0)
        y = _Conv3d.apply(g, w, P[f"{p}Conv_{i}.bias"], stride, padding, precision)
        y = y.permute(0, 2, 3, 4, 1)  # the LayerNorm is over the channels
        y = torch.relu(F.layer_norm(y, y.shape[-1:], P[f"{p}LayerNorm_{i}.weight"], P[f"{p}LayerNorm_{i}.bias"], _EPS))
        g = y.permute(0, 4, 1, 2, 3).contiguous()
        occ = F.max_pool3d(occ, k, stride, padding)
    R, C = g.shape[:2]
    sites = g.reshape(R, C, -1)
    mask = occ.reshape(R, 1, -1) > 0
    pooled = torch.where(mask, sites, torch.finfo(sites.dtype).min).amax(dim=-1)
    pooled = torch.where(mask.any(dim=-1), pooled, torch.zeros((), dtype=pooled.dtype, device=pooled.device))
    f = linear(pooled, P[p + "Dense_0.weight"], P[p + "Dense_0.bias"], precision)
    last = f"{p}LayerNorm_{layers}."
    return F.layer_norm(f, f.shape[-1:], P[last + "weight"], P[last + "bias"], _EPS)


def encode(P: Dict[str, torch.Tensor], pcd: torch.Tensor, precision: str) -> torch.Tensor:
    """``encode_grid`` at the configuration's voxel size, grid and stride."""
    return encode_grid(P, pcd, precision, VOXEL_SIZE, GRID, STRIDE)


# ------------------------------------------------------------------ FLOPs and least times
def conv_layers(shapes: Dict) -> List[Dict[str, int]]:
    """Each convolution's input and output channels and sites (voxels of
    its input and output grids) and taps."""
    k, s = int(shapes["kernel"]), int(shapes["stride"])
    c_in, dims, out = int(shapes["stem"][-1]), [int(g) for g in shapes["grid"]], []
    for c_out in (int(w) for w in shapes["widths"]):
        nxt = [-(-n // s) for n in dims]
        out.append(dict(c_in=c_in, c_out=c_out, in_sites=math.prod(dims), out_sites=math.prod(nxt), taps=k**3))
        c_in, dims = c_out, nxt
    return out


def conv_flop(layer: Dict[str, int], rows: int) -> int:
    """One call's products over every output site and tap, padding included
    (the dense grid's): a forward, an input gradient or a weight gradient."""
    return 2 * rows * layer["out_sites"] * layer["c_out"] * layer["c_in"] * layer["taps"]


def _stem_dense(shapes: Dict) -> Tuple[int, int, int, int, int, int]:
    s1, s2 = (int(c) for c in shapes["stem"])
    return int(shapes["points"]), int(shapes["channels"]), s1, s2, int(shapes["widths"][-1]), int(shapes["feature"])


def forward_flops(shapes: Dict, rows: int) -> int:
    """The stem over every point, the three convolutions over the whole
    grid, the final dense layer."""
    N, C, s1, s2, c3, F_ = _stem_dense(shapes)
    convs = sum(conv_flop(layer, rows) for layer in conv_layers(shapes))
    return 2 * rows * N * (C * s1 + s1 * s2) + convs + 2 * rows * c3 * F_


def backward_flops(shapes: Dict, rows: int) -> int:
    """Each convolution's input and weight gradients (conv 0's input
    gradient too: the stem's leaves need it), the stem's (no gradient of
    the input cloud) and the final dense layer's."""
    N, C, s1, s2, c3, F_ = _stem_dense(shapes)
    convs = sum(2 * conv_flop(layer, rows) for layer in conv_layers(shapes))
    stem = 2 * rows * N * C * s1 + 2 * 2 * rows * N * s1 * s2
    return convs + stem + 2 * 2 * rows * c3 * F_


def conv_call_bytes(layer: Dict[str, int], rows: int, kind: str) -> int:
    """Bytes one call reads once and writes once, in f32: a forward reads
    the input grid, the kernel and the bias and writes the output grid; an
    input gradient reads the output's gradient and the kernel and writes
    the input's; a weight gradient reads the input grid and the output's
    gradient and writes the kernel's."""
    grid_in = rows * layer["in_sites"] * layer["c_in"]
    grid_out = rows * layer["out_sites"] * layer["c_out"]
    kernel = layer["c_out"] * layer["c_in"] * layer["taps"]
    n = {"fwd": grid_in + kernel + layer["c_out"] + grid_out, "dgrad": grid_out + kernel + grid_in,
         "wgrad": grid_in + grid_out + kernel}[kind]
    return _F32 * n


def least_ms(shapes: Dict, rows: int, precision: str = "float32") -> Dict[Tuple[int, str], float]:
    """The least ms of each convolution call at ``rows`` clouds, by (layer,
    kind): the larger of its products at the peak ``flops.bound_ms`` holds
    ``precision`` to (f32 as three TF32 products, so that an f32-exact
    tensor-core kernel cannot read over its roofline) and its bytes at HBM's."""
    out = {}
    for i, layer in enumerate(conv_layers(shapes)):
        for kind in KINDS:
            out[(i, kind)] = 1e3 * max(conv_flop(layer, rows) / peak_flops(precision),
                                       conv_call_bytes(layer, rows, kind) / PEAK_BYTES)
    return out


# ------------------------------------------------------------------ seeding
def is_norm(name: str) -> bool:
    return "LayerNorm" in name


def fan_in(name: str, shapes: Dict[str, Tuple[int, ...]]) -> int:
    """A kernel and its bias: its input width, times the taps for a
    convolution's ``[out, in, k, k, k]``."""
    kernel = shapes[name[: -len("bias")] + "weight"] if name.endswith(".bias") else shapes[name]
    return int(math.prod(kernel[1:]))
