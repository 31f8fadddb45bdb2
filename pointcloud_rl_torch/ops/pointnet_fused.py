"""Fused PointNet body: a hand-written CUDA kernel plus the winner-gather backward.

Port of ``pointcloud_rl_tpu/ops/pointnet_fused.py``.  The body is the
shipped configs' per-point layer pattern (mlp_spec of 3, ignore_first_ln)
followed by the global max-pool::

    h1 = relu(x @ W1 + b1)                     # no LN on the first layer
    h2 = relu(LN(h1 @ W2 + b2))                # eps 1e-6
    h3 = relu(LN(h2 @ W3 + b3))
    out = max over points of h3

Weights are in the JAX layout, ``W [in, out]``; ``params`` is the 10-tuple
``(w1, b1, w2, b2, g2, be2, w3, b3, g3, be3)``.

Dispatch has no fallback.  A CPU tensor runs the plain PyTorch version
(``_forward_plain``, a faithful port of ``_body_rows`` and the first-index
``_tile_max_argmax``); a CUDA tensor launches the kernel in
``csrc/pointnet_fused.cu`` (built with nvcc at first use) or raises.  The
plain version is the kernel's oracle in the tests on the card.

In bf16 (where its weights fit in shared memory) the kernel is persistent:
``choose_runs`` cuts the (batch row, 64-point tile) pairs into one run of
consecutive pairs per CTA.  Otherwise (f32, and bf16 too wide for it) it
splits the point axis into chunks (``choose_chunks``), one CTA per (batch
row, chunk).  A second launch merges the partial (max, first index) of
each row; the wrapper allocates the scratch that holds the prepared
weights and the partials.

Backward: the max-pool routes each output channel's gradient through ONE
winner point (the first-index argmax, torch ``max`` semantics), so
``FusedPointNetBody`` saves the winner indices, gathers the [B, C_out]
winner rows, recomputes the body on them in f32 and walks relu -> LN ->
matmul back to dx and the ten parameter gradients.  A CPU tensor runs
``_winner_backward`` (plain PyTorch ops as in the JAX package, and the
kernel's oracle); a CUDA tensor launches the winner-backward kernel of the
same source (``_winner_backward_kernel``: every per-row value stays on the
SM, the parameter gradients are summed per CTA and reduced in a fixed
order) or raises, and computes dx only when autograd asks for it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from ..utils.trace import counter
from . import build

_LN_EPS = 1e-6
_BIG_I32 = 2**30
_LIB_NAME = "pointnet_fused"

# Kernel launches per entry point in this process.  Each wrapper adds one
# where it launches its kernel and nowhere else.
launch_counts = counter("launches", ("pointnet_fused_fwd_idx", "pointnet_fused_fwd_max"))

# The backward kernel's launches, apart: readers of ``launch_counts`` hold
# its total to the forward launches they find in a trace.
bwd_launch_counts = counter("bwd_launches", ("pointnet_fused_bwd",))


# ------------------------------------------------------------ plain version
def _ln_f32(a, gamma, beta):
    mu = a.mean(dim=-1, keepdim=True)
    var = ((a - mu) ** 2).mean(dim=-1, keepdim=True)
    return (a - mu) * torch.rsqrt(var + _LN_EPS) * gamma + beta


def _body_rows(x, params, compute_dtype: Optional[torch.dtype]):
    """The 3-layer body on [rows, C_in] -> [rows, C_out].

    With ``compute_dtype=torch.bfloat16`` the rounding follows the JAX
    mixed-precision policy: matmul inputs are rounded to bf16 and accumulate
    in f32 (the exact bf16 products summed in f32), each layer's activation
    is stored bf16, and LayerNorm runs in f32.  Output dtype is
    ``compute_dtype`` (f32 when None)."""
    (w1, b1, w2, b2, g2, be2, w3, b3, g3, be3) = params
    if compute_dtype is None:
        x = x.float()
        h1 = torch.relu(x @ w1 + b1)
        h2 = torch.relu(_ln_f32(h1 @ w2 + b2, g2, be2))
        return torch.relu(_ln_f32(h2 @ w3 + b3, g3, be3))
    c = compute_dtype

    def dot(a, b):
        return a.to(c).float() @ b.to(c).float()

    h1 = torch.relu(dot(x, w1) + b1).to(c)
    h2 = torch.relu(_ln_f32(dot(h1, w2) + b2, g2, be2)).to(c)
    return torch.relu(_ln_f32(dot(h2, w3) + b3, g3, be3)).to(c)


def _tile_max_argmax(h3):
    """Max + FIRST-index argmax over the point axis of [B, N, C]."""
    m = h3.max(dim=1).values
    eq = h3 >= m[:, None, :]
    iota = torch.arange(h3.shape[1], device=h3.device, dtype=torch.int32)[None, :, None]
    idx = torch.where(eq, iota, torch.full_like(iota, _BIG_I32)).min(dim=1).values
    return m, idx


def _forward_plain(x, params, compute_dtype, with_idx: bool = True):
    B, N, C_in = x.shape
    h3 = _body_rows(x.reshape(B * N, C_in), params, compute_dtype).reshape(B, N, -1)
    if not with_idx:
        return h3.max(dim=1).values.float(), None
    m, idx = _tile_max_argmax(h3)
    return m.float(), idx


# ------------------------------------------------------------------ kernel
def load_library(verbose: bool = False) -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/pointnet_fused.cu``."""
    lib = build.load_library(_LIB_NAME, verbose=verbose)
    if not getattr(lib, "_pcrl_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        common = [ci, vp, ci, ci, ci, vp, vp, ci, vp, vp, vp, vp, ci, vp, vp, vp, vp, ci, ci, ci, vp, vp]
        lib.pointnet_fused_fwd_idx.argtypes = common + [vp, vp]
        lib.pointnet_fused_fwd_idx.restype = ci
        lib.pointnet_fused_fwd_max.argtypes = common + [vp]
        lib.pointnet_fused_fwd_max.restype = ci
        lib.pointnet_fused_tile_rows.argtypes = [ci] * 5
        lib.pointnet_fused_tile_rows.restype = ci
        lib.pointnet_fused_persistent.argtypes = [ci] * 5
        lib.pointnet_fused_persistent.restype = ci
        lib.pointnet_fused_scratch_bytes.argtypes = [ci] * 9
        lib.pointnet_fused_scratch_bytes.restype = ctypes.c_longlong
        lib.pointnet_fused_bwd.argtypes = [ci, vp, ci, ci, ci, vp, vp, vp, vp, ci, vp, vp, vp, vp, ci,
                                           vp, vp, vp, vp, ci, ci, ci, vp, vp, vp, vp]
        lib.pointnet_fused_bwd.restype = ci
        lib.pointnet_fused_bwd_tile_rows.argtypes = [ci] * 4
        lib.pointnet_fused_bwd_tile_rows.restype = ci
        lib.pointnet_fused_bwd_scratch_bytes.argtypes = [ci] * 7
        lib.pointnet_fused_bwd_scratch_bytes.restype = ctypes.c_longlong
        lib.pointnet_fused_error_string.argtypes = [ci]
        lib.pointnet_fused_error_string.restype = ctypes.c_char_p
        lib._pcrl_bound = True
    return lib


def _check(t: torch.Tensor, name: str, device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _kernel_inputs(x, params, compute_dtype):
    """Check what the kernel takes and cast x and W1..W3 to the compute
    dtype; raises on anything else.  Returns (dtype, x, params)."""
    dtype = compute_dtype or torch.float32
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported compute dtype {dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, C_in], got shape {tuple(x.shape)}")
    # As the TPU wrapper does: the matmul input enters in the compute dtype.
    if x.dtype != dtype:
        x = x.to(dtype)
    B, N, c_in = x.shape
    (w1, b1, w2, b2, g2, be2, w3, b3, g3, be3) = params
    c1, c2, c3 = w1.shape[-1], w2.shape[-1], w3.shape[-1]
    if B < 1 or N < 1:
        raise ValueError(f"unsupported shape: x {tuple(x.shape)}")
    dev = x.device
    _check(x, "x", dev, dtype, (B, N, c_in))
    f32 = torch.float32
    for name, t, shape in (("w1", w1, (c_in, c1)), ("w2", w2, (c1, c2)), ("w3", w3, (c2, c3))):
        _check(t, name, dev, f32, shape)
    for name, t, n in (("b1", b1, c1), ("b2", b2, c2), ("g2", g2, c2), ("be2", be2, c2),
                       ("b3", b3, c3), ("g3", g3, c3), ("be3", be3, c3)):
        _check(t, name, dev, f32, (n,))
    if dtype == torch.bfloat16:
        w1, w2, w3 = (w.to(torch.bfloat16) for w in (w1, w2, w3))
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel copies x in aligned 4-byte words
    return dtype, x, (w1, b1, w2, b2, g2, be2, w3, b3, g3, be3)


def choose_chunks(B: int, N: int, tile_rows: int, n_sm: int) -> int:
    """Point chunks per batch row: the count that minimises (waves of
    B * chunks CTAs over the SMs) x (tiles per CTA), the fewest on ties.
    No chunk is left empty."""
    n_tiles = -(-N // tile_rows)
    best_cost, best = None, 1
    for want in range(1, n_tiles + 1):
        per_chunk = -(-n_tiles // want)
        chunks = -(-n_tiles // per_chunk)
        cost = -(-B * chunks // n_sm) * per_chunk
        if best_cost is None or cost < best_cost:
            best_cost, best = cost, chunks
    return best


# Points of a partial of the persistent body at most: its keys hold a
# point's index inside the partial in 16 bits.
MAX_RUN_POINTS = 65536


def choose_runs(B: int, N: int, tile_rows: int, n_sm: int) -> Tuple[int, int]:
    """(CTAs, tiles per CTA) of the persistent body: the B * ceil(N /
    tile_rows) (batch row, tile) pairs in row-major order, cut into runs of
    ``per`` consecutive pairs, one run a CTA.  ``per`` is the least that
    keeps the CTAs within one wave of ``n_sm`` (one CTA an SM), and no more
    tiles than MAX_RUN_POINTS hold.  The kernel runs this split as given."""
    total = B * -(-N // tile_rows)
    per = min(-(-total // n_sm), MAX_RUN_POINTS // tile_rows)
    return -(-total // per), per


def choose_bwd_ctas(rows: int, tile_rows: int, n_sm: int) -> Tuple[int, int]:
    """(CTAs, tiles per CTA) of the winner backward: the least number of
    tiles per CTA when the tiles of ``rows`` winner rows are shared over
    ``n_sm`` SMs, and the fewest CTAs that take them at that number (fewer
    CTAs, fewer partial sums to reduce).  The kernel runs this split as
    given and sizes nothing by another."""
    tiles = -(-rows // tile_rows)
    per = -(-tiles // n_sm)
    return -(-tiles // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _forward_kernel(x, params, compute_dtype, with_idx: bool):
    """Launch the CUDA kernel on ``x`` [B, N, C_in] (a CUDA tensor)."""
    dtype, x, params = _kernel_inputs(x, params, compute_dtype)
    (w1, b1, w2, b2, g2, be2, w3, b3, g3, be3) = params
    B, N, c_in = x.shape
    c1, c2, c3 = w1.shape[-1], w2.shape[-1], w3.shape[-1]
    dev, f32 = x.device, torch.float32

    lib = load_library()
    bf16 = int(dtype == torch.bfloat16)
    tile_rows = lib.pointnet_fused_tile_rows(bf16, c_in, c1, c2, c3)
    if tile_rows <= 0:
        raise ValueError(f"unsupported shape: C_in {c_in}, widths {c1}/{c2}/{c3} in {dtype} "
                         "(the kernel takes widths 1..256 whose tiles fit in shared memory)")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if lib.pointnet_fused_persistent(bf16, c_in, c1, c2, c3):
        chunks, per = choose_runs(B, N, tile_rows, _sm_count(index))
    else:
        chunks, per = choose_chunks(B, N, tile_rows, _sm_count(index)), 0
    scratch = torch.empty(lib.pointnet_fused_scratch_bytes(bf16, c_in, c1, c2, c3, B, N, chunks, per),
                          device=dev, dtype=torch.uint8)
    pooled = torch.empty((B, c3), device=dev, dtype=f32)
    idx = torch.empty((B, c3), device=dev, dtype=torch.int32) if with_idx else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = [bf16, x.data_ptr(), B, N, c_in,
                w1.data_ptr(), b1.data_ptr(), c1, w2.data_ptr(), b2.data_ptr(), g2.data_ptr(),
                be2.data_ptr(), c2, w3.data_ptr(), b3.data_ptr(), g3.data_ptr(), be3.data_ptr(), c3,
                chunks, per, scratch.data_ptr(), pooled.data_ptr()]
        if with_idx:
            name = "pointnet_fused_fwd_idx"
            err = lib.pointnet_fused_fwd_idx(*args, idx.data_ptr(), stream)
        else:
            name = "pointnet_fused_fwd_max"
            err = lib.pointnet_fused_fwd_max(*args, stream)
    if err != 0:
        msg = lib.pointnet_fused_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")
    launch_counts[name] += 1
    return pooled, idx


def pointnet_fused_forward(x, params: Sequence[torch.Tensor], compute_dtype=None,
                           with_idx: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pooled [B, C_out] f32 (and int32 winner indices when ``with_idx``).

    A CPU tensor runs the plain version, a CUDA tensor the kernel; any other
    device raises."""
    if x.device.type == "cpu":
        return _forward_plain(x, params, compute_dtype, with_idx)
    if x.device.type == "cuda":
        return _forward_kernel(x, params, compute_dtype, with_idx)
    raise NotImplementedError(f"fused PointNet body has no implementation for device {x.device}")


# ---------------------------------------------------------------- backward
def _ln_bwd(dn, xhat, rstd, gamma):
    dy = dn * gamma
    return rstd * (dy - dy.mean(dim=-1, keepdim=True)
                   - xhat * (dy * xhat).mean(dim=-1, keepdim=True))


def _winner_backward(x, params, idx, g, dtype=torch.float32):
    """Gradient via the winner rows only.

    x: [B, N, C_in]; idx: [B, K] winner point per output channel (K ==
    C_out); g: [B, K] pooled-output cotangent.  All math in ``dtype``: f32,
    as the JAX package; float64 is the tests' exact reference."""
    (w1, b1, w2, b2, g2, be2, w3, b3, g3, be3) = (p.to(dtype) for p in params)
    B, N, C_in = x.shape
    K = idx.shape[-1]
    g = g.to(dtype)
    idx = idx.long()
    batch = torch.arange(B, device=x.device)[:, None]
    rows = x.reshape(B * N, C_in)[(batch * N + idx).reshape(-1)].to(dtype)  # [B*K, C_in]

    # recompute the chain on winner rows, keeping residuals (f32)
    a1 = rows @ w1 + b1
    h1 = torch.relu(a1)
    a2 = h1 @ w2 + b2
    mu2 = a2.mean(dim=-1, keepdim=True)
    rstd2 = torch.rsqrt(((a2 - mu2) ** 2).mean(dim=-1, keepdim=True) + _LN_EPS)
    xhat2 = (a2 - mu2) * rstd2
    n2 = xhat2 * g2 + be2
    h2 = torch.relu(n2)
    a3 = h2 @ w3 + b3
    mu3 = a3.mean(dim=-1, keepdim=True)
    rstd3 = torch.rsqrt(((a3 - mu3) ** 2).mean(dim=-1, keepdim=True) + _LN_EPS)
    xhat3 = (a3 - mu3) * rstd3
    n3 = xhat3 * g3 + be3

    # dh3 for winner row k is g[b, k] on channel k only
    eye = torch.eye(K, device=x.device, dtype=dtype)
    dh3 = (g[:, :, None] * eye[None]).reshape(B * K, K)

    dn3 = dh3 * (n3 > 0)
    da3 = _ln_bwd(dn3, xhat3, rstd3, g3)
    dn2 = (da3 @ w3.T) * (n2 > 0)
    da2 = _ln_bwd(dn2, xhat2, rstd2, g2)
    da1 = (da2 @ w2.T) * (a1 > 0)
    dxw = (da1 @ w1.T).reshape(B, K, C_in)

    dx = torch.zeros_like(x)
    dx.index_put_((batch.expand(B, K), idx), dxw.to(x.dtype), accumulate=True)
    dparams = (
        rows.T @ da1, da1.sum(dim=0),
        h1.T @ da2, da2.sum(dim=0), (dn2 * xhat2).sum(dim=0), dn2.sum(dim=0),
        h2.T @ da3, da3.sum(dim=0), (dn3 * xhat3).sum(dim=0), dn3.sum(dim=0),
    )
    return dx, dparams


def _winner_backward_kernel(x, params, idx, g, with_dx: bool):
    """``_winner_backward`` on CUDA tensors, by the winner-backward kernel;
    dx only ``with_dx`` (else None).  Raises on what the kernel does not take."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x has dtype {x.dtype}; the winner backward takes float32 or bfloat16")
    x = x.contiguous()
    B, N, c_in = x.shape
    (w1, b1, w2, b2, g2, be2, w3, b3, g3, be3) = params
    c1, c2, c3 = w1.shape[-1], w2.shape[-1], w3.shape[-1]
    dev, f32 = x.device, torch.float32
    for name, t, shape in (("w1", w1, (c_in, c1)), ("w2", w2, (c1, c2)), ("w3", w3, (c2, c3))):
        _check(t, name, dev, f32, shape)
    for name, t, n in (("b1", b1, c1), ("b2", b2, c2), ("g2", g2, c2), ("be2", be2, c2),
                       ("b3", b3, c3), ("g3", g3, c3), ("be3", be3, c3)):
        _check(t, name, dev, f32, (n,))
    _check(idx, "idx", dev, torch.int32, (B, c3))
    g = g.to(f32).contiguous()
    _check(g, "g", dev, f32, (B, c3))

    lib = load_library()
    tile_rows = lib.pointnet_fused_bwd_tile_rows(c_in, c1, c2, c3)
    if tile_rows <= 0:
        raise ValueError(f"unsupported shape: C_in {c_in}, widths {c1}/{c2}/{c3} "
                         "(the winner backward takes widths 1..256)")
    rows = B * c3
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    ctas, per = choose_bwd_ctas(rows, tile_rows, _sm_count(index))
    scratch = torch.empty(lib.pointnet_fused_bwd_scratch_bytes(c_in, c1, c2, c3, ctas, rows, int(with_dx)),
                          device=dev, dtype=torch.uint8)
    sizes = [p.numel() for p in params]
    grads = torch.empty(sum(sizes), device=dev, dtype=f32)  # the kernel packs the ten in order
    dx = torch.zeros((B, N, c_in), device=dev, dtype=f32) if with_dx else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pointnet_fused_bwd(int(x.dtype == torch.bfloat16), x.data_ptr(), B, N, c_in, idx.data_ptr(),
                                     g.data_ptr(), w1.data_ptr(), b1.data_ptr(), c1, w2.data_ptr(), b2.data_ptr(),
                                     g2.data_ptr(), be2.data_ptr(), c2, w3.data_ptr(), b3.data_ptr(),
                                     g3.data_ptr(), be3.data_ptr(), c3, ctas, per, scratch.data_ptr(),
                                     grads.data_ptr(), None if dx is None else dx.data_ptr(), stream)
    if err != 0:
        msg = lib.pointnet_fused_error_string(err).decode()
        raise RuntimeError(f"pointnet_fused_bwd launch failed: {msg} (cudaError {err})")
    bwd_launch_counts["pointnet_fused_bwd"] += 1
    dparams = tuple(d.view(p.shape) for d, p in zip(grads.split(sizes), params))
    return (None if dx is None else dx.to(x.dtype)), dparams


class FusedPointNetBody(torch.autograd.Function):
    """Pooled body with the winner-gather backward.

    The forward launches the with-argmax kernel (plain version on CPU) and
    saves the winner indices; the backward is the winner-backward kernel on
    CUDA tensors and ``_winner_backward`` on any other."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, g2, be2, w3, b3, g3, be3, compute_dtype=None):
        params = (w1, b1, w2, b2, g2, be2, w3, b3, g3, be3)
        pooled, idx = pointnet_fused_forward(x, params, compute_dtype, with_idx=True)
        ctx.save_for_backward(x, idx, *params)
        return pooled

    @staticmethod
    def backward(ctx, g):
        x, idx, *params = ctx.saved_tensors
        if x.device.type == "cuda":
            dx, dparams = _winner_backward_kernel(x, params, idx, g, ctx.needs_input_grad[0])
        else:
            dx, dparams = _winner_backward(x, params, idx, g)
        return (dx if ctx.needs_input_grad[0] else None, *dparams, None)


def fused_pointnet_body(x, params: Sequence[torch.Tensor], compute_dtype=None) -> torch.Tensor:
    """x: [B, N, C_in]; params: the 10-tuple.  Returns [B, C_out] f32.

    When autograd needs a gradient this runs ``FusedPointNetBody`` (the
    with-argmax kernel); otherwise the max-only kernel."""
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        return FusedPointNetBody.apply(x, *params, compute_dtype)
    pooled, _ = pointnet_fused_forward(x, params, compute_dtype, with_idx=False)
    return pooled
