"""The port's fused PointNet body against the JAX package's.

The same numpy inputs go through ``pointcloud_rl_tpu.ops.pointnet_fused``
(its XLA path, as the JAX package's own CPU tests run it) and
``pointcloud_rl_torch.ops.pointnet_fused`` (the plain PyTorch version,
which the wrapper takes for CPU tensors).  The CUDA kernel itself is held
against the plain version on the card (``gpu``-marked tests here, and
``chip_smoke.py``).  The card's machine has no JAX, so JAX is imported
inside the tests that compare with it; there the ``gpu`` tests run as
``python -m pytest --noconftest -m gpu tests/test_torch_pointnet_fused.py``.
"""

import numpy as np
import pytest
import torch

from pointcloud_rl_torch.ops import pointnet_fused as tpf

torch.set_num_threads(1)

# f32: the two frameworks sum each dot product in another order; 1e-5 is
# the JAX package's own fused-vs-reference bound (tests/test_pallas_ops.py:45).
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16: h1/h2/h3 are rounded to bf16 (8 mantissa bits) on both sides, and a
# different f32 sum order can land an element one bf16 step (2^-8 relative)
# away; LayerNorm carries that into the next layer.  Three steps' worth.
BF16_TOL = dict(rtol=1.2e-2, atol=1.2e-2)
# Gradients: f32 recompute on the winner rows, as tests/test_pallas_ops.py:62.
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(seed, B, N, c_in, widths=(32, 64, 128)):
    rs = np.random.RandomState(seed)
    c1, c2, c3 = widths
    x = rs.randn(B, N, c_in).astype(np.float32)
    params = [
        rs.randn(c_in, c1) * 0.3, rs.randn(c1) * 0.05,
        rs.randn(c1, c2) * 0.15, rs.randn(c2) * 0.05, 1 + 0.1 * rs.randn(c2), 0.1 * rs.randn(c2),
        rs.randn(c2, c3) * 0.1, rs.randn(c3) * 0.05, 1 + 0.1 * rs.randn(c3), 0.1 * rs.randn(c3),
    ]
    return x, [p.astype(np.float32) for p in params]


def _jax():
    import jax
    import jax.numpy as jnp

    from pointcloud_rl_tpu.ops import pointnet_fused as jpf

    return jax, jnp, jpf


def _jax_forward(x, params, compute_dtype):
    _, jnp, jpf = _jax()
    return jpf._forward_xla(jnp.asarray(x), tuple(jnp.asarray(p) for p in params), compute_dtype)


def _torch_forward(x, params, compute_dtype, with_idx=True):
    return tpf.pointnet_fused_forward(torch.from_numpy(x), tuple(torch.from_numpy(p) for p in params),
                                      compute_dtype, with_idx=with_idx)


def _clear_winner(h3, gap=1e-4):
    """[B, C] mask of channels whose max beats every other point by > gap."""
    top2 = np.sort(h3, axis=1)[:, -2:, :]
    return (top2[:, 1] - top2[:, 0]) > gap


@pytest.mark.parametrize("shape", [(4, 300, 9), (2, 200, 8)], ids=["4x300x9", "2x200x8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_matches_jax(shape, dtype):
    _, jnp, jpf = _jax()
    B, N, c_in = shape
    x, params = _inputs(0, B, N, c_in)
    jdt, tdt = (None, None) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    j_pooled, j_idx = _jax_forward(x, params, jdt)
    t_pooled, t_idx = _torch_forward(x, params, tdt)
    assert t_pooled.dtype == torch.float32 and t_idx.dtype == torch.int32
    assert tuple(t_pooled.shape) == (B, 128) and tuple(t_idx.shape) == (B, 128)
    np.testing.assert_allclose(t_pooled.numpy(), np.asarray(j_pooled), **tol)

    # Winner indices agree exactly wherever the max is not a near-tie.
    h3 = np.asarray(jpf._body_rows(jnp.asarray(x.reshape(B * N, c_in)),
                                   tuple(jnp.asarray(p) for p in params), jdt),
                    np.float32).reshape(B, N, -1)
    clear = _clear_winner(h3, gap=1e-4 if dtype == "float32" else 3e-2)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(t_idx.numpy()[clear], np.asarray(j_idx)[clear])

    # The max-only entry point gives the same pooled values.
    t_max, none = _torch_forward(x, params, tdt, with_idx=False)
    assert none is None
    np.testing.assert_array_equal(t_max.numpy(), t_pooled.numpy())


def test_duplicated_points_take_the_first_index():
    """Three copies of the same 10 points: every winner is a first copy,
    as the TPU kernel's strict ``>`` running max keeps it."""
    x, params = _inputs(1, 2, 10, 9)
    x = np.concatenate([x, x, x], axis=1)  # [2, 30, 9]
    t_pooled, t_idx = _torch_forward(x, params, None)
    j_pooled, j_idx = _jax_forward(x, params, None)
    assert int(t_idx.max()) < 10
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_pooled.numpy(), np.asarray(j_pooled), **F32_TOL)


def test_fused_body_gradients_match_jax_custom_vjp():
    jax, jnp, jpf = _jax()
    x, params = _inputs(2, 2, 200, 9)

    def jax_loss(x_, p_):
        return (jpf.fused_pointnet_body(x_, tuple(p_), 128) ** 2).sum()

    jgrads = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), [jnp.asarray(p) for p in params])
    jflat = [jgrads[0]] + list(jgrads[1])

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in [x] + params]
    out = tpf.fused_pointnet_body(leaves[0], tuple(leaves[1:]))
    (out ** 2).sum().backward()
    names = ["dx", "dw1", "db1", "dw2", "db2", "dg2", "dbe2", "dw3", "db3", "dg3", "dbe3"]
    for name, leaf, ref in zip(names, leaves, jflat):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), err_msg=name, **GRAD_TOL)


def test_dispatch_takes_the_max_only_path_without_autograd(monkeypatch):
    """No gradient needed -> the max-only forward; otherwise the autograd
    Function with the argmax forward.  Other devices raise."""
    x, params = _inputs(3, 2, 50, 9)
    calls = []
    orig = tpf.pointnet_fused_forward

    def spy(x_, p_, cdt=None, with_idx=True):
        calls.append(with_idx)
        return orig(x_, p_, cdt, with_idx=with_idx)

    monkeypatch.setattr(tpf, "pointnet_fused_forward", spy)
    tx, tp = torch.from_numpy(x), tuple(torch.from_numpy(p) for p in params)
    with torch.no_grad():
        tpf.fused_pointnet_body(tx, tuple(p.requires_grad_(True) for p in tp))
    tpf.fused_pointnet_body(tx, tp)
    assert calls == [False, True]
    with pytest.raises(NotImplementedError):
        orig(tx.to("meta"), tuple(p.detach().to("meta") for p in tp))


def test_cpu_tensors_never_launch_the_kernel():
    tpf.reset_launch_counts()
    x, params = _inputs(4, 2, 40, 9)
    _torch_forward(x, params, None)
    _torch_forward(x, params, None, with_idx=False)
    assert tpf.launch_counts == {"pointnet_fused_fwd_idx": 0, "pointnet_fused_fwd_max": 0}


def test_library_path_changes_with_the_source(tmp_path, monkeypatch):
    """An edited source gets a new library name, so a stale build is never loaded."""
    from pointcloud_rl_torch.ops import build

    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path("k")
    src.write_text("// v2\n")
    second = build.library_path("k")
    assert first != second and first.parent == build.BUILD_DIR and first.name.startswith("libk_")


@pytest.mark.parametrize("B, N, tile, chunks", [
    (256, 1200, 128, 1), (4, 1200, 128, 10), (1, 1, 128, 1), (3, 1201, 64, 19), (64, 1200, 128, 2)])
def test_chunk_count_fills_the_card(B, N, tile, chunks):
    """Many chunks per row at act batch sizes, one at the update's B=256,
    and never an empty chunk (132 SMs, one CTA each)."""
    got = tpf.choose_chunks(B, N, tile, 132)
    assert got == chunks
    n_tiles = -(-N // tile)
    per_chunk = -(-n_tiles // got)
    assert (got - 1) * per_chunk < n_tiles <= got * per_chunk


# ------------------------------------------------------------ on the card
# (name, B, N, C_in, widths): the main path's shapes (the update's encodes,
# the act encode at 4 env workers), then edges: a single chunk, one point,
# ragged tails, widths that are no multiple of 16 or 64, and widths narrow
# enough that f32 weights stay in shared memory (bf16 weights always do here).
GPU_SHAPES = [
    ("slice", 8, 1200, 8, (128, 128, 256)),
    ("act", 4, 1200, 8, (128, 128, 256)),
    ("walker", 8, 1536, 9, (64, 128, 256)),
    ("b1_n1", 1, 1, 8, (128, 128, 256)),
    ("b1_n63", 1, 63, 9, (64, 128, 256)),
    ("n1201", 2, 1201, 8, (128, 128, 256)),
    ("odd_widths", 3, 300, 8, (40, 72, 200)),
    ("narrow", 2, 100, 8, (32, 64, 128)),  # f32 weights resident in shared memory too
]


def _gpu_inputs(seed, B, N, c_in, widths):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    x, params = _inputs(seed, B, N, c_in, widths=widths)
    return torch.from_numpy(x).cuda(), tuple(torch.from_numpy(p).cuda() for p in params)


@pytest.mark.gpu
@pytest.mark.parametrize("name, B, N, c_in, widths", GPU_SHAPES, ids=[s[0] for s in GPU_SHAPES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_gpu(dtype, name, B, N, c_in, widths):
    tx, tp = _gpu_inputs(5, B, N, c_in, widths)
    tdt = None if dtype == "float32" else torch.bfloat16
    got, idx = tpf._forward_kernel(tx, tp, tdt, with_idx=True)
    got_max, _ = tpf._forward_kernel(tx, tp, tdt, with_idx=False)
    want, _ = tpf._forward_plain(tx, tp, tdt, with_idx=True)
    torch.cuda.synchronize()
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=2e-2, atol=3e-2)
    torch.testing.assert_close(got, want, **tol)
    torch.testing.assert_close(got_max, got, rtol=0, atol=0)
    assert int(idx.min()) >= 0 and int(idx.max()) < N
    h3 = tpf._body_rows(tx.reshape(B * N, c_in), tp, tdt).reshape(B, N, -1).float()
    at_winner = torch.gather(h3, 1, idx.long()[:, None, :])[:, 0, :]
    torch.testing.assert_close(at_winner, want, **tol)
    # Repeated calls are bitwise equal (no atomics, fixed merge order).
    again, idx_again = tpf._forward_kernel(tx, tp, tdt, with_idx=True)
    assert torch.equal(again, got) and torch.equal(idx_again, idx)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_copies_in_different_chunks_take_the_first_index_on_gpu(dtype):
    """Three copies of 400 points, each copy in other chunks than the rest:
    every winner is the first copy's, exactly the plain first-index argmax."""
    tx, tp = _gpu_inputs(6, 4, 400, 8, (128, 128, 256))
    tx = torch.cat([tx, tx, tx], dim=1)  # [4, 1200, 8]
    tdt = None if dtype == "float32" else torch.bfloat16
    lib = tpf.load_library()
    tile = lib.pointnet_fused_tile_rows(int(tdt is not None), 8, 128, 128, 256)
    chunks = tpf.choose_chunks(4, 1200, tile, torch.cuda.get_device_properties(0).multi_processor_count)
    per_chunk = -(-(-(-1200 // tile)) // chunks) * tile
    assert per_chunk <= 400, "the copies must fall in different chunks"
    _, idx = tpf._forward_kernel(tx, tp, tdt, with_idx=True)
    _, want = tpf._forward_plain(tx, tp, tdt, with_idx=True)
    torch.cuda.synchronize()
    assert int(idx.max()) < 400
    assert torch.equal(idx, want)
