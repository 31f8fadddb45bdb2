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
from pointcloud_rl_torch.utils import trace

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
    trace.reset_counters()
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


def _runs(B, N, tile, ctas, per):
    """Each CTA's run as a list of (batch row, tile) pairs, in run order."""
    T = -(-N // tile)
    return [[divmod(g, T) for g in range(c * per, min(B * T, (c + 1) * per))] for c in range(ctas)]


@pytest.mark.parametrize("B, N", [(512, 1536), (256, 1536), (128, 1536), (16, 1536), (512, 1200), (4, 1200),
                                  (2, 1200), (100, 1536), (1, 1), (3, 200000), (1, 70000)])
@pytest.mark.parametrize("n_sm", [132, 7])
def test_persistent_runs_cover_every_tile_once(B, N, n_sm):
    """The persistent body's runs take every (batch row, tile) pair once, a
    row's tiles in point order within a run, every CTA some; a run spans at
    most MAX_RUN_POINTS points of a row (the keys' 16-bit index), and the
    CTAs stay within one wave unless that cap forces more."""
    tile = 64
    ctas, per = tpf.choose_runs(B, N, tile, n_sm)
    runs = _runs(B, N, tile, ctas, per)
    flat = [pair for run in runs for pair in run]
    T = -(-N // tile)
    assert flat == [(b, t) for b in range(B) for t in range(T)]
    assert all(runs) and per * tile <= tpf.MAX_RUN_POINTS
    for run in runs:
        for row in {b for b, _ in run}:
            tiles = [t for b, t in run if b == row]
            assert tiles == list(range(tiles[0], tiles[0] + len(tiles)))
            assert (tiles[-1] - tiles[0] + 1) * tile <= tpf.MAX_RUN_POINTS
    assert ctas <= n_sm or per == tpf.MAX_RUN_POINTS // tile


@pytest.mark.parametrize("B, N", [(2, 1200), (4, 1200), (16, 1536), (2, 1536), (4, 1536)])
def test_persistent_runs_spread_act_shapes_at_least_as_wide(B, N):
    """At the act shapes the persistent body spreads a few rows over at
    least as many CTAs as the chunked split of 128-point tiles did."""
    ctas, per = tpf.choose_runs(B, N, 64, 132)
    assert ctas >= B * tpf.choose_chunks(B, N, 128, 132)
    assert ctas <= 132


# ------------------------------------------------------------ on the card
# (name, B, N, C_in, widths): the main path's shapes (the update's encodes,
# a data-parallel rank's, the act encodes), then edges: a single chunk, one
# point, ragged tails, widths that are no multiple of 16 or 64, widths
# narrow enough that f32 weights stay in shared memory, a wide C_in, and
# more points than a 16-bit index holds.
GPU_SHAPES = [
    ("walker_drq", 512, 1536, 9, (64, 128, 256)),  # the walker update's encodes (256 rows x 2 copies)
    ("walker_rank", 128, 1536, 9, (64, 128, 256)),  # a rank's of 4
    ("walker_act", 16, 1536, 9, (64, 128, 256)),  # the walker act at 16 envs
    ("drq", 512, 1200, 8, (128, 128, 256)),  # DrQ at 256 rows x 2 copies
    ("slice", 8, 1200, 8, (128, 128, 256)),
    ("act", 4, 1200, 8, (128, 128, 256)),
    ("walker", 8, 1536, 9, (64, 128, 256)),
    ("b1_n1", 1, 1, 8, (128, 128, 256)),
    ("b1_n63", 1, 63, 9, (64, 128, 256)),
    ("n1201", 2, 1201, 8, (128, 128, 256)),
    ("odd_widths", 3, 300, 8, (40, 72, 200)),
    ("narrow", 2, 100, 8, (32, 64, 128)),  # f32 weights resident in shared memory too
    ("c_in40", 3, 300, 40, (64, 128, 256)),  # bf16: three k16 steps of layer 1
    ("n70000", 2, 70000, 9, (64, 128, 256)),  # winner indices past 16 bits, partials that start past them
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


def _points_per_partial(dtype, B, N, c_in, widths):
    """Points of a row that one partial covers at most, in the split the
    wrapper takes for this dtype and these widths."""
    lib = tpf.load_library()
    bf16 = int(dtype == "bfloat16")
    tile = lib.pointnet_fused_tile_rows(bf16, c_in, *widths)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    if lib.pointnet_fused_persistent(bf16, c_in, *widths):
        return min(tpf.choose_runs(B, N, tile, n_sm)[1] * tile, N)
    return -(-(-(-N // tile)) // tpf.choose_chunks(B, N, tile, n_sm)) * tile


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_copies_in_different_chunks_take_the_first_index_on_gpu(dtype):
    """Three copies of 400 points, each copy in other chunks than the rest:
    every winner is the first copy's, exactly the plain first-index argmax."""
    tx, tp = _gpu_inputs(6, 4, 400, 8, (128, 128, 256))
    tx = torch.cat([tx, tx, tx], dim=1)  # [4, 1200, 8]
    tdt = None if dtype == "float32" else torch.bfloat16
    assert _points_per_partial(dtype, 4, 1200, 8, (128, 128, 256)) <= 400, \
        "the copies must fall in different chunks"
    _, idx = tpf._forward_kernel(tx, tp, tdt, with_idx=True)
    _, want = tpf._forward_plain(tx, tp, tdt, with_idx=True)
    torch.cuda.synchronize()
    assert int(idx.max()) < 400
    assert torch.equal(idx, want)


@pytest.mark.gpu
def test_copies_across_runs_and_rows_take_the_first_index_on_gpu():
    """bf16 walker widths at 25 rows of three copies of 512 points: the
    copies lie in different tiles, in both warpgroups' tiles and in
    different CTAs' runs, and runs cross row boundaries.  Every winner is
    the first copy's (the plain first-index argmax).  Channels whose gamma
    and beta are 0 read 0 (or -0) at every point: they pool to 0 at index 0."""
    B, N, widths = 25, 1536, (64, 128, 256)
    tx, tp = _gpu_inputs(13, B, 512, 9, widths)
    tx = torch.cat([tx, tx, tx], dim=1)
    tp = list(tp)
    flat = torch.arange(0, 256, 5, device="cuda")
    tp[8] = tp[8].index_fill(0, flat, 0.0)  # gamma3
    tp[9] = tp[9].index_fill(0, flat, 0.0)  # beta3
    tp = tuple(tp)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    ctas, per = tpf.choose_runs(B, N, 64, n_sm)
    assert 24 % per != 0 and per < 8, "runs must cross rows and split the copies"
    assert tpf.load_library().pointnet_fused_persistent(1, 9, *widths) == 1
    for with_idx in (True, False):
        got, idx = tpf._forward_kernel(tx, tp, torch.bfloat16, with_idx=with_idx)
        want, want_idx = tpf._forward_plain(tx, tp, torch.bfloat16, with_idx=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=2e-2, atol=3e-2)
        assert torch.equal(got[:, flat], torch.zeros_like(got[:, flat]))
        if with_idx:
            assert int(idx.max()) < 512
            assert torch.equal(idx, want_idx)
            assert not idx[:, flat].any()


@pytest.mark.gpu
def test_the_body_design_follows_the_dtype_and_widths_on_gpu():
    """bf16 at the walker's and the ManiSkill widths takes the persistent
    body; f32, and bf16 too wide for it, the chunked one.  Each launch adds
    one to its entry point, whatever the design."""
    cases = [(torch.bfloat16, (64, 128, 256), 1), (torch.bfloat16, (128, 128, 256), 1),
             (None, (64, 128, 256), 0), (torch.bfloat16, (256, 256, 256), 0)]
    for tdt, widths, persistent in cases:
        tx, tp = _gpu_inputs(14, 4, 300, 9, widths)
        assert tpf.load_library().pointnet_fused_persistent(int(tdt is not None), 9, *widths) == persistent
        before = dict(tpf.launch_counts)
        tpf._forward_kernel(tx, tp, tdt, with_idx=True)
        tpf._forward_kernel(tx, tp, tdt, with_idx=False)
        added = {k: v - before[k] for k, v in tpf.launch_counts.items()}
        assert added == {"pointnet_fused_fwd_idx": 1, "pointnet_fused_fwd_max": 1}, (tdt, widths, added)


@pytest.mark.gpu
@pytest.mark.parametrize("with_idx", [True, False], ids=["idx", "max"])
def test_persistent_body_replays_bitwise_in_a_cuda_graph_on_gpu(with_idx):
    """The bf16 body at the walker update's shape captured in a CUDA graph:
    each replay gives the eager call's pooled values and indices, bitwise."""
    tx, tp = _gpu_inputs(15, 512, 1536, 9, (64, 128, 256))
    eager, eager_idx = tpf._forward_kernel(tx, tp, torch.bfloat16, with_idx=with_idx)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        got, got_idx = tpf._forward_kernel(tx, tp, torch.bfloat16, with_idx=with_idx)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, eager)
        assert not with_idx or torch.equal(got_idx, eager_idx)


def test_launch_counts_keep_the_forward_keys_alone():
    """The roofline reader holds the forward launches it finds in a trace to
    the sum of every value of ``launch_counts``: the backward counts apart."""
    assert set(tpf.launch_counts) == {"pointnet_fused_fwd_idx", "pointnet_fused_fwd_max"}
    assert set(tpf.bwd_launch_counts) == {"pointnet_fused_bwd"}


def test_cpu_backward_is_the_plain_one_and_never_launches():
    """CPU tensors run ``_winner_backward`` unchanged: autograd's gradients
    are its output, and the backward kernel's counter stays at 0."""
    trace.reset_counters()
    x, params = _inputs(7, 3, 60, 9)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in [x] + params]
    out = tpf.fused_pointnet_body(leaves[0], tuple(leaves[1:]))
    g = torch.from_numpy(np.random.RandomState(8).randn(*out.shape).astype(np.float32))
    out.backward(g)
    _, idx = tpf._forward_plain(leaves[0].detach(), tuple(p.detach() for p in leaves[1:]), None)
    want_dx, want = tpf._winner_backward(leaves[0].detach(), tuple(p.detach() for p in leaves[1:]), idx, g)
    for leaf, ref in zip(leaves, (want_dx,) + want):
        assert torch.equal(leaf.grad, ref)
    assert tpf.bwd_launch_counts == {"pointnet_fused_bwd": 0}
    assert tpf.launch_counts == {"pointnet_fused_fwd_idx": 0, "pointnet_fused_fwd_max": 0}


def test_plain_backward_in_float64_is_the_f32_one_to_rounding():
    """``_winner_backward`` in float64 (the card tests' exact reference)
    computes what its f32 default does, to f32 rounding, and returns float64."""
    x, params = _inputs(11, 2, 40, 8)
    tx, tp = torch.from_numpy(x), tuple(torch.from_numpy(p) for p in params)
    _, idx = tpf._forward_plain(tx, tp, None)
    g = torch.from_numpy(np.random.RandomState(12).randn(*idx.shape).astype(np.float32))
    dx32, d32 = tpf._winner_backward(tx, tp, idx, g)
    dx64, d64 = tpf._winner_backward(tx, tp, idx, g, torch.float64)
    assert dx64.dtype == torch.float32 and all(d.dtype == torch.float64 for d in d64)  # dx keeps x's dtype
    np.testing.assert_allclose(dx32.numpy(), dx64.numpy(), rtol=1e-4, atol=1e-5)
    for a, b in zip(d32, d64):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rows, tile, ctas", [(512 * 256, 64, 128), (256 * 256, 64, 128), (64 * 256, 64, 128),
                                              (130 * 64, 64, 130), (8, 64, 1), (133 * 64, 64, 67)])
def test_backward_ctas_keep_the_fewest_tiles_per_cta(rows, tile, ctas):
    """As many CTAs as the least number of tiles per CTA needs, no more (132
    SMs): the walker's, ManiSkill's and a 64-row rank's winner rows in 128."""
    tiles = -(-rows // tile)
    got, per = tpf.choose_bwd_ctas(rows, tile, 132)
    assert got == ctas and per == -(-tiles // 132)
    assert got * per >= tiles and (got - 1) * per < tiles  # every tile taken, every CTA given one


# The backward kernel against ``_winner_backward`` on the card.  (name,
# dtype of x, B, N, C_in, widths, copies of the points): the walker's DrQ
# encode, ManiSkill's SAC encode, a 64-row data-parallel rank, C_in 8 with
# widths that are no multiple of 8, three copies of 400 points (every
# winner in the first copy, many channels on one point), and widths whose
# buffers take the 32-row tile.
BWD_SHAPES = [
    ("walker", "bfloat16", 512, 1536, 9, (64, 128, 256), 1),
    ("maniskill", "float32", 256, 1200, 9, (128, 128, 256), 1),
    ("rank64", "float32", 64, 1200, 8, (128, 128, 256), 1),
    ("c_in8_odd", "float32", 3, 300, 8, (40, 72, 200), 1),
    ("copies", "float32", 4, 400, 8, (128, 128, 256), 3),
    ("wide", "float32", 16, 600, 8, (64, 256, 256), 1),
    ("wide_bf16", "bfloat16", 8, 600, 9, (256, 256, 256), 1),
]
GRAD_NAMES = ("dw1", "db1", "dw2", "db2", "dg2", "dbe2", "dw3", "db3", "dg3", "dbe3")
# Each gradient's worst element against the tensor's largest, the kernel
# against the plain backward in f32 (sums in another order) and in float64:
# on the H100 every gradient and f32 dx came within 1e-6 at the walker's,
# ManiSkill's and the ranks' shapes, so ten times that; a 3xTF32 version of
# the products, at 4e-4 to 1.4e-3, fails it.
BWD_TOL = 1e-5
# A winner row with a relu input (a1, n2, or n3 on its own channel) within
# this of 0 in float64 may take either branch in f32, wherever the sums
# round otherwise: on the H100 the kernel took the other branch than both
# plain versions at one such row of the ManiSkill case (6e-3 in dW2), and
# both f32 versions the other branch than float64 at one of the walker's
# (1.2e-3).  Such rows get a zero cotangent, which takes every term of
# theirs out of every gradient; f32 rounds these inputs by ~1e-7.
FLIP_MARGIN = 1e-5


def _near_relu_edge(tx, tp, idx):
    """[B, K] rows whose relu inputs come within FLIP_MARGIN of 0 in float64."""
    w1, b1, w2, b2, g2, be2, w3, b3, g3, be3 = (p.double() for p in tp)
    B, N, c_in = tx.shape
    K = idx.shape[1]
    batch = torch.arange(B, device=tx.device)[:, None]
    rows = tx.reshape(B * N, c_in)[(batch * N + idx.long()).reshape(-1)].double()

    def ln(a, gamma, beta):
        mu = a.mean(dim=-1, keepdim=True)
        return (a - mu) * torch.rsqrt(((a - mu) ** 2).mean(dim=-1, keepdim=True) + tpf._LN_EPS) * gamma + beta

    a1 = rows @ w1 + b1
    n2 = ln(torch.relu(a1) @ w2 + b2, g2, be2)
    n3 = ln(torch.relu(n2) @ w3 + b3, g3, be3).reshape(B, K, K).diagonal(dim1=1, dim2=2)
    near = (a1.abs() < FLIP_MARGIN).any(dim=1) | (n2.abs() < FLIP_MARGIN).any(dim=1)
    return near.reshape(B, K) | (n3.abs() < FLIP_MARGIN)


def _bwd_case(name, dtype, B, N, c_in, widths, copies):
    tx, tp = _gpu_inputs(9, B, N, c_in, widths)
    tx = torch.cat([tx] * copies, dim=1)
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    tx = tx.to(tdt or torch.float32)
    _, idx = tpf._forward_kernel(tx, tp, tdt, with_idx=True)
    g = torch.randn(idx.shape, generator=torch.Generator("cuda").manual_seed(10), device="cuda")
    near = _near_relu_edge(tx, tp, idx)
    assert float(near.float().mean()) < 0.02  # the other 98% and more of the rows are compared
    return tx, tp, idx, g.masked_fill(near, 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("with_dx", [True, False], ids=["dx", "no_dx"])
@pytest.mark.parametrize("name, dtype, B, N, c_in, widths, copies", BWD_SHAPES, ids=[s[0] for s in BWD_SHAPES])
def test_backward_kernel_matches_plain_on_gpu(name, dtype, B, N, c_in, widths, copies, with_dx):
    tx, tp, idx, g = _bwd_case(name, dtype, B, N, c_in, widths, copies)
    want_dx, want = tpf._winner_backward(tx, tp, idx, g)
    _, exact = tpf._winner_backward(tx, tp, idx, g, torch.float64)
    before = tpf.bwd_launch_counts["pointnet_fused_bwd"]
    got_dx, got = tpf._winner_backward_kernel(tx, tp, idx, g, with_dx)
    torch.cuda.synchronize()
    assert tpf.bwd_launch_counts["pointnet_fused_bwd"] == before + 1
    for gname, a, b, c in zip(GRAD_NAMES, got, want, exact):
        assert a.shape == b.shape and a.dtype == torch.float32, gname
        gap = float((a - b).abs().max() / b.abs().max())
        gap64 = float((a.double() - c).abs().max() / c.abs().max())
        assert gap <= BWD_TOL and gap64 <= BWD_TOL, (gname, gap, gap64)
    if not with_dx:
        assert got_dx is None
    else:
        assert got_dx.dtype == tx.dtype and got_dx.shape == tx.shape
        # bf16: both round the summed rows to bf16 (the plain one each add)
        tol = BWD_TOL if dtype == "float32" else 2e-2
        gap = float((got_dx.float() - want_dx.float()).abs().max() / want_dx.float().abs().max())
        assert gap <= tol, gap
        hit = torch.zeros(tx.shape[:2], dtype=torch.bool, device=tx.device)
        hit[torch.arange(B, device=tx.device)[:, None], idx.long()] = True
        assert not got_dx[~hit].any()  # no gradient where no winner is
    # Repeated calls are bitwise equal (no atomics, a fixed order of the sums).
    again_dx, again = tpf._winner_backward_kernel(tx, tp, idx, g, with_dx)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert not with_dx or torch.equal(again_dx, got_dx)


@pytest.mark.gpu
def test_backward_kernel_replays_bitwise_in_a_cuda_graph_on_gpu():
    """The kernel captured in a CUDA graph: each replay gives the eager
    call's gradients, bitwise."""
    tx, tp, idx, g = _bwd_case(*BWD_SHAPES[0])
    _, eager = tpf._winner_backward_kernel(tx, tp, idx, g, False)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        _, captured = tpf._winner_backward_kernel(tx, tp, idx, g, False)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, eager))


@pytest.mark.gpu
@pytest.mark.parametrize("c_in, widths, tile", [(9, (64, 128, 256), 64), (9, (128, 128, 256), 64),
                                                (8, (40, 72, 200), 64), (8, (64, 256, 256), 32),
                                                (9, (256, 256, 256), 32)])
def test_backward_tile_rows_follow_the_widths_on_gpu(c_in, widths, tile):
    """64 winner rows a tile where its buffers fit in shared memory, else
    32 (the ``wide`` cases above run that tile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel is built with nvcc")
    assert tpf.load_library().pointnet_fused_bwd_tile_rows(c_in, *widths) == tile
