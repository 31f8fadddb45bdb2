#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pointcloud_rl_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py               # all phases, one card
    python3 chip_smoke.py --kernels-only

Phases (any failure exits non-zero and prints no result):

1. The card: ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. Build the CUDA kernels from ``pointcloud_rl_torch/csrc`` with nvcc.
   ``cuobjdump -sass`` of the built library: the count of ``HGMMA`` (and
   ``HMMA``) instructions in each kernel; the body kernels of both entry
   points must hold ``HGMMA`` (the tensor cores' warpgroup products).
3. Each kernel against its plain PyTorch version on the same inputs, at the
   training slices' encoder shapes (SAC f32, DrQ f32 and bf16), the act
   encode's (4 env workers, f32 and bf16) and the walker encoder's (f32 and
   bf16), then at edge shapes (one
   batch row, one point, ragged tails, widths that are no multiple of 16):
   pooled values, winner indices (the kernel's winner must attain the plain
   max), bitwise-equal repeated calls, a cloud of three copies of the same
   points in different chunks (the winners must equal the plain first-index
   argmax exactly), gradients of ``FusedPointNetBody`` against autograd
   through the plain body, and ms per call of kernel and plain version
   beside the least time the card could take (``bound_ms``).
4. The slices through the CLI a user runs, in subprocesses, each at its
   config's full widths: it trains a few thousand env steps on the card,
   evaluates from ``model_final`` and resumes with ``--auto-resume``.
   ``sac``: SAC + PointNet on ``configs/mfrl/sac/synthetic/pn_fake_manipulation.py``
   with a host replay.  ``drq_host``: DrQ (``num_aug=2``, a jitter on xyz;
   the encoders run at 512 rows) on
   ``configs/mfrl/drq/synthetic/pn_jitter_fake_manipulation.py`` with a host
   replay.  ``drq_device``: the same DrQ on a ``DeviceReplayMemory`` of the
   config's 100000 transitions on the card, stored packed in bf16, with the
   bf16 agent flag (the kernels' bf16 path).  Each run starts a fresh
   process and resets its kernel launch counts to 0 just before it trains
   or evaluates; it writes them to ``run_summary.json``, and both kernels
   must have launched in every training run.  Each run also lists there the
   ``pointcloud_rl_tpu`` modules it loaded, which must be none, and its
   replay (``drq_device``: a ``DeviceReplayMemory`` on ``cuda`` with its
   bytes).  The loss of each run must be logged and finite.
5. Each run's three checkpoints act on 32 environment observations on the
   card (fused kernel) and on the CPU (plain body): the eval-mode actions
   must agree (f32 runs to ``ACTION_ATOL``, the bf16 run to
   ``ACTION_ATOL_BF16``); the count of bf16 rounding flips that reach an
   action is printed.
6. One JSON line describing the kernels, the card's name and power limit,
   then the result line ``{"ok": true, "device": {...}}``.

Every time printed here was measured in this run, on the card named in
phase 1.  The plain versions run with TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``), i.e. in full f32.
"""

from __future__ import annotations

import csv
import json
import math
import os
import os.path as osp
import shutil
import subprocess
import sys
import tempfile
import time

REPO = osp.dirname(osp.abspath(__file__))
SLICE_CONFIG = "configs/mfrl/sac/synthetic/pn_fake_manipulation.py"
DRQ_CONFIG = "configs/mfrl/drq/synthetic/pn_jitter_fake_manipulation.py"
FUSED = "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.fused=True"
# The training runs of phase 4: (name, config, its --cfg-options, metric prefix).
RUNS = [
    ("sac", SLICE_CONFIG, [FUSED, "replay_cfg.capacity=20000"], "sac"),
    ("drq_host", DRQ_CONFIG, [FUSED, "replay_cfg.capacity=20000"], "drq"),
    ("drq_device", DRQ_CONFIG, [FUSED, "replay_cfg.type=DeviceReplayMemory",
                                "replay_cfg.transfer_cfg.pack_features=True", "agent_cfg.bf16=True"], "drq"),
]
KERNEL_SOURCE = "pointcloud_rl_torch/csrc/pointnet_fused.cu"
TPU_KERNELS = {
    "pointnet_fused_fwd_idx": "pointcloud_rl_tpu/ops/pointnet_fused.py:113",
    "pointnet_fused_fwd_max": "pointcloud_rl_tpu/ops/pointnet_fused.py:138",
}
# (name, B, N, C_in, widths, compute dtype name): the main path's shapes,
# timed (SAC's update encodes at B=256, DrQ's at 2 x 256 rows in f32 and in
# bf16, the act encode at 4 env workers in f32 and in bf16, the walker
# encoder), then edge shapes, checked only.
SHAPES = [
    ("slice_f32", 256, 1200, 8, (128, 128, 256), "float32"),
    ("drq_f32", 512, 1200, 8, (128, 128, 256), "float32"),
    ("drq_bf16", 512, 1200, 8, (128, 128, 256), "bfloat16"),
    ("act_f32", 4, 1200, 8, (128, 128, 256), "float32"),
    ("act_bf16", 4, 1200, 8, (128, 128, 256), "bfloat16"),
    ("walker_f32", 256, 1536, 9, (64, 128, 256), "float32"),
    ("walker_bf16", 256, 1536, 9, (64, 128, 256), "bfloat16"),
]
EDGE_SHAPES = [
    ("b1_n1", 1, 1, 8, (128, 128, 256), "float32"),
    ("b1_n63", 1, 63, 9, (64, 128, 256), "float32"),
    ("b2_n1201", 2, 1201, 8, (128, 128, 256), "float32"),
    ("b1_n1201_bf16", 1, 1201, 9, (64, 128, 256), "bfloat16"),
    ("odd_widths_f32", 3, 300, 8, (40, 72, 200), "float32"),
    ("odd_widths_bf16", 3, 300, 8, (40, 72, 200), "bfloat16"),
    ("narrow_f32", 2, 100, 8, (32, 64, 128), "float32"),  # f32 weights resident in shared memory
]
# Published dense peaks of one H100 SXM at 700 W (NVIDIA H100 datasheet).
PEAK_TF32 = 495e12   # FLOP/s; f32 runs as 3xTF32, 3 products per FLOP
PEAK_BF16 = 989e12   # FLOP/s
PEAK_BYTES = 3.35e12  # bytes/s of HBM3
BOUND_FORMULA = ("max(ops, bytes): ops = 3*FLOP/495e12 s (f32 as 3xTF32) or FLOP/989e12 s (bf16), "
                 "FLOP = 2*B*N*(C_in*c1 + c1*c2 + c2*c3); bytes = x + W + biases/LN read once, "
                 "pooled (+idx) written once, over 3.35e12 B/s")
# Tolerances of kernel vs plain.  f32: the kernel sums each dot product in
# another order than cuBLAS, and LayerNorm divides by a per-row std, so
# values agree to a few f32 ulps times the depth; 1e-4 absolute on O(1)
# features.  bf16: both sides round h1/h2/h3 to bf16 (8 bits of mantissa),
# and a different f32 sum can land on the other side of a rounding step,
# so one element may move by an ulp of bf16 (0.4% relative) per layer.
POOLED_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 2e-2)}  # (atol, rtol)
# Gradients: f32 winner-row recompute vs autograd through cuBLAS f32 and
# per-element sums over the batch; compared relative to each tensor's scale.
GRAD_RTOL = 1e-3
# Trained agent, kernel on the card vs plain body on the CPU: f32 features
# that differ by ~1e-6, through the 1024-wide head and a tanh (slope <= 1).
ACTION_ATOL = 1e-4
# The bf16 agent: the card and the CPU round to bf16 at the same points
# (each product, each bias add, h1..h3 in the body), but their f32 sums run
# in another order, and a sum that lands on the other side of a rounding
# step moves that value by one bf16 ulp.  A flip upstream moves the next
# layer's f32 sums by far less than an ulp, so what reaches the action is
# in the main a flip of the bf16 action mean itself: one ulp times the
# tanh's slope, at most 2^-7 * sech^2(1) = 3.3e-3 over all means.  The
# limit admits two such flips in one action element: 7e-3.  The flips seen
# are counted and printed (actions that differ by more than FLIP_ABS).
ACTION_ATOL_BF16 = 7e-3
FLIP_ABS = 1e-5  # above the f32 noise of the tanh (~1e-7)
REF_OBS = 32  # environment observations per checkpoint in phase 5
REF_CHECKPOINTS = ("model_1500", "model_3000", "model_final")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_inputs(B, N, c_in, widths, seed: int = 0):
    """x and the 10 body params on the card, from a seeded generator."""
    import torch

    g = torch.Generator().manual_seed(seed)
    c1, c2, c3 = widths

    def uni(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        return (torch.rand(shape, generator=g) * 2 - 1) * bound

    def near(shape, center, scale):
        return center + scale * torch.randn(shape, generator=g)

    x = torch.randn((B, N, c_in), generator=g)
    params = (
        uni((c_in, c1), c_in), uni((c1,), c_in),
        uni((c1, c2), c1), uni((c2,), c1), near((c2,), 1.0, 0.1), near((c2,), 0.0, 0.1),
        uni((c2, c3), c2), uni((c3,), c2), near((c3,), 1.0, 0.1), near((c3,), 0.0, 0.1),
    )
    return x.cuda(), tuple(p.cuda() for p in params)


def check_close(name, got, want, atol, rtol) -> float:
    import torch

    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        fail(f"{name}: {int(bad.sum())} elements outside atol={atol} rtol={rtol}; "
             f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def bound_ms(B, N, c_in, widths, dname, with_idx: bool):
    """The least time the card could take for one call: the larger of the
    operations over the peak rate of their type and the bytes over HBM's
    rate.  Returns (ms, "operations" or "bytes")."""
    c1, c2, c3 = widths
    flop = 2 * B * N * (c_in * c1 + c1 * c2 + c2 * c3)
    esz = 4 if dname == "float32" else 2
    nbytes = (B * N * c_in + c_in * c1 + c1 * c2 + c2 * c3) * esz + 4 * (c1 + 3 * c2 + 3 * c3)
    nbytes += B * c3 * (8 if with_idx else 4)
    ops_s = 3 * flop / PEAK_TF32 if dname == "float32" else flop / PEAK_BF16
    mem_s = nbytes / PEAK_BYTES
    return 1e3 * max(ops_s, mem_s), ("operations" if ops_s >= mem_s else "bytes")


def sass_counts(lib_path: str) -> dict:
    """{kernel name: (HGMMA count, HMMA count)} from ``cuobjdump -sass``."""
    from pointcloud_rl_torch.ops import build as kbuild

    cuobjdump = osp.join(osp.dirname(kbuild.find_nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                         timeout=120, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][0] += "HGMMA" in line
            counts[fn][1] += " HMMA" in line
    return {k: tuple(v) for k, v in counts.items()}


def phase_sass(lib_path: str) -> dict:
    counts = sass_counts(lib_path)
    per_entry = {}
    for entry, body in (("pointnet_fused_fwd_idx", "pointnet_body_idx_kernel"),
                        ("pointnet_fused_fwd_max", "pointnet_body_max_kernel")):
        kern = {k: v for k, v in counts.items() if body in k}
        if len(kern) != 2:
            fail(f"expected an f32 and a bf16 {body} in the library, found {sorted(kern)}")
        for k, (hgmma, hmma) in sorted(kern.items()):
            dt = "bf16" if "bfloat16" in k else "f32"
            print(f"[sass] {entry} {body}<{dt}>: {hgmma} HGMMA, {hmma} HMMA", flush=True)
            if hgmma == 0:
                fail(f"{body}<{dt}> holds no HGMMA instruction: the tensor cores are unused")
        per_entry[entry] = {("bf16" if "bfloat16" in k else "f32"): v[0] for k, v in kern.items()}
    for k, (hgmma, hmma) in sorted(counts.items()):
        if "pointnet_body" not in k:
            print(f"[sass] {k}: {hgmma} HGMMA, {hmma} HMMA", flush=True)
    return per_entry


def check_shape(pf, name, B, N, c_in, widths, dname, seed=0):
    """Both entry points against the plain version at one shape; returns
    (inputs, compute dtype, errors, share of identical indices)."""
    import torch

    dtype = getattr(torch, dname)
    cdt = None if dtype == torch.float32 else dtype
    atol, rtol = POOLED_TOL[dname]
    x, params = make_inputs(B, N, c_in, widths, seed=seed)
    with torch.no_grad():
        want_h3 = pf._body_rows(x.reshape(B * N, c_in), params, cdt).reshape(B, N, -1).float()
        want = want_h3.max(dim=1).values
        got_idx_pooled, got_idx = pf._forward_kernel(x, params, cdt, with_idx=True)
        got_max, _ = pf._forward_kernel(x, params, cdt, with_idx=False)
        again_pooled, again_idx = pf._forward_kernel(x, params, cdt, with_idx=True)
        again_max, _ = pf._forward_kernel(x, params, cdt, with_idx=False)
        torch.cuda.synchronize()
        e_idx = check_close(f"{name} fwd_idx pooled", got_idx_pooled, want, atol, rtol)
        e_max = check_close(f"{name} fwd_max pooled", got_max, want, atol, rtol)
        if not torch.equal(got_idx_pooled, got_max):
            fail(f"{name}: the two entry points disagree on pooled")
        if not (torch.equal(again_pooled, got_idx_pooled) and torch.equal(again_idx, got_idx)
                and torch.equal(again_max, got_max)):
            fail(f"{name}: two calls on the same inputs are not bitwise equal")
        if int(got_idx.min()) < 0 or int(got_idx.max()) >= N:
            fail(f"{name}: winner index out of range")
        # The kernel's winner must attain the plain max (robust to near-ties).
        at_winner = torch.gather(want_h3, 1, got_idx.long()[:, None, :])[:, 0, :]
        e_arg = check_close(f"{name} argmax", at_winner, want, atol, rtol)
        same = float((got_idx == pf._tile_max_argmax(want_h3)[1]).float().mean())
    del want_h3
    return (x, params), cdt, (e_idx, e_max, e_arg), same


def check_copies(pf, dname: str) -> None:
    """Three copies of the same 400 points at the act shape, each copy in
    other chunks than the rest: the winners must equal the plain first-index
    argmax exactly, and all be first copies."""
    import torch

    dtype = getattr(torch, dname)
    cdt = None if dtype == torch.float32 else dtype
    x, params = make_inputs(4, 400, 8, (128, 128, 256), seed=3)
    x = torch.cat([x, x, x], dim=1).contiguous()
    lib = pf.load_library()
    tile = lib.pointnet_fused_tile_rows(int(cdt is not None), 8, 128, 128, 256)
    chunks = pf.choose_chunks(4, 1200, tile, torch.cuda.get_device_properties(0).multi_processor_count)
    per_chunk = -(-(-(-1200 // tile)) // chunks) * tile
    if per_chunk > 400:
        fail(f"copies: {chunks} chunks of {per_chunk} points do not separate the copies")
    with torch.no_grad():
        _, idx = pf._forward_kernel(x, params, cdt, with_idx=True)
        _, want = pf._forward_plain(x, params, cdt, with_idx=True)
        torch.cuda.synchronize()
    if int(idx.max()) >= 400 or not torch.equal(idx, want):
        fail(f"copies ({dname}): winners differ from the plain first-index argmax on "
             f"{int((idx != want).sum())} of {idx.numel()} channels")
    print(f"[kernels] copies in different chunks ({dname}, {chunks} chunks of {per_chunk} points): "
          f"winners equal the plain first-index argmax on all {idx.numel()} channels", flush=True)


def phase_kernels(pf, report: dict, card: str) -> None:
    import torch

    for name, B, N, c_in, widths, dname in SHAPES:
        (x, params), cdt, (e_idx, e_max, e_arg), same = check_shape(pf, name, B, N, c_in, widths, dname)
        with torch.no_grad():
            ms_idx = time_ms(lambda: pf._forward_kernel(x, params, cdt, with_idx=True))
            ms_max = time_ms(lambda: pf._forward_kernel(x, params, cdt, with_idx=False))
            plain_idx = time_ms(lambda: pf._forward_plain(x, params, cdt, with_idx=True))
            plain_max = time_ms(lambda: pf._forward_plain(x, params, cdt, with_idx=False))
        b_idx = bound_ms(B, N, c_in, widths, dname, True)
        b_max = bound_ms(B, N, c_in, widths, dname, False)
        print(f"[kernels] {name} B={B} N={N} C_in={c_in} widths={widths}: "
              f"max abs err fwd_idx {e_idx:.3e} fwd_max {e_max:.3e} argmax {e_arg:.3e}, "
              f"idx identical to plain {same:.4%}; ms/call fwd_idx {ms_idx:.4f} "
              f"(plain {plain_idx:.3f}, bound {b_idx[0]:.4f}) fwd_max {ms_max:.4f} "
              f"(plain {plain_max:.3f}, bound {b_max[0]:.4f}) on {card}", flush=True)
        for kname, err, ms, pms, bnd in (
                ("pointnet_fused_fwd_idx", max(e_idx, e_arg), ms_idx, plain_idx, b_idx),
                ("pointnet_fused_fwd_max", e_max, ms_max, plain_max, b_max)):
            rec = report.setdefault(kname, {"max_abs_err": 0.0, "shapes": {}})
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["shapes"][name] = {"ms": ms, "plain_ms": pms, "bound_ms": bnd[0], "bound_by": bnd[1]}
        del x, params

    for name, B, N, c_in, widths, dname in EDGE_SHAPES:
        _, _, errs, same = check_shape(pf, name, B, N, c_in, widths, dname, seed=4)
        print(f"[kernels] edge {name} B={B} N={N} C_in={c_in} widths={widths} {dname}: "
              f"max abs err {max(errs):.3e}, idx identical to plain {same:.4%}, repeat bitwise equal",
              flush=True)
    for dname in ("float32", "bfloat16"):
        check_copies(pf, dname)

    # Gradients of the fused body at the slice's shape vs autograd through
    # the plain body (f32; the slice trains in f32).
    name, B, N, c_in, widths, _ = SHAPES[0]
    x, params = make_inputs(B, N, c_in, widths, seed=1)
    w = torch.randn((B, widths[-1]), generator=torch.Generator().manual_seed(2)).cuda()
    leaves = [x.clone().requires_grad_(True)] + [p.clone().requires_grad_(True) for p in params]
    (pf.FusedPointNetBody.apply(*leaves, None) * w).sum().backward()
    ref = [t.detach().clone().requires_grad_(True) for t in leaves]
    h3 = pf._body_rows(ref[0].reshape(B * N, c_in), tuple(ref[1:]), None).reshape(B, N, -1)
    (h3.max(dim=1).values * w).sum().backward()
    names = ["dx", "dw1", "db1", "dw2", "db2", "dg2", "dbe2", "dw3", "db3", "dg3", "dbe3"]
    worst = 0.0
    for gname, a, b in zip(names, leaves, ref):
        scale = float(b.grad.abs().max()) + 1e-12
        rel = float((a.grad - b.grad).abs().max()) / scale
        if not math.isfinite(rel) or rel > GRAD_RTOL:
            fail(f"gradient {gname}: max abs err / max abs = {rel:.3e} > {GRAD_RTOL}")
        worst = max(worst, rel)
    print(f"[kernels] FusedPointNetBody gradients at {name}: worst max-err/scale {worst:.3e} "
          f"(limit {GRAD_RTOL})", flush=True)


def run_cli(config: str, args, log_path: str, timeout: int) -> None:
    cmd = [sys.executable, "-m", "pointcloud_rl_torch.apis.run_rl", config, *args]
    print("[run] $ " + " ".join(cmd[1:]), flush=True)
    t0 = time.monotonic()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
            rc = "timeout"
    if rc != 0:
        with open(log_path) as f:
            tail = f.read()[-4000:]
        fail(f"run_rl exited with {rc}:\n{tail}")
    print(f"[run]   done in {time.monotonic() - t0:.1f} s", flush=True)


def read_summary(wd: str) -> dict:
    """The run's ``run_summary.json``; the run must have loaded nothing of
    the JAX package."""
    with open(osp.join(wd, "run_summary.json")) as f:
        summary = json.load(f)
    if summary.get("pointcloud_rl_tpu_modules") != []:
        fail(f"the run loaded modules of the JAX package: {summary.get('pointcloud_rl_tpu_modules')}")
    return summary


def read_metrics(path: str):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        fail(f"{path} has no rows")
    for row in rows:
        for k, v in row.items():
            if v not in ("", None) and not math.isfinite(float(v)):
                fail(f"{path}: {k}={v} at step {row.get('step')}")
    return rows


def phase_train(work: str, name: str, config: str, opts, prefix: str) -> dict:
    """Train, evaluate and auto-resume one run; returns its summary."""
    root = osp.join(work, name)
    wd = osp.join(root, "0")  # run_rl appends the seed to --work-dir
    common = ["--work-dir", root, "--seed", "0", "--device", "cuda"]
    opts = list(opts) + ["train_cfg.warm_steps=512", "train_cfg.exp_logger_cfg.type=csv", "train_cfg.n_log=500",
                         "train_cfg.n_checkpoint=1500", "eval_cfg.save_video=False", "eval_cfg.num=2"]
    run_cli(config, common + ["--cfg-options", *opts, "train_cfg.total_steps=3000"],
            osp.join(work, f"{name}_train.log"), timeout=420)
    summary = read_summary(wd)
    if not summary["device"].startswith("cuda"):
        fail(f"{name} ran on {summary['device']}")
    for kname, n in summary["launches"].items():
        if n <= 0:
            fail(f"{kname} was never launched by the {name} training run")
    for ckpt in ("model_1500", "model_3000", "model_final"):
        if not osp.isfile(osp.join(wd, "models", ckpt)):
            fail(f"{name}: checkpoint {ckpt} missing")
    rows = read_metrics(osp.join(wd, "logs", "metrics.csv"))
    if not any(r.get(f"train/{prefix}/critic_loss") for r in rows):
        fail(f"{name}: no train/{prefix}/critic_loss was logged")
    replay = summary["replay"]
    print(f"[{name}] train: {summary['steps']} env steps, {summary['grad_steps']} updates on "
          f"{summary['device_name']}; kernel launches {summary['launches']}; replay {replay}", flush=True)

    run_cli(config, common + ["--evaluation", "--resume-from", osp.join(wd, "models", "model_final"),
                              "--cfg-options", *opts], osp.join(work, f"{name}_eval.log"), timeout=180)
    ev = read_summary(wd)
    if not ev["eval"] or not all(math.isfinite(v) for v in ev["eval"].values()):
        fail(f"{name}: evaluation returned {ev['eval']}")
    if ev["launches"]["pointnet_fused_fwd_max"] <= 0:
        fail(f"{name}: evaluation never launched the max-only kernel")
    print(f"[{name}] eval from model_final: {ev['eval']}", flush=True)

    run_cli(config, common + ["--auto-resume", "--cfg-options", *opts, "train_cfg.total_steps=3200"],
            osp.join(work, f"{name}_resume.log"), timeout=180)
    rs = read_summary(wd)
    if rs["resume_steps"] != 3000 or rs["steps"] != 3200:
        fail(f"{name}: auto-resume went from {rs['resume_steps']} to {rs['steps']}, expected 3000 -> 3200")
    print(f"[{name}] auto-resume: model_3000 -> {rs['steps']} env steps", flush=True)
    summary["models_dir"] = osp.join(wd, "models")
    return summary


def phase_reference(name: str, config: str, opts, models_dir: str, atol: float) -> float:
    """Each checkpoint of the run on the card (fused kernel) against the
    same checkpoint on the CPU (plain PyTorch body): eval-mode actions on
    ``REF_OBS`` of the environment's own observations."""
    import numpy as np

    from pointcloud_rl_torch.algorithms import build_agent
    from pointcloud_rl_torch.apis.run_rl import load_config, resolve_agent_placeholders
    from pointcloud_rl_torch.env import build_env, get_env_info
    from pointcloud_rl_torch.utils.checkpoint import load_checkpoint

    from pointcloud_rl_torch.config import DictAction

    agent_opts = {k: DictAction._parse_value(v) for k, v in (o.split("=", 1) for o in opts)
                  if k.startswith("agent_cfg.")}
    cfg = load_config(osp.join(REPO, config), agent_opts)
    env_cfg = dict(cfg["env_cfg"])
    info = get_env_info(env_cfg)
    resolve_agent_placeholders(cfg, info)
    agent_cfg = dict(cfg["agent_cfg"])
    env = build_env(env_cfg)
    env.seed(1)
    frames = [env.reset()]
    while len(frames) < REF_OBS:
        o, _, done, _ = env.step(env.action_space.sample())
        frames.append(env.reset() if done else o)
    obs = {k: np.stack([f[k] for f in frames]) for k in frames[0]}
    agents = {device: build_agent(dict(agent_cfg, env_params=info, seed=0, device=device))
              for device in ("cuda", "cpu")}
    worst = 0.0
    for ckpt in REF_CHECKPOINTS:
        acts = {}
        for device, agent in agents.items():
            agent.load_state_dict(load_checkpoint(osp.join(models_dir, ckpt), device))
            acts[device] = agent.forward(obs, mode="eval")
        diff = np.abs(acts["cuda"] - acts["cpu"])
        if acts["cuda"].shape != (REF_OBS, info["action_shape"]) or not np.isfinite(acts["cuda"]).all():
            fail(f"actions of shape {acts['cuda'].shape} from {ckpt}")
        err = float(diff.max())
        print(f"[reference] {name} {ckpt}: card (kernel) vs CPU (plain) eval actions on {REF_OBS} env "
              f"observations: max abs diff {err:.3e} (limit {atol}); {int((diff > FLIP_ABS).sum())} of "
              f"{diff.size} elements differ by more than {FLIP_ABS}", flush=True)
        if err > atol:
            fail(f"{name} {ckpt}: card vs CPU eval actions differ by {err:.3e} > {atol}")
        worst = max(worst, err)
    return worst


def main() -> int:
    if not osp.isdir(osp.join(REPO, "pointcloud_rl_torch")):
        fail(f"the port's package is not beside {__file__}; run from a checkout of the repo")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    kernels_only = "--kernels-only" in sys.argv[1:]

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    from pointcloud_rl_torch.ops import build as kbuild
    from pointcloud_rl_torch.ops import pointnet_fused as pf

    t0 = time.monotonic()
    lib_path = kbuild.build_library("pointnet_fused", verbose=True)
    pf.load_library()
    print(f"[build] {KERNEL_SOURCE} built and loaded in {time.monotonic() - t0:.1f} s", flush=True)
    hgmma = phase_sass(str(lib_path))

    report: dict = {}
    phase_kernels(pf, report, f"{kind} ({smi})")

    launches = {k: None for k in TPU_KERNELS}
    by_run: dict = {}
    if not kernels_only:
        work = tempfile.mkdtemp(prefix="chip_smoke_", dir=osp.join(REPO, "build"))
        summaries = {}
        try:
            for name, config, opts, prefix in RUNS:
                summaries[name] = summary = phase_train(work, name, config, opts, prefix)
                replay = summary["replay"]
                if name == "drq_device" and not (replay["type"] == "DeviceReplayMemory"
                                                 and replay["device"].startswith("cuda")
                                                 and replay["storage_bytes"] > 0):
                    fail(f"drq_device: the replay is {replay}, not a DeviceReplayMemory on cuda")
                phase_reference(name, config, opts, summary["models_dir"],
                                ACTION_ATOL_BF16 if "agent_cfg.bf16=True" in opts else ACTION_ATOL)
        finally:
            keep = osp.join(REPO, "build", "chip_smoke_logs")
            shutil.rmtree(keep, ignore_errors=True)
            shutil.copytree(work, keep, ignore=shutil.ignore_patterns("models", "*.py"))
            shutil.rmtree(work, ignore_errors=True)
        for name, summary in summaries.items():
            by_run[name] = summary["launches"]
            print(f"[{name}] {summary['env_steps_per_s']:.1f} env steps/s, "
                  f"{summary['updates_per_s']:.1f} updates/s over the main loop "
                  f"({summary['main_loop_s']:.1f} s) on {kind} ({smi})", flush=True)
        launches = {k: sum(run[k] for run in by_run.values()) for k in TPU_KERNELS}

    kernels = []
    for kname, rec in report.items():
        shp = rec["shapes"]
        slice_t = shp["slice_f32"]
        kernels.append({
            "name": kname, "route": "cuda", "source": KERNEL_SOURCE, "replaces": TPU_KERNELS[kname],
            "launches": launches[kname], "max_abs_err": rec["max_abs_err"],
            "ms": slice_t["ms"], "plain_ms": slice_t["plain_ms"],
            "bound_ms": slice_t["bound_ms"], "bound_by": slice_t["bound_by"],
            "bound_formula": BOUND_FORMULA, "share_of_bound": slice_t["bound_ms"] / slice_t["ms"],
            "library_ms": None,  # no single PyTorch call computes body + LayerNorm + max-pool
            "launches_by_run": {name: run[kname] for name, run in by_run.items()},
            **{f"{shape}_{key}": shp[shape][key] for shape in ("drq_f32", "drq_bf16", "act_f32", "act_bf16")
               for key in ("ms", "plain_ms", "bound_ms")},
            "walker_f32_ms": shp["walker_f32"]["ms"],
            "walker_bf16_ms": shp["walker_bf16"]["ms"],
            "walker_bf16_bound_ms": shp["walker_bf16"]["bound_ms"],
            "hgmma": hgmma[kname],
        })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    if kernels_only:
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
