#!/usr/bin/env python3
"""Where the time goes in a training slice of the PyTorch port, on one GPU.

    python3 tools/profile_torch_slice.py [--config CONFIG] [--cfg-options K=V ...]
        [--updates 20] [--cycles 50] [--out PATH]

    # the SAC slice (the default), then DrQ with a host replay, then DrQ on
    # the device replay with packed bf16 storage and the bf16 agent flag:
    python3 tools/profile_torch_slice.py
    python3 tools/profile_torch_slice.py --config configs/mfrl/drq/synthetic/pn_jitter_fake_manipulation.py
    python3 tools/profile_torch_slice.py --config configs/mfrl/drq/synthetic/pn_jitter_fake_manipulation.py \
        --cfg-options replay_cfg.type=DeviceReplayMemory replay_cfg.transfer_cfg.pack_features=True \
        agent_cfg.bf16=True replay_cfg.capacity=100000
    # DrQ with the voxel encoder (dense 32^3 grid), host replay:
    python3 tools/profile_torch_slice.py --config configs/mfrl/drq/synthetic/sparse_conv_shift_fake_manipulation.py
    # recurrent SAC (pn_rnn.py's settings: GRU 128, batch 64, windows of 8):
    python3 tools/profile_torch_slice.py --cfg-options agent_cfg.actor_cfg.nn_cfg.rnn_cfg.type=GRU \
        agent_cfg.actor_cfg.nn_cfg.rnn_cfg.hidden_size=128 agent_cfg.batch_size=64 \
        replay_cfg.sampling_cfg.type=TStepTransition replay_cfg.sampling_cfg.horizon=8
    # DDPG/TD3 on the SAC config:
    python3 tools/profile_torch_slice.py --cfg-options agent_cfg.type=DDPG

Builds the slice (the config at its full widths, a PointNet with
``fused=True``, 4 env workers, its replay: a host replay of ``replay_cfg.capacity=20000`` unless
``--cfg-options`` says otherwise, or a ``DeviceReplayMemory`` on the card)
exactly as ``run_rl`` does, fills the replay with random steps, then:

1. Collection: ``--cycles`` cycles of ``rollout.forward_with_policy(agent,
   n_steps)`` (4 env steps, one act encode at B=4 each), timed on the host
   clock; the rollout's own split (agent / simulation / copy) per cycle; and
   one profiled window of 10 cycles for the device time.
2. Update: ``--updates`` calls of ``agent.update_parameters`` (sampling,
   upload, the SAC or DrQ step, a replay of its captured CUDA graph, with
   the metric fetch): wall ms per update and its eager parts, each
   timed alone and synchronised (``replay.sample``: a host gather, or a
   gather on the card; a recurrent agent's ``replay.sample_windows``, the
   host gather of ``[B, H]`` windows, with the bytes of their obs and
   next_obs; the batch's preparation and upload, nothing to upload
   for a device replay; the step and its metric fetch); then under
   ``torch.profiler``: device busy ms per
   update, the card's idle share, and device ms per update by kernel (the
   fused PointNet kernels summed apart) and by op (``device_by_op``: each
   conv layer's forward, data-gradient and weight-gradient kernels by the
   layer's input shape, the voxelize scatter, grid zeroing, LayerNorm,
   copies such as permutes, max-pool, the masked max, matmuls; a recurrent
   model's GRU apart: its products and its elementwise kernels, forward and
   backward, found by a profiler range around the GRU's forward and the
   autograd sequence numbers of the ops inside it).
3. Where the encoder has convolutions: the same update with TF32
   convolutions (``ops/conv.ALLOW_TF32``, flipped by this tool only),
   timed and profiled the same way, after 5 updates of warm-up.

Prints one JSON object (and writes it to ``--out``).  Every time is measured
in this run on the card it names; the script fails without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import sys
import time

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SLICE_CONFIG = "configs/mfrl/sac/synthetic/pn_fake_manipulation.py"


def device_split(prof, n: int) -> dict:
    """Device ms per iteration: total busy, fused-body kernels, and the
    ten largest kernels by name."""
    by_name = {}
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False) or "#" in evt.key:
            continue  # ranges such as "Optimizer.step#Adam.step" span kernels counted below
        dt = getattr(evt, "self_device_time_total", None)
        if dt is None:
            dt = evt.self_cuda_time_total
        if dt and evt.device_type is not None and "CUDA" in str(evt.device_type):
            by_name[evt.key] = by_name.get(evt.key, 0.0) + dt / 1e3 / n
    total = sum(by_name.values())
    fused = sum(v for k, v in by_name.items()
                if "pointnet_body" in k or "prep_weights" in k or "merge_chunks" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ms": total, "fused_pointnet_ms": fused,
            "top_kernels_ms": {k[:90]: v for k, v in top}}


# (group, substrings of the aten op that launched the kernels); first match wins.
_OP_GROUPS = (
    ("conv_bwd", ("convolution_backward",)),
    ("conv_fwd", ("convolution", "conv3d", "conv2d")),
    ("voxelize_scatter", ("index_add", "scatter_add", "scatter_reduce")),
    ("grid_zeroing", ("fill_", "zero_")),
    ("layer_norm", ("layer_norm",)),
    ("copy_permute", ("copy_", "contiguous", "clone")),
    ("max_pool", ("max_pool",)),
    ("masked_max", ("amax", "where", "any")),
    ("matmul", ("mm", "linear", "matmul")),
)


GRU_RANGE = "gru"  # the profiler range the tool puts around the GRU's forward
_BACKWARD = "autograd::engine::evaluate_function"


def _gru_part(evt, gru_seq: set):
    """"gru" if a GRU forward range encloses ``evt``, "gru_bwd" if it runs
    inside the backward of an op of such a range, else None."""
    node = evt
    while node is not None:
        if node.name == GRU_RANGE:
            return "gru"
        if node.name.startswith(_BACKWARD) and getattr(node, "sequence_nr", -1) in gru_seq:
            return "gru_bwd"
        node = node.cpu_parent
    return None


def device_by_op(prof, n: int) -> dict:
    """Device ms per iteration, by the aten op that launched each kernel.
    Convolutions are split by layer (the input's shape) and, in the
    backward, into data-gradient (``dgrad``), weight-gradient (``wgrad``)
    and other kernels by the kernel's name.  The GRU's kernels are rows of
    their own: products (``matmul``) and the rest (``elementwise``), forward
    and backward."""
    out: dict = {}
    events = prof.events()
    gru_seq = {e.sequence_nr for e in events
               if getattr(e, "sequence_nr", -1) >= 0 and _gru_part(e, set()) == "gru"}

    def add(key, us):
        out[key] = out.get(key, 0.0) + us / 1e3 / n

    for evt in events:
        kernels = getattr(evt, "kernels", None)
        if not kernels or "CPU" not in str(evt.device_type):
            continue
        name = evt.name
        part = _gru_part(evt, gru_seq) if gru_seq else None
        if part is not None:
            kind = "matmul" if any(x in name for x in ("mm", "linear", "matmul")) else "elementwise"
            for k in kernels:
                add(f"{part}_{kind}", k.duration)
            continue
        group = next((g for g, subs in _OP_GROUPS if any(x in name for x in subs)), "other")
        shapes = getattr(evt, "input_shapes", None) or []
        for k in kernels:
            if group == "conv_fwd":
                add(f"conv_fwd {shapes[0] if shapes else '?'}", k.duration)
            elif group == "conv_bwd":
                part = "dgrad" if "dgrad" in k.name else "wgrad" if "wgrad" in k.name else "bwd_other"
                add(f"conv_{part} {shapes[1] if len(shapes) > 1 else '?'}", k.duration)
            else:
                add(group, k.duration)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def time_updates(agent, replay, first: int, n: int, acts) -> dict:
    """Wall ms per update over ``n`` updates, then ``n`` more under the
    profiler: device ms, idle share, by kernel and by op."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        agent.update_parameters(replay, first + i)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) * 1e3 / n
    with torch.profiler.profile(activities=[acts.CPU, acts.CUDA], record_shapes=True) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            agent.update_parameters(replay, first + n + i)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / n
    upd = device_split(prof, n)
    return {"ms_per_update": update_ms, "ms_per_update_profiled": profiled_ms, **upd,
            "device_idle_share": 1.0 - upd["device_ms"] / profiled_ms,
            "device_ms_by_op": device_by_op(prof, n)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=SLICE_CONFIG, help="config path, relative to the repo")
    ap.add_argument("--cfg-options", nargs="+", default=[], help="config overrides a.b=v, as run_rl takes them")
    ap.add_argument("--updates", type=int, default=20)
    ap.add_argument("--cycles", type=int, default=50)
    ap.add_argument("--out", default=osp.join(REPO, "chiprun_out", "profile_torch_slice.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slice: needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    from pointcloud_rl_torch.algorithms import build_agent
    from pointcloud_rl_torch.apis.run_rl import load_config, replay_summary, resolve_agent_placeholders
    from pointcloud_rl_torch.config import DictAction
    from pointcloud_rl_torch.env import build_replay, build_rollout, get_env_info
    from pointcloud_rl_torch.ops import conv as conv_ops
    from pointcloud_rl_torch.ops import pointnet_fused

    options = {"replay_cfg.capacity": 20000}
    options.update((k, DictAction._parse_value(v)) for k, v in (o.split("=", 1) for o in args.cfg_options))
    cfg = load_config(osp.join(REPO, args.config), options)
    visual = cfg["agent_cfg"]["actor_cfg"]["nn_cfg"]["visual_nn_cfg"]
    if visual["type"] == "PointNet":
        cfg = load_config(osp.join(REPO, args.config),
                          {"agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.fused": True, **options})
    env_cfg = dict(cfg["env_cfg"])
    info = get_env_info(env_cfg)
    resolve_agent_placeholders(cfg, info)
    train_cfg = dict(cfg["train_cfg"])
    n_steps = int(train_cfg.get("n_steps", 4))
    rollout_cfg = dict(cfg["rollout_cfg"], env_cfg=env_cfg, base_seed=0)
    rollout = build_rollout(rollout_cfg)
    try:
        device = torch.device("cuda", 0)
        agent = build_agent(dict(dict(cfg["agent_cfg"]), env_params=info, seed=0, device=device))
        rnn = agent.model.rnn
        if rnn is not None:  # a profiler range around each GRU forward
            rnn_forward = rnn.forward

            def ranged(*a, **kw):
                with torch.profiler.record_function(GRU_RANGE):
                    return rnn_forward(*a, **kw)

            rnn.forward = ranged
        replay = build_replay(cfg.get("replay_cfg"), dict(seed=0), device=device)
        rollout.forward_with_policy(None, 1024, replay)  # random warm-up fill
        card = torch.cuda.get_device_name(0)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
        acts = torch.profiler.ProfilerActivity

        # ---- collection cycles
        agent.eval()
        for _ in range(5):
            rollout.forward_with_policy(agent, n_steps, replay)
        split = {"agent_time": 0.0, "simulation_time": 0.0, "copy_time": 0.0, "overhead_time": 0.0}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.cycles):
            out = rollout.forward_with_policy(agent, n_steps, replay)
            for k in split:
                split[k] += out["_stats"][k]
        torch.cuda.synchronize()
        cycle_ms = (time.perf_counter() - t0) * 1e3 / args.cycles
        with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
            for _ in range(10):
                rollout.forward_with_policy(agent, n_steps, replay)
            torch.cuda.synchronize()
        collect = {"ms_per_cycle": cycle_ms, "env_steps_per_cycle": n_steps,
                   **{k.replace("_time", "_ms"): v * 1e3 / args.cycles for k, v in split.items()},
                   **device_split(prof, 10)}

        # ---- updates
        agent.train()
        for i in range(10):
            agent.update_parameters(replay, i + 1)
        torch.cuda.synchronize()
        pointnet_fused.reset_launch_counts()
        for i in range(args.updates):
            agent.update_parameters(replay, i + 11)
        torch.cuda.synchronize()
        launches = {k: v / args.updates for k, v in pointnet_fused.launch_counts.items()}
        parts = {"sample_ms": 0.0, "prepare_upload_ms": 0.0, "step_ms": 0.0}
        horizon = getattr(replay.sampling, "horizon", 8) if rnn is not None else None
        for _ in range(args.updates):
            t0 = time.perf_counter()
            sample = (replay.sample_windows(agent.batch_size, horizon) if rnn is not None
                      else replay.sample(agent.batch_size))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            batch = agent._prepare_batch(sample)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            metrics = agent._update_step(batch)
            torch.stack([v.detach().float().reshape(()) for v in metrics.values()]).cpu()
            t3 = time.perf_counter()
            for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                parts[k] += dt * 1e3 / args.updates
        first = 11 + 2 * args.updates
        obs_bytes = sum(int(v.nbytes) for key in ("obs", "next_obs")
                        for v in (sample[key].values() if isinstance(sample[key], dict) else [sample[key]]))
        update = {"launches_per_update": launches, **parts, "sample_obs_bytes": obs_bytes,
                  "sample_shape": [agent.batch_size] + ([horizon] if horizon else []),
                  **time_updates(agent, replay, first, args.updates, acts)}
        tf32 = None
        if visual["type"] in ("SparseCNN", "VoxelCNN", "NatureCNN", "DMCEncoder", "IMPALA"):  # convolutions
            conv_ops.ALLOW_TF32 = True
            agent.drop_programs()  # the captured updates hold the f32 convolutions
            try:
                for i in range(5):
                    agent.update_parameters(replay, first + 2 * args.updates + i)
                tf32 = time_updates(agent, replay, first + 2 * args.updates + 5, args.updates, acts)
            finally:
                conv_ops.ALLOW_TF32 = False
        result = {"card": card, "nvidia_smi": smi, "torch": torch.__version__, "config": args.config,
                  "cfg_options": args.cfg_options, "agent": type(agent).__name__,
                  "replay": replay_summary(replay), "collect": collect, "update": update,
                  "update_tf32_convs": tf32}
    finally:
        rollout.close()
    os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
