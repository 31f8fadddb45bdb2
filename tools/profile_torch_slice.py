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

Builds the slice (the config at its full widths with ``fused=True``, 4 env
workers, its replay: a host replay of ``replay_cfg.capacity=20000`` unless
``--cfg-options`` says otherwise, or a ``DeviceReplayMemory`` on the card)
exactly as ``run_rl`` does, fills the replay with random steps, then:

1. Collection: ``--cycles`` cycles of ``rollout.forward_with_policy(agent,
   n_steps)`` (4 env steps, one act encode at B=4 each), timed on the host
   clock; the rollout's own split (agent / simulation / copy) per cycle; and
   one profiled window of 10 cycles for the device time.
2. Update: ``--updates`` calls of ``agent.update_parameters`` (sampling,
   upload, the SAC or DrQ step): wall ms per update and its parts, each
   timed alone and synchronised (``replay.sample``: a host gather, or a
   gather on the card; the batch's preparation and upload, nothing to upload
   for a device replay; the step and its metric fetch); then under
   ``torch.profiler``: device busy ms per
   update, the card's idle share, and device ms per update by kernel (the
   fused PointNet kernels summed apart).

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
    from pointcloud_rl_torch.ops import pointnet_fused

    options = {"agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.fused": True, "replay_cfg.capacity": 20000}
    options.update((k, DictAction._parse_value(v)) for k, v in (o.split("=", 1) for o in args.cfg_options))
    cfg = load_config(osp.join(REPO, args.config), options)
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
        t0 = time.perf_counter()
        for i in range(args.updates):
            agent.update_parameters(replay, i + 11)
        torch.cuda.synchronize()
        update_ms = (time.perf_counter() - t0) * 1e3 / args.updates
        launches = {k: v / args.updates for k, v in pointnet_fused.launch_counts.items()}
        parts = {"sample_ms": 0.0, "prepare_upload_ms": 0.0, "step_ms": 0.0}
        for _ in range(args.updates):
            t0 = time.perf_counter()
            sample = replay.sample(agent.batch_size)
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
        with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(args.updates):
                agent.update_parameters(replay, i + 11 + args.updates)
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) * 1e3 / args.updates
        upd = device_split(prof, args.updates)
        update = {"ms_per_update": update_ms, "ms_per_update_profiled": profiled_ms,
                  "launches_per_update": launches, **parts, **upd,
                  "device_idle_share": 1.0 - upd["device_ms"] / profiled_ms}
        result = {"card": card, "nvidia_smi": smi, "torch": torch.__version__, "config": args.config,
                  "cfg_options": args.cfg_options, "agent": type(agent).__name__,
                  "replay": replay_summary(replay), "collect": collect, "update": update}
    finally:
        rollout.close()
    os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
