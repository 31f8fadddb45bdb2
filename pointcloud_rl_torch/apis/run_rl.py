"""CLI entry point: config -> work dir -> env/agent construction -> training.

Port of ``pointcloud_rl_tpu/apis/run_rl.py`` with the same flags and
work-dir layout, plus ``--device``::

    python -m pointcloud_rl_torch.apis.run_rl configs/mfrl/sac/synthetic/pn_fake_manipulation.py \\
        --work-dir ./work_dirs/pn_fake --seed 0 --device cuda \\
        --cfg-options replay_cfg.capacity=20000 train_cfg.exp_logger_cfg.type=csv

``--num-devices N`` (or ``--gpu-ids``) with N > 1 trains data-parallel:
this process spawns N ranks on a free local port, rank r on
``cuda:<gpu_ids[r]>`` over NCCL (``--device cpu``: N gloo ranks on the
CPU), and forwards SIGTERM to them.  Rank 0 alone collects, evaluates and
writes the logs, checkpoints and ``run_summary.json``; see
``parallel/mesh.py`` and ``train_rl``.  ``--profile N`` traces the first N
env steps after the warm-up into ``<work_dir>/profile``.

``--device cuda`` (the default) raises when no GPU is visible: nothing
moves to the CPU on its own.  The rollout and the evaluator (whose env
workers start through ``forkserver``) are built before the agent, i.e.
before the agent touches CUDA; with ``env_cfg.server_obs=True`` they fuse
their workers' raw renders on ``--device`` too.  The replay comes after the
agent, since a ``DeviceReplayMemory`` keeps its storage on the agent's
device.  Each run
writes ``run_summary.json`` into the work dir: the device, step counts,
throughput over the main loop, the replay (type, device, bytes of storage),
the fused-PointNet kernel launches of the process, evaluation results, and
the ``pointcloud_rl_tpu`` modules loaded in the process (none: the port
stands alone).
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
import time
from copy import deepcopy
from typing import Optional

import numpy as np

from ..config import Config, DictAction
from ..utils.checkpoint import find_checkpoint, load_checkpoint
from ..utils.logger import get_logger
from ..utils.seeding import add_env_vars, set_host_seed
from .train_rl import train_rl

_TRAIN_KEYS = ("total_steps", "warm_steps", "n_steps", "n_updates", "n_log", "n_eval",
               "n_checkpoint", "on_policy", "ep_stats_cfg")


def parse_args(args=None):
    parser = argparse.ArgumentParser(description="Train an RL agent (PyTorch/CUDA port)")
    parser.add_argument("config", help="config file path (.py with _base_ support)")
    parser.add_argument("--work-dir", default=None, help="directory to save logs and models")
    parser.add_argument("--seed", type=int, default=None, help="random seed")
    parser.add_argument("--cfg-options", nargs="+", action=DictAction, help="override config entries a.b=v")
    parser.add_argument("--evaluation", "--eval", dest="evaluation", action="store_true", help="eval only")
    parser.add_argument("--resume-from", default=None, help="checkpoint to resume from")
    parser.add_argument("--resume-keys-map", nargs="+", action=DictAction, default=None,
                        help="regex=replacement key rewrites applied to the restored checkpoint")
    parser.add_argument("--auto-resume", action="store_true", help="resume from latest checkpoint in work dir")
    parser.add_argument("--num-gpus", "--num-devices", dest="num_devices", type=int, default=None,
                        help="data-parallel ranks, one process each (default: len(--gpu-ids), else 1)")
    parser.add_argument("--gpu-ids", nargs="+", type=int, default=None, help="device indices")
    parser.add_argument("--debug", action="store_true", help="autograd anomaly detection")
    parser.add_argument("--deterministic", action="store_true",
                        help="deterministic torch algorithms (slower, reproducible)")
    parser.add_argument("--reproducible", action="store_true",
                        help="require a clean git tree and record the commit")
    parser.add_argument("--clean-up", action="store_true", help="remove the work dir after finishing")
    parser.add_argument("--profile", type=int, default=0, metavar="N",
                        help="torch.profiler trace of the first N env steps after the warm-up, "
                             "in <work_dir>/profile")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="device of the agent (default cuda; raises when no GPU is visible)")
    return parser.parse_args(args)


def build_work_dir(cfg: Config, config_path: str, work_dir: Optional[str], seed: Optional[int]) -> str:
    """work_dirs/<config_name>[/seed] layout."""
    name = osp.splitext(osp.basename(config_path))[0]
    root = work_dir or osp.join("./work_dirs", name)
    if seed is not None:
        root = osp.join(root, str(seed))
    os.makedirs(root, exist_ok=True)
    return osp.abspath(root)


def load_config(path: str, cfg_options: Optional[dict] = None) -> Config:
    """A config file with ``--cfg-options``-style overrides merged in."""
    cfg = Config.fromfile(path)
    if cfg_options:
        cfg.merge_from_dict(cfg_options)
    return cfg


def resolve_agent_placeholders(cfg: Config, env_info: dict) -> None:
    """Replace shape placeholders in ``cfg.agent_cfg`` (``"pcd_all_channel"``,
    ``"action_shape * 2"``) with the env's values, in place."""
    from ..models import get_kwargs_from_shape, replace_placeholder_with_args

    kwargs = get_kwargs_from_shape(env_info["obs_shape"], env_info["action_shape"])
    agent_cfg = cfg["agent_cfg"]
    cfg["agent_cfg"] = replace_placeholder_with_args(
        agent_cfg.to_dict() if hasattr(agent_cfg, "to_dict") else dict(agent_cfg), **kwargs)


def main(args=None) -> None:
    add_env_vars()
    args = parse_args(args)
    num_devices = args.num_devices or (len(args.gpu_ids) if args.gpu_ids else 1)
    if max(int(os.environ.get(k, "1")) for k in ("WORLD_SIZE", "SLURM_NTASKS")) > 1:
        raise NotImplementedError("a world launched from outside (WORLD_SIZE or SLURM_NTASKS > 1, e.g. torchrun "
                                  "across hosts) is not ported: run_rl spawns its own ranks on one host with "
                                  "--num-devices (ROADMAP.md queue A, item A10: multi-host, each host collecting)")
    cfg = load_config(args.config, args.cfg_options)
    if num_devices > 1:
        check_world(cfg, args, num_devices)

    seed = set_host_seed(args.seed)
    work_dir = build_work_dir(cfg, args.config, args.work_dir, args.seed)
    logger = get_logger("pcrl", work_dir=work_dir if num_devices == 1 else None)
    logger.info(f"Work dir: {work_dir}; seed: {seed}; device: {args.device}; ranks: {num_devices}")
    cfg.dump(osp.join(work_dir, time.strftime("%Y%m%d_%H%M%S") + "-config.py"))
    if args.reproducible:
        from ..utils.collect_env import check_reproducibility

        check_reproducibility(strict=True)

    if num_devices > 1:
        spawn_ranks(work_dir, seed, args, num_devices)
    else:
        run(cfg, work_dir, seed, args)
    if args.clean_up:
        import shutil

        shutil.rmtree(work_dir, ignore_errors=True)


def gpu_ids_of(args, num_devices: int):
    """The GPU of each rank: ``--gpu-ids``, else 0..N-1."""
    ids = list(args.gpu_ids) if args.gpu_ids else list(range(num_devices))
    if len(ids) != num_devices:
        raise ValueError(f"--gpu-ids {ids} names {len(ids)} GPUs for --num-devices {num_devices}")
    return ids


def check_world(cfg: Config, args, num_devices: int) -> None:
    """Refuse a data-parallel world that cannot run, before any rank starts:
    an evaluation, a global batch that does not split over the ranks, and
    on CUDA fewer GPUs than ranks or two ranks on one GPU (NCCL refuses it)."""
    if args.evaluation:
        raise ValueError("--evaluation runs in one process: drop --num-devices / --gpu-ids")
    batch = dict(cfg["agent_cfg"]).get("batch_size")
    if batch is not None and batch % num_devices:
        raise ValueError(f"agent_cfg.batch_size={batch} does not split over {num_devices} ranks")
    if args.device != "cuda":
        return
    import torch

    ids = gpu_ids_of(args, num_devices)
    if not torch.cuda.is_available():
        raise RuntimeError(f"--num-devices {num_devices} --device cuda: torch.cuda.is_available() is false "
                           "(pass --device cpu for gloo ranks on the CPU)")
    have = torch.cuda.device_count()
    if max(ids) >= have:
        raise RuntimeError(f"Need {num_devices} devices ({ids}), have {have}")
    if len(set(ids)) != len(ids):
        raise ValueError(f"--gpu-ids {ids}: NCCL runs one rank per GPU")


def spawn_ranks(work_dir: str, seed: int, args, num_devices: int) -> None:
    """Run ``num_devices`` ranks (``rank_main``) in spawned processes that
    meet on a free local port; SIGTERM to this process goes on to each."""
    import signal
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.start_processes(rank_main, args=(num_devices, port, work_dir, seed, args), nprocs=num_devices,
                             join=False, start_method="spawn")

    def forward(signum, frame):
        for proc in ctx.processes:
            if proc.is_alive():
                os.kill(proc.pid, signum)

    prev = signal.signal(signal.SIGTERM, forward)
    try:
        while not ctx.join():
            pass
    finally:
        signal.signal(signal.SIGTERM, prev)


def rank_main(rank: int, world: int, port: int, work_dir: str, seed: int, args) -> None:
    """One data-parallel rank: joins the process group from the environment
    the spawner sets and runs ``run``; only rank 0 logs below warnings."""
    import logging

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(rank))
    add_env_vars()
    set_host_seed(seed)
    get_logger("pcrl", work_dir=work_dir if rank == 0 else None,
               level=logging.INFO if rank == 0 else logging.WARNING)
    run(load_config(args.config, args.cfg_options), work_dir, seed, args, world=world)


def _check_device(name: str, gpu: Optional[int] = None):
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for, but torch.cuda.is_available() is false "
                           "(pass --device cpu to run on the CPU)")
    if name == "cuda" and gpu is not None:
        torch.cuda.set_device(gpu)
    device = torch.device("cuda", torch.cuda.current_device()) if name == "cuda" else torch.device("cpu")
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return device, device_name


def replay_summary(replay) -> Optional[dict]:
    """Type, device, capacity, length and bytes of storage of a replay."""
    if replay is None:
        return None
    from ..utils.tree_ops import tree_leaves

    storage = replay.storage if hasattr(replay, "storage") else replay.memory
    nbytes = 0 if storage is None else sum(int(x.nbytes) for x in tree_leaves(storage))
    return {"type": type(replay).__name__, "device": str(getattr(replay, "device", "cpu")),
            "capacity": replay.capacity, "size": len(replay), "storage_bytes": nbytes}


def run(cfg: Config, work_dir: str, seed: int, args, world: int = 1) -> dict:
    """Build the env side, the agent and the replay, then train (or
    evaluate).  In a data-parallel world of ``world`` ranks this runs on
    every rank; rank 0 alone builds the rollout and the evaluator."""
    from ..env import build_evaluation, build_replay, build_rollout, get_env_info
    from ..loggers import build_exp_logger

    logger = get_logger("pcrl")
    rank = int(os.environ["RANK"]) if world > 1 else 0
    if world > 1:
        from ..parallel import init_distributed

        init_distributed(device=args.device)  # from the environment rank_main set
    env_cfg = cfg["env_cfg"].to_dict() if hasattr(cfg["env_cfg"], "to_dict") else dict(cfg["env_cfg"])
    train_cfg = dict(cfg.get("train_cfg", {}))
    for key in ("expert_replay_cfg", "recent_traj_replay_cfg"):
        if cfg.get(key):
            raise NotImplementedError(f"{key} is not ported to pointcloud_rl_torch yet (ROADMAP.md queue A, item A1)")
    if train_cfg.get("save_replay"):
        raise NotImplementedError("train_cfg.save_replay is not ported to pointcloud_rl_torch yet "
                                  "(ROADMAP.md queue A, item A1)")

    env_info = get_env_info(env_cfg)
    logger.info(f"Env info: obs={env_info['obs_shape']}, action={env_info['action_shape']}, "
                f"discrete={env_info['is_discrete']}")
    resolve_agent_placeholders(cfg, env_info)

    # Env workers first (forkserver), then CUDA.
    rollout = None
    if not args.evaluation and "rollout_cfg" in cfg and rank == 0:
        rollout_cfg = dict(cfg["rollout_cfg"])
        rollout_cfg.setdefault("env_cfg", env_cfg)
        rollout_cfg.setdefault("base_seed", seed)
        rollout_cfg.setdefault("device", args.device)  # a server_obs env fuses there
        rollout = build_rollout(rollout_cfg)
    evaluator, eval_num = None, None
    if "eval_cfg" in cfg and rank == 0:
        eval_cfg = dict(cfg["eval_cfg"])
        merged_env = deepcopy(env_cfg)
        merged_env.update(dict(eval_cfg.pop("env_cfg", {})))
        eval_cfg["env_cfg"] = merged_env
        eval_cfg.setdefault("seed", (seed or 0) + 2**16)
        eval_cfg.setdefault("device", args.device)
        eval_num = eval_cfg.get("num", 1)
        evaluator = build_evaluation(eval_cfg)

    exp_logger = None
    try:
        import torch

        from ..algorithms import build_agent
        from ..ops import pointnet_fused

        if args.debug:
            torch.autograd.set_detect_anomaly(True)
        if args.deterministic:
            torch.use_deterministic_algorithms(True)
        device, device_name = _check_device(args.device, gpu_ids_of(args, world)[rank] if world > 1 else None)
        agent_cfg = dict(cfg["agent_cfg"])
        agent_cfg["env_params"] = env_info
        agent_cfg.setdefault("seed", seed)
        agent_cfg["device"] = device
        agent = build_agent(agent_cfg)
        logger.info(f"Agent: {agent_cfg['type']}, params: {agent.num_params:,}, device: {device} ({device_name})")
        replay = build_replay(cfg.get("replay_cfg"), dict(seed=seed), device=device)
        if world > 1:
            from ..parallel import replicate_rollout, setup_data_parallel

            dp = setup_data_parallel(agent, world, replay=replay)
            if "rollout_cfg" in cfg:
                rollout = replicate_rollout(rollout, dp)

        resume_steps = 0
        resume_path = args.resume_from
        if resume_path is None and args.auto_resume:
            resume_path, resume_steps = find_checkpoint(work_dir)
        if resume_path:
            logger.info(f"Resuming from {resume_path} (step {resume_steps})")
            agent.load_state_dict(load_checkpoint(resume_path, device, keys_map=args.resume_keys_map))
            resume_steps = int(train_cfg.get("resume_steps", resume_steps))

        exp_logger_cfg = train_cfg.pop("exp_logger_cfg", dict(type="tensorboard"))
        if isinstance(exp_logger_cfg, dict):
            exp_logger_cfg = dict(exp_logger_cfg)
            exp_logger_cfg["log_dir"] = osp.join(work_dir, "logs")
        if rank == 0:
            exp_logger = build_exp_logger(exp_logger_cfg)

        summary = {"device": str(device), "device_name": device_name, "resume_steps": resume_steps,
                   "world_size": world}
        pointnet_fused.reset_launch_counts()
        if args.evaluation:
            assert evaluator is not None, "--evaluation requires eval_cfg"
            agent.eval()
            lens, rewards, finishes = evaluator.run(agent, num=eval_num, work_dir=osp.join(work_dir, "eval"))
            summary["eval"] = {"rewards_mean": float(np.mean(rewards)), "lengths_mean": float(np.mean(lens)),
                               "success_rate": float(np.mean(finishes))}
        else:
            out = train_rl(agent=agent, rollout=rollout, evaluator=evaluator, replay=replay,
                           work_dir=work_dir, exp_logger=exp_logger, resume_steps=resume_steps,
                           eval_num=eval_num, profile_steps=args.profile,
                           **{k: v for k, v in train_cfg.items() if k in _TRAIN_KEYS})
            secs = max(out["main_loop_s"], 1e-9)
            summary.update(out, env_steps_per_s=out["main_loop_env_steps"] / secs,
                           updates_per_s=out["grad_steps"] / secs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        summary["replay"] = replay_summary(replay)
        summary["launches"] = dict(pointnet_fused.launch_counts)
        summary["pointcloud_rl_tpu_modules"] = sorted(
            m for m in sys.modules if m.split(".")[0] == "pointcloud_rl_tpu")
        logger.info(f"Fused PointNet kernel launches: {summary['launches']}")
        if rank == 0:
            with open(osp.join(work_dir, "run_summary.json"), "w") as f:
                json.dump(summary, f, indent=1)
        return summary
    finally:
        if rollout is not None:
            rollout.close()
        if evaluator is not None:
            evaluator.close()
        if exp_logger is not None:
            exp_logger.close()
        if world > 1:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()


if __name__ == "__main__":
    main()
