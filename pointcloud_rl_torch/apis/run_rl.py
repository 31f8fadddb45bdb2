"""CLI entry point: config -> work dir -> env/agent construction -> training.

Port of ``pointcloud_rl_tpu/apis/run_rl.py`` with the same flags and
work-dir layout, plus ``--device``::

    python -m pointcloud_rl_torch.apis.run_rl configs/mfrl/sac/synthetic/pn_fake_manipulation.py \\
        --work-dir ./work_dirs/pn_fake --seed 0 --device cuda \\
        --cfg-options replay_cfg.capacity=20000 train_cfg.exp_logger_cfg.type=csv

``--num-devices N`` (or ``--gpu-ids``) with N > 1 trains data-parallel on
one host: this process spawns N ranks on a free local port, rank r on
``cuda:<gpu_ids[r]>`` over NCCL (``--device cpu``: N gloo ranks on the
CPU), and forwards SIGTERM to them.  Rank 0 alone collects, evaluates and
writes the logs, checkpoints and ``run_summary.json``; see
``parallel/mesh.py`` and ``train_rl``.

Across hosts, a launcher starts this module once per rank (``WORLD_SIZE``
or ``SLURM_NTASKS`` > 1), e.g. on each of two hosts H = 0, 1::

    torchrun --nnodes 2 --node-rank H --nproc-per-node 1 --master-addr A --master-port P \
        -m pointcloud_rl_torch.apis.run_rl <config> --device cuda --seed 0 --work-dir <shared dir>

or ``srun`` with ``MASTER_ADDR`` / ``MASTER_PORT`` exported.  Each rank
joins the world (``parallel.init_distributed``) on ``cuda:<LOCAL_RANK>``
(or ``--gpu-ids[LOCAL_RANK]``), the ranks are laid out over hosts
(``parallel.distributed.setup_hosts``), and each host's lead collects with
the same seeds as every other host, as the JAX package's hosts do, and
broadcasts its pushes to its host's ranks.  Rank 0 alone evaluates and
writes.  A resume reads ``<work_dir>/models``, so the work dir must be on a
filesystem every host sees: a rank that does not see the replay snapshot
starts with an empty replay.  ``--profile N`` traces the first N env steps
after the warm-up into ``<work_dir>/profile``: the kernels and the port's
spans (``utils/trace.py``; ``train_rl`` names them).

``--device cuda`` (the default) raises when no GPU is visible: nothing
moves to the CPU on its own.  The rollout and the evaluator (whose env
workers start through ``forkserver``) are built before the agent, i.e.
before the agent touches CUDA; with ``env_cfg.server_obs=True`` they fuse
their workers' raw renders on ``--device`` too.  The replay comes after the
agent, since a ``DeviceReplayMemory`` keeps its storage on the agent's
device.  Each run
writes ``run_summary.json`` into the work dir: the device, step counts,
throughput over the main loop, the replay (type, device, bytes of storage;
``replay_restored``: the transitions a resume restored from the
``train_cfg.save_replay`` snapshot ``models/replay_latest.h5``),
the fused-PointNet kernel launches of the process, the update programs'
counters (``programs``: eager first runs, captures, invalidations, and
each program's replays; ``algorithms/graphs.py``), evaluation results, and
the ``pointcloud_rl_tpu`` and ``jax`` modules loaded in the process
(none: the port stands alone).
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
               "n_checkpoint", "on_policy", "ep_stats_cfg", "save_replay", "stall_timeout")


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
                        help="torch.profiler trace of the first N env steps after the warm-up, in "
                             "<work_dir>/profile/trace.json: the kernels and the port's spans (train.cycle, "
                             "train.updates, sac.update, replay.sample, graphs.*, rollout.collect, forward_async.*, "
                             "obs_fuse, rollout.env_wait, rollout.push; utils/trace.py)")
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


def launched_world() -> int:
    """The size of the world a launcher started this process in
    (``WORLD_SIZE`` or ``SLURM_NTASKS``); 1 without one."""
    return max(int(os.environ.get(k, "1")) for k in ("WORLD_SIZE", "SLURM_NTASKS"))


def main(args=None) -> None:
    import logging

    add_env_vars()
    args = parse_args(args)
    outside = launched_world()
    if outside > 1 and args.num_devices is not None:
        raise ValueError(f"--num-devices {args.num_devices} spawns ranks on one host, but this process is a rank of "
                         f"a world of {outside} launched from outside (WORLD_SIZE or SLURM_NTASKS): drop "
                         "--num-devices, the launcher starts the ranks")
    num_devices = args.num_devices or (len(args.gpu_ids) if args.gpu_ids and outside == 1 else 1)
    cfg = load_config(args.config, args.cfg_options)
    if num_devices > 1:
        check_world(cfg, args, num_devices)
    elif outside > 1:
        check_split(cfg, args, outside)

    seed = set_host_seed(args.seed)
    work_dir = build_work_dir(cfg, args.config, args.work_dir, args.seed)
    lead = outside == 1 or int(os.environ.get("RANK", os.environ.get("SLURM_PROCID", "0"))) == 0
    logger = get_logger("pcrl", work_dir=work_dir if num_devices == 1 and lead else None,
                        level=logging.INFO if lead else logging.WARNING)
    logger.info(f"Work dir: {work_dir}; seed: {seed}; device: {args.device}; ranks: {max(num_devices, outside)}")
    if lead:
        cfg.dump(osp.join(work_dir, time.strftime("%Y%m%d_%H%M%S") + "-config.py"))
    if args.reproducible:
        from ..utils.collect_env import check_reproducibility

        check_reproducibility(strict=True)

    if num_devices > 1:
        spawn_ranks(work_dir, seed, args, num_devices)
    else:
        run(cfg, work_dir, seed, args, world=outside)
    if args.clean_up and lead:
        import shutil

        shutil.rmtree(work_dir, ignore_errors=True)


def gpu_ids_of(args, num_devices: int):
    """The GPU of each rank: ``--gpu-ids``, else 0..N-1."""
    ids = list(args.gpu_ids) if args.gpu_ids else list(range(num_devices))
    if len(ids) != num_devices:
        raise ValueError(f"--gpu-ids {ids} names {len(ids)} GPUs for --num-devices {num_devices}")
    return ids


def check_split(cfg: Config, args, ranks: int) -> None:
    """Refuse a data-parallel world that cannot run: an evaluation, and a
    global batch that does not split over the ranks."""
    if args.evaluation:
        raise ValueError("--evaluation runs in one process: drop --num-devices / --gpu-ids, or the launcher")
    batch = dict(cfg["agent_cfg"]).get("batch_size")
    if batch is not None and batch % ranks:
        raise ValueError(f"agent_cfg.batch_size={batch} does not split over {ranks} ranks")


def check_world(cfg: Config, args, num_devices: int) -> None:
    """Refuse a data-parallel world of spawned ranks that cannot run, before
    any rank starts: ``check_split``, and on CUDA fewer GPUs than ranks or
    two ranks on one GPU (NCCL refuses it)."""
    check_split(cfg, args, num_devices)
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
    """One data-parallel rank of one host: joins the process group from the
    environment the spawner sets (torchrun's variables) and runs ``run``;
    only rank 0 logs below warnings."""
    import logging

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world), GROUP_RANK="0")  # one host
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


def restore_replay(replay, work_dir: str) -> int:
    """Push ``<work_dir>/models/replay_latest.h5`` (``train_rl``'s
    ``save_replay`` snapshot), when there is one, into ``replay``; return
    the replay's length then.  In a data-parallel world every rank reads
    the file into its own replica, so each equals the 1-rank restore."""
    snap = osp.join(work_dir, "models", "replay_latest.h5")
    if replay is None or not osp.exists(snap):
        return 0
    replay.load_hdf5(snap)
    get_logger("pcrl").info(f"Restored replay snapshot: {len(replay)} transitions")
    return len(replay)


def gpu_of_rank(args) -> int:
    """The GPU of this rank: ``--gpu-ids[LOCAL_RANK]``, else ``LOCAL_RANK``."""
    from ..parallel.distributed import local_rank

    local = local_rank()
    if not args.gpu_ids:
        return local
    if local >= len(args.gpu_ids):
        raise ValueError(f"--gpu-ids {args.gpu_ids} names no GPU for local rank {local}")
    return args.gpu_ids[local]


def join_world(device: str) -> None:
    """Join the world the environment describes, unless this process has
    joined one already, and lay its ranks out over hosts."""
    import torch.distributed as dist

    from ..parallel.distributed import init_distributed, setup_hosts

    if not dist.is_initialized() and not init_distributed(device=device):
        raise RuntimeError(f"a world of {launched_world()} ranks: set MASTER_ADDR and MASTER_PORT to rank 0's host "
                           "and a free port (torchrun sets them)")
    setup_hosts()


def run(cfg: Config, work_dir: str, seed: int, args, world: int = 1) -> dict:
    """Build the env side, the agent and the replay, then train (or
    evaluate).  In a data-parallel world of ``world`` ranks this runs on
    every rank: each host's lead builds a rollout, seeded as every other
    host's, and rank 0 alone the evaluator."""
    from ..env import build_evaluation, build_replay, build_rollout, get_env_info
    from ..loggers import build_exp_logger
    from ..parallel.distributed import host_layout, is_host_lead, per_host

    logger = get_logger("pcrl")
    rank = 0
    if world > 1:
        import torch.distributed as dist

        join_world(args.device)
        rank = dist.get_rank()
    env_cfg = cfg["env_cfg"].to_dict() if hasattr(cfg["env_cfg"], "to_dict") else dict(cfg["env_cfg"])
    train_cfg = dict(cfg.get("train_cfg", {}))
    if rank == 0 and (train_cfg.get("save_replay") or 0) > 0:
        try:  # fail now, not at the first checkpoint
            import h5py  # noqa: F401
        except ImportError as e:
            raise ImportError(f"train_cfg.save_replay={train_cfg['save_replay']} writes HDF5 snapshots and needs "
                              "h5py (or set train_cfg.save_replay=0)") from e
    if cfg.get("expert_replay_cfg") and not dict(cfg["expert_replay_cfg"]).get("buffer_filenames"):
        raise ValueError("expert_replay_cfg needs buffer_filenames")

    env_info = get_env_info(env_cfg)
    logger.info(f"Env info: obs={env_info['obs_shape']}, action={env_info['action_shape']}, "
                f"discrete={env_info['is_discrete']}")
    resolve_agent_placeholders(cfg, env_info)

    # Env workers first (forkserver), then CUDA.  Every host collects with
    # the same seeds, as the JAX package's hosts do (ROADMAP C9).
    rollout = None
    if not args.evaluation and "rollout_cfg" in cfg and is_host_lead():
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

    agent = exp_logger = replay = expert_replay = None
    try:
        import torch

        from ..algorithms import build_agent
        from ..ops import pointnet_fused

        if args.debug:
            torch.autograd.set_detect_anomaly(True)
        if args.deterministic:
            torch.use_deterministic_algorithms(True)
        device, device_name = _check_device(args.device, gpu_of_rank(args) if world > 1 else None)
        agent_cfg = dict(cfg["agent_cfg"])
        agent_cfg["env_params"] = env_info
        agent_cfg.setdefault("seed", seed)
        agent_cfg["device"] = device
        agent = build_agent(agent_cfg)
        logger.info(f"Agent: {agent_cfg['type']}, params: {agent.num_params:,}, device: {device} ({device_name})")
        replay = build_replay(cfg.get("replay_cfg"), dict(seed=seed), device=device)
        # a demo/expert dataset (HDF5, streamed when larger than its
        # capacity) and a buffer of the recent collections, for agents whose
        # objectives read them
        expert_replay = build_replay(cfg.get("expert_replay_cfg") or None, dict(seed=seed), device=device)
        recent_traj_replay = build_replay(cfg.get("recent_traj_replay_cfg") or None, dict(seed=seed), device=device)
        if world > 1:
            from ..parallel import replicate_rollout, setup_data_parallel

            setup_data_parallel(agent, world, replay=replay)
            if "rollout_cfg" in cfg:
                rollout = replicate_rollout(rollout)

        resume_steps = 0
        resume_path = args.resume_from
        if resume_path is None and args.auto_resume:
            resume_path, resume_steps = find_checkpoint(work_dir)
        if resume_path:
            logger.info(f"Resuming from {resume_path} (step {resume_steps})")
            agent.load_state_dict(load_checkpoint(resume_path, device, keys_map=args.resume_keys_map))
            resume_steps = int(train_cfg.get("resume_steps", resume_steps))
        restored = restore_replay(replay, work_dir) if resume_path else 0

        exp_logger_cfg = train_cfg.pop("exp_logger_cfg", dict(type="tensorboard"))
        if isinstance(exp_logger_cfg, dict):
            exp_logger_cfg = dict(exp_logger_cfg)
            exp_logger_cfg["log_dir"] = osp.join(work_dir, "logs")
        if rank == 0:
            exp_logger = build_exp_logger(exp_logger_cfg)

        summary = {"device": str(device), "device_name": device_name, "resume_steps": resume_steps,
                   "world_size": world, "replay_restored": restored}
        pointnet_fused.reset_launch_counts()
        if args.evaluation:
            assert evaluator is not None, "--evaluation requires eval_cfg"
            agent.eval()
            lens, rewards, finishes = evaluator.run(agent, num=eval_num, work_dir=osp.join(work_dir, "eval"))
            summary["eval"] = {"rewards_mean": float(np.mean(rewards)), "lengths_mean": float(np.mean(lens)),
                               "success_rate": float(np.mean(finishes))}
        else:
            pushed = getattr(replay, "running_count", 0)
            out = train_rl(agent=agent, rollout=rollout, evaluator=evaluator, replay=replay,
                           work_dir=work_dir, exp_logger=exp_logger, resume_steps=resume_steps,
                           eval_num=eval_num, profile_steps=args.profile, expert_replay=expert_replay,
                           recent_traj_replay=recent_traj_replay,
                           **{k: v for k, v in train_cfg.items() if k in _TRAIN_KEYS})
            secs = max(out["main_loop_s"], 1e-9)
            summary.update(out, env_steps_per_s=out["main_loop_env_steps"] / secs,
                           updates_per_s=out["grad_steps"] / secs)
            # the transitions each host's rollout pushed into its replay
            pushed = getattr(replay, "running_count", 0) - pushed if is_host_lead() else None
            hosts = host_layout().hosts
            summary.update(hosts=len(hosts), ranks_per_host=[len(h) for h in hosts],
                           collected_steps_per_host=per_host(pushed))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        summary["replay"] = replay_summary(replay)
        summary["launches"] = dict(pointnet_fused.launch_counts)
        programs = getattr(agent, "_programs", None)  # none where the updates run eagerly
        summary["programs"] = programs.stats() if programs is not None else None
        summary["pointcloud_rl_tpu_modules"] = sorted(
            m for m in sys.modules if m.split(".")[0] == "pointcloud_rl_tpu")
        summary["jax_modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
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
        for buf in (replay, expert_replay):  # stops a dataset's prefetch thread
            if hasattr(buf, "close"):
                buf.close()
        if world > 1:
            import torch.distributed as dist

            from ..parallel.distributed import clear_hosts

            if dist.is_initialized():
                if agent is not None and hasattr(agent, "drop_programs"):
                    agent.drop_programs()  # the graphs that hold NCCL collectives go before the communicator
                dist.destroy_process_group()
            clear_hosts()


if __name__ == "__main__":
    main()
