"""Write a configuration file of the benchmark from a config of the port.

    python benchmark/tools/freeze_config.py <name>

resolves the port config that ``FROZEN[name]`` names against the
stand-in's observation shapes, applies its overrides, and writes
``benchmark/configs/<name>.json`` with the sections the harness builds
from (``agent_cfg``, ``replay_cfg``, ``rollout_cfg``, ``train_cfg``,
``env_cfg``), the shapes the FLOP count and the reference read, and the
description (source, reduced, assumed).  The harness reads only the written file, so a
later change to the port's config does not change a cell.
"""

from __future__ import annotations

import json
import os.path as osp
import sys

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))

WALKER = dict(image_size=[84, 84], n_points=512, num_ground=128, ground_eps=8e-3, max_depth=5.0, fovy=45.0,
              frame_skip=2)

FROZEN = {
    "drq_walker_pn": dict(
        port_config="configs/mfrl/drq/dm_control/pn_shift_tpu.py",
        source="https://arxiv.org/abs/2306.06799",
        description=("DrQ on DM Control point clouds, the paper's protocol (reference config "
                     "configs/mfrl/drq/dm_control/pn_shift.py): PointNet [64,128,256] -> 50, heads 1024x1024, "
                     "bf16 matmuls, batch 256 with 2 augmented copies, 3 frames x 512 points x 9 channels, "
                     "a packed bf16 device replay of 100000, 16 envs, 16 env steps : 16 updates, action_lag 1"),
        obs_shape={"xyz": [3, 1536], "rgb": [3, 1536], "pos_encoding": [3, 1536]},
        action_dim=6,
        overrides={"rollout_cfg": {"vec_backend": "thread"}},
        env=dict(kind="walker", frames=3, **WALKER),
        reduced=["env_cfg", "rollout_cfg"],
        assumed={
            "env_cfg": "dm_control's cheetah/walker is absent on the card's machine: 16 WalkerRawStandIn envs "
                       "(raw depth/rgb/camera renders of a procedural walker, 84x84) fused on the card by the "
                       "port's ServerObsVectorEnv into 3 x 512 points (128 on the ground)",
            "rollout_cfg.vec_backend": "thread: the stand-in is registered in the benchmark's process, so its "
                                       "envs step in threads of that process",
            "fill": "the updates traffic fills the replay to its 100000 capacity with seeded transitions shaped "
                    "and ranged like the stand-in's fused clouds",
            "weights": "seeded on the card by the benchmark (uniform +-1/sqrt(fan in); LayerNorms near 1 / 0)",
        },
    ),
    "sac_maniskill_pn": dict(
        port_config="configs/mfrl/sac/maniskill/pn.py",
        source="https://arxiv.org/abs/2306.06799",
        description=("SAC on ManiSkill PushChair point clouds: PointNet [128,128,256] -> 128 with the 38-dim "
                     "robot state, heads 1024x1024, f32, batch 256, 1200 points x 9 channels (xyz, rgb, seg), "
                     "4 env workers, 4 env steps : 1 update, a host replay of 100000"),
        obs_shape={"xyz": [3, 1200], "rgb": [3, 1200], "seg": [3, 1200], "state": [38]},
        action_dim=22,
        overrides={"agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.fused": True},
        env=dict(kind="maniskill", n_points=1200, min_pts=50, fg_pts=800),
        reduced=["env_cfg", "agent_cfg"],
        assumed={
            "env_cfg": "SAPIEN and mani_skill are absent on the card's machine: ManiSkillRawStandIn (6000 raw "
                       "points, 1500 on the ground, three segments and background, a 38-dim state, 22 actions) "
                       "behind the port's ManiSkillObsWrapper and its seg-balanced downsample to 1200 points",
            "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.fused": "true: the PointNet body runs on the port's fused "
                                                             "CUDA kernel (the config leaves it to the caller)",
            "weights": "seeded on the card by the benchmark (uniform +-1/sqrt(fan in); LayerNorms near 1 / 0)",
        },
    ),
}


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, slice):
        return {"__slice__": [x.start, x.stop, x.step]}
    if hasattr(x, "to_dict"):
        return _jsonable(x.to_dict())
    return x


def _set(cfg: dict, dotted: str, value) -> None:
    keys = dotted.split(".")
    for k in keys[:-1]:
        cfg = cfg.setdefault(k, {})
    cfg[keys[-1]] = value


def freeze(name: str) -> dict:
    import numpy as np

    sys.path.insert(0, ROOT)
    from pointcloud_rl_torch.apis.run_rl import load_config, resolve_agent_placeholders
    from pointcloud_rl_torch.env.spaces import Box

    f = FROZEN[name]
    ones = np.ones(f["action_dim"], np.float32)
    info = dict(obs_shape={k: tuple(v) for k, v in f["obs_shape"].items()}, action_shape=f["action_dim"],
                action_space=Box(-ones, ones), is_discrete=False)
    cfg = load_config(osp.join(ROOT, f["port_config"]))
    resolve_agent_placeholders(cfg, info)
    out = {k: _jsonable(cfg[k]) for k in ("agent_cfg", "replay_cfg", "rollout_cfg", "train_cfg", "env_cfg")}
    if f["env"]["kind"] == "walker":  # the stand-in's raw renders, fused on the card
        out["env_cfg"] = dict(type="WalkerRawStandIn", obs_mode="pointcloud", stack_frame=f["env"]["frames"],
                              server_obs=True, **WALKER)
    for section, value in f["overrides"].items():
        if "." in section:
            _set(out, section, value)
        else:
            out[section].update(value)
    agent = out["agent_cfg"]
    vis = agent["actor_cfg"]["nn_cfg"]["visual_nn_cfg"]
    amlp = agent["actor_cfg"]["nn_cfg"]["mlp_cfg"]["mlp_spec"]
    cmlp = agent["critic_cfg"]["nn_cfg"]["mlp_cfg"]["mlp_spec"]
    state = int(f["obs_shape"].get("state", [0])[0])
    points = int(f["obs_shape"]["xyz"][1])
    coeff = agent["update_coeff"]
    shapes = dict(batch_size=agent["batch_size"], num_aug=agent.get("num_aug", 1), points=points,
                  channels=vis["feat_dim"], widths=vis["mlp_spec"], feature=vis["out_channels"], state=state,
                  action=f["action_dim"], hidden=amlp[1:-1], heads=agent["critic_cfg"]["num_heads"],
                  actor_interval=agent["actor_update_interval"])
    aug = agent.get("obs_aug") or {}
    reference = dict(algo=agent["type"], encoder=vis["type"].lower(), batch_size=agent["batch_size"],
                     num_aug=agent.get("num_aug", 1),
                     gamma=agent["gamma"], alpha=agent["alpha"], action_dim=f["action_dim"],
                     actor_update_interval=agent["actor_update_interval"],
                     target_update_interval=agent["target_update_interval"],
                     target_tau=coeff["default"] if isinstance(coeff, dict) else coeff,
                     actor_layers=len(amlp) - 1, critic_layers=len(cmlp) - 1,
                     critic_heads=agent["critic_cfg"]["num_heads"],
                     log_std_bound=agent["actor_cfg"]["head_cfg"]["log_std_bound"],
                     lr={"critic": agent["critic_cfg"]["optim_cfg"]["lr"],
                         "actor": agent["actor_cfg"]["optim_cfg"]["lr"],
                         "alpha": agent["alpha_optim_cfg"]["lr"]},
                     betas={"critic": [0.9, 0.999], "actor": [0.9, 0.999],
                            "alpha": list(agent["alpha_optim_cfg"].get("betas", [0.9, 0.999]))},
                     translation=aug.get("translation_range"),
                     packed=bool(out["replay_cfg"].get("transfer_cfg", {}).get("pack_features")))
    precision = "bfloat16" if agent.get("bf16") else "float32"
    return {
        "name": name,
        "source": f["source"],
        "port_config": f["port_config"],
        "description": f["description"],
        "precision": precision,
        "control": "float8" if precision == "bfloat16" else "tf32",
        "obs_shape": f["obs_shape"],
        "action_dim": f["action_dim"],
        "env": f["env"],
        **out,
        "shapes": shapes,
        "reference": reference,
        "reduced": f["reduced"],
        "assumed": f["assumed"],
    }


if __name__ == "__main__":
    for name in sys.argv[1:] or sorted(FROZEN):
        path = osp.join(ROOT, "benchmark", "configs", f"{name}.json")
        with open(path, "w") as fh:
            json.dump(freeze(name), fh, indent=1)
            fh.write("\n")
        print(path)
