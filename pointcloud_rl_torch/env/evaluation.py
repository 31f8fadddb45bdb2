# Copy of pointcloud_rl_tpu/env/evaluation.py for the PyTorch port (that package's env imports JAX).
"""Deterministic policy evaluation with episode accounting.

Parity target: reference ``pyrl/env/evaluation.py`` — its own vec env,
slot-reuse episode bookkeeping (a finished env immediately takes the next
episode index), deterministic ``mode="eval"`` actions, optional mp4 videos
(imageio) and HDF5 trajectory dumps with env states, fixed eval level lists
from JSON/CSV, and a ``statistics.csv`` summary.
"""

from __future__ import annotations

import csv
import os
import os.path as osp
from typing import List, Optional, Tuple

import numpy as np

from ..utils.logger import get_logger
from .builder import EVALUATIONS, build_vec_env


def save_eval_statistics(work_dir: Optional[str], lens, rewards, finishes, logger=None) -> None:
    """statistics.csv + summary line (reference evaluation.py:25-49)."""
    logger = logger or get_logger("pcrl.eval")
    lens, rewards, finishes = np.asarray(lens), np.asarray(rewards), np.asarray(finishes)
    logger.info(
        f"Num of trails: {len(lens):.2f}, "
        f"Length: {lens.mean():.2f}±{lens.std():.2f}, "
        f"Reward: {rewards.mean():.2f}±{rewards.std():.2f}, "
        f"Success or Early Stop Rate: {finishes.mean():.2f}±{finishes.std():.2f}"
    )
    if work_dir is not None:
        os.makedirs(work_dir, exist_ok=True)
        with open(osp.join(work_dir, "statistics.csv"), "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["length", "reward", "finish"])
            for l, r, fin in zip(lens, rewards, finishes):
                writer.writerow([int(l), float(r), int(fin)])


class VideoWriter:
    """mp4 episode recorder (reference evaluation.py:139-144 uses imageio
    FFMPEG).  imageio's FFMPEG plugin needs the imageio-ffmpeg wheel; when
    absent (as in this image) fall back to OpenCV's bundled mp4v encoder —
    same .mp4 artifact, no extra dependency.  Frames are RGB uint8 HxWx3."""

    def __init__(self, path: str, fps: int = 20):
        self._path = path
        self._fps = fps
        self._backend = None
        self._w = None
        try:
            import imageio

            self._w = imageio.get_writer(path, fps=fps, format="FFMPEG", codec="libx264")
            self._backend = "imageio"
        except Exception:
            import cv2  # lazy writer: cv2 needs the frame size up front

            self._cv2 = cv2
            self._backend = "cv2"

    def append_data(self, frame) -> None:
        frame = np.asarray(frame)
        if frame.ndim == 2:
            frame = np.repeat(frame[..., None], 3, axis=-1)
        if self._backend == "imageio":
            self._w.append_data(frame)
            return
        if self._w is None:
            h, w = frame.shape[:2]
            self._w = self._cv2.VideoWriter(
                self._path, self._cv2.VideoWriter_fourcc(*"mp4v"), float(self._fps), (w, h)
            )
            if not self._w.isOpened():
                raise RuntimeError(f"cv2.VideoWriter failed to open {self._path}")
        self._w.write(frame[..., ::-1])  # RGB -> BGR

    def close(self) -> None:
        if self._w is not None:
            (self._w.close if self._backend == "imageio" else self._w.release)()
            self._w = None


@EVALUATIONS.register_module()
class Evaluation:
    def __init__(
        self,
        env_cfg: dict,
        num_procs: int = 1,
        num: int = 1,
        use_hidden_state: bool = False,
        save_traj: bool = False,
        save_video: bool = False,
        log_every_step: bool = False,
        eval_levels: Optional[List] = None,
        seed: Optional[int] = None,
        device="cuda",
        **kwargs,
    ):
        # ``device``: where a server_obs env fuses its observations
        self.vec_env = build_vec_env(env_cfg, num_procs, base_seed=seed, device=device)
        self.num_envs = self.vec_env.num_envs
        self.num = num
        self.save_traj = save_traj
        self.save_video = save_video
        self.log_every_step = log_every_step
        self.logger = get_logger("pcrl.eval")
        if isinstance(eval_levels, str):
            eval_levels = self._load_levels(eval_levels)
        self.eval_levels = eval_levels

    @staticmethod
    def _load_levels(path: str) -> List:
        import json

        if path.endswith(".json"):
            with open(path) as f:
                return json.load(f)
        with open(path) as f:
            return [int(x) for line in f for x in line.strip().split(",") if x]

    def run(self, pi, num: Optional[int] = None, work_dir: Optional[str] = None, **kwargs) -> Tuple[List, List, List]:
        """Run ``num`` deterministic episodes; returns (lens, rewards, finishes)
        with slot reuse across the vec env (reference evaluation.py:99-250)."""
        num = num or self.num
        video_writers = [None] * self.num_envs
        traj_buffers = [[] for _ in range(self.num_envs)] if self.save_traj else None
        traj_file = None
        if self.save_traj and work_dir is not None:
            import h5py

            os.makedirs(work_dir, exist_ok=True)
            traj_file = h5py.File(osp.join(work_dir, "trajectory.h5"), "w")

        def _dump_traj(slot, episode_idx):
            """One HDF5 group per episode: obs/actions/rewards/dones/env_states
            (reference evaluation.py:173-181,224-226)."""
            if traj_file is None or not traj_buffers[slot]:
                return
            from ..utils.tree_ops import tree_map as _tm

            steps = traj_buffers[slot]
            stacked = _tm(lambda *xs: np.stack(xs), *steps)
            group = traj_file.create_group(f"traj_{episode_idx}")

            def _write(g, node, name=None):
                if isinstance(node, dict):
                    sub = g.create_group(name) if name else g
                    for k, v in node.items():
                        _write(sub, v, str(k))
                else:
                    g.create_dataset(name, data=np.asarray(node), compression="gzip")

            _write(group, stacked)
            traj_buffers[slot] = []

        def _start_video(slot, episode_idx):
            if not self.save_video or work_dir is None:
                return None
            os.makedirs(work_dir, exist_ok=True)
            return VideoWriter(osp.join(work_dir, f"episode_{episode_idx}.mp4"), fps=20)

        # episode index currently being run in each env slot; slots beyond
        # ``num`` stay idle (None) so num < num_envs never over-indexes
        episode_idx = [i if i < num else None for i in range(self.num_envs)]
        next_episode = min(self.num_envs, num)
        lens = [0] * num
        rewards = [0.0] * num
        finishes = [False] * num

        reset_kwargs = {}
        if self.eval_levels is not None:
            reset_kwargs["level"] = [
                self.eval_levels[(i if i is not None else 0) % len(self.eval_levels)] for i in episode_idx
            ]
        obs = self.vec_env.reset(**reset_kwargs)
        for slot, ep in enumerate(episode_idx):
            if ep is None:
                continue
            video_writers[slot] = _start_video(slot, ep)
            if video_writers[slot] is not None:
                frame = self.vec_env.render(idx=[slot])
                video_writers[slot].append_data(np.asarray(frame[0]) if isinstance(frame, list) else np.asarray(frame))

        num_finished = 0
        while num_finished < num:
            actions = pi(self.vec_env.recent_obs, mode="eval")
            trans = self.vec_env.step_dict(np.asarray(actions), restart=False)
            if hasattr(pi, "reset_rnn_states") and trans["episode_dones"].any():
                pi.reset_rnn_states(trans["episode_dones"])
            env_states = self.vec_env.get_env_state() if self.save_traj else None
            for slot in range(self.num_envs):
                ep = episode_idx[slot]
                if ep is None or ep >= num:
                    continue
                lens[ep] += 1
                rewards[ep] += float(trans["rewards"][slot, 0])
                if traj_buffers is not None:
                    from ..utils.tree_ops import tree_slice as _ts

                    item = dict(
                        obs=_ts(trans["obs"], slot),
                        actions=trans["actions"][slot],
                        rewards=trans["rewards"][slot],
                        episode_dones=trans["episode_dones"][slot],
                    )
                    if env_states and isinstance(env_states[slot], dict) and env_states[slot]:
                        item["env_states"] = env_states[slot]
                    traj_buffers[slot].append(item)
                if video_writers[slot] is not None:
                    frame = self.vec_env.render(idx=[slot])
                    video_writers[slot].append_data(np.asarray(frame[0]) if isinstance(frame, list) else np.asarray(frame))
                if self.log_every_step:
                    self.logger.info(f"episode {ep} step {lens[ep]} reward {rewards[ep]:.3f}")
                if bool(trans["episode_dones"][slot, 0]):
                    # "finish" = terminated before the time limit (success/early stop)
                    finishes[ep] = bool(trans["dones"][slot, 0])
                    num_finished += 1
                    if traj_buffers is not None:
                        _dump_traj(slot, ep)
                    if video_writers[slot] is not None:
                        video_writers[slot].close()
                        video_writers[slot] = None
                    if next_episode < num:
                        episode_idx[slot] = next_episode
                        rk = {}
                        if self.eval_levels is not None:
                            rk["level"] = self.eval_levels[next_episode % len(self.eval_levels)]
                        self.vec_env.reset(idx=[slot], **rk)
                        video_writers[slot] = _start_video(slot, next_episode)
                        next_episode += 1
                    else:
                        episode_idx[slot] = None
        for w in video_writers:
            if w is not None:
                w.close()
        if traj_file is not None:
            traj_file.close()
        if work_dir is not None:
            save_eval_statistics(work_dir, lens, rewards, finishes, self.logger)
        return lens, rewards, finishes

    def close(self):
        self.vec_env.close()
