"""Host-side agent plumbing (port of ``pointcloud_rl_tpu/algorithms/base.py``).

An agent lives on one ``device``, the card unless the caller asks for the
CPU: observations come in as numpy trees (or tensors), go to that device,
and actions come back as numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..parallel.mesh import DataParallel


def example_obs_from_shape(obs_shape, batch: int = 1):
    """A zero observation batch matching the env's obs shapes (rgb is uint8,
    as the env emits it)."""
    if isinstance(obs_shape, dict):
        out = {}
        for k, shape in obs_shape.items():
            shape = (shape,) if isinstance(shape, int) else tuple(shape)
            out[k] = np.zeros((batch,) + shape, np.uint8 if k == "rgb" else np.float32)
        return out
    shape = (obs_shape,) if isinstance(obs_shape, int) else tuple(obs_shape)
    return np.zeros((batch,) + shape, np.float32)


def to_torch(tree: Any, device: torch.device) -> Any:
    """numpy tree -> tensors on ``device`` (dtypes kept: uint8 rgb stays uint8).
    Tensors already on ``device`` (a device replay's batch) pass through."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.as_tensor(np.asarray(tree)).to(device)


def pack_pointcloud_obs(obs: Dict[str, Any], spec=None):
    """Assemble a point-cloud obs dict into ONE channel-first array (and the
    robot state): xyz, rgb/255, pos_encoding, seg, as the PointNet's own
    preprocessing orders them, so the act uploads one array.

    ``spec`` (``ObsTransferSpec``): leave out the constant pos_encoding
    block (``_device_obs`` re-synthesizes it) and/or pack in the spec's
    narrower dtype."""
    drop_pos = spec is not None and spec.drop_pos_encoding
    feats = [np.asarray(obs["xyz"])]
    if "rgb" in obs:
        rgb = np.asarray(obs["rgb"])
        # divide in f32 (uint8 / 255), cast at the assignment
        feats.append(np.divide(rgb, np.float32(255.0), dtype=np.float32) if rgb.dtype == np.uint8 else rgb)
    for key in ("pos_encoding", "seg"):
        if key in obs and not (drop_pos and key == "pos_encoding"):
            feats.append(np.asarray(obs[key]))
    out_dtype = spec.pack_dtype if (spec is not None and spec.pack_dtype is not None) else np.float32
    ch = sum(f.shape[-2] for f in feats)
    packed = np.empty(feats[0].shape[:-2] + (ch,) + feats[0].shape[-1:], out_dtype)
    at = 0
    for f in feats:
        packed[..., at:at + f.shape[-2], :] = f
        at += f.shape[-2]
    state = obs.get("state", obs.get("agent"))
    return packed, (np.asarray(state, np.float32) if state is not None else None)


class ActionHandle:
    """The actions of one act that ``forward_async`` dispatched.

    ``host`` is a numpy view of host memory that holds only this act's
    actions once ``event`` (a ``torch.cuda.Event`` recorded after their
    copy) has completed; without an event they are there already.
    ``is_ready()`` never blocks, and ``np.asarray(handle)`` waits for the
    event and returns the actions."""

    def __init__(self, host: np.ndarray, event=None):
        self._host = host
        self._event = event

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._host if dtype is None else self._host.astype(dtype, copy=False)


class BaseAgent:
    """Common host plumbing; algorithm classes implement ``act`` and the update."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the agent's device is 'cuda' (the default), but torch.cuda.is_available() is "
                               'false: pass device="cpu" to run it on the CPU')
        self.modules: Dict[str, torch.nn.Module] = {}
        self.data_parallel = DataParallel()  # a world of one; parallel.setup_data_parallel makes it a rank
        self._rnn_states = None  # a recurrent agent's per-env state [B, L, H], threaded through act
        self.obs_transfer = None  # ObsTransferSpec (init_obs_transfer)
        self._fused_plan = None  # armed act-fused updates (SAC.set_fused_updates)

    def init_obs_transfer(self, cfg, obs_shape) -> None:
        """Arm ``obs_transfer_cfg`` (``algorithms/obs_transfer.py``) for the
        env's obs shapes: drop the constant pos_encoding block from the act
        upload and the update's batches and re-synthesize it on the device,
        and pack the act upload in a narrower dtype."""
        from .obs_transfer import make_obs_transfer

        self.obs_transfer = make_obs_transfer(cfg, obs_shape)

    def _device_obs(self, obs):
        """Complete an obs on the device: re-attach the pos_encoding block
        the spec dropped, and cast a packed upload to float32.  A no-op
        without a spec or when the obs already carry the block."""
        spec = self.obs_transfer
        if spec is None:
            return obs
        from .obs_transfer import complete_obs_dict, complete_packed

        if not isinstance(obs, dict):
            return complete_packed(obs, spec) if spec.drop_pos_encoding or spec.pack_dtype else obs
        if "packed" in obs:
            obs = dict(obs)
            obs["packed"] = complete_packed(obs["packed"], spec)
            return obs
        if spec.drop_pos_encoding:
            return complete_obs_dict(obs, spec)
        return obs

    def _upload_obs(self, obs):
        """The act's host -> device step: ``_host_obs``, the upload, then the
        completion on the device (``_device_obs``)."""
        return self._device_obs(to_torch(self._host_obs(obs), self.device))

    def _host_obs(self, obs):
        """The act's obs as they go up.  With a transfer spec, a point-cloud
        obs goes up as the spec asks: ``"dict"`` sends the model's leaves
        (xyz in ``pack_dtype``, rgb uint8) less the dropped block,
        ``"packed"`` one array from ``pack_pointcloud_obs``; on the device
        it is completed and cast to float32 (``_device_obs``)."""
        spec = self.obs_transfer
        if (spec is not None and isinstance(obs, dict) and "xyz" in obs
                and getattr(self, "inference_aug", None) is None):
            if spec.pack_mode == "dict":
                keep = ("xyz", "rgb", "seg", "state", "agent") + (
                    () if spec.drop_pos_encoding else ("pos_encoding",))
                obs = {k: v for k, v in obs.items() if k in keep}
                if spec.pack_dtype is not None:
                    obs["xyz"] = np.asarray(obs["xyz"]).astype(spec.pack_dtype)
            else:
                packed, state = pack_pointcloud_obs(obs, spec=spec)
                obs = packed if state is None else {"state": state, "packed": packed}
        return obs

    def train(self):
        for m in self.modules.values():
            m.train()
        return self

    def eval(self):
        for m in self.modules.values():
            m.eval()
        return self

    def act(self, obs, mode: str) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def forward_async(self, obs, mode: str = "explore", **kwargs) -> "ActionHandle":
        """Dispatch the act without waiting for its actions (the JAX
        package's ``forward_async``): the obs go up through ``_upload_obs``,
        which has read them when it returns; on a card the act runs on the
        current stream and its actions are copied into pinned host memory
        without blocking.  ``np.asarray`` on the returned handle waits for
        them, so the pipelined rollout can step other envs meanwhile.

        With act-fused updates armed (``SAC.set_fused_updates``), an explore
        act of a feed-forward agent takes the plan's chunk of updates first,
        in the same program (``_fused_act_dispatch``)."""
        obs = self._host_obs(obs)
        actions = None
        model = getattr(self, "model", None)
        if mode == "explore" and self._fused_plan is not None and not (model is not None and model.is_recurrent):
            actions = self._fused_act_dispatch(obs)
        if actions is None:
            actions = self.act(self._device_obs(to_torch(obs, self.device)), mode)
        if actions.device.type == "cpu":
            return ActionHandle(actions.numpy())
        host = torch.empty(actions.shape, dtype=actions.dtype, pin_memory=True)
        host.copy_(actions, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(actions.device))
        return ActionHandle(host.numpy(), event)

    def forward(self, obs, mode: str = "explore", **kwargs) -> np.ndarray:
        """obs (numpy tree, batched) -> actions (numpy [B, A])."""
        return np.asarray(self.forward_async(obs, mode=mode, **kwargs))

    def reset_rnn_states(self, dones=None) -> None:
        """Zero the recurrent states: all of them, or the rows of the envs
        whose ``dones`` ([B, 1]) are set."""
        if self._rnn_states is None:
            return
        if dones is None:
            self._rnn_states = None
        else:
            keep = 1.0 - torch.as_tensor(np.asarray(dones, np.float32)).reshape(-1, 1, 1)
            self._rnn_states = self._rnn_states * keep.to(self._rnn_states.device)

    def __call__(self, obs, mode: str = "explore", **kwargs):
        return self.forward(obs, mode=mode, **kwargs)

    def update_parameters(self, memory, updates: int) -> Dict[str, float]:
        raise NotImplementedError

    @property
    def num_params(self) -> int:
        model = self.modules.get("model")
        return 0 if model is None else int(sum(p.numel() for p in model.parameters()))
