"""Data augmentations as tensor ops on the data's device.

Port of ``pointcloud_rl_tpu/ops/augment.py``.  Each augmentation is a
callable ``aug(generator, data)`` over a data dict: the same sampled
transform is applied to every requested key, sampling is per batch element
where the reference does so, and "vel" keys rotate but do not translate.

Randomness comes from an explicit ``torch.Generator`` on the data's device,
passed in as the JAX package passes its key.  Every draw of a class sits in
one method (``sample_info`` or a small ``_draw_*``), so a test can inject
the same values into both packages.  A JAX key is folded once per
transform and per key; here each transform and key draws from the
generator in turn, which gives independent draws in the same order.
Draws over the batch axis go through ``utils.draws.draw_rows``, so a
data-parallel rank draws for the global batch and keeps its rows.

Layout contract: point clouds are channel-first ``[B, 3, N]`` leaves (env
contract), robot state vectors ``[B, 3]``/``[B, 2]``, images ``[B, C, H, W]``.
None of these is a kernel of its own: on a CUDA tensor each runs as a
handful of PyTorch ops on the card, with no host round trip.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..registry import Registry, build_from_cfg
from ..utils.draws import draw_rows
from ..utils.tree_ops import tree_map

AUGMENTATIONS = Registry("augmentation")


# ---------------------------------------------------------------- tree paths
def path_get(data, path: str):
    node = data
    for part in path.strip("/").split("/"):
        if part not in node:
            return None
        node = node[part]
    return node


def path_set(data, path: str, value) -> None:
    parts = path.strip("/").split("/")
    node = data
    for part in parts[:-1]:
        node = node[part]
    node[parts[-1]] = value


def _shallow_copy(data):
    if isinstance(data, dict):
        return {k: _shallow_copy(v) for k, v in data.items()}
    return data


def _device_constant(owner, name, device, make) -> torch.Tensor:
    """``make()`` (a CPU tensor) on ``device``, uploaded once per device and
    kept on ``owner``: an upload inside a captured CUDA graph of the update
    would be a host copy, which the capture refuses."""
    cache = owner.__dict__.setdefault("_device_constants", {})
    key = (name, torch.device(device))
    if key not in cache:
        cache[key] = make().to(device)
    return cache[key]


def _uniform(generator, shape, low, high, device) -> torch.Tensor:
    """Uniform f32 in [low, high) drawn from ``generator`` on ``device``."""
    u = draw_rows(lambda s: torch.rand(s, generator=generator, device=device, dtype=torch.float32), shape)
    return u * (float(high) - float(low)) + float(low)


class BaseAugmentation:
    """Same-transform-across-keys contract (reference builder.py:49-96)."""

    def __init__(self, main_key=None, req_keys=None):
        self.main_key = main_key
        self.req_keys = list(req_keys) if req_keys is not None else ([main_key] if main_key else None)

    def sample_info(self, generator, main_data):
        return None

    def apply_single(self, data, key, info, generator):
        return data

    def __call__(self, generator, data):
        data = _shallow_copy(data)
        main = path_get(data, self.main_key) if self.main_key else data
        info = self.sample_info(generator, main)
        for key in (self.req_keys if self.req_keys else [None]):
            if key is None:
                data = self.apply_single(data, None, info, generator)
            else:
                item = path_get(data, key)
                if item is not None:
                    path_set(data, key, self.apply_single(item, key, info, generator))
        return data


class DataAugmentations:
    """Compose; each transform draws from the generator in turn."""

    def __init__(self, transforms: Sequence):
        self.transforms = []
        for t in transforms:
            if isinstance(t, dict):
                t = build_from_cfg(dict(t), AUGMENTATIONS)
            self.transforms.append(t)

    def __call__(self, generator, data):
        for t in self.transforms:
            data = t(generator, data)
        return data


def build_data_augmentations(cfg) -> Optional[DataAugmentations]:
    if cfg is None:
        return None
    if not isinstance(cfg, (list, tuple)):
        cfg = [cfg]
    return DataAugmentations(cfg)


def augs_are_xyz_only(augs: Optional[DataAugmentations]) -> bool:
    """True when every transform touches only the ``xyz`` key: the
    precondition for applying the stack to packed replay storage."""
    if augs is None:
        return True
    return all(t.main_key == "xyz" and list(t.req_keys or []) == ["xyz"] for t in augs.transforms)


def apply_augs_to_packed(augs: DataAugmentations, generator, obs: Dict[str, Any]) -> Dict[str, Any]:
    """Run an xyz-only stack on packed replay storage.

    ``obs["pcd"]`` is the channel-LAST model-input tensor ``[..., N, C]``
    built by ``pack_device_features`` (channels xyz, rgb, pos_encoding,
    seg).  The xyz block is lifted to the stack's ``[B, 3, N]`` f32 layout,
    transformed, and spliced back in the storage dtype."""
    pcd = obs["pcd"]
    xyz = pcd[..., :3].transpose(-1, -2).float()  # [B, 3, N]
    out = augs(generator, {"xyz": xyz})
    aug_xyz = out["xyz"].transpose(-1, -2).to(pcd.dtype)
    obs = dict(obs)
    obs["pcd"] = torch.cat([aug_xyz, pcd[..., 3:]], dim=-1)
    return obs


# ------------------------------------------------------------- point clouds
def rot_matrix_about_axis(angle: torch.Tensor, axis: int) -> torch.Tensor:
    """[B] angles -> [B, 3, 3] rotations about x/y/z
    (reference pyrl/utils/torch/ops.py:171 batch_rot_with_axis)."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    if axis == 2:  # z
        rows = [c, -s, z, s, c, z, z, z, o]
    elif axis == 1:  # y
        rows = [c, z, s, z, o, z, -s, z, c]
    else:  # x
        rows = [o, z, z, z, c, -s, z, s, c]
    return torch.stack(rows, dim=-1).reshape(angle.shape[0], 3, 3)


@AUGMENTATIONS.register_module()
class GlobalRotScaleTrans(BaseAugmentation):
    """Global rotation/scale/translation of the scene (pcd_aug.py:126-227).

    One 3x3 matrix and one shift per batch element, shared by all req_keys;
    "vel" keys are rotated and scaled but not translated; 2-D keys use the
    top-left 2x2 block.  ``rot_range=None`` skips the rotation."""

    def __init__(self, main_key="xyz", req_keys=("xyz",), rot_range=(-0.78539816, 0.78539816), rot_axis="z",
                 scale_ratio_range=(0.95, 1.05), translation_range=(0, 0, 0), shift_height=False):
        super().__init__(main_key, req_keys)
        if rot_range is not None and not isinstance(rot_range, (list, tuple, np.ndarray)):
            rot_range = [-rot_range, rot_range]
        self.rot_range = rot_range
        self.rot_axis = (ord(rot_axis) - ord("x")) if isinstance(rot_axis, str) else int(rot_axis)
        self.scale_ratio_range = scale_ratio_range
        self.translation_range = None if translation_range is None else np.asarray(translation_range, np.float32)
        self.shift_height = shift_height

    def sample_info(self, generator, main_data):
        B, dev = main_data.shape[0], main_data.device
        rot = None
        if self.rot_range is not None:
            rot = rot_matrix_about_axis(_uniform(generator, (B,), *self.rot_range, dev), self.rot_axis)
        if self.scale_ratio_range is not None:
            # a [B, 3, 1] scale: an independent scale per row of the matrix
            scale = _uniform(generator, (B, 3, 1), *self.scale_ratio_range, dev)
            base = torch.eye(3, device=dev).expand(B, 3, 3) if rot is None else rot
            rot = base * scale
        if self.translation_range is not None:
            trange = _device_constant(self, "translation_range", dev, lambda: torch.from_numpy(self.translation_range))
            delta = (draw_rows(lambda s: torch.rand(s, generator=generator, device=dev), (B, 3)) - 0.5) * 2.0 * trange
            if not self.shift_height:
                delta[..., 2] = 0.0
        else:
            delta = torch.zeros((B, 3), device=dev)
        return rot, delta

    def apply_single(self, data, key, info, generator):
        rot, delta = info
        is_vel = "vel" in (key or "")
        dims = data.shape[-2] if data.dim() == 3 else data.shape[-1]
        t = delta[..., :dims]
        x = data.float()
        if x.dim() == 3:  # [B, C, N]
            if rot is not None:
                x = torch.einsum("bji,bin->bjn", rot[..., :dims, :dims], x)
            if not is_vel and self.translation_range is not None:
                x = x + t[..., None]
        else:  # [B, C]
            if rot is not None:
                x = torch.einsum("bji,bi->bj", rot[..., :dims, :dims], x)
            if not is_vel and self.translation_range is not None:
                x = x + t
        return x.to(data.dtype) if data.is_floating_point() else x


@AUGMENTATIONS.register_module()
class RandomJitterPoints(BaseAugmentation):
    """Per-point uniform coordinate noise (pcd_aug.py:307-327)."""

    def __init__(self, main_key="xyz", req_keys=None, jitter_range=(-0.1, 0.1)):
        super().__init__(main_key, req_keys)
        self.jitter_range = jitter_range

    def _draw_noise(self, generator, shape, device) -> torch.Tensor:
        return _uniform(generator, shape, self.jitter_range[0], self.jitter_range[1], device)

    def apply_single(self, data, key, info, generator):
        return data + self._draw_noise(generator, data.shape, data.device).to(data.dtype)


@AUGMENTATIONS.register_module()
class RandomDownSample(BaseAugmentation):
    """Drop a fixed ratio of points with one shared permutation
    (pcd_aug.py:232-267: the same point subset for the whole batch).

    ``fixed_ratio=False`` keeps a random count of points; N stays fixed and
    the tail is padded with copies of the kept points (pad-by-tiling),
    which a max-pool encoder cannot tell from dropping them."""

    def __init__(self, main_key="xyz", req_keys=("xyz",), max_num_points=None, drop_ratio=None, fixed_ratio=True):
        super().__init__(main_key, req_keys)
        if (drop_ratio is None) == (max_num_points is None):
            raise ValueError("RandomDownSample takes exactly one of drop_ratio and max_num_points")
        self.max_num_points = max_num_points
        self.drop_ratio = drop_ratio
        self.fixed_ratio = fixed_ratio

    def sample_info(self, generator, main_data):
        N, dev = main_data.shape[-1], main_data.device
        perm = torch.randperm(N, generator=generator, device=dev)
        min_keep = N - int(N * self.drop_ratio) if self.drop_ratio is not None else min(self.max_num_points, N)
        if self.fixed_ratio:
            return perm[:min_keep], None
        keep = torch.randint(min_keep, N + 1, (), generator=generator, device=dev)
        pos = torch.arange(N, device=dev)
        tiled = perm[torch.remainder(pos, keep.clamp(min=1))]
        return torch.where(pos < keep, perm, tiled), keep

    def apply_single(self, data, key, info, generator):
        index, _ = info
        return data.index_select(-1, index)


@AUGMENTATIONS.register_module()
class RandomDownSampleAndFilter(BaseAugmentation):
    """Segmentation-aware random downsample with a per-frame foreground
    budget (the JAX package's semantics: per stacked frame, ``n_fg`` points
    where ``filter_seg`` is true and ``n_points - n_fg`` from the rest,
    pad-by-tiling when a side is short, zero-fill of xyz/rgb when a side is
    empty, the SAME indices gathered from every requested key and the seg
    key)."""

    def __init__(self, main_key="xyz", req_keys=("xyz", "rgb", "pos_encoding"),
                 func_keys=("xyz", "filter_seg"), func_key_map='lambda _: _.split("_")[-1]',
                 n_points=512, n_fg=292, stack_frame=1):
        super().__init__(main_key, req_keys)
        self.n_points = int(n_points)
        self.n_fg = int(n_fg)
        if not 0 <= self.n_fg <= self.n_points:
            raise ValueError(f"n_fg {self.n_fg} must lie in [0, n_points {self.n_points}]")
        self.stack_frame = int(stack_frame)
        key_map = eval(func_key_map) if isinstance(func_key_map, str) else (func_key_map or (lambda k: k))
        self.seg_key = next((k for k in func_keys if key_map(k) == "seg"), "seg")

    def _draw_scores(self, generator, shape, device) -> torch.Tensor:
        return draw_rows(lambda s: torch.rand(s, generator=generator, device=device), shape)

    def _frame_indices(self, generator, seg):
        """seg: [B, Nf] bool for ONE frame -> ([B, n_points] indices into
        Nf, [B, n_points] validity).  Foreground picks first, then the rest."""
        B, Nf = seg.shape
        scores = self._draw_scores(generator, (B, Nf), seg.device)

        def _side(mask, count):
            order = torch.argsort(torch.where(mask, scores, scores + 2.0), dim=-1, stable=True)
            avail = mask.sum(dim=-1, keepdim=True)  # [B, 1]
            pos = torch.arange(count, device=seg.device)[None, :]
            pos = torch.where(pos < avail, pos, torch.remainder(pos, avail.clamp(min=1)))
            return torch.gather(order, -1, pos), (avail > 0).expand(B, count)

        fg_idx, fg_valid = _side(seg, self.n_fg)
        bg_idx, bg_valid = _side(~seg, self.n_points - self.n_fg)
        return torch.cat([fg_idx, bg_idx], dim=-1), torch.cat([fg_valid, bg_valid], dim=-1)

    def __call__(self, generator, data):
        data = _shallow_copy(data)
        seg = path_get(data, self.seg_key)
        if seg is None:
            raise KeyError(f"RandomDownSampleAndFilter: missing '{self.seg_key}' in obs")
        if seg.dim() == 3:  # channel-first [B, 1, N]
            seg = seg[:, 0, :]
        seg = seg.bool()
        N = seg.shape[-1]
        if N % self.stack_frame:
            raise ValueError(f"{N} points do not split into {self.stack_frame} frames")
        Nf = N // self.stack_frame
        if self.n_points > Nf:
            raise ValueError(f"n_points {self.n_points} > frame size {Nf}")
        idx_frames, valid_frames = [], []
        for f in range(self.stack_frame):
            idx_f, valid_f = self._frame_indices(generator, seg[..., f * Nf:(f + 1) * Nf])
            idx_frames.append(idx_f + f * Nf)
            valid_frames.append(valid_f)
        index = torch.cat(idx_frames, dim=-1)  # [B, stack * n_points]
        valid = torch.cat(valid_frames, dim=-1)
        for key in list(self.req_keys) + [self.seg_key]:
            item = path_get(data, key)
            if item is None:
                continue
            gather_idx = index[:, None, :].expand(item.shape[0], item.shape[1], index.shape[-1])
            picked = torch.gather(item, -1, gather_idx)  # [B, C, stack*n_points]
            if key in ("xyz", "rgb"):  # an empty side's values are zero-filled
                picked = picked * valid[:, None, :].to(picked.dtype)
            path_set(data, key, picked)
        return data


@AUGMENTATIONS.register_module()
class ColorJitterPoints(BaseAugmentation):
    """Brightness/contrast/saturation/hue jitter on [B, 3, N] colors
    (pcd_aug.py:270-303): one factor of each per call, for the whole batch,
    applied in a random order.  The order stays on the device: each step
    computes the four candidates and selects one, with no host read."""

    def __init__(self, main_key="rgb", req_keys=("rgb",), brightness=0.5, contrast=0.5, saturation=0.5, hue=0.5):
        super().__init__(main_key, req_keys)
        self.brightness, self.contrast, self.saturation, self.hue = brightness, contrast, saturation, hue

    def sample_info(self, generator, main_data):
        dev = main_data.device
        b = _uniform(generator, (), max(0.0, 1 - self.brightness), 1 + self.brightness, dev)
        c = _uniform(generator, (), max(0.0, 1 - self.contrast), 1 + self.contrast, dev)
        s = _uniform(generator, (), max(0.0, 1 - self.saturation), 1 + self.saturation, dev)
        h = _uniform(generator, (), -self.hue, self.hue, dev)
        order = torch.randperm(4, generator=generator, device=dev)
        return b, c, s, h, order

    def apply_single(self, data, key, info, generator):
        b, c, s, h, order = info
        x = data.float() / 255.0 if data.dtype == torch.uint8 else data.float()  # [B, 3, N] in [0, 1]

        def _gray(x):
            return 0.2989 * x[:, 0] + 0.587 * x[:, 1] + 0.114 * x[:, 2]

        def _brightness(x):
            return (x * b).clamp(0.0, 1.0)

        def _contrast(x):
            mean = _gray(x).mean(dim=-1, keepdim=True)[:, None]
            return (x * c + (1 - c) * mean).clamp(0.0, 1.0)

        def _saturation(x):
            return (x * s + (1 - s) * _gray(x)[:, None]).clamp(0.0, 1.0)

        def _hue(x):
            # hue rotation in YIQ space, as the JAX package computes it
            theta = 2 * math.pi * h
            cos_t, sin_t = torch.cos(theta), torch.sin(theta)
            one, zero = torch.ones_like(cos_t), torch.zeros_like(cos_t)
            tyiq = _device_constant(self, "tyiq", x.device, lambda: torch.tensor(
                [[0.299, 0.587, 0.114], [0.596, -0.274, -0.321], [0.211, -0.523, 0.311]]))
            ityiq = _device_constant(self, "ityiq", x.device, lambda: torch.tensor(
                [[1.0, 0.956, 0.621], [1.0, -0.272, -0.647], [1.0, -1.107, 1.705]]))
            rot = torch.stack([one, zero, zero, zero, cos_t, -sin_t, zero, sin_t, cos_t]).reshape(3, 3)
            m = ityiq @ rot @ tyiq
            return torch.einsum("ij,bjn->bin", m, x).clamp(0.0, 1.0)

        fns = (_brightness, _contrast, _saturation, _hue)
        for step in range(4):
            candidates = torch.stack([fn(x) for fn in fns])
            x = candidates.index_select(0, order[step:step + 1])[0]
        if data.dtype == torch.uint8:
            return (x * 255.0 + 0.5).to(torch.uint8)
        return x.to(data.dtype)


@AUGMENTATIONS.register_module()
class AddOriginBall(BaseAugmentation):
    """Append n_pts Gaussian points at the origin (pcd_aug.py:330-359), for
    PushChair's origin-centered target-ball indicator; seg and rgb get zeros."""

    def __init__(self, main_key="xyz", req_keys=None, n_pts=50, noise_std=0.02):
        super().__init__(main_key, req_keys or [main_key])
        self.n_pts = n_pts
        self.noise_std = noise_std

    def _draw_ball(self, generator, B, dtype, device) -> torch.Tensor:
        ball = draw_rows(lambda s: torch.randn(s, generator=generator, device=device, dtype=dtype), (B, 3, self.n_pts))
        return ball * self.noise_std

    def __call__(self, generator, data):
        data = _shallow_copy(data)
        xyz = path_get(data, "xyz")
        B = xyz.shape[0]
        path_set(data, "xyz", torch.cat([xyz, self._draw_ball(generator, B, xyz.dtype, xyz.device)], dim=-1))
        seg = path_get(data, "seg")
        if seg is not None:
            path_set(data, "seg", torch.cat([seg, seg.new_zeros(seg.shape[:-1] + (self.n_pts,))], dim=-1))
        rgb = path_get(data, "rgb")
        if rgb is not None:
            path_set(data, "rgb", torch.cat([rgb, rgb.new_zeros((B, 3, self.n_pts))], dim=-1))
        return data


# ------------------------------------------------------------------ images
@AUGMENTATIONS.register_module()
class ToChannelFirst(BaseAugmentation):
    """[..., H, W, C] -> [..., C, H, W] for every leaf (image_aug.py:123)."""

    def __call__(self, generator, data):
        return tree_map(lambda x: x.movedim(-1, -3), data)


@AUGMENTATIONS.register_module()
class ToChannelLast(BaseAugmentation):
    """[..., C, H, W] -> [..., H, W, C] for every leaf (image_aug.py:147)."""

    def __call__(self, generator, data):
        return tree_map(lambda x: x.movedim(-3, -1), data)


@AUGMENTATIONS.register_module()
class RandomChannelSwap(BaseAugmentation):
    """Permute the rgb channel order of each image with probability
    ``prob``: one draw per batch element (per stacked frame when
    ``independent``), one permutation per call."""

    def __init__(self, main_key="rgb", req_keys=("rgb",), prob=0.5, independent=False):
        super().__init__(main_key, req_keys)
        self.prob = prob
        self.independent = independent

    def _draw_swap(self, generator, B, n_draw, device):
        """([B, n_draw] bool: swap this image, [3] permutation)."""
        do = draw_rows(lambda s: torch.rand(s, generator=generator, device=device), (B, n_draw)) <= self.prob
        return do, torch.randperm(3, generator=generator, device=device)

    def apply_single(self, data, key, info, generator):
        B = data.shape[0]  # data: [B, 3*K, H, W]
        num_images = data.shape[-3] // 3
        x = data.reshape(B, num_images, 3, *data.shape[-2:])
        n_draw = num_images if self.independent else 1
        do, perm = self._draw_swap(generator, B, n_draw, data.device)
        do = do.repeat_interleave(num_images // n_draw, dim=1)  # [B, num_images]
        swapped = x.index_select(2, perm)
        return torch.where(do[:, :, None, None, None], swapped, x).reshape(data.shape)


@AUGMENTATIONS.register_module()
class RandomCrop(BaseAugmentation):
    """Pad-and-random-crop (DrQ's shift aug), per-batch-element offsets
    (image_aug.py:12-92).  Padding modes: constant, reflect, edge, symmetric."""

    def __init__(self, main_key="rgb", req_keys=("rgb",), size=None, padding=None,
                 pad_if_needed=False, pad_val=0, padding_mode="constant", use_kornia=False):
        super().__init__(main_key, req_keys)
        self.size = (size, size) if isinstance(size, (int, float)) else tuple(size)
        self.padding = padding
        self.pad_val = pad_val
        if padding_mode not in ("constant", "reflect", "edge", "symmetric"):
            raise KeyError(f"unknown padding_mode {padding_mode!r}")
        self.padding_mode = padding_mode
        self.pad_if_needed = pad_if_needed

    def _pad(self, x):
        if self.padding is None:
            return x
        p = self.padding
        if isinstance(p, int):
            l, t, r, b = p, p, p, p
        elif len(p) == 2:
            l, t, r, b = p[0], p[1], p[0], p[1]
        else:
            l, t, r, b = p
        if self.padding_mode == "constant":
            return F.pad(x, (l, r, t, b), value=self.pad_val)
        # numpy's own pad of an index range gives each padded row/column's source
        h, w = x.shape[-2:]
        rows = _device_constant(self, ("rows", h), x.device,
                                lambda: torch.from_numpy(np.pad(np.arange(h), (t, b), mode=self.padding_mode)))
        cols = _device_constant(self, ("cols", w), x.device,
                                lambda: torch.from_numpy(np.pad(np.arange(w), (l, r), mode=self.padding_mode)))
        return x[..., rows[:, None], cols[None, :]]

    def sample_info(self, generator, main_data):
        th, tw = self.size
        h, w = self._pad(main_data).shape[-2:]
        batch_shape, dev = main_data.shape[:-3], main_data.device
        i = draw_rows(lambda s: torch.randint(0, h - th + 1, s, generator=generator, device=dev), batch_shape)
        j = draw_rows(lambda s: torch.randint(0, w - tw + 1, s, generator=generator, device=dev), batch_shape)
        return i, j

    def apply_single(self, data, key, info, generator):
        i, j = info
        x = self._pad(data)
        th, tw = self.size
        lead = x.shape[:-3]
        flat = x.reshape((-1,) + x.shape[-3:])
        dev = x.device
        rows = i.reshape(-1)[:, None] + torch.arange(th, device=dev)  # [Bf, th]
        cols = j.reshape(-1)[:, None] + torch.arange(tw, device=dev)  # [Bf, tw]
        batch = torch.arange(flat.shape[0], device=dev)[:, None, None]
        out = flat[batch, :, rows[:, :, None], cols[:, None, :]].permute(0, 3, 1, 2)  # [Bf, C, th, tw]
        return out.reshape(lead + out.shape[-3:])
