"""The port stands alone: it imports nothing of ``pointcloud_rl_tpu``.

``pointcloud_rl_torch`` keeps its own copies of the JAX-free host modules
it needs (config, registry, utils, loggers, the native sampler).  These
tests find no import of the JAX package in the port's sources, hold each
copy the slice runs to its original on the same inputs, and check that an
env worker that will not exit is still shut down.
"""

import ast
import glob
import multiprocessing as mp
import os.path as osp
import signal
import time

import numpy as np
import pytest

from pointcloud_rl_torch import native as torch_native
from pointcloud_rl_torch.config import Config as TorchConfig
from pointcloud_rl_torch.env.obs_process import pcd_base as torch_pcd_base
from pointcloud_rl_torch.env.vec_env import EnvWorker
from pointcloud_rl_torch.registry import Registry as TorchRegistry
from pointcloud_rl_tpu import native as jax_native
from pointcloud_rl_tpu.config import Config as JaxConfig
from pointcloud_rl_tpu.env.obs_process import pcd_base as jax_pcd_base

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SLICE_CONFIG = osp.join(REPO, "configs/mfrl/sac/synthetic/pn_fake_manipulation.py")
DRQ_CONFIG = osp.join(REPO, "configs/mfrl/drq/synthetic/pn_jitter_fake_manipulation.py")
VOXEL_CONFIG = osp.join(REPO, "configs/mfrl/drq/synthetic/sparse_conv_shift_fake_manipulation.py")
PORT_SOURCES = sorted(glob.glob(osp.join(REPO, "pointcloud_rl_torch", "**", "*.py"), recursive=True)
                      + [osp.join(REPO, "chip_smoke.py"), osp.join(REPO, "tools", "profile_torch_slice.py"),
                   osp.join(REPO, "tools", "vn_f32_gap.py")])


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            yield node.args[0].value


def test_no_port_source_imports_the_jax_package():
    assert len(PORT_SOURCES) > 40
    bad = [(osp.relpath(p, REPO), m) for p in PORT_SOURCES for m in _imported_modules(p)
           if m.split(".")[0] == "pointcloud_rl_tpu"]
    assert not bad, bad


def test_registries_are_the_ports_own():
    from pointcloud_rl_torch.algorithms import MFRL
    from pointcloud_rl_torch.env import device_replay  # noqa: F401  (registers DeviceReplayMemory)
    from pointcloud_rl_torch.env.builder import ENVS, REPLAYS
    from pointcloud_rl_torch.loggers import EXP_LOGGER
    from pointcloud_rl_torch.models import NETWORK
    from pointcloud_rl_torch.ops.augment import AUGMENTATIONS

    for reg in (MFRL, ENVS, EXP_LOGGER, NETWORK, REPLAYS, AUGMENTATIONS):
        assert type(reg) is TorchRegistry, reg
    # The slices' configs resolve their ``type=`` names in the port's registries.
    for path in (SLICE_CONFIG, DRQ_CONFIG, VOXEL_CONFIG):
        cfg = TorchConfig.fromfile(path)
        assert cfg["agent_cfg"]["type"] in MFRL
        assert cfg["env_cfg"]["type"] in ENVS
        assert cfg["agent_cfg"]["actor_cfg"]["nn_cfg"]["visual_nn_cfg"]["type"] in NETWORK
    assert TorchConfig.fromfile(DRQ_CONFIG)["agent_cfg"]["obs_aug"]["type"] in AUGMENTATIONS
    assert {"ReplayMemory", "DeviceReplayMemory"} <= set(REPLAYS.module_dict)
    # every augmentation and replay of the JAX package has its port
    from pointcloud_rl_tpu.env.builder import REPLAYS as JAX_REPLAYS
    from pointcloud_rl_tpu.ops.augment import AUGMENTATIONS as JAX_AUGMENTATIONS

    assert set(AUGMENTATIONS.module_dict) == set(JAX_AUGMENTATIONS.module_dict)
    assert set(REPLAYS.module_dict) >= set(JAX_REPLAYS.module_dict) & {"ReplayMemory", "DeviceReplayMemory"}


@pytest.mark.parametrize("path", [SLICE_CONFIG, DRQ_CONFIG, VOXEL_CONFIG], ids=["sac", "drq", "drq_voxel"])
def test_config_loads_the_slice_config_like_the_original(path):
    got = TorchConfig.fromfile(path)
    want = JaxConfig.fromfile(path)
    assert got.to_dict() == want.to_dict()
    opts = {"agent_cfg.batch_size": 16, "env_cfg.n_points": 64}
    got.merge_from_dict(opts)
    want.merge_from_dict(opts)
    assert got.to_dict() == want.to_dict()
    assert got.pretty_text == want.pretty_text


def _cloud(seed):
    rs = np.random.RandomState(seed)
    n = 3000
    obs = {
        "xyz": np.concatenate([rs.rand(n, 3) + [0, 0, 0.5], rs.rand(50, 3) * [1, 1, 1e-4]]).astype(np.float32),
        "rgb": rs.randint(0, 255, (n + 50, 3)).astype(np.uint8),
        "seg": np.zeros((n + 50, 3), bool),
    }
    obs["seg"][:30, 0] = True
    obs["seg"][30:1500, 1] = True
    obs["seg"][1400:1900, 2] = True
    return obs


@pytest.mark.parametrize("use_native", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize("seed", [0, 3])
def test_pcd_base_matches_the_original(use_native, seed):
    if use_native:
        assert torch_native.available() and jax_native.available(), "g++ is needed for the native path"
    obs = _cloud(seed)
    got = torch_pcd_base(dict(obs), n_points=1200, min_pts=50, fg_pts=800,
                         np_random=np.random.RandomState(seed + 10), use_native=use_native)
    want = jax_pcd_base(dict(obs), n_points=1200, min_pts=50, fg_pts=800,
                        np_random=np.random.RandomState(seed + 10), use_native=use_native)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["xyz"].shape == (1200, 3)


def test_native_indices_match_the_original():
    obs = _cloud(5)
    args = (obs["xyz"], obs["seg"].astype(np.uint8), 1200, 50, 800)
    for seed in (0, 7, 2**40 + 3):
        np.testing.assert_array_equal(torch_native.seg_balanced_sample_indices(*args, seed),
                                      jax_native.seg_balanced_sample_indices(*args, seed))


def _deaf_worker(conn):
    # Like a worker wedged in env.step: ignores SIGTERM (as env workers do)
    # and never answers the "exit" command.
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    while True:
        time.sleep(1)


def test_env_worker_close_kills_a_worker_that_ignores_sigterm():
    ctx = mp.get_context("fork")
    worker = EnvWorker.__new__(EnvWorker)
    worker.conn, child = ctx.Pipe()
    worker.proc = ctx.Process(target=_deaf_worker, args=(child,), daemon=True)
    worker.proc.start()
    child.close()
    worker._pending = False
    time.sleep(0.2)  # let it install its SIGTERM handler
    t0 = time.monotonic()
    worker.close(timeout=0.5)
    assert not worker.proc.is_alive()
    assert worker.proc.exitcode == -signal.SIGKILL
    assert time.monotonic() - t0 < 10
