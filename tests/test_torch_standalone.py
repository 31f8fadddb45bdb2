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
RNN_CONFIG = osp.join(REPO, "configs/mfrl/sac/dm_control/pn_rnn.py")
DMC_CONFIG = osp.join(REPO, "configs/mfrl/sac/dm_control/pn.py")
WALKER_CONFIG = osp.join(REPO, "configs/mfrl/sac/dm_control/pn_walker_tpu.py")
PORT_SOURCES = sorted(glob.glob(osp.join(REPO, "pointcloud_rl_torch", "**", "*.py"), recursive=True)
                      + [osp.join(REPO, "chip_smoke.py"),
                   osp.join(REPO, "tools", "vn_f32_gap.py"), osp.join(REPO, "tools", "replay_snapshot_cost.py"),
                   osp.join(REPO, "tests", "_torch_dp_worker.py"),
                   osp.join(REPO, "tests", "_torch_multihost_worker.py")])


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


def _absolute_imports(rel):
    """The modules (and the names of ``from`` imports) a package file imports, as absolute names."""
    package = ["pointcloud_rl_torch"] + rel.split("/")[:-1]
    tree = ast.parse(open(osp.join(REPO, "pointcloud_rl_torch", rel)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            module = ".".join(package[:len(package) + 1 - node.level] if node.level else [])
            module = ".".join(m for m in (module, node.module) if m)
            yield module
            yield from (f"{module}.{alias.name}" for alias in node.names)


def test_the_update_programs_and_the_cli_import_no_kernel_module():
    """``algorithms/graphs.py`` and ``apis/run_rl.py`` reach the kernels'
    counters through ``utils/trace.py``: neither imports a module of ``ops``."""
    for rel in ("algorithms/graphs.py", "apis/run_rl.py"):
        found = set(_absolute_imports(rel))
        assert "pointcloud_rl_torch.utils.trace" in found, rel
        bad = sorted(m for m in found if m.split(".")[:2] == ["pointcloud_rl_torch", "ops"])
        assert not bad, (rel, bad)


def test_parallel_has_the_jax_packages_names():
    """``parallel/`` ports the JAX package's data-parallel layer onto
    ``torch.distributed``: every name but the two that build a jax mesh."""
    import pointcloud_rl_torch.parallel as ours
    import pointcloud_rl_tpu.parallel as theirs

    assert set(theirs.__all__) - {"make_mesh", "data_parallel_shardings"} <= set(ours.__all__)
    assert glob.glob(osp.join(REPO, "pointcloud_rl_torch", "parallel", "*.py"))[0] in PORT_SOURCES


def test_registries_are_the_ports_own():
    from pointcloud_rl_torch.algorithms import MFRL
    from pointcloud_rl_torch.env import device_replay  # noqa: F401  (registers DeviceReplayMemory)
    from pointcloud_rl_torch.env.builder import ENVS, REPLAYS, ROLLOUTS
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
    assert TorchConfig.fromfile(RNN_CONFIG)["agent_cfg"]["actor_cfg"]["nn_cfg"]["rnn_cfg"]["type"] in NETWORK
    walker = TorchConfig.fromfile(WALKER_CONFIG)
    assert walker["agent_cfg"]["type"] in MFRL and walker["replay_cfg"]["type"] in REPLAYS
    assert walker["rollout_cfg"]["type"] in ROLLOUTS and walker["env_cfg"]["type"] in ENVS
    # every agent, network and head type of the JAX package has its port
    from pointcloud_rl_torch.models import REGRESSION
    from pointcloud_rl_tpu.algorithms import MFRL as JAX_MFRL
    from pointcloud_rl_tpu.models import NETWORK as JAX_NETWORK
    from pointcloud_rl_tpu.models import REGRESSION as JAX_REGRESSION

    for ours, theirs in ((MFRL, JAX_MFRL), (NETWORK, JAX_NETWORK), (REGRESSION, JAX_REGRESSION)):
        assert set(ours.module_dict) == set(theirs.module_dict), ours
    assert {"ReplayMemory", "DeviceReplayMemory"} <= set(REPLAYS.module_dict)
    # every augmentation and replay of the JAX package has its port
    from pointcloud_rl_tpu.env.builder import REPLAYS as JAX_REPLAYS
    from pointcloud_rl_tpu.ops.augment import AUGMENTATIONS as JAX_AUGMENTATIONS

    assert set(AUGMENTATIONS.module_dict) == set(JAX_AUGMENTATIONS.module_dict)
    assert set(REPLAYS.module_dict) >= set(JAX_REPLAYS.module_dict) & {"ReplayMemory", "DeviceReplayMemory"}


@pytest.mark.parametrize("path", [SLICE_CONFIG, DRQ_CONFIG, VOXEL_CONFIG, RNN_CONFIG, DMC_CONFIG, WALKER_CONFIG],
                         ids=["sac", "drq", "drq_voxel", "sac_rnn", "dmc", "dmc_walker"])
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


@pytest.mark.parametrize("valid", ["mask", "all"])
@pytest.mark.parametrize("fix_base_z", [None, 0.0, -5.0], ids=["min_z", "fixed", "no_ground"])
def test_native_dmc_sampler_matches_the_original(valid, fix_base_z):
    """``unproject_depth`` and ``ground_body_split_sample`` (the DMC env's
    native path) give the original's outputs bit for bit."""
    rs = np.random.RandomState(4)
    depth = (rs.rand(40, 32) * 6).astype(np.float32)
    inv_k = np.linalg.inv(np.array([[38.6, 0, 15.5], [0, 38.6, 19.5], [0, 0, 1.0]]))
    rot = np.linalg.qr(rs.randn(3, 3))[0]
    xyz = torch_native.unproject_depth(depth, inv_k, rot, 1.25)
    np.testing.assert_array_equal(xyz, jax_native.unproject_depth(depth, inv_k, rot, 1.25))
    xyz = xyz.reshape(-1, 3)
    rgb = rs.randint(0, 256, xyz.shape).astype(np.uint8)
    mask = (depth.reshape(-1) <= 5.0).astype(np.uint8) if valid == "mask" else None
    for seed in (0, 11, 2**40 + 1):
        got = torch_native.ground_body_split_sample(xyz, rgb, mask, 0.2, 384, 128, seed, fix_base_z=fix_base_z)
        want = jax_native.ground_body_split_sample(xyz, rgb, mask, 0.2, 384, 128, seed, fix_base_z=fix_base_z)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    if fix_base_z == -5.0:
        assert (got[0][384:] == 0).all()  # no ground point: the ground side is zeroed


class _FakeSpec:
    minimum = np.full(6, -2.0)
    maximum = np.full(6, 3.0)


class _FakeSuiteEnv:
    """What ``DMCEnv`` reads of a dm_control suite env, without a simulator:
    the physics' camera and render settings, the task's RNG and a step."""

    def __init__(self, seed):
        from types import SimpleNamespace as NS

        model = NS(vis=NS(quality=NS(offsamples=4)), cam_fovy=np.array([45.0]),
                   cam_mat0=np.array([np.linalg.qr(np.random.RandomState(seed).randn(3, 3))[0].reshape(-1)]))
        self.physics = NS(model=model, data=NS(cam_xpos=np.array([[0.3, -2.0, 1.1]])))
        self.task = NS(_random=np.random.RandomState(seed))
        self.actions = []

    def action_spec(self):
        return _FakeSpec()

    def reset(self):
        from types import SimpleNamespace as NS

        return NS(observation={"a": np.zeros(2)})

    def step(self, action):
        from types import SimpleNamespace as NS

        self.actions.append(np.array(action))
        return NS(reward=0.5, last=lambda: len(self.actions) >= 3, discount=1.0, observation={"a": np.ones(2)})


def _fake_render(seed):
    def render(self, with_depth):
        rs = np.random.RandomState(seed + len(self.env.actions))
        depth = rs.uniform(0.5, 7.0, (24, 24)).astype(np.float32)
        rgb = rs.randint(0, 256, (24, 24, 3)).astype(np.uint8)
        return rgb, depth, depth <= self.max_depth
    return render


@pytest.mark.parametrize("mode, extra", [
    ("pointcloud", dict(use_native=True)), ("pointcloud", dict(use_native=False)),
    ("pointcloud", dict(num_ground=-1, n_points=300)), ("pointcloud", dict(fix_base_z=0.9, use_native=False)),
    ("xyz-img", {}), ("rgbd", {}), ("depth", {}), ("raw", {})],
    ids=["native", "numpy", "filter_seg", "fixed_base_z", "xyz_img", "rgbd", "depth", "raw"])
def test_dmc_env_copy_matches_the_original(mode, extra, monkeypatch):
    """``env/dmc.py`` against its original on the same renders, camera and
    RNG, with no simulator: every observation mode, both samplers, and the
    step's action rescale and time-limit handling."""
    from pointcloud_rl_torch.env import dmc as t_dmc
    from pointcloud_rl_tpu.env import dmc as j_dmc

    outs = []
    for mod in (t_dmc, j_dmc):
        monkeypatch.setattr(mod.DMCEnv, "_render", _fake_render(3))
        env = mod.DMCEnv(_FakeSuiteEnv(7), obs_mode=mode, image_size=(24, 24),
                         **dict(dict(n_points=200, num_ground=50), **extra))
        env.seed(7)
        obs = [env.reset()]
        for a in (np.full(6, 0.5), np.full(6, -1.5)):
            o, r, d, _ = env.step(a)
            obs.append((o, r, d))
        outs.append((obs, env.env.actions))
    (t_obs, t_acts), (j_obs, j_acts) = outs
    np.testing.assert_array_equal(np.array(t_acts), np.array(j_acts))
    for a, b in zip(t_obs, j_obs):
        a, b = (a, b) if isinstance(a, dict) else (a[0], b[0])
        assert sorted(a) == sorted(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert t_obs[-1][1:] == j_obs[-1][1:]


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


def test_running_mean_std_is_the_original():
    from pointcloud_rl_torch.utils.stats import RunningMeanStd as T
    from pointcloud_rl_tpu.utils.stats import RunningMeanStd as J

    rs = np.random.RandomState(0)
    t, j = T(shape=(3,), clip_max=2.0), J(shape=(3,), clip_max=2.0)
    for _ in range(3):
        x = rs.randn(7, 3) * 4 + 2
        t.update(x)
        j.update(x)
    x = rs.randn(5, 3) * 6
    np.testing.assert_array_equal(t.normalize(x), j.normalize(x))
    np.testing.assert_array_equal(t.std, j.std)


def test_io_and_file_client_are_the_originals(tmp_path):
    """``utils/io.py`` and ``utils/file_client.py`` are copies: the same
    public names with the same signatures, and the same reads.  The codecs,
    ``load`` / ``dump``, ``FileCache`` and the replays' files are held to the
    originals in ``tests/test_torch_replay_io.py``."""
    import inspect

    from pointcloud_rl_torch.utils import file_client as t_fc
    from pointcloud_rl_torch.utils import io as t_io
    from pointcloud_rl_tpu.utils import file_client as j_fc
    from pointcloud_rl_tpu.utils import io as j_io

    def params(fn):
        return [(p.name, p.kind) for p in inspect.signature(fn).parameters.values()]

    for ours, theirs in ((t_io, j_io), (t_fc, j_fc)):
        names = {n for n, v in vars(theirs).items() if not n.startswith("_") and getattr(v, "__module__", None)
                 == theirs.__name__}
        assert names and names <= set(vars(ours)), names - set(vars(ours))
        for name in names:
            a, b = getattr(ours, name), getattr(theirs, name)
            members = [(n, m) for n, m in vars(b).items() if callable(m)] if inspect.isclass(b) else [("", b)]
            for member, fn in members:
                assert params(getattr(a, member) if member else a) == params(fn), (name, member)
    (tmp_path / "blob.bin").write_bytes(b"\x00\x01payload")
    (tmp_path / "t.txt").write_text("hello")
    for fc in (t_fc, j_fc):
        client = fc.FileClient("disk")
        assert client.get(tmp_path / "blob.bin") == b"\x00\x01payload"
        assert client.get_text(tmp_path / "t.txt") == "hello"
        with pytest.raises(ValueError, match="not supported"):
            fc.FileClient("nope")
        with pytest.raises(TypeError):
            fc.FileClient.register_backend("bad", dict)
    assert set(t_fc.FileClient._backends) >= {"disk", "http", "lmdb", "memcached", "ceph"}


@pytest.mark.parametrize("module", ["env.gym_adapter", "utils.visualization", "version"])
def test_host_module_copies_are_the_originals(module):
    """The copies of the last host modules: the same public names with the
    same signatures, and the same source below the copy line.  Their
    behaviour is held to the originals' in ``tests/test_torch_host_utils.py``."""
    import importlib
    import inspect

    ours = importlib.import_module(f"pointcloud_rl_torch.{module}")
    theirs = importlib.import_module(f"pointcloud_rl_tpu.{module}")
    first, rest = open(ours.__file__).read().split("\n", 1)
    assert first.startswith(f"# Copy of pointcloud_rl_tpu/{module.replace('.', '/')}.py")
    assert rest == open(theirs.__file__).read()
    names = {n for n, v in vars(theirs).items() if not n.startswith("_") and getattr(v, "__module__", None)
             == theirs.__name__}
    for name in names:
        a, b = getattr(ours, name), getattr(theirs, name)
        if callable(b):
            assert str(inspect.signature(a)) == str(inspect.signature(b)), name


MANISKILL_COPIES = ["mani/__init__", "mani/geometry", "mani/controllers", "mani/config_parser", "mani/evaluator",
                    "mani/handle_discovery", "env/maniskill"]


def _yaml_moved_into_the_loader(source: str) -> str:
    """The one change the port makes to ``mani/config_parser.py``: PyYAML is
    imported where a task file is loaded, not when the module is."""
    doc = '    """Load a task YAML, resolving file paths and ``_include``/``_override``."""\n'
    assert source.count("import numpy as np\nimport yaml\n") == 1 and source.count(doc) == 1
    return source.replace("import numpy as np\nimport yaml\n", "import numpy as np\n").replace(
        doc, doc + "    import yaml\n\n")


@pytest.mark.parametrize("path", MANISKILL_COPIES)
def test_maniskill_module_copies_are_the_originals(path):
    """``mani/`` (but ``osc.py``) and ``env/maniskill.py``: the copy line,
    then the original's source, with the stated ``yaml`` move in
    ``config_parser.py`` and nothing else; the same public names and
    signatures.  Their behaviour is held to the originals' in
    ``tests/test_torch_mani.py`` and ``tests/test_torch_maniskill.py``."""
    import importlib
    import inspect

    module = path.replace("/__init__", "").replace("/", ".")
    ours = importlib.import_module(f"pointcloud_rl_torch.{module}")
    theirs = importlib.import_module(f"pointcloud_rl_tpu.{module}")
    first, rest = open(ours.__file__).read().split("\n", 1)
    assert first.startswith(f"# Copy of pointcloud_rl_tpu/{path}.py for the PyTorch port")
    original = open(theirs.__file__).read()
    if path == "mani/config_parser":
        assert "import yaml" in first and "load_task_config" in first
        original = _yaml_moved_into_the_loader(original)
    assert rest == original
    names = {n for n, v in vars(theirs).items() if not n.startswith("_") and callable(v)}
    assert names <= set(vars(ours)), names - set(vars(ours))
    for name in names:
        a, b = getattr(ours, name), getattr(theirs, name)
        if getattr(b, "__module__", "").startswith("pointcloud_rl_tpu."):
            assert a.__module__ == b.__module__.replace("pointcloud_rl_tpu.", "pointcloud_rl_torch.", 1), name
            assert str(inspect.signature(a)) == str(inspect.signature(b)), name
