"""The last modules of the port against the JAX package's, on the CPU.

The MuJoCo manipulation tasks (``env/{mjc_task,mujoco_manipulation,
cabinet_tasks,chair_task,a2_robot}.py``), ``mani/osc.py`` and the stall
watchdog (``utils/watchdog.py``) are copies: the copy line, then the
original's source, with the same public names and signatures.  The
builder routes the ``*MJC*`` names as the JAX package's does, and without
the A2 robot or PartNet-Mobility assets (which live outside the
repository) the tasks raise the JAX package's own error.  What runs
without assets or a renderer is held to the original bitwise: a small
``MujocoTaskEnv`` subclass on an inline MJCF scene steps, debounces its
eval flags and returns its state-mode obs as the original's does (mujoco
is imported inside the test; no render, as this image has no working GL).
``MovingAverage`` is held to the original, and the watchdog ends a stalled
``train_rl`` in a subprocess with the JAX package's exit code and marker.
"""

import importlib
import inspect
import os
import os.path as osp
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
COPIES = ["env/mjc_task", "env/mujoco_manipulation", "env/cabinet_tasks", "env/chair_task", "env/a2_robot",
          "mani/osc", "utils/watchdog"]


@pytest.mark.parametrize("path", COPIES)
def test_module_copies_are_the_originals(path):
    module = path.replace("/", ".")
    ours = importlib.import_module(f"pointcloud_rl_torch.{module}")
    theirs = importlib.import_module(f"pointcloud_rl_tpu.{module}")
    first, rest = open(ours.__file__).read().split("\n", 1)
    assert first.startswith(f"# Copy of pointcloud_rl_tpu/{path}.py for the PyTorch port")
    assert rest == open(theirs.__file__).read()
    names = {n for n, v in vars(theirs).items() if not n.startswith("_") and callable(v)
             and getattr(v, "__module__", "") == theirs.__name__}
    assert names and names <= set(vars(ours)), names - set(vars(ours))
    for name in names:
        assert str(inspect.signature(getattr(ours, name))) == str(inspect.signature(getattr(theirs, name))), name


MJC_NAMES = {
    "MoveBucketMJC_train-v0": ("mujoco_manipulation", "MoveBucketEnv", "train"),
    "MoveBucketMJC_val-v0": ("mujoco_manipulation", "MoveBucketEnv", "val"),
    "OpenCabinetDoorMJC_train-v0": ("cabinet_tasks", "OpenCabinetDoorEnv", "train"),
    "OpenCabinetDrawerMJC_val-v0": ("cabinet_tasks", "OpenCabinetDrawerEnv", "val"),
    "PushChairMJC_train-v0": ("chair_task", "PushChairEnv", "train"),
}


@pytest.mark.parametrize("name", sorted(MJC_NAMES))
def test_mjc_names_are_routed_like_the_original(name, monkeypatch):
    """Each name reaches its task class with its split and the env kwargs,
    in both packages; with the classes as they are and no assets, both
    raise the same error."""
    module, cls, split = MJC_NAMES[name]
    calls = {}
    for pkg in ("pointcloud_rl_torch", "pointcloud_rl_tpu"):
        builder = importlib.import_module(f"{pkg}.env.builder")
        with pytest.raises(AssertionError) as info:
            builder._build_base_env(name, "pointcloud", n_points=64)
        calls[pkg] = [str(info.value)]
        task = importlib.import_module(f"{pkg}.env.{module}")

        def record(*args, _pkg=pkg, **kwargs):
            calls[_pkg].append((args, kwargs))
            return "built"

        monkeypatch.setattr(task, cls, record)
        assert builder._build_base_env(name, "pointcloud", n_points=64) == "built"
    assert calls["pointcloud_rl_torch"] == calls["pointcloud_rl_tpu"]
    error, (args, kwargs) = calls["pointcloud_rl_torch"]
    assert "A2 robot" in error or "PartNet-Mobility" in error
    assert args == () and kwargs == dict(split=split, obs_mode="pointcloud", n_points=64)


# A box on two slide joints driven by two motors, a target site and a camera.
SCENE = """
<mujoco>
  <option timestep="0.004"/>
  <worldbody>
    <light pos="0 0 3"/>
    <geom name="floor" type="plane" size="2 2 0.1"/>
    <camera name="cam0" pos="0 -1.5 1.2" xyaxes="1 0 0 0 0.6 0.8"/>
    <body name="base" pos="0 0 0.06">
      <joint name="x" type="slide" axis="1 0 0" damping="2"/>
      <joint name="y" type="slide" axis="0 1 0" damping="2"/>
      <geom name="box" type="box" size="0.05 0.05 0.05" mass="1"/>
      <body name="mast" pos="0 0 0.1">
        <geom name="mast" type="capsule" size="0.01" fromto="0 0 0 0 0 0.1" mass="0.05"/>
      </body>
    </body>
    <site name="target" pos="0.3 -0.2 0.06" size="0.02"/>
  </worldbody>
  <actuator>
    <motor joint="x" gear="1"/>
    <motor joint="y" gear="1"/>
  </actuator>
</mujoco>
"""


class _Agent:
    """What ``MujocoTaskEnv._step_agent`` calls on an agent: the motors'
    range, the held target and one control update per sim substep."""

    def __init__(self, data):
        self.data = data

    def scale_action(self, action):
        return np.clip(np.asarray(action, np.float64), -1, 1) * 4.0

    def set_action(self, scaled, ego_mode):
        self.target = scaled

    def simulation_step(self):
        self.data.ctrl[:] = self.target - 0.5 * self.data.qvel


def _box_task(pkg):
    """A ``MujocoTaskEnv`` of ``pkg`` on ``SCENE``: reach the target and
    stop there, debounced over 3 steps."""
    import mujoco

    mjc_task = importlib.import_module(f"{pkg}.env.mjc_task")
    Box = importlib.import_module(f"{pkg}.env.spaces").Box

    class BoxTask(mjc_task.MujocoTaskEnv):
        def __init__(self):
            self.model = mujoco.MjModel.from_xml_string(SCENE)
            self.data = mujoco.MjData(self.model)
            self.obs_mode, self.ego_mode = "state", False
            self.n_sim_per_control, self.ctrl_per_step = 5, 2
            self.keep_good_steps_threshold = 3
            self.np_random = np.random.RandomState()
            self.action_space = Box(-1.0, 1.0, (2,))
            self.agent = _Agent(self.data)
            base = mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_BODY, "base")
            self._seg_geoms = [self._geoms_of(self._subtree(base)), set()]
            self._reset_hysteresis()

        def reset(self, level=None):
            if level is not None:
                self.np_random.seed(level)
            mujoco.mj_resetData(self.model, self.data)
            self.data.qpos[:] = self.np_random.uniform(-0.3, 0.3, 2)
            mujoco.mj_forward(self.model, self.data)
            self._reset_hysteresis()
            return self.get_obs()

        def _state(self):
            return np.concatenate([self.data.qpos, self.data.qvel]).astype(np.float32)

        def _state_extras(self):
            return [self.data.site_xpos[0], [self._in_subtree(2, 1), self._in_subtree(1, 2)]]

        def step(self, action):
            self._step_agent(np.asarray(action))
            gap = self.data.site_xpos[0][:2] - self.data.xpos[1][:2]
            flags = {"near": bool(np.linalg.norm(gap) < 0.08), "slow": bool(np.abs(self.data.qvel).max() < 0.2)}
            info = self._apply_hysteresis(flags)
            return self.get_obs(), float(-np.linalg.norm(gap)), info["success"], info

    return BoxTask()


def test_mujoco_task_env_steps_like_the_original():
    pytest.importorskip("mujoco")
    envs = {pkg: _box_task(pkg) for pkg in ("pointcloud_rl_torch", "pointcloud_rl_tpu")}
    runs = {}
    for pkg, env in envs.items():
        env.seed(7)
        out = [env.reset(level=3)]
        rs = np.random.RandomState(0)
        for t in range(60):
            # a proportional reach on the target with seeded noise, then hold still
            gap = env.data.site_xpos[0][:2] - env.data.xpos[1][:2]
            action = np.clip(2.0 * gap / 4.0 + (0.05 * rs.randn(2) if t < 20 else 0.0), -1, 1)
            out.append(env.step(action))
        runs[pkg] = out
        assert env._seg_geoms[0] == {1, 2}  # the base's subtree: the box and the mast
    ours, theirs = runs["pointcloud_rl_torch"], runs["pointcloud_rl_tpu"]
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert ours[0].shape == (4 + 3 + 2,) and ours[0].dtype == np.float32
    for (o1, r1, d1, i1), (o2, r2, d2, i2) in zip(ours[1:], theirs[1:]):
        np.testing.assert_array_equal(o1, o2)
        assert (r1, d1, i1) == (r2, d2, i2)
    infos = [step[3] for step in ours[1:]]
    # the debounce: success only after 3 steps with both raw flags set
    first = next(t for t, i in enumerate(infos) if i["success"])
    assert first >= 2 and not any(i["success"] for i in infos[:first]) and infos[-1]["success"]


def test_moving_average_is_the_original():
    from pointcloud_rl_torch.utils import MovingAverage as Ours
    from pointcloud_rl_tpu.utils import MovingAverage as Theirs

    ours, theirs = Ours(window=3), Theirs(window=3)
    assert ours.mean == theirs.mean == 0.0 and len(ours) == 0
    for x in np.random.RandomState(0).randn(8):
        ours.push(x)
        theirs.push(x)
        assert ours.mean == theirs.mean and len(ours) == len(theirs)
    assert len(ours) == 3


_STALL = textwrap.dedent("""
    import sys
    import threading

    side, work = sys.argv[1], sys.argv[2]
    if side == "torch":
        from pointcloud_rl_torch.apis.train_rl import train_rl
        from pointcloud_rl_torch.parallel import DataParallel
    else:
        from pointcloud_rl_tpu.apis.train_rl import train_rl

    class Agent:
        data_parallel = DataParallel() if side == "torch" else None

        def train(self):
            return self

        def eval(self):
            return self

        def update_parameters(self, memory, updates):
            threading.Event().wait()  # an update that never returns

    train_rl(Agent(), None, None, None, work_dir=work, total_steps=10, warm_steps=0, n_steps=0, n_updates=1,
             stall_timeout=2)
    print("the loop returned")
""")


def test_watchdog_ends_a_stalled_loop_like_the_original(tmp_path):
    from pointcloud_rl_tpu.utils.watchdog import StallWatchdog

    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    for side in ("torch", "jax"):
        work = tmp_path / side
        work.mkdir()
        out = subprocess.run([sys.executable, "-c", _STALL, side, str(work)], env=env, cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == StallWatchdog.DEFAULT_EXIT_CODE, (side, out.stderr[-2000:])
        assert "the loop returned" not in out.stdout
        assert "Stall watchdog: no progress" in out.stderr + out.stdout
        lines = (work / "STALLED").read_text().splitlines()
        assert len(lines) == 1 and float(lines[0]) > 0
