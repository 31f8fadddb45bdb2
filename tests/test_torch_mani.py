"""The port's ``mani/`` copies against the JAX package's, on the same inputs.

Geometry and controllers: every public function and class on seeded
inputs, step sequences compared bitwise.  The YAML pipeline on a task
file with ``_include``, ``_override``, ``$`` variables, samplers and
``_variants``: the same dict.  The evaluator on a stand-in env and through
each package's ``build_env``: the same result and CSV.  Handle discovery
on a small URDF with OBJ meshes written here, with a revolute and a
prismatic handle link: the same links, the same grasp-bar points for the
same seed, the same grasp poses.
"""

import numpy as np
import pytest

from pointcloud_rl_torch.mani import config_parser as t_cp
from pointcloud_rl_torch.mani import controllers as t_ctl
from pointcloud_rl_torch.mani import evaluator as t_ev
from pointcloud_rl_torch.mani import geometry as t_geo
from pointcloud_rl_torch.mani import handle_discovery as t_hd
from pointcloud_rl_tpu.mani import config_parser as j_cp
from pointcloud_rl_tpu.mani import controllers as j_ctl
from pointcloud_rl_tpu.mani import evaluator as j_ev
from pointcloud_rl_tpu.mani import geometry as j_geo
from pointcloud_rl_tpu.mani import handle_discovery as j_hd


def assert_same(a, b, path="out"):
    """Equal bitwise: arrays of one dtype and shape, floats to the bit,
    dicts / sequences / poses element by element."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), (path, list(a), list(b))
        for k in b:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif type(b).__name__ in ("Pose", "Rotation"):
        assert type(a).__name__ == type(b).__name__, path
        for attr in ("p", "q") if type(b).__name__ == "Pose" else ("quat",):
            assert_same(getattr(a, attr), getattr(b, attr), f"{path}.{attr}")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=True), (path, a, b)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (path, a, b)


# ---------------------------------------------------------------- geometry
def _geometry_cases():
    rs = np.random.RandomState(0)
    q1, q2 = rs.randn(4), rs.randn(4)
    R = np.linalg.qr(rs.randn(3, 3))[0]
    R = R * np.sign(np.linalg.det(R))
    pts, p = rs.randn(40, 3), rs.randn(3)
    return {
        "qmult": lambda m: m.qmult(q1, q2),
        "qinverse": lambda m: m.qinverse(q1),
        "qnorm": lambda m: m.qnorm(q2),
        "axangle2quat": lambda m: m.axangle2quat([0.3, -1.0, 2.0], 0.7),
        "euler2quat": lambda m: m.euler2quat(0.3, -0.2, 0.7),
        "mat2quat": lambda m: [m.mat2quat(r) for r in (R, np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
                                                       np.diag([-1.0, -1, 1]))],
        "quat2mat": lambda m: m.quat2mat(q1),
        "qrotate": lambda m: m.qrotate(q1, pts),
        "rotate_2d_vec_by_angle": lambda m: m.rotate_2d_vec_by_angle([0.4, -1.2], 2.1),
        "pose": lambda m: (lambda a, b: [a.inv(), a.transform(b), a * b, a.to_transformation_matrix(),
                                         m.Pose.from_transformation_matrix((a * b).to_transformation_matrix()),
                                         repr(a)])(m.Pose(p, q1), m.Pose(-p, q2)),
        "apply_pose_to_points": lambda m: m.apply_pose_to_points(pts, m.Pose(p, q2)),
        "norm": lambda m: [m.norm(pts), m.norm(pts, keepdims=True)],
        "normalize_vec": lambda m: [m.normalize_vec(p), m.normalize_vec(np.zeros(3))],
        "clip": lambda m: [m.clip(x, -0.5, 0.5) for x in (-2.0, 0.1, 3.0)],
        "normalize_and_clip_in_interval": lambda m: [m.normalize_and_clip_in_interval(x, *r)
                                                     for x in (-3.0, 0.25, 0.9, 7.0) for r in ((0, 1), (2,), (-1, 4))],
        "angle_between_vec": lambda m: m.angle_between_vec(m.normalize_vec(p), m.normalize_vec(pts[0])),
        "rew_close_to_target": lambda m: [m.rew_close_to_target(pts[i], pts[i + 1], pts[i + 2], **kw)
                                          for i in range(0, 30, 3)
                                          for kw in ({}, dict(max_dist=2, max_vel=0.5, vel_coeff=0, angle_coeff=3))],
        "angle_distance": lambda m: [m.angle_distance(q1, q2), m.angle_distance([1, 0, 0, 0],
                                                                                m.axangle2quat([0, 0, 1], 4.0))],
        "quaternion_distance": lambda m: m.quaternion_distance(q1, q2),
        "pose_vec_distance": lambda m: m.pose_vec_distance(m.Pose(p, q1), m.Pose(pts[3], q2)),
    }


GEOMETRY = sorted(_geometry_cases())


@pytest.mark.parametrize("name", GEOMETRY)
def test_geometry_matches_jax(name):
    case = _geometry_cases()[name]
    assert_same(case(t_geo), case(j_geo))


def test_geometry_cases_cover_the_public_names():
    public = {n for n, v in vars(j_geo).items() if not n.startswith("_") and callable(v)
              and getattr(v, "__module__", None) == j_geo.__name__}
    assert public <= set(GEOMETRY) | {"Pose"}, public - set(GEOMETRY)


# ------------------------------------------------------------- controllers
SPECS = [
    {"action_type": "velocity", "action_range": [-1.0, 1.0]},
    {"action_type": "velocity", "action_range": [-2.0, 2.0], "velocity_filter": {"cutoff_frequency": 7.0}},
    {"action_type": "position", "action_range": [-3.0, 3.0],
     "velocity_pid": {"kp": 4.0, "ki": 0.5, "kd": 0.2, "limit": [-1.5, 1.5]}},
    {"action_type": "position", "action_range": [-0.5, 0.5], "velocity_filter": {"cutoff_frequency": 3.0},
     "velocity_pid": {"kp": 10.0, "ki": 0.0, "kd": 1.0, "limit": [-1.0, 1.0]}},
]


def _controller_run(m, kind):
    rs = np.random.RandomState(1)
    current, targets = rs.randn(60), rs.randn(60) * 2
    if kind == "lp_filter":
        f = m.LPFilter(control_freq=100, cutoff_freq=5)
        out = [f.next(x) for x in targets]
        f.reset()
        return [f.alpha, out, f.next(1.0)]
    if kind == "pid":
        c = m.PIDController(3.0, 0.4, 0.1, 50, (-1.0, 1.0))
        out = [c.control(a, b) for a, b in zip(current, targets)]
        c.reset()
        return [out, c.control(0.0, 2.0)]
    if kind == "velocity":
        return [[m.VelocityController(lp).control(a, b) for a, b in zip(current, targets)]
                for lp in (None, m.LPFilter(50, 4))]
    if kind == "position":
        c = m.PositionController(m.PIDController(5.0, 0.2, 0.3, 100, [-2, 2]), m.LPFilter(100, 10))
        out = [c.control(a, b) for a, b in zip(current, targets)]
        c.reset()
        return [out, c.control(0.5, -0.5)]
    controllers, ranges = m.build_joint_controllers(SPECS, control_freq=20)
    return [ranges, [[type(c).__name__ for c in controllers]],
            [[c.control(a, b) for c in controllers] for a, b in zip(current, targets)]]


@pytest.mark.parametrize("kind", ["lp_filter", "pid", "velocity", "position", "build_joint_controllers"])
def test_controllers_match_jax_step_for_step(kind):
    assert_same(_controller_run(t_ctl, kind), _controller_run(j_ctl, kind))


def test_build_joint_controllers_refuses_the_same_specs():
    for m in (t_ctl, j_ctl):
        with pytest.raises(ValueError, match="velocity|position"):
            m.build_joint_controllers([{"action_type": "torque", "action_range": [0, 1]}], 20)


# ------------------------------------------------------------ YAML pipeline
def _write_task(tmp_path):
    (tmp_path / "base.yml").write_text("fovy: 1.0\nwidth: 40\nheight: 16\nmesh_file: meshes/a.obj\n")
    (tmp_path / "nested.yml").write_text("inner:\n  _include: base.yml\n  _override:\n    height: 8\n")
    (tmp_path / "task.yml").write_text(
        "render:\n"
        "  _include: base.yml\n"
        "  _override:\n"
        "    width: 64\n"
        "deep:\n"
        "  _include: nested.yml\n"
        "physics:\n"
        "  $g: eval(9.81)\n"
        "  $s: Uniform(0.5, 1.5)\n"
        "  gravity: [0, 0, eval(-$g)]\n"
        "  timestep: eval(1/500)\n"
        "  noise: Uniform(0.0, 0.1)\n"
        "  scaled: eval($s * 2)\n"
        "  flag: eval(true)\n"
        "  pose: RandomAngleAxis(0.0, 3.14, [0, 0, 1])\n"
        "  rot: eval(euler([0.1, 0.2, 0.3]) * angleAxis(0.5, [1, 0, 0]))\n"
        "  raw_scale: $s\n"
        "  name: cabinet\n"
        "layout:\n"
        "  articulations:\n"
        "    - name: cabinet\n"
        "      urdf_file: base.yml\n"
        "      _variants:\n"
        "        type: options\n"
        "        global_id: partnet_mobility_id\n"
        "        options:\n"
        "          '4000': {scale: 0.5}\n"
        "          '4001': {scale: 0.8}\n"
        "          '4002': {scale: 1.1}\n"
        "    - name: drawer\n"
        "      friction:\n"
        "        _variants:\n"
        "          type: options\n"
        "          global_id: friction_id\n"
        "          options: {low: 0.1, high: 0.9}\n"
    )
    return tmp_path / "task.yml"


def _pipeline(m, path, pinned):
    cfg = m.load_task_config(path)
    loaded = repr(cfg)
    rng = np.random.RandomState(5)
    cfg = m.process_variables(cfg, rng)
    resolved, chosen = m.process_variants(cfg, rng, pinned)
    return loaded, resolved, chosen


@pytest.mark.parametrize("pinned", [None, {"partnet_mobility_id": "4001"}, {"friction_id": "high"}],
                         ids=["sampled", "pinned_model", "pinned_scalar"])
def test_task_config_pipeline_matches_jax(tmp_path, pinned):
    path = _write_task(tmp_path)
    loaded, resolved, chosen = _pipeline(t_cp, path, pinned)
    j_loaded, j_resolved, j_chosen = _pipeline(j_cp, path, pinned)
    assert loaded == j_loaded
    assert "_include" not in loaded and "'width': 64" in loaded and "'height': 8" in loaded
    assert_same(resolved, j_resolved)
    assert_same(chosen, j_chosen)


def test_task_config_refuses_the_same_include_collision(tmp_path):
    (tmp_path / "base.yml").write_text("width: 40\n")
    (tmp_path / "bad.yml").write_text("render:\n  _include: base.yml\n  width: 3\n")
    for m in (t_cp, j_cp):
        with pytest.raises(AssertionError, match="collision"):
            m.load_task_config(tmp_path / "bad.yml")


# --------------------------------------------------------------- evaluator
class _LevelEnv:
    """A deterministic env whose episode length and eval flags follow the
    level and the actions."""

    def reset(self, level=None):
        self.level, self.t, self.pos = level, 0, 0.0
        return np.array([self.level, self.pos], np.float32)

    def step(self, action):
        self.t += 1
        self.pos += float(np.asarray(action)[0])
        done = self.t >= 3 + self.level
        info = {"eval_info": {"success": self.pos > 1.5, "moved": self.pos != 0.0}} if done else {}
        return np.array([self.level, self.pos], np.float32), 0.0, done, info

    def close(self):
        pass


def _policy(m):
    class Push(m.BasePolicy):
        obs_mode = "state"

        def act(self, obs):
            return np.array([0.5 if obs[0] % 2 else 0.0], np.float32)

    return Push()


def test_evaluator_matches_jax_on_a_stand_in_env(tmp_path):
    out = {}
    for tag, m in (("torch", t_ev), ("jax", j_ev)):
        ev = m.Evaluator(env_name="Level-v0", policy=_policy(m), env=_LevelEnv())
        result = ev.run(level_list=[0, 1, 2, 3, 5], max_steps=20)
        ev.export_to_csv(str(tmp_path / f"{tag}.csv"))
        out[tag] = (dict(result), (tmp_path / f"{tag}.csv").read_text())
        ev.close()
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == {"success": 0.6, "moved": 0.6}


def test_evaluator_refuses_an_episode_without_eval_info():
    class NoInfo(_LevelEnv):
        def step(self, action):
            obs, r, done, _ = super().step(action)
            return obs, r, done, {}

    for m in (t_ev, j_ev):
        ev = m.Evaluator(env_name="Level-v0", policy=_policy(m), env=NoInfo())
        with pytest.raises(RuntimeError, match="eval_info"):
            ev.run(level_list=[0])
        with pytest.raises(RuntimeError, match="without done"):
            ev.run(level_list=[30], max_steps=4)


def test_evaluator_builds_its_env_through_the_packages_builder(tmp_path):
    """``env_name`` with no ``env``: each package's ``build_env`` makes the
    FakeManipulation env; a greedy state policy gives the same shares."""
    out = {}
    for tag, m in (("torch", t_ev), ("jax", j_ev)):
        class Greedy(m.BasePolicy):
            obs_mode = "state"

            def act(self, obs):
                d = obs[3:6]
                a = np.zeros(8, np.float32)
                a[:3] = d / max(np.linalg.norm(d), 1e-6)
                return a

        ev = m.Evaluator(env_name="FakeManipulation-v0", policy=Greedy(), env_cfg=dict(horizon=8))
        assert type(ev.env).__module__.startswith(f"pointcloud_rl_{'torch' if tag == 'torch' else 'tpu'}.env")
        result = ev.run(level_list=[0, 1, 2, 3], max_steps=60)
        ev.export_to_csv(str(tmp_path / f"{tag}.csv"))
        out[tag] = (dict(result), (tmp_path / f"{tag}.csv").read_text())
        ev.close()
    assert out["torch"] == out["jax"] and "success" in out["torch"][0]


# -------------------------------------------------------- handle discovery
_BOX = """v -0.5 -0.5 -0.5
v 0.5 -0.5 -0.5
v 0.5 0.5 -0.5
v -0.5 0.5 -0.5
v -0.5 -0.5 0.5
v 0.5 -0.5 0.5
v 0.5 0.5 0.5
v -0.5 0.5 0.5
vt 0 0
vn 0 0 1
f 1/1/1 2/1/1 3/1/1 4/1/1
f 5//1 8//1 7//1 6//1
f 1 5 6 2
f 2 6 7 3
f 3 7 8 4
f -8 -4 -1 -5
"""
_URDF = """<robot name="cabinet">
  <link name="base"><visual name="body"><geometry><mesh filename="box.obj"/></geometry></visual></link>
  <link name="door">
    <visual name="door_panel"><geometry><mesh filename="box.obj" scale="0.02 0.4 0.6"/></geometry></visual>
    <visual name="handle_bar"><origin xyz="0.05 0.15 0.0" rpy="0 0 0"/>
      <geometry><mesh filename="box.obj" scale="0.02 0.02 0.2"/></geometry></visual>
  </link>
  <link name="drawer">
    <visual name="drawer_handle_0"><origin xyz="0.3 0.0 -0.2" rpy="0.1 0.0 1.5708"/>
      <geometry><mesh filename="box.obj" scale="0.03 0.25 0.03"/></geometry></visual>
    <visual name="drawer_handle_1"><origin xyz="0.31 0.05 -0.2"/>
      <geometry><mesh filename="box.obj" scale="0.02 0.2 0.02"/></geometry></visual>
  </link>
  <link name="knob"><visual name="knob_handle"><geometry><mesh filename="box.obj" scale="0.05 0.05 0.05"/></geometry></visual></link>
  <joint name="j_door" type="revolute"><parent link="base"/><child link="door"/></joint>
  <joint name="j_drawer" type="prismatic"><parent link="base"/><child link="drawer"/></joint>
  <joint name="j_knob" type="continuous"><parent link="base"/><child link="knob"/></joint>
</robot>
"""


@pytest.fixture()
def urdf(tmp_path):
    (tmp_path / "box.obj").write_text(_BOX)
    (tmp_path / "cabinet.urdf").write_text(_URDF)
    return str(tmp_path / "cabinet.urdf")


def _discovery(m, urdf, seed):
    import os.path as osp

    poses = {"door": m.Pose([0.1, -0.2, 0.3], [0.9, 0.1, -0.2, 0.3])}
    return [
        m.read_obj_mesh(osp.join(osp.dirname(urdf), "box.obj")),
        m.parse_urdf_handle_meshes(urdf, scale=1.3),
        m.handle_links_by_joint_type(urdf, "revolute"),
        m.handle_links_by_joint_type(urdf, "prismatic"),
        m.handle_links_by_joint_type(urdf, "revolute", handle_links=["door"]),
        m.discover_handles(urdf, seed=seed),
        m.discover_handles(urdf, link_poses=poses, scale=0.8, sample_n=300, keep_n=40, seed=seed),
    ]


@pytest.mark.parametrize("seed", [0, 7])
def test_handle_discovery_matches_jax(urdf, seed):
    got, want = _discovery(t_hd, urdf, seed), _discovery(j_hd, urdf, seed)
    assert_same(got, want)
    assert got[2] == ["door", "knob"] and got[3] == ["drawer"]
    handles = got[5]
    assert set(handles) == {"door", "drawer", "knob"}
    assert all(0 < len(h["points"]) <= 100 for h in handles.values())
