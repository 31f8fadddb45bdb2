"""The port's data-parallel training (``pointcloud_rl_torch/parallel``) on the CPU.

Two gloo ranks, started from the launcher environment as
``tests/test_multihost.py`` starts the JAX package's processes, and a
1-rank reference process run ``tests/_torch_dp_worker.py``:

- the SAC update of two ranks, on parameters converted from the JAX agent
  with the noise pinned to zero, against the JAX package's single-device
  update and its ``setup_data_parallel`` update on the 8-device CPU mesh
  (``tests/test_parallel.py``'s tolerance on the parameters);
- SAC, DrQ (jitter and rotation/scale/translation augmentations),
  recurrent SAC, DDPG and SAC with ``max_grad_norm`` with the noise on:
  the parameters bitwise equal across the ranks and within that tolerance
  of the 1-rank update (the clip of the global gradient needs the
  all-reduce before it);
- the primitives (``is_lead_process``, ``allreduce_stats``, ``DistVar``)
  against the values the JAX package's give.

Then ``run_rl --device cpu --num-devices 2`` trains, evaluates, profiles,
auto-resumes and stops on SIGTERM with rank 0 writing alone, and the
refusals: CUDA ranks without a GPU, a batch that does not split,
``--num-devices`` in a world launched from outside, and the agent's
default device without a GPU.
"""

import csv
import json
import os
import os.path as osp
import signal
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

from test_torch_models import SLICE_CONFIG, TINY_CLI, jax_leaf, slice_setup  # noqa: E402
from test_torch_sac import METRIC_RTOL, _batch, _FixedMemory, _pin_noise  # noqa: E402

from pointcloud_rl_torch.convert import params_from_jax  # noqa: E402

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
WORKER = osp.join(osp.dirname(__file__), "_torch_dp_worker.py")
N_UPDATES = 3  # the worker's
# tests/test_parallel.py's: the mesh update against the single-device one
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
NOISY = ["sac", "drq", "recurrent", "ddpg", "clip"]
TIMEOUT_S = 240  # per spawned process (pytest-timeout is not installed)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(procs, timeout=TIMEOUT_S):
    """Every process's (return code, output); all are killed on a timeout."""
    out = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a spawned process timed out")
        out.append((p.returncode, stdout))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory, request):
    """The worker's results: ``{(world size, rank): results}``, and the JAX
    agents' updates on the same batch."""
    tmp = tmp_path_factory.mktemp("dp")
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    _pin_noise(mp)
    from pointcloud_rl_tpu.algorithms import build_agent as j_build_agent
    from pointcloud_rl_tpu.parallel import setup_data_parallel as j_setup_data_parallel

    agent_cfg, env_info, _ = slice_setup(fused=True)
    j_single = j_build_agent(dict(agent_cfg, env_params=env_info, seed=0))
    st = j_single.train_state
    torch.save(params_from_jax(st.params, st.target_params, st.log_alpha), tmp / "init.pt")
    batch = _batch()
    torch.save(batch, tmp / "batch.pt")
    env = dict(os.environ, PCRL_DP_OUT=str(tmp), PCRL_DP_INIT=str(tmp / "init.pt"),
               PCRL_DP_BATCH=str(tmp / "batch.pt"), OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, WORKER], cwd=REPO, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT,
                              env=dict(env, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                                       RANK=str(rank)))
             for rank in range(2)]
    procs.append(subprocess.Popen([sys.executable, WORKER], cwd=REPO, text=True, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, env=env))

    # the JAX updates on the same batch while the port's processes run
    j_mesh = j_build_agent(dict(agent_cfg, env_params=env_info, seed=0))
    j_setup_data_parallel(j_mesh, 8)
    jax_metrics = {}
    for name, agent in (("single", j_single), ("mesh", j_mesh)):
        jax_metrics[name] = [agent.update_parameters(_FixedMemory(batch), updates=u) for u in range(N_UPDATES)]

    for rc, log in _wait(procs):
        assert rc == 0, log[-4000:]
    results = {key: torch.load(tmp / f"world{key[0]}_rank{key[1]}.pt", weights_only=False)
               for key in ((2, 0), (2, 1), (1, 0))}
    return results, {"single": j_single, "mesh": j_mesh}, jax_metrics


@pytest.mark.parametrize("oracle", ["single", "mesh"])
def test_two_rank_update_matches_jax(world, oracle):
    """Two ranks' SAC update equals the JAX package's single-device and
    8-device mesh updates on the same batch, noise pinned to zero."""
    results, j_agents, j_metrics = world
    for rank in (0, 1):
        ours = results[(2, rank)]["sac_jax"]
        for u, (a, b) in enumerate(zip(j_metrics[oracle], ours["metrics"])):
            for key in ("critic_loss", "q", "q_target", "alpha", "actor_loss", "entropy"):
                if f"sac/{key}" in a:
                    x, y = a[f"sac/{key}"], b[f"sac/{key}"]
                    assert abs(x - y) < METRIC_RTOL * (1 + abs(x)), f"update {u} {key}: jax {x} vs torch {y}"
        st = j_agents[oracle].train_state
        params, target = jax.device_get(st.params), jax.device_get(st.target_params)
        for name, value in ours["model"].items():
            np.testing.assert_allclose(value.numpy(), jax_leaf(params, name), **PARAM_TOL, err_msg=name)
        for name, value in ours["target"].items():
            np.testing.assert_allclose(value.numpy(), jax_leaf(target, name), **PARAM_TOL, err_msg=name)
        np.testing.assert_allclose(float(ours["log_alpha"]), float(st.log_alpha), **PARAM_TOL)


@pytest.mark.parametrize("scenario", NOISY)
def test_two_ranks_equal_each_other_and_one_rank(world, scenario):
    """With the noise on: bitwise equal parameters on both ranks, within
    the mesh tolerance of one rank on the same global batches."""
    results, _, _ = world
    r0, r1, one = (results[key][scenario] for key in ((2, 0), (2, 1), (1, 0)))
    for part in ("model", "target"):
        for name, value in r0[part].items():
            assert torch.equal(value, r1[part][name]), f"{part}.{name} differs across the ranks"
            np.testing.assert_allclose(value.numpy(), one[part][name].numpy(), **PARAM_TOL,
                                       err_msg=f"{part}.{name}")
    assert torch.equal(r0["log_alpha"], r1["log_alpha"])
    assert r0["metrics"] == r1["metrics"]
    for u, (a, b) in enumerate(zip(one["metrics"], r0["metrics"])):
        assert a.keys() == b.keys()
        for key, x in a.items():
            assert abs(x - b[key]) < METRIC_RTOL * (1 + abs(x)), f"update {u} {key}: 1 rank {x} vs 2 ranks {b[key]}"


def test_clip_sees_the_global_gradient(world):
    """The clip scenario clips (its norms are far above 0.05), so two ranks
    equal one only because the clip follows the all-reduce."""
    results, _, _ = world
    metrics = results[(1, 0)]["clip"]["metrics"]
    assert min(m["sac/critic_grad"] for m in metrics) > 0.05
    assert min(m["sac/actor_grad"] for m in metrics if "sac/actor_grad" in m) > 0.05


def test_primitives_behave_as_jax(world):
    from pointcloud_rl_torch.parallel import allreduce_stats, is_lead_process
    from pointcloud_rl_tpu.parallel import allreduce_stats as j_allreduce_stats

    results, _, _ = world
    for rank in (0, 1):
        res = results[(2, rank)]
        assert res["joined"]
        # the values tests/_multihost_worker.py asserts for the JAX package
        assert res["primitives"] == {"sum": {"n": 2.0, "r": 1.0}, "max": {"r": 1.0}, "mean": {"r": 0.5},
                                     "unknown_op": "KeyError", "distvar": 3}
    assert not results[(1, 0)]["joined"]
    # a world of one: the identity, as JAX's on one host
    stats = {"a": 1.5, "b": -2.0}
    assert allreduce_stats(stats, op="sum") == j_allreduce_stats(stats, op="sum") == stats
    assert is_lead_process()


# ---------------------------------------------------------------- the draws
# Every draw of the update over the batch axis must go through
# utils.draws.draw_rows: then a rank's draws inside split_draws are its rows
# of the 1-rank draws, and the generator ends where the 1-rank one does.  A
# draw that bypasses it fails here.  One case per registered augmentation
# and head, so a new one without a case fails too.
DRAW_B = 8
AUG_CASES = {
    "GlobalRotScaleTrans": dict(req_keys=["xyz", "ee_vel"], translation_range=[0.1, 0.1, 0.1]),
    "RandomJitterPoints": dict(jitter_range=[-0.01, 0.01]),
    "RandomDownSample": dict(drop_ratio=0.25, fixed_ratio=False),
    "RandomDownSampleAndFilter": dict(req_keys=["xyz", "rgb"], func_keys=["xyz", "seg"], n_points=6, n_fg=2,
                                      stack_frame=2),
    "ColorJitterPoints": {},
    "AddOriginBall": dict(n_pts=5),
    "ToChannelFirst": dict(main_key=None, req_keys=["image"]),
    "ToChannelLast": dict(main_key=None, req_keys=["image"]),
    "RandomChannelSwap": dict(main_key="image", req_keys=["image"], independent=True),
    "RandomCrop": dict(main_key="image", req_keys=["image"], size=10, padding=2, padding_mode="reflect"),
}
HEAD_CASES = {  # (kwargs, feature width, modes)
    "TanhGaussianHead": (dict(dim_output=3, bound=([-1.0] * 3, [1.0] * 3)), 6, ["explore", "max-entropy"]),
    "GaussianHead": (dict(dim_output=3, bound=([-2.0] * 3, [2.0] * 3)), 6, ["explore", "max-entropy"]),
    "SoftplusGaussianHead": (dict(dim_output=3), 6, ["explore", "max-entropy"]),
    "BasicHead": (dict(dim_output=3), 3, ["eval"]),
    "TanhHead": (dict(dim_output=3), 3, ["eval"]),
    "DiscreteBaseHead": (dict(num_choices=5), 5, ["explore", "max-entropy"]),
}


def _draw_obs():
    rs = np.random.RandomState(11)
    return {"xyz": torch.as_tensor(rs.randn(DRAW_B, 3, 24).astype(np.float32)),
            "rgb": torch.as_tensor(rs.randint(0, 256, (DRAW_B, 3, 24)).astype(np.uint8)),
            "seg": torch.as_tensor(rs.rand(DRAW_B, 1, 24) < 0.4),
            "ee_vel": torch.as_tensor(rs.randn(DRAW_B, 3).astype(np.float32)),
            "image": torch.as_tensor(rs.randint(0, 256, (DRAW_B, 6, 12, 12)).astype(np.uint8))}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _assert_split_draws_are_rows(fn, inputs):
    """``fn(generator, inputs)`` of rank r of 2 inside ``split_draws`` equals
    rows [r*B/2, (r+1)*B/2) of the whole batch's, bitwise, from the same
    generator state, and leaves the generator where the whole batch does."""
    from pointcloud_rl_torch.utils.draws import split_draws

    whole_gen = torch.Generator().manual_seed(3)
    whole = _leaves(fn(whole_gen, inputs))
    half = DRAW_B // 2
    for rank in (0, 1):
        rows = slice(rank * half, (rank + 1) * half)
        gen = torch.Generator().manual_seed(3)
        with split_draws(rank, 2):
            part = _leaves(fn(gen, {k: v[rows] for k, v in inputs.items()}))
        assert len(part) == len(whole)
        for a, b in zip(part, whole):
            assert torch.equal(a, b[rows]), f"rank {rank}: its draws are not its rows of the whole batch's"
        assert torch.equal(gen.get_state(), whole_gen.get_state()), f"rank {rank}: the generator advanced otherwise"


def test_draw_cases_cover_every_augmentation_and_head():
    from pointcloud_rl_torch.models import REGRESSION
    from pointcloud_rl_torch.ops.augment import AUGMENTATIONS

    assert set(AUG_CASES) == set(AUGMENTATIONS.module_dict)
    assert set(HEAD_CASES) == set(REGRESSION.module_dict)


@pytest.mark.parametrize("name", sorted(AUG_CASES))
def test_augmentation_draws_split_over_ranks(name):
    from pointcloud_rl_torch.ops.augment import build_data_augmentations

    augs = build_data_augmentations([dict(AUG_CASES[name], type=name)])
    obs = _draw_obs()
    if name == "ToChannelFirst":
        obs = {"image": obs["image"].movedim(-3, -1)}
    elif name == "ToChannelLast":
        obs = {"image": obs["image"]}
    _assert_split_draws_are_rows(augs, obs)


@pytest.mark.parametrize("name", sorted(HEAD_CASES))
def test_head_draws_split_over_ranks(name):
    from pointcloud_rl_torch.models import REGRESSION

    kwargs, width, modes = HEAD_CASES[name]
    head = REGRESSION.module_dict[name](**kwargs)
    feature = torch.as_tensor(np.random.RandomState(5).randn(DRAW_B, width).astype(np.float32))
    for mode in modes:
        _assert_split_draws_are_rows(lambda gen, x: head(x["f"], mode=mode, generator=gen), {"f": feature})


@pytest.mark.parametrize("draw", ["standard_normal", "standard_gumbel"])
def test_distribution_draws_split_over_ranks(draw):
    """The samplers under the heads and DDPG's target smoothing."""
    from pointcloud_rl_torch.models import distributions

    fn = getattr(distributions, draw)
    _assert_split_draws_are_rows(lambda gen, x: fn(x["like"], gen), {"like": torch.zeros(DRAW_B, 4, 3)})


# ------------------------------------------------------------------ run_rl
_OPTS = TINY_CLI + [
    "agent_cfg.actor_cfg.nn_cfg.visual_nn_cfg.fused=True",
    "replay_cfg.capacity=500",
    "train_cfg.warm_steps=32",
    "train_cfg.n_log=32",
    "train_cfg.exp_logger_cfg.type=csv",
    "rollout_cfg.num_procs=1",
    "eval_cfg.save_video=False",
    "eval_cfg.num=1",
]


def _cli(work_dir, *extra, opts=()):
    cmd = [sys.executable, "-m", "pointcloud_rl_torch.apis.run_rl", SLICE_CONFIG, "--work-dir", str(work_dir),
           "--seed", "0", "--device", "cpu", *extra, "--cfg-options", *_OPTS, *opts]
    return subprocess.Popen(cmd, cwd=REPO, text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            env=dict(os.environ, OMP_NUM_THREADS="1"))


def _summary(work_dir):
    with open(osp.join(work_dir, "0", "run_summary.json")) as f:
        return json.load(f)


def test_run_rl_two_ranks_train_evaluate_profile_resume_and_sigterm(tmp_path):
    wd, wd_term = tmp_path / "wd", tmp_path / "term"
    # a long run to stop with SIGTERM, beside the short one
    term = _cli(wd_term, "--num-devices", "2", opts=["train_cfg.total_steps=100000", "train_cfg.n_checkpoint=-1"])
    train = _cli(wd, "--num-devices", "2", "--profile", "5",
                 opts=["train_cfg.total_steps=96", "train_cfg.n_checkpoint=64", "train_cfg.n_eval=64"])
    (rc, log), = _wait([train])
    assert rc == 0, log[-4000:]
    run = wd / "0"
    out = _summary(wd)
    assert out["world_size"] == 2 and out["steps"] == 96 and out["grad_steps"] == 16
    assert out["pointcloud_rl_tpu_modules"] == []
    assert sorted(os.listdir(run / "models")) == ["model_64", "model_final"]
    assert os.listdir(run / "eval_64")
    # one writer: one train log, one row per log boundary in metrics.csv
    assert len([f for f in os.listdir(run) if f.endswith("-train.log")]) == 1
    with open(run / "logs" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    steps = [row["step"] for row in rows if row.get("train/sac/critic_loss")]
    assert steps == ["64", "96"] and [row["step"] for row in rows if row.get("test/rewards_mean")] == ["64"]
    with open(run / "profile" / "trace.json") as f:
        trace = json.load(f)
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])

    (rc, log), = _wait([_cli(wd, "--num-devices", "2", "--auto-resume",
                             opts=["train_cfg.total_steps=128", "train_cfg.n_checkpoint=64"])])
    assert rc == 0, log[-4000:]
    rs = _summary(wd)
    assert rs["resume_steps"] == 64 and rs["steps"] == 128 and rs["world_size"] == 2
    assert "model_128" in os.listdir(run / "models")

    # SIGTERM to the spawner, once the ranks train: both stop after the
    # cycle, with one numbered checkpoint
    metrics = wd_term / "0" / "logs" / "metrics.csv"
    deadline = time.monotonic() + TIMEOUT_S
    while not (metrics.exists() and metrics.read_text().count("\n") >= 2):
        assert term.poll() is None and time.monotonic() < deadline, "the SIGTERM run never trained"
        time.sleep(0.2)
    term.send_signal(signal.SIGTERM)
    (rc, log), = _wait([term])
    assert rc == 0, log[-4000:]
    models = os.listdir(wd_term / "0" / "models")
    numbered = [m for m in models if m != "model_final"]
    assert len(numbered) == 1 and "model_final" in models, models
    assert 0 < _summary(wd_term)["steps"] < 100000


def test_refusals(tmp_path, monkeypatch):
    """CUDA ranks without a GPU, a global batch that does not split, an
    evaluation, and ``--num-devices`` in a world launched from outside: each
    raises before any rank starts."""
    from pointcloud_rl_torch.apis import run_rl

    def main(*flags, opts=()):
        run_rl.main([SLICE_CONFIG, "--work-dir", str(tmp_path), "--seed", "0", *flags, "--cfg-options", *_OPTS,
                     *opts])

    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main("--num-devices", "2")  # --device cuda is the default
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        main("--num-devices", "2", "--device", "cpu", opts=["agent_cfg.batch_size=15"])
    with pytest.raises(ValueError, match="one process"):
        main("--num-devices", "2", "--device", "cpu", "--evaluation")
    # a world launched from outside (torchrun, SLURM) starts its own ranks
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="--num-devices 2 spawns ranks on one host.*WORLD_SIZE"):
        main("--num-devices", "2", "--device", "cpu")


def test_agent_defaults_to_the_card():
    """Without ``device`` the agent is built on CUDA: here, with no GPU, that
    raises and names the way to ask for the CPU; with it, it builds."""
    from pointcloud_rl_torch.algorithms import build_agent

    agent_cfg, env_info, _ = slice_setup(fused=True)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_agent(dict(agent_cfg, env_params=env_info, seed=0))
    for kind in ("DrQ", "DDPG"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build_agent(dict(agent_cfg, type=kind, env_params=env_info, seed=0))
    agent = build_agent(dict(agent_cfg, env_params=env_info, seed=0, device="cpu"))
    assert agent.device.type == "cpu" and next(agent.model.parameters()).device.type == "cpu"
