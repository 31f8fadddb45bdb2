"""The update programs of a data-parallel rank (``algorithms/graphs.py`` on
``parallel/mesh.py``).

On the CPU: which ranks capture their updates as CUDA graphs (a card
outside a process group and an NCCL rank do, a gloo rank does not, nor
the CPU); SAC, DrQ and DDPG send every update entry point through
``_program``; ``reduce_metrics`` uploads its mask once per key set and
reduces as before; on two gloo ranks running ``train_rl`` with updates
interleaved, the host lead's programs and the other rank's pair up (an
``act`` or a ``storage`` program of n updates against a ``storage``
program of n, on the same buffer), and the ranks end bitwise equal.  The
``gpu``-marked test holds a graphed NCCL world of one to its eager twin
bitwise; it runs on a card as
``python -m pytest --noconftest -m gpu tests/test_torch_dp_programs.py``.
"""

import copy
import os
import os.path as osp
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, osp.dirname(__file__))

from _torch_dp_worker import SLICE_CONFIG, DRQ_CONFIG, agent_cfg_of, transitions  # noqa: E402

from pointcloud_rl_torch.algorithms.sac import SAC  # noqa: E402
from pointcloud_rl_torch.parallel.mesh import DataParallel  # noqa: E402

torch.set_num_threads(1)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
WORKER = osp.join(REPO, "tests", "_torch_dp_programs_worker.py")


# ------------------------------------------------------------- which ranks
class _Rank:
    """What ``SAC._graphed`` reads of an agent."""

    def __init__(self, device, dp):
        self.device, self.data_parallel = torch.device(device), dp


@pytest.mark.parametrize("device, backend, graphed", [("cpu", None, False), ("cuda", None, True),
                                                      ("cuda", "gloo", False), ("cuda", "nccl", True),
                                                      ("cpu", "gloo", False)],
                         ids=["cpu", "card_no_group", "card_gloo", "card_nccl", "cpu_gloo"])
def test_which_ranks_capture_their_updates(device, backend, graphed, monkeypatch):
    """A card's agent outside a process group and an NCCL rank capture their
    update programs; a gloo rank (its collectives run on the host) and the
    CPU run the eager step.  The backend is faked."""
    dp = DataParallel() if backend is None else DataParallel(0, 2, distributed=True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    assert dp.capturable == (backend in (None, "nccl"))
    assert SAC._graphed(_Rank(device, dp)) == graphed


@pytest.mark.parametrize("config, overrides", [(SLICE_CONFIG, {}), (DRQ_CONFIG, {}),
                                               (SLICE_CONFIG, {"agent_cfg.type": "DDPG"})],
                         ids=["sac", "drq", "ddpg"])
def test_every_update_entry_point_runs_a_program(config, overrides):
    """SAC, DrQ and DDPG share ``SAC._graphed``, and each update entry
    point runs through ``_program``: a storage scan, a lazy and a fetched
    update over a device replay, a lazy update on a host batch, and an
    act-fused forward."""
    from pointcloud_rl_torch.algorithms import build_agent
    from pointcloud_rl_torch.env import build_replay

    agent = build_agent(agent_cfg_of(config, overrides))
    assert type(agent)._graphed is SAC._graphed
    mem = build_replay(dict(type="DeviceReplayMemory", capacity=64), dict(seed=0), device="cpu")
    mem.push_batch(transitions(48, seed=1))
    host = build_replay(dict(type="ReplayMemory", capacity=64), dict(seed=0), device="cpu")
    host.push_batch(transitions(48, seed=1))
    kinds, program = [], agent._program

    def recorded(kind, n, body, inputs=None, memory=None):
        kinds.append((kind, n))
        return program(kind, n, body, inputs, memory)

    agent._program = recorded
    agent.update_parameters_scan(mem, 3)
    agent.update_parameters_lazy(mem, 0)
    agent.update_parameters(mem, 0)
    agent.update_parameters_lazy(host, 0)
    assert agent.set_fused_updates(mem, chunk=2, budget=2)
    agent.forward(transitions(4, seed=2)["obs"], mode="explore")
    agent.finish_fused_updates()
    assert kinds == [("storage", 3), ("storage", 1), ("storage", 1), ("batch", 1), ("act", 2)]
    assert agent.updates == 3 + 1 + 1 + 1 + 2


# ------------------------------------------------------- two gloo CPU ranks
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_ranks(mode: str, tmp_path) -> list:
    port = _free_port()
    outs = [str(tmp_path / f"{mode}{rank}.pt") for rank in range(2)]
    procs = [subprocess.Popen([sys.executable, WORKER, mode, outs[rank]], cwd=REPO, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                                       MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank)))
             for rank in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [torch.load(o, weights_only=False) for o in outs]


def test_reduce_metrics_uploads_its_mask_once(tmp_path):
    """Two gloo ranks: three reduces of one key set upload one mask, a
    second key set one more, and each reduce is the mean over the ranks,
    or the max where the key is maxed."""
    ranks = _two_ranks("reduce", tmp_path)
    for res in ranks:
        assert res["masks"] == 2 and len(res["uploads"]) == 2
    for i in range(4):
        maxed = torch.as_tensor(ranks[0]["calls"][i]["maxed"])
        rows = torch.stack([r["calls"][i]["values"] for r in ranks])
        want = torch.where(maxed, rows.max(dim=0).values, rows.mean(dim=0))
        for res in ranks:
            assert torch.equal(res["calls"][i]["out"], want), (i, res["calls"][i]["out"], want)


@pytest.mark.parametrize("fused", [False, True], ids=["hook", "act_fused"])
def test_the_ranks_programs_pair_up(fused, tmp_path):
    """Two gloo ranks through ``train_rl`` with 4 updates per cycle of 8 env
    steps, interleaved: the lead runs a chunk of 1 after (or, act-fused,
    inside) each of its 4 act dispatches on the buffer before the cycle's
    push, and the other rank a storage program of the same chunk on the
    same buffer, in the same order; the ranks end bitwise equal."""
    lead, other = _two_ranks("pairs_fused" if fused else "pairs", tmp_path)
    kind = "act" if fused else "storage"
    want = [(kind, 1, 8 + 8 * c) for c in range(3) for _ in range(4)]
    assert lead["programs"] == want
    assert other["programs"] == [("storage", n, size) for _, n, size in want]
    assert lead["updates"] == other["updates"] == 12
    for part in ("model", "target"):
        for k, v in lead[part].items():
            assert torch.equal(v, other[part][k]), f"{part}.{k}"
    assert torch.equal(lead["log_alpha"], other["log_alpha"])


# ------------------------------------------------------------- on the card
@pytest.mark.gpu
def test_graphed_nccl_world_of_one_equals_its_eager_twin_on_gpu():
    """An NCCL world of one: two ranks' agents of the tiny slice in one
    state over a device replay, the first replaying its programs
    (the all-reduces captured), the second taking the eager step (the
    all-reduces eager); after scans of 4 and 3 at both gate phases, eager,
    captured and replayed, across a push, the two are bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from pointcloud_rl_torch.algorithms import build_agent
    from pointcloud_rl_torch.env import build_replay
    from pointcloud_rl_torch.parallel import setup_data_parallel

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    graphed = None
    try:
        cfg = dict(agent_cfg_of(SLICE_CONFIG, {"agent_cfg.actor_update_interval": 2,
                                               "agent_cfg.target_update_interval": 2}), device="cuda")
        graphed, eager = build_agent(copy.deepcopy(cfg)), build_agent(copy.deepcopy(cfg))
        eager.load_state_dict(graphed.state_dict())
        mem = build_replay(dict(type="DeviceReplayMemory", capacity=512), dict(seed=0), device="cuda")
        mem.push_batch(transitions(192, seed=1))
        for agent in (graphed, eager):
            setup_data_parallel(agent, 1, replay=mem)
        assert graphed._graphed() and eager._graphed()
        for rnd in range(3):  # round 0 runs eagerly, rounds 1-2 replay graphs
            for n in (4, 3, 4, 3):  # phases 0, 0, 1, 1 of the interval-2 gates
                gen = mem.generator.get_state()
                got = graphed.update_parameters_scan(mem, n)
                after = mem.generator.get_state()
                mem.generator.set_state(gen)
                want = eager._update_vecs(mem, n)
                assert torch.equal(mem.generator.get_state(), after), (rnd, n)
                assert torch.equal(got, want), (rnd, n, got, want)
                sa, sb = graphed.state_dict(), eager.state_dict()
                for part in ("model", "target"):
                    for k, v in sa[part].items():
                        assert torch.equal(v, sb[part][k]), (rnd, n, part, k)
                for opt in ("actor_opt", "critic_opt", "alpha_opt"):
                    for i, st in sa[opt]["state"].items():
                        for k, v in st.items():
                            assert torch.equal(v, sb[opt]["state"][i][k]), (rnd, n, opt, i, k)
                assert sa["updates"] == sb["updates"] and torch.equal(sa["log_alpha"], sb["log_alpha"])
            if rnd == 1:  # the graphs captured in round 1 sample the grown replay in round 2
                mem.push_batch(transitions(40, seed=2))
        assert len(graphed._programs.programs) == 4
        assert np.isfinite(graphed.reduce_metric_vecs(got, 3)["sac/critic_loss"])
    finally:
        if graphed is not None:
            graphed.drop_programs()  # NCCL frees a communicator only once no graph holds its collectives
        dist.destroy_process_group()
