"""The encoder plug leaves the PointNet cells' readings as they were.

Before the plug, ``reference.py`` held PointNet's encode, ``flops.py`` its
FLOPs and ``weights.py`` its seeding; now ``encoders/pointnet.py`` does,
found by the name in each configuration file.  ``_old_pointnet`` and
``_old_make`` restate the removed code; ``data/pointnet_readings.json``
holds the FLOP counts and the compared numbers of tiny CPU runs that the
benchmark gave before the plug.  Each must come out the same, bit for bit."""

import json
import math
import os

import pytest
import tiny
import torch
import torch.nn.functional as F

from pcbench import drivers, flops, harness, reference, weights
from pcbench.encoders import pointnet

with open(os.path.join(tiny.BENCH, "tests", "data", "pointnet_readings.json")) as _f:
    BEFORE = json.load(_f)
CONFIGS = ("drq_walker_pn", "sac_maniskill_pn")


def _old_pointnet(P, pcd, precision):
    R, N, C = pcd.shape
    x = pcd.reshape(R * N, C).float()
    p = "visual.conv."
    lin = reference.linear
    h = torch.relu(lin(x, P[p + "Dense_0.weight"], P[p + "Dense_0.bias"], precision))
    h = lin(h, P[p + "Dense_1.weight"], P[p + "Dense_1.bias"], precision)
    h = torch.relu(F.layer_norm(h, h.shape[-1:], P[p + "LayerNorm_0.weight"], P[p + "LayerNorm_0.bias"], 1e-6))
    h = lin(h, P[p + "Dense_2.weight"], P[p + "Dense_2.bias"], precision)
    h = torch.relu(F.layer_norm(h, h.shape[-1:], P[p + "LayerNorm_1.weight"], P[p + "LayerNorm_1.bias"], 1e-6))
    pooled = h.reshape(R, N, -1).max(dim=1).values
    f = lin(pooled, P["visual.final_dense.weight"], P["visual.final_dense.bias"], precision)
    return F.layer_norm(f, f.shape[-1:], P["visual.final_ln.weight"], P["visual.final_ln.bias"], 1e-6)


def _old_make(shapes, seed, device):
    def is_norm(name):
        return "LayerNorm" in name or name.endswith(("final_ln.weight", "final_ln.bias"))

    def fan_in(name):
        kernel = shapes[name[: -len("bias")] + "weight"] if name.endswith(".bias") else shapes[name]
        return int(kernel[1])

    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32) * 2.0 - 1.0
    out, start = {}, 0
    for name, size in zip(names, sizes):
        x = u[start:start + size].reshape(shapes[name])
        start += size
        out[name] = (1.0 + 0.1 * x if name.endswith(".weight") else 0.1 * x) if is_norm(name) else \
            x / math.sqrt(fan_in(name))
    return out


def _shapes(name):
    """The leaves of the configuration's agent at its own sizes, as the port builds it."""
    from pointcloud_rl_torch.algorithms import build_agent

    cfg = harness.Cell(f"{name}.updates").config
    agent = build_agent(dict(drivers.decode(cfg["agent_cfg"]), env_params=drivers.env_info(cfg), seed=1,
                             device="cpu"))
    return weights.shapes_of(agent.model.named_parameters())


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_as_before(name):
    shapes = _shapes(name)
    new, old = weights.make(shapes, 2147483629, "cpu", "pointnet"), _old_make(shapes, 2147483629, "cpu")
    assert sorted(new) == sorted(old)
    for k in old:
        assert torch.equal(new[k], old[k]), k


@pytest.mark.parametrize("name", CONFIGS)
def test_update_flops_as_before(name):
    cfg = harness.Cell(f"{name}.updates").config
    assert cfg["reference"]["encoder"] == "pointnet"
    assert flops.update_flops(cfg["shapes"], cfg["reference"]["encoder"]) == BEFORE["flops"][name]


@pytest.mark.parametrize("precision", reference.PRECISIONS)
def test_encode_as_before(precision):
    torch.manual_seed(3)
    shapes = {"visual.conv.Dense_0.weight": (8, 9), "visual.conv.Dense_1.weight": (16, 8),
              "visual.conv.Dense_2.weight": (32, 16), "visual.final_dense.weight": (5, 32)}
    P = {}
    for k, s in shapes.items():
        P[k] = torch.randn(s)
        P[k.replace("weight", "bias")] = torch.randn(s[0])
    for ln, w in (("visual.conv.LayerNorm_0", 16), ("visual.conv.LayerNorm_1", 32), ("visual.final_ln", 5)):
        P[ln + ".weight"], P[ln + ".bias"] = 1 + 0.1 * torch.randn(w), 0.1 * torch.randn(w)
    pcd = torch.rand(4, 50, 9)
    with reference.precise():
        assert torch.equal(pointnet.encode(P, pcd, precision), _old_pointnet(P, pcd, precision))


@pytest.mark.parametrize("run", sorted(BEFORE["compared"]))
def test_tiny_runs_compare_as_before(run):
    workload, seed = run.split("@")
    cell = harness.Cell(workload)
    args = harness.parse_args(["--workload", workload, "--seed", seed, "--seconds", "0.3", "--trace", "0"])
    out = drivers.run(cell, args, "cpu", 0.0, tiny.tweak(workload.split(".")[0]))
    assert {k: v["value"] for k, v in out["compared"].items()} == BEFORE["compared"][run]
