"""The voxel configuration ``drq_voxel`` at tiny sizes on the CPU.

The plain reference's SparseCNN (``pcbench/encoders/sparsecnn.py``) against
the port's dense ``VoxelCNN`` on the same seeded weights: features and every
leaf's gradient to f32 rounding (sums in another order: the scatter-mean,
the convolutions' backward); its FLOP count against
``torch.utils.flop_counter`` on the port's module; its voxel size, grid and
stride against the configuration; and the tiny configuration through the
whole check: a sound run correct, its faults and its control not.  The
reference imports nothing of the port (nor JAX)."""

import json
import os
import subprocess
import sys

import pytest
import tiny
import torch
from test_bench_reference import _f32

from pcbench import drivers, harness, weights
from pcbench.encoders import sparsecnn

CELL = "drq_voxel.updates"
GRAD_RTOL = 3e-6  # of each leaf's largest gradient element, as the PointNet reference is held (3e-6)


def _port_net(grid):
    from pointcloud_rl_torch.models import build_all

    return build_all(dict(type="SparseCNN", in_channels=9, out_channels=8, voxel_size=0.05, mlp_spec=[8, 8, 16],
                          stem_channels=[8, 8], grid_size=grid, impl="dense"))


def _clouds(seed, rows=6, points=300):
    """Clouds of xyz (wider than an 8-voxel grid of 5 cm on x: clipped), rgb and a 0/1 segmentation."""
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand(rows, points, 3, generator=g) * torch.tensor([0.6, 0.3, 0.5]) - 0.2
    return torch.cat([xyz, torch.rand(rows, points, 3, generator=g),
                      (torch.rand(rows, points, 3, generator=g) < 0.3).float()], -1)


@pytest.mark.parametrize("grid", [(8, 8, 8), (7, 8, 9)], ids=["grid8", "grid_odd"])
def test_the_reference_encoder_follows_the_port(grid):
    net = _port_net(grid)
    w = weights.make({"visual." + n: tuple(p.shape) for n, p in net.named_parameters()}, 2147483711, "cpu",
                     "sparsecnn")
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(w["visual." + n])
    pcd = _clouds(5)
    proj = torch.randn(pcd.shape[0], 8, generator=torch.Generator().manual_seed(6))
    got = net({"pcd": pcd})
    (got * proj).sum().backward()
    P = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    want = sparsecnn.encode_grid(P, pcd, "float32", 0.05, grid, 2)
    grads = dict(zip(P, torch.autograd.grad((want * proj).sum(), list(P.values()))))
    got, want = got.detach(), want.detach()
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    port = dict(net.named_parameters())
    for name, g in grads.items():
        gap = float((port[name[len("visual."):]].grad - g).abs().max())
        assert gap <= GRAD_RTOL * float(g.abs().max()), (name, gap, float(g.abs().max()))
    # the control's operands rounded to TF32 move the feature well past the f32 gap
    with torch.no_grad():
        assert float((sparsecnn.encode_grid(P, pcd, "tf32", 0.05, grid, 2) - want).abs().max()) > 1e-4


def test_the_flops_are_the_flop_counters():
    from torch.utils.flop_counter import FlopCounterMode

    shapes = dict(points=50, channels=9, stem=[8, 8], widths=[8, 8, 16], grid=[8, 8, 8], kernel=4, stride=2,
                  feature=8)
    net = _port_net((8, 8, 8))
    pcd = torch.rand(3, 50, 9)
    with FlopCounterMode(display=False) as fwd:
        out = net({"pcd": pcd})
    with FlopCounterMode(display=False) as bwd:
        out.sum().backward()
    assert fwd.get_total_flops() == sparsecnn.forward_flops(shapes, 3)
    assert bwd.get_total_flops() == sparsecnn.backward_flops(shapes, 3)


def test_least_times_by_hand():
    # one layer: 2 clouds, a 4^3 grid of 3 channels -> 2^3 sites of 5, 4^3 taps
    shapes = dict(stem=[7, 3], widths=[5], grid=[4, 4, 4], kernel=4, stride=2)
    (layer,) = sparsecnn.conv_layers(shapes)
    assert layer == dict(c_in=3, c_out=5, in_sites=64, out_sites=8, taps=64)
    flop = 2 * 2 * 8 * 5 * 3 * 64
    assert sparsecnn.conv_flop(layer, 2) == flop
    nbytes = {"fwd": 4 * (2 * 64 * 3 + 5 * 3 * 64 + 5 + 2 * 8 * 5), "dgrad": 4 * (2 * 8 * 5 + 5 * 3 * 64 + 2 * 64 * 3),
              "wgrad": 4 * (2 * 64 * 3 + 2 * 8 * 5 + 5 * 3 * 64)}
    got = sparsecnn.least_ms(shapes, 2, "float32")
    for kind, b in nbytes.items():
        assert got[(0, kind)] == pytest.approx(1e3 * max(flop / (495e12 / 3), b / 3.35e12))
    # at the cell's size every call is bound by its products
    cfg = harness.Cell(CELL).config
    for (i, kind), ms in sparsecnn.least_ms(cfg["shapes"], 512, "float32").items():
        layer = sparsecnn.conv_layers(cfg["shapes"])[i]
        assert ms == pytest.approx(1e3 * sparsecnn.conv_flop(layer, 512) / (495e12 / 3))


def test_the_constants_are_the_configurations():
    from pointcloud_rl_torch.models import build_all

    cfg = harness.Cell(CELL).config
    shapes, vis = cfg["shapes"], cfg["agent_cfg"]["actor_cfg"]["nn_cfg"]["visual_nn_cfg"]
    assert sparsecnn.VOXEL_SIZE == shapes["voxel"] == vis["voxel_size"]
    assert list(sparsecnn.GRID) == shapes["grid"] and sparsecnn.STRIDE == shapes["stride"]
    net = build_all(dict(vis))  # the port's defaults fill what the configuration leaves out
    assert net.grid_size == tuple(shapes["grid"]) and net.stride == shapes["stride"]
    assert net.kernel_size == shapes["kernel"] and net.widths == shapes["widths"] and net.impl == "dense"
    assert net.MLP_0.spec == [shapes["channels"]] + shapes["stem"] and net.out_channels == shapes["feature"]


def test_the_reference_follows_the_port_in_float32():
    args = harness.parse_args(["--workload", CELL, "--seed", "2147483711", "--seconds", "0.3", "--trace", "0"])
    out = drivers.run(harness.Cell(CELL), args, "cpu", 0.0, _f32("drq_voxel"))
    got = {k: v["value"] for k, v in out["compared"].items()}
    for k in ("loss_gap", "loss1_gap", "grad_gap", "change_gap", "round_loss_gap", "round_change_gap", "moment_gap"):
        assert got[k] < 1e-5, (k, got)


@pytest.mark.parametrize("fault", [None, "half_batch", "unchanged"])
def test_a_sound_run_is_correct_and_a_fault_is_not(fault, capsys):
    tw = _f32("drq_voxel")
    if fault:
        tw["fault"] = fault
    rc = harness.main(["--workload", CELL, "--seed", "2147483653", "--seconds", "0.5", "--trace", "0"], device="cpu",
                      tweak=tw)
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is (fault is None), (fault, res["compared"])
    assert set(res["compared"]) == set(harness.Cell(CELL).limits)


def test_the_control_fails_a_limit():
    cell = harness.Cell(CELL)
    args = harness.parse_args(["--workload", CELL, "--seed", "2147483659", "--seconds", "0.3", "--trace", "0"])
    tw = tiny.tweak("drq_voxel")
    tw["readings"] = True
    out = drivers.run(cell, args, "cpu", 0.0, tw)
    for kind in ("control", "half_batch", "unchanged"):
        assert any(v > cell.limits[k] for k, v in out["readings"][kind].items() if k in cell.limits), kind


def test_the_reference_encoder_imports_nothing_of_the_port():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('pointcloud_rl_torch', 'pointcloud_rl_tpu', 'jax', 'jaxlib', 'flax'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"sys.path.insert(0, {tiny.BENCH!r})\n"
        "import torch\n"
        "from pcbench import flops, weights\n"
        "from pcbench.encoders import sparsecnn\n"
        "shapes = {'visual.MLP_0.Dense_0.weight': (4, 9), 'visual.MLP_0.Dense_0.bias': (4,),\n"
        "  'visual.MLP_0.Dense_1.weight': (4, 4), 'visual.MLP_0.Dense_1.bias': (4,),\n"
        "  'visual.MLP_0.LayerNorm_0.weight': (4,), 'visual.MLP_0.LayerNorm_0.bias': (4,),\n"
        "  'visual.Conv_0.weight': (5, 4, 4, 4, 4), 'visual.Conv_0.bias': (5,),\n"
        "  'visual.LayerNorm_0.weight': (5,), 'visual.LayerNorm_0.bias': (5,),\n"
        "  'visual.Dense_0.weight': (3, 5), 'visual.Dense_0.bias': (3,),\n"
        "  'visual.LayerNorm_1.weight': (3,), 'visual.LayerNorm_1.bias': (3,)}\n"
        "P = weights.make(shapes, 3, 'cpu', 'sparsecnn')\n"
        "for p in ('float32', 'tf32', 'bfloat16', 'float8'):\n"
        "    assert sparsecnn.encode_grid(P, torch.rand(2, 30, 9), p, 0.1, (6, 6, 6), 2).shape == (2, 3), p\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('pointcloud_rl_torch', 'pointcloud_rl_tpu', 'jax'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(tiny.ROOT))
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
