"""The plain reference against ``pointcloud_rl_torch``'s CPU path at a tiny size.

With the program in float32 (``agent_cfg.bf16`` off, float32 replay
storage and act upload) the check's rounds and the first act agree to
float32 rounding; and the reference imports nothing of the port (nor JAX)."""

import os
import subprocess
import sys

import pytest
import tiny

from pcbench import drivers, harness


def _f32(name: str) -> dict:
    """The tiny sizes, the program in float32 (``agent_cfg.bf16`` off, and
    float32 replay storage and act upload where the config packs them)."""
    return tiny.tweak(name, float32=True)


@pytest.mark.parametrize("workload", ["drq_walker_pn.updates", "sac_maniskill_pn.updates", "drq_walker_pn.loop"])
def test_reference_follows_the_port_in_float32(workload):
    cell = harness.Cell(workload)
    args = harness.parse_args(["--workload", workload, "--seed", "2147483711", "--seconds", "0.3", "--trace", "0"])
    out = drivers.run(cell, args, "cpu", 0.0, _f32(workload.split(".")[0]))
    got = {k: v["value"] for k, v in out["compared"].items()}
    for k in ("loss_gap", "loss1_gap", "grad_gap", "change_gap", "round_loss_gap", "round_change_gap", "moment_gap"):
        assert got[k] < 1e-5, (k, got)
    if "act_gap" in got:
        assert got["act_gap"] < 1e-5
        assert got["fuse_faults"] == 0 and got["store_faults"] == 0 and got["push_faults"] == 0


def test_reference_imports_nothing_of_the_port():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('pointcloud_rl_torch', 'pointcloud_rl_tpu', 'jax', 'jaxlib', 'flax'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"sys.path.insert(0, {tiny.BENCH!r})\n"
        "import torch\n"
        "from pcbench import reference, weights, flops\n"
        "spec = reference.Spec(dict(algo='DrQ', batch_size=4, num_aug=2, gamma=0.9, alpha=0.1, action_dim=2,\n"
        "    actor_update_interval=2, target_update_interval=2, target_tau=0.01, actor_layers=2, critic_layers=2,\n"
        "    critic_heads=2, log_std_bound=[-10, 2], lr=dict(critic=1e-3, actor=1e-3, alpha=1e-3),\n"
        "    betas=dict(critic=[0.9, 0.999], actor=[0.9, 0.999], alpha=[0.5, 0.999]), translation=[0.04, 0, 0.04],\n"
        "    encoder='pointnet'))\n"
        "shapes = {'visual.conv.Dense_0.weight': (4, 5), 'visual.conv.Dense_0.bias': (4,),\n"
        "  'visual.conv.Dense_1.weight': (4, 4), 'visual.conv.Dense_1.bias': (4,),\n"
        "  'visual.conv.LayerNorm_0.weight': (4,), 'visual.conv.LayerNorm_0.bias': (4,),\n"
        "  'visual.conv.Dense_2.weight': (4, 4), 'visual.conv.Dense_2.bias': (4,),\n"
        "  'visual.conv.LayerNorm_1.weight': (4,), 'visual.conv.LayerNorm_1.bias': (4,),\n"
        "  'visual.final_dense.weight': (3, 4), 'visual.final_dense.bias': (3,),\n"
        "  'visual.final_ln.weight': (3,), 'visual.final_ln.bias': (3,),\n"
        "  'actor.final_mlp.Dense_0.weight': (6, 3), 'actor.final_mlp.Dense_0.bias': (6,),\n"
        "  'actor.final_mlp.Dense_1.weight': (4, 6), 'actor.final_mlp.Dense_1.bias': (4,),\n"
        "  'critic.VmapMLP_0.Dense_0.weight': (2, 5, 6), 'critic.VmapMLP_0.Dense_0.bias': (2, 6),\n"
        "  'critic.VmapMLP_0.Dense_1.weight': (2, 6, 1), 'critic.VmapMLP_0.Dense_1.bias': (2, 1)}\n"
        "w = weights.make(shapes, 3, 'cpu', 'pointnet')\n"
        "g = torch.Generator().manual_seed(0)\n"
        "b = dict(obs={'pcd': torch.rand(4, 7, 5)}, next_obs={'pcd': torch.rand(4, 7, 5)}, actions=torch.rand(4, 2),\n"
        "         rewards=torch.rand(4, 1), dones=torch.zeros(4, 1))\n"
        "for p in reference.PRECISIONS:\n"
        "    out = reference.run_steps(w, [lambda: b] * 3, torch.Generator().manual_seed(1), spec, p)\n"
        "    assert len(out['losses']) == 3 and out['grad1'] and out['change'], p\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('pointcloud_rl_torch', 'pointcloud_rl_tpu', 'jax'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(tiny.ROOT))
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
