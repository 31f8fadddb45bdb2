#!/usr/bin/env python3
"""How far VNPointNet's f32 result is from its f64 result, on the CPU.

    python3 tools/vn_f32_gap.py [--batch 8]

Builds ``VNPointNet`` at ``configs/mfrl/sac/maniskill/vn.py``'s widths from
a seeded generator, runs the clouds of ``chip_smoke.py``'s encoder phase
(the voxel config's env clouds on a 1/64 lattice, mirrored, so k-NN is
exact) through it in f32 and in f64 (the same neighbours), and prints the
largest forward difference per block and of the output, and each
parameter gradient's largest difference relative to its scale.  These set
``chip_smoke.VN_TOL``: the card's and the CPU's f32 results each sit about
this far from f64.
"""

from __future__ import annotations

import argparse
import copy
import json
import os.path as osp
import sys

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from pointcloud_rl_torch.models import build_all, vn

    net = build_all(cs.encoder_cfg("configs/mfrl/sac/maniskill/vn.py", {}), generator=torch.Generator().manual_seed(0))
    net64 = copy.deepcopy(net).double()
    obs = cs.encoder_inputs("lattice_cloud", args.batch)
    w = torch.randn((args.batch, net.LayerNorm_0.normalized_shape[0]), generator=torch.Generator().manual_seed(6))
    acts: dict = {}
    for tag, model in (("f32", net), ("f64", net64)):
        for name, child in model.named_children():
            child.register_forward_hook(lambda m, i, o, key=(tag, name): acts.__setitem__(key, o.detach()))
    (net(obs) * w).sum().backward()

    # f64: the same module on f64 features; k-NN from the f32 cloud (exact here)
    preprocess, knn = vn.preprocess_pointcloud, vn.knn_indices
    vn.preprocess_pointcloud = lambda o: preprocess(o).double()
    vn.knn_indices = lambda xyz, k: knn(xyz.to(torch.float32), k)
    float_ = torch.Tensor.float
    torch.Tensor.float = lambda self: self if self.dtype == torch.float64 else float_(self)
    try:
        (net64(obs) * w.double()).sum().backward()
    finally:
        vn.preprocess_pointcloud, vn.knn_indices, torch.Tensor.float = preprocess, knn, float_

    forward = {name: float((acts[("f32", name)].double() - acts[("f64", name)]).abs().max())
               for name, _ in net.named_children()}
    scale = {name: float(acts[("f64", name)].abs().max()) for name, _ in net.named_children()}
    grads = {name: float((a.grad.double() - b.grad).abs().max() / b.grad.abs().max())
             for (name, a), b in zip(net.named_parameters(), net64.parameters())}
    print(json.dumps({"batch": args.batch, "forward_max_abs_diff": forward, "forward_scale": scale,
                      "grad_max_diff_over_scale": grads, "worst_grad": max(grads.values())}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
