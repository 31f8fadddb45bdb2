"""Tiny sizes of the benchmark's configurations, for its CPU tests.

``tweak(config_name)`` is what ``pcbench.harness.main(..., tweak=)`` patches
into a configuration: every width, the batch, the points and the replay cut
so that a cell runs on the CPU in seconds.  The timed sizes are the files'."""

from __future__ import annotations

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

WIDTHS, FEATURE, HIDDEN, BATCH = [8, 16, 32], 8, 32, 16


def _nets(feature_in: int, action: int, critic_in: int, fused: bool) -> dict:
    return {
        "batch_size": BATCH,
        "actor_cfg": {"nn_cfg": {"visual_nn_cfg": {"mlp_spec": WIDTHS, "out_channels": FEATURE, "fused": fused},
                                 "mlp_cfg": {"mlp_spec": [feature_in, HIDDEN, HIDDEN, 2 * action]}}},
        "critic_cfg": {"nn_cfg": {"mlp_cfg": {"mlp_spec": [critic_in, HIDDEN, HIDDEN, 1]}}},
    }


def tweak(name: str, fault=None) -> dict:
    if name == "drq_walker_pn":
        frames, n_points, ground, A = 3, 16, 4, 6
        pts = frames * n_points
        config = {
            "agent_cfg": _nets(FEATURE, A, FEATURE + A, True),
            "obs_shape": {"xyz": [3, pts], "rgb": [3, pts], "pos_encoding": [3, pts]},
            "env": {"n_points": n_points, "num_ground": ground, "image_size": [16, 16]},
            "env_cfg": {"n_points": n_points, "num_ground": ground, "image_size": [16, 16]},
            "replay_cfg": {"capacity": 600},
            "rollout_cfg": {"num_procs": 2},
            "train_cfg": {"n_steps": 2, "n_updates": 2, "warm_steps": 40, "n_log": 6},
            "shapes": {"batch_size": BATCH, "points": pts, "widths": WIDTHS, "feature": FEATURE,
                       "hidden": [HIDDEN, HIDDEN]},
            "reference": {"batch_size": BATCH},
        }
    elif name == "sac_maniskill_pn":
        A, S = 22, 38
        config = {
            "agent_cfg": _nets(FEATURE + S, A, FEATURE + S + A, True),
            "replay_cfg": {"capacity": 600},
            "rollout_cfg": {"num_procs": 2},
            "train_cfg": {"n_steps": 2, "n_updates": 1, "warm_steps": 40, "n_log": 6},
            "shapes": {"batch_size": BATCH, "widths": WIDTHS, "feature": FEATURE, "hidden": [HIDDEN, HIDDEN]},
            "reference": {"batch_size": BATCH},
        }
    else:
        raise KeyError(name)
    out = {"config": config, "traffic": {"fill_rows": 600, "warm_rounds": 2, "warm_cycles": 3, "trace_rounds": 0}}
    if fault:
        out["fault"] = fault
    return out


def run_cell(workload: str, seed: int = 7, seconds: float = 1.0, fault=None, capsys=None):
    """Run a cell on the CPU at the tiny sizes; returns the result line (a dict)."""
    import json

    from pcbench import harness

    config = workload.split(".")[0]
    rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"],
                      device="cpu", tweak=tweak(config, fault))
    assert rc == 0, rc
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
