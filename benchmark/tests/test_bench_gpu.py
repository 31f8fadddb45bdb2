"""On the card: each cell runs through ``benchmark/run.py`` and comes out
correct, traced and untraced.  Marked ``gpu``; skips here without a card
(the fixture decides, not the import).

    python -m pytest --noconftest -m gpu benchmark/tests/test_bench_gpu.py
"""

import json
import os
import subprocess
import sys

import pytest
import tiny

CELLS = ["drq_walker_pn.updates", "sac_maniskill_pn.updates", "drq_walker_pn.loop"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, workload, trace):
    proc = subprocess.run([sys.executable, os.path.join(tiny.BENCH, "run.py"), "--workload", workload, "--seed",
                           "2147483900", "--seconds", "5", "--trace", str(trace)],
                          capture_output=True, text=True, timeout=1200, cwd=tiny.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["compared"]
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
    assert res["metrics"]
    for name, m in res["metrics"].items():
        if name.endswith(("roofline_pct",)) or "mfu" in name:
            assert 0 < m["value"] <= 100, (name, m)


@pytest.fixture
def four_cards():
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 NVIDIA GPUs")


RANKS = (
    "import json, sys\n"
    "sys.path[:0] = ['benchmark', '.']\n"
    "from pcbench import harness\n"
    "fault = json.loads(sys.argv[1])\n"
    "sys.exit(harness.main(['--workload', 'drq_walker_pn.updates_dp4', '--seed', '2147483911', '--seconds', '5',\n"
    "                       '--trace', '0'], device='cuda', tweak={'fault': fault} if fault else None))\n"
)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", [None, "exchange_left_out"])
def test_ranks_on_four_cards(four_cards, fault):
    """The twin of ``test_bench_ranks.py`` on 4 NCCL ranks at the cell's own size."""
    proc = subprocess.run([sys.executable, "-c", RANKS, json.dumps(fault)], capture_output=True, text=True,
                          timeout=1200, cwd=tiny.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["device"]["count"] == 4
    assert res["correct"] is (fault is None), (fault, res["compared"])
