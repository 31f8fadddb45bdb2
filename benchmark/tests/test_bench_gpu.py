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
