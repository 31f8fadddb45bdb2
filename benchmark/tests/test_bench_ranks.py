"""The rank driver: a cell of several cards runs one data-parallel rank of
the port per process, each checked against the reference on the global
batch.  Here on 2 gloo ranks on the CPU at tiny sizes, the program in
float32: every rank's numbers agree with the reference to rounding, and a
run with the exchange left out (each rank steps on its own rows' gradient),
with half of each batch, or with a step that leaves its state unchanged,
comes out not correct.  ``test_bench_gpu.py`` has the 4-card twin."""

import json

import pytest
import tiny

from pcbench import harness, ranks

CELL = "drq_walker_pn.updates_dp4"
SEED = "2147483693"


def _tweak(fault=None):
    tw = tiny.tweak("drq_walker_pn", fault, float32=True)
    tw["ranks"] = 2
    return tw


def test_every_rank_follows_the_reference_on_the_global_batch():
    args = harness.parse_args(["--workload", CELL, "--seed", SEED, "--seconds", "0.5", "--trace", "0"])
    parts = ranks.launch(2, harness.run_part, (CELL, args, "cpu", 0.0, _tweak()), "cpu")
    assert len(parts) == 2
    for rank, part in enumerate(parts):
        got = {k: v["value"] for k, v in part["compared"].items()}
        for k in ("loss_gap", "grad_gap", "change_gap", "round_loss_gap", "round_change_gap", "moment_gap"):
            assert got[k] < 1e-5, (rank, k, got)
        assert part["device"]["count"] == 2 and part["failed"] == 0
    assert parts[0]["attempted"] == parts[1]["attempted"]  # the ranks agreed on the window's last round


@pytest.mark.parametrize("fault", [None, "exchange_left_out", "half_batch", "unchanged"])
def test_a_fault_on_the_ranks_is_not_correct(fault, capsys):
    rc = harness.main(["--workload", CELL, "--seed", SEED, "--seconds", "0.5", "--trace", "0"], device="cpu",
                      tweak=_tweak(fault))
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["device"]["count"] == 2
    assert res["correct"] is (fault is None), (fault, res["compared"])


def _fails():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("planted")
    return dist.get_rank()


def test_a_failed_rank_ends_the_run():
    with pytest.raises(ranks.RankFailed, match="planted"):
        ranks.launch(2, _fails, (), "cpu")
