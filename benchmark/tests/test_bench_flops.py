"""The yardstick's arithmetic at small shapes, against values worked out by hand."""

import pytest
import tiny  # noqa: F401  (puts the benchmark on the path)

from pcbench import flops
from pcbench.encoders import pointnet


def test_body_flop_and_bound():
    # 2 rows x 3 points, 4 channels, widths 5, 6, 7: 2*2*3*(4*5 + 5*6 + 6*7) = 12 * 92
    assert pointnet.body_flop(2, 3, 4, (5, 6, 7)) == 1104
    # f32 runs as three TF32 products: 1104 FLOP at 495e12 / 3 FLOP/s
    ops_ms = 1e3 * 1104 / (495e12 / 3)
    # bytes: x (2*3*4) + W (4*5 + 5*6 + 6*7) in f32, biases and norms 4*(5 + 3*6 + 3*7), out 2*7*(4 + 4)
    nbytes = (24 + 92) * 4 + 4 * 44 + 2 * 7 * 8
    mem_ms = 1e3 * nbytes / 3.35e12
    ms, bound = flops.bound_ms(2, 3, 4, (5, 6, 7), "float32", True)
    assert ms == pytest.approx(max(ops_ms, mem_ms))
    assert bound == ("operations" if ops_ms >= mem_ms else "bytes")
    # the walker's shape in bf16 is bound by its products
    ms, bound = flops.bound_ms(512, 1536, 9, (64, 128, 256), "bfloat16", True)
    assert bound == "operations"
    assert ms == pytest.approx(1e3 * 2 * 512 * 1536 * (9 * 64 + 64 * 128 + 128 * 256) / 989e12)


def test_update_flops_by_hand():
    s = dict(batch_size=2, num_aug=1, points=3, channels=4, widths=[5, 6, 7], feature=8, state=1, action=2,
             hidden=[10], heads=2, actor_interval=2)
    body = 2 * 2 * 3 * (4 * 5 + 5 * 6 + 6 * 7)          # 1104
    encode = body + 2 * 2 * 7 * 8                        # + final dense 224 = 1328
    actor = 2 * 2 * (9 * 10 + 10 * 4)                    # [8+1 -> 10 -> 4], 2 rows: 520
    critic = 2 * (2 * 2 * (11 * 10 + 10 * 1))            # 2 heads of [8+1+2 -> 10 -> 1]: 960
    body_bwd = 2 * 7 * (4 * 6 * 7 + 4 * 5 * 6 + 2 * 4 * 5)  # 7 winner points per row: 14 * 328
    final_bwd = 4 * 2 * 7 * 8
    target = encode + actor + critic
    critic_step = encode + critic + 2 * critic + body_bwd + final_bwd
    actor_step = actor + (2 * actor - 2 * 2 * 9 * 10) + critic + critic
    got = flops.update_flops(s, "pointnet")
    assert got["target"] == target
    assert got["critic_step"] == critic_step
    assert got["actor_step"] == actor_step
    assert got["total"] == target + critic_step + actor_step / 2


def test_peaks():
    assert flops.peak_flops("bfloat16") == 989e12
    assert flops.peak_flops("float32") == pytest.approx(165e12)
