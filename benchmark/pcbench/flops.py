"""Operations and bytes: the kernels' roofline and the update's FLOPs.

``bound_ms`` is a copy of ``chip_smoke.py``'s: the least time one H100
takes for one call of the fused PointNet body, the larger of its products
over the peak rate of their type (f32 runs as 3xTF32, three tensor-core
products per FLOP) and its bytes (inputs read once, outputs written once)
over HBM's rate.  ``update_flops`` counts the matrix products of one
SAC / DrQ update of the actor-critic from the configuration's shapes, its
encoder's through the encoder's module (``encoders/<name>.py``);
LayerNorms, elementwise ops and the optimizer are not counted.
"""

from __future__ import annotations

from typing import Dict, Tuple

from . import encoders
from .encoders.pointnet import body_flop

# Published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet).
PEAK_TF32 = 495e12  # FLOP/s
PEAK_BF16 = 989e12  # FLOP/s
PEAK_BYTES = 3.35e12  # bytes/s of HBM3


def peak_flops(dtype: str) -> float:
    """The rate ``bound_ms`` holds a product of ``dtype`` to: bf16 at its
    tensor-core peak, f32 as three TF32 products per FLOP."""
    return PEAK_BF16 if dtype == "bfloat16" else PEAK_TF32 / 3


def bound_ms(B: int, N: int, c_in: int, widths, dtype: str, with_idx: bool) -> Tuple[float, str]:
    """(the least ms of one call, "operations" or "bytes": which bounds it)."""
    c1, c2, c3 = widths
    flop = body_flop(B, N, c_in, widths)
    esz = 4 if dtype == "float32" else 2
    nbytes = (B * N * c_in + c_in * c1 + c1 * c2 + c2 * c3) * esz + 4 * (c1 + 3 * c2 + 3 * c3)
    nbytes += B * c3 * (8 if with_idx else 4)
    ops_s = flop / peak_flops(dtype)
    mem_s = nbytes / PEAK_BYTES
    return 1e3 * max(ops_s, mem_s), ("operations" if ops_s >= mem_s else "bytes")


def _dense_chain(rows: int, dims) -> int:
    """Forward FLOPs of a chain of dense layers ``dims[0] -> dims[1] -> ...``."""
    return sum(2 * rows * a * b for a, b in zip(dims[:-1], dims[1:]))


def update_flops(shapes: Dict, encoder: str) -> Dict[str, float]:
    """FLOPs of one update, by part, and their mean per update (``total``).

    ``shapes``: ``batch_size``, ``num_aug`` (1 for SAC), ``feature`` (the
    encoder's output width), ``state`` (robot state appended to it, 0 if
    none), ``action``, ``hidden`` (the heads' hidden widths), ``heads`` (Q
    heads), ``actor_interval``, and what the encoder ``encoder`` reads of
    them.  The configuration's algorithm: the encoder is shared and trained
    by the critic; the actor reuses the critic forward's feature (no encode
    of its own).

    - target (R = batch x num_aug rows, no gradient): the encode of the
      next obs, the actor's head and the target critic's heads;
    - critic step (R rows): the encode and the critic's heads forward;
      their backward, the encoder's with no gradient of its input
      (``backward_flops``);
    - actor step (batch rows, on every ``actor_interval``-th update): the
      actor's head forward and backward (no input gradient at its first
      layer, whose input is a detached feature), the critic's heads
      forward and their input gradients (the critic is not stepped)."""
    enc = encoders.load(encoder)
    B, K = int(shapes["batch_size"]), int(shapes.get("num_aug", 1))
    R = B * K
    F, S, A = int(shapes["feature"]), int(shapes.get("state", 0)), int(shapes["action"])
    hid = [int(h) for h in shapes["hidden"]]
    heads, interval = int(shapes["heads"]), int(shapes["actor_interval"])

    actor_dims = [F + S] + hid + [2 * A]
    critic_dims = [F + S + A] + hid + [1]
    actor_fwd = lambda rows: _dense_chain(rows, actor_dims)  # noqa: E731
    critic_fwd = lambda rows: heads * _dense_chain(rows, critic_dims)  # noqa: E731

    encode = enc.forward_flops(shapes, R)
    parts = {
        "target": encode + actor_fwd(R) + critic_fwd(R),
        "critic_step": encode + critic_fwd(R) + 2 * critic_fwd(R) + enc.backward_flops(shapes, R),
        "actor_step": (actor_fwd(B) + (2 * actor_fwd(B) - 2 * B * actor_dims[0] * actor_dims[1])
                       + critic_fwd(B) + critic_fwd(B)),
    }
    parts["total"] = parts["target"] + parts["critic_step"] + parts["actor_step"] / interval
    return parts
