"""Random draws over a batch that data-parallel ranks split between them.

Every draw of the update whose first axis is the batch (head noise, DDPG
target smoothing, the augmentations) goes through ``draw_rows``.  Inside
``split_draws(rank, size)``, which ``parallel.mesh.DataParallel`` enters
around a rank's update, such a draw takes the rows of all ``size`` ranks
from the generator and returns rank ``rank``'s.  A generator in the same
state on every rank then advances as in a 1-rank update, and each rank's
noise is its rows of the 1-rank noise.  Outside the context a draw is
the plain ``draw(shape)``.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Sequence

_SPLIT = threading.local()  # (rank, size) inside split_draws


def draw_rows(draw: Callable[[tuple], "torch.Tensor"], shape: Sequence[int]) -> "torch.Tensor":  # noqa: F821
    """``draw(shape)`` for a draw whose first axis is the batch; inside
    ``split_draws`` the rows of every rank are drawn and this rank's kept."""
    shape = tuple(shape)
    split = getattr(_SPLIT, "value", None)
    if split is None or not shape:
        return draw(shape)
    rank, size = split
    rows = shape[0]
    return draw((rows * size,) + shape[1:])[rank * rows:(rank + 1) * rows]


@contextmanager
def split_draws(rank: int, size: int):
    """Batch-axis draws inside are rank ``rank``'s rows of a batch ``size`` times as long."""
    prev = getattr(_SPLIT, "value", None)
    _SPLIT.value = None if size == 1 else (rank, size)
    try:
        yield
    finally:
        _SPLIT.value = prev
