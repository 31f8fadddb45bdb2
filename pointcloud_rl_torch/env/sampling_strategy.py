# Copy of pointcloud_rl_tpu/env/sampling_strategy.py for the PyTorch port (that package's env imports JAX).
"""Replay sampling strategies.

Parity target: reference ``pyrl/env/sampling_strategy.py`` —
``OneStepTransition`` uniform iid sampling with optional no-replacement
shuffled epochs; ``TStepTransition`` horizon windows for recurrent policies.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .builder import SAMPLING


@SAMPLING.register_module()
class OneStepTransition:
    def __init__(self, with_replacement: bool = True, no_random: bool = False, seed: Optional[int] = None):
        self.with_replacement = with_replacement
        self.no_random = no_random
        self.rng = np.random.RandomState(seed)
        self._epoch_order = None
        self._epoch_pos = 0
        self.horizon = 1

    def reset(self) -> None:
        self._epoch_order = None
        self._epoch_pos = 0

    def sample(self, batch_size: int, size: int, capacity: int) -> np.ndarray:
        """Return [B] flat indices into the valid region [0, size)."""
        assert size > 0, "Cannot sample from an empty buffer"
        if self.no_random:
            idx = (np.arange(batch_size) + self._epoch_pos) % size
            self._epoch_pos = (self._epoch_pos + batch_size) % size
            return idx
        if self.with_replacement:
            return self.rng.randint(0, size, batch_size)
        if self._epoch_order is None or self._epoch_pos + batch_size > len(self._epoch_order):
            self._epoch_order = self.rng.permutation(size)
            self._epoch_pos = 0
        out = self._epoch_order[self._epoch_pos : self._epoch_pos + batch_size]
        self._epoch_pos += batch_size
        return out


@SAMPLING.register_module()
class TStepTransition:
    """Fixed-horizon windows per worker episode (reference
    sampling_strategy.py:105-246).  Returns [B, H] indices + padding mask;
    horizon=-1 samples whole episodes.  Used by recurrent policies."""

    def __init__(self, horizon: int = 1, seed: Optional[int] = None, max_horizon: Optional[int] = None):
        self.horizon = horizon
        self.max_horizon = max_horizon  # optional cap on the H=-1 window width
        self.rng = np.random.RandomState(seed)

    def reset(self) -> None:
        pass

    def sample_windows(self, batch_size: int, episode_spans: List[Tuple[int, int]], horizon: Optional[int] = None):
        """episode_spans: list of (start, end) flat index ranges (end exclusive).

        horizon=-1 returns WHOLE episodes (reference sampling_strategy.py:
        105-246): the window width is the longest sampled episode (optionally
        capped by ``max_horizon``), with shorter episodes mask-padded.
        Padded rows repeat the episode's last index so gathered frames stay
        in-episode; ``is_valid`` masks them out of the loss."""
        assert episode_spans, "No complete episodes available"
        H = self.horizon if horizon is None else horizon
        span_idx = self.rng.randint(0, len(episode_spans), batch_size)
        if H == -1:
            width = max(episode_spans[si][1] - episode_spans[si][0] for si in span_idx)
            if self.max_horizon is not None:
                width = min(width, int(self.max_horizon))
        else:
            width = H
        idx = np.zeros((batch_size, width), np.int64)
        mask = np.zeros((batch_size, width), bool)
        for b, si in enumerate(span_idx):
            s, e = episode_spans[si]
            length = e - s
            if H == -1 or H >= length:
                take = min(length, width)
                idx[b, :take] = np.arange(s, s + take)
                idx[b, take:] = s + take - 1
                mask[b, :take] = True
            else:
                t0 = self.rng.randint(s, e - H + 1)
                idx[b] = np.arange(t0, t0 + H)
                mask[b] = True
        return idx, mask
