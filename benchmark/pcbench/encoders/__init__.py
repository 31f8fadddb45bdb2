"""The encoders of the plain reference, one module per encoder, found by name.

A configuration names its encoder under ``reference.encoder``; the module
``encoders/<name>.py`` gives what the rest of the benchmark needs of it:

- ``encode(P, pcd, precision)``: the feature of each cloud of ``pcd [R, N,
  C]`` from the named leaves ``P`` (plain torch, every product through
  ``reference.matmul`` in ``precision``);
- ``forward_flops(shapes, rows)`` and ``backward_flops(shapes, rows)``: the
  FLOPs of the encode of ``rows`` clouds and of its backward (parameter
  gradients only), from the configuration's ``shapes``, for
  ``flops.update_flops``;
- ``is_norm(name)`` and ``fan_in(name, shapes)``: how ``weights.make``
  seeds each of the encoder's leaves (those under ``visual.``).

A new encoder is a new file here; nothing else of the benchmark names one.
"""

from __future__ import annotations

import importlib
from types import ModuleType

PREFIX = "visual."  # the encoder's leaves, as the port's Visuomotor names them


def load(name: str) -> ModuleType:
    """The encoder module ``encoders/<name>.py``."""
    if not name or not name.replace("_", "").isalnum():
        raise ValueError(f"an encoder's name is letters, digits and '_', not {name!r}")
    return importlib.import_module(f"{__name__}.{name}")
