"""The 3D convolutions' kernels in the traced sub-window, held to the port's counts.

cuDNN runs each 3D convolution call of the port (``ops/conv.py``) as one
main kernel whose name says its kind (``fprop``, ``dgrad``, ``wgrad``: a
forward, an input gradient, a weight gradient), and helpers: layout
conversions (``nchwToNhwc``, ``nhwcToNchw``) where the main kernel takes
another layout than the port's channels-last grid, and the fill of an
output it accumulates into (``setTensor``).  On an H100 with cuDNN 9 in
f32: ``sm80_xmma_fprop_implicit_gemm_indexed_*``,
``convolveNd_dgrad_float_engine``, ``sm80_xmma_wgrad_implicit_gemm_indexed_*``
and ``cudnn::cnn::convolveNd_wgrad_engine``, with
``cudnn::engines_precompiled::{nchwToNhwc,nhwcToNchw,setTensor5d}_kernel``.
No heads' GEMM (cuBLAS) or LayerNorm (ATen) kernel bears these marks.
Inside a captured update program no span can mark them; the port counts
the calls instead (``ops/conv.call_counts``), and its update programs keep
what one replay of each adds (``algorithms/graphs.replay_launches``).
``window_calls`` counts the calls by kind from the main kernels that start
in the sub-window, and holds them to the graph launches the host made in
it (``cudaGraphLaunch``, on the host's clock) times one replay's counts,
which every captured program that convolves must share.  It reads no
kernel's correlation id and no replay's end: the sub-window opens and
closes on a synchronize, so every kernel of its launches starts inside it,
and a kernel's start lies far from either edge, where a small offset
between the card's and the host's clocks cannot move it out.  A mismatch,
programs whose counts differ, a window without a convolution, and a
program without the counters (none before they were added): no reading,
and nothing raises.
"""

from __future__ import annotations

from typing import Dict, Optional

KINDS = ("fwd", "dgrad", "wgrad")
MAIN = {"fwd": "fprop", "dgrad": "dgrad", "wgrad": "wgrad"}  # a main kernel's mark, by kind
HELPERS = ("nchwToNhwc", "nhwcToNchw", "setTensor")  # cuDNN's layout conversions and output fills


def kind_of(name: str) -> Optional[str]:
    """``fwd``, ``dgrad`` or ``wgrad`` for a main kernel, ``helper`` for a
    layout conversion or an output fill, None for any other kernel."""
    for kind, mark in MAIN.items():
        if mark in name:
            return kind
    return "helper" if any(m in name for m in HELPERS) else None


def replay_counts() -> Optional[Dict[str, int]]:
    """One replay's convolution calls by kind, shared by every captured
    program that convolves; None where the port has no counters or its
    programs' counts differ."""
    try:
        from pointcloud_rl_torch.algorithms import graphs
        from pointcloud_rl_torch.ops import conv
    except ImportError:
        return None
    if not hasattr(conv, "call_counts") or not hasattr(graphs, "replay_launches"):
        return None
    figures = {tuple(int(fig.get(f"conv3d_{k}", 0)) for k in KINDS) for fig in graphs.replay_launches.values()}
    figures.discard((0,) * len(KINDS))
    return dict(zip(KINDS, figures.pop())) if len(figures) == 1 else None


def window_calls(ctx) -> Optional[dict]:
    """The sub-window's convolution calls by kind (``calls``) and the device
    us of their kernels, main and helpers (``us``), once the calls are the
    window's graph launches times one replay's counts; else None."""
    trace = ctx["trace"]
    per_replay = replay_counts()
    if trace is None or per_replay is None:
        return None
    launches = sum(1 for e in trace.runtime if e.get("name", "").startswith("cudaGraphLaunch")
                   and trace.t0 <= float(e["ts"]) <= trace.t1)
    calls, us = dict.fromkeys(KINDS, 0), 0.0
    for k in trace.kernels:
        kind = kind_of(k["name"])
        if kind is None or not trace.t0 <= float(k["ts"]) <= trace.t1:
            continue
        us += float(k.get("dur", 0))
        if kind in calls:
            calls[kind] += 1
    if not any(calls.values()) or calls != {k: launches * n for k, n in per_replay.items()}:
        return None
    return {"calls": calls, "us": us}
