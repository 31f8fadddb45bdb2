#!/usr/bin/env python3
"""Host cost of the walker recipe's replay snapshot file, on the CPU.

    python3 tools/replay_snapshot_cost.py [--rows 2000]

Fills a packed bf16 ``DeviceReplayMemory`` on the CPU with ``--rows`` raw
full-width walker transitions (``chip_smoke.walker_raw_block``: 3 frames x
512 points), then times what ``train_rl``'s ``save_replay`` and
``run_rl``'s warm restore do on the host: ``save_replay_snapshot`` (the
host replay's copy and the lzf HDF5 write with its rename) and
``load_hdf5`` into a fresh ring (the chunked read and pushes).  Prints one
JSON line: bytes per transition, the file's size, each time, its rate, the
same times scaled linearly to the recipe's ``save_replay=50000`` rows, and
the process's peak resident memory (``--rows 50000``: about 9 GB).
A data-parallel lead writes the snapshot while the other ranks wait in
their next collective, so the scaled write must stay far inside
``parallel.distributed.COLLECTIVE_TIMEOUT``.  Needs h5py.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import resource
import sys
import tempfile
import time

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=2000)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from pointcloud_rl_torch.apis.train_rl import save_replay_snapshot
    from pointcloud_rl_torch.env import build_replay
    from pointcloud_rl_torch.parallel.distributed import COLLECTIVE_TIMEOUT
    from pointcloud_rl_torch.utils.tree_ops import tree_leaves, tree_slice

    torch.set_num_threads(1)
    _, _, cfg = cs.walker_agent_cfg()
    target = cfg["train_cfg"]["save_replay"]
    replay_cfg = dict(cfg["replay_cfg"], capacity=args.rows)
    ring = build_replay(replay_cfg, dict(seed=0), device="cpu")
    block = cs.walker_raw_block(min(args.rows, cs.REPLAY_IO_BLOCK), 0)  # one block, reused as the chip phase does
    for start in range(0, args.rows, len(block["rewards"])):
        ring.push_batch(tree_slice(block, slice(0, args.rows - start)))
    del block
    row_bytes = sum(x[0].nbytes for x in tree_leaves(ring.storage))
    with tempfile.TemporaryDirectory() as work:
        os.makedirs(osp.join(work, "models"))
        t0 = time.perf_counter()
        save_replay_snapshot(ring, args.rows, work)
        write_s = time.perf_counter() - t0
        path = osp.join(work, "models", "replay_latest.h5")
        file_bytes = osp.getsize(path)
        del ring
        fresh = build_replay(replay_cfg, dict(seed=1), device="cpu")
        t0 = time.perf_counter()
        fresh.load_hdf5(path)
        read_s = time.perf_counter() - t0
    scale = target / args.rows
    print(json.dumps({
        "device": "cpu", "rows": args.rows, "bytes_per_transition": row_bytes, "file_bytes": file_bytes,
        "write_s": write_s, "write_mb_per_s": row_bytes * args.rows / write_s / 1e6,
        "restore_s": read_s, "restore_mb_per_s": row_bytes * args.rows / read_s / 1e6,
        f"write_s_scaled_to_{target}": write_s * scale, f"restore_s_scaled_to_{target}": read_s * scale,
        "collective_timeout_s": COLLECTIVE_TIMEOUT.total_seconds(),
        "peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
