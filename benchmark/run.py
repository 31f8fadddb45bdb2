"""Run one cell of the benchmark of ``pointcloud_rl_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  Prints one JSON line last: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and ``breakdown`` when traced), then the numbers
that decided ``correct`` beside their limits.  See ``pcbench/harness.py``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pcbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
