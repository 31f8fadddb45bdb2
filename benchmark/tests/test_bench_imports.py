"""What the harness loads, and what it needs.

Every module loaded by a run of ``benchmark/run.py`` is walked: none may
have ``jax``, ``jaxlib``, ``flax``, ``optax`` or ``pointcloud_rl_tpu`` as
its top-level name (the part before the first dot, compared whole: the
port's name begins with the JAX package's).  A directory that holds only
``BENCHMARK.json`` and the benchmark's files gives no result."""

import os
import shutil
import subprocess
import sys

import tiny

BLOCKED = {"jax", "jaxlib", "flax", "optax", "pointcloud_rl_tpu"}


def test_a_run_loads_no_jax():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {os.path.join(tiny.BENCH, 'tests')!r})\n"
        "import tiny\n"
        "from pcbench import harness\n"
        "for wl in ('drq_walker_pn.updates', 'drq_walker_pn.loop'):\n"
        "    rc = harness.main(['--workload', wl, '--seed', '5', '--seconds', '0.3', '--trace', '0'], device='cpu',\n"
        "                      tweak=tiny.tweak(wl.split('.')[0]))\n"
        "    assert rc == 0, rc\n"
        "print('MODULES ' + json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=tiny.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("MODULES ")][-1]
    tops = set(__import__("json").loads(line[len("MODULES "):]))
    assert "pointcloud_rl_torch" in tops and "pcbench" in tops
    assert not (tops & BLOCKED), tops & BLOCKED


def test_the_prefix_is_compared_whole():
    assert "pointcloud_rl_torch".split(".")[0] not in BLOCKED
    assert "pointcloud_rl_tpu.ops".split(".")[0] in BLOCKED


def test_a_bare_directory_gives_no_result(tmp_path):
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(tiny.BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, 'benchmark'); from pcbench import harness; "
            "sys.exit(harness.main(['--workload', 'drq_walker_pn.updates', '--seed', '1', '--seconds', '1', "
            "'--trace', '0'], device='cpu'))")
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=tmp_path,
                          env=env)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
