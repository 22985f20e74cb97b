"""What the harness and the reference load: never JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference nothing of the program."""

import json
import os
import subprocess
import sys

from benchmark.harness import spec

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(imports):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=spec.CHECKOUT,
                                            imports=imports)],
        capture_output=True, text=True, timeout=300, check=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_jax_and_no_program():
    mods = _top_level(
        "import benchmark.reference.models, benchmark.reference.vit, "
        "benchmark.reference.voxel, benchmark.harness.check, "
        "benchmark.harness.counts, benchmark.traffic.generator")
    assert not mods & {"jax", "jaxlib", "flax", "tpu3dssf",
                       "tpu3dssf_torch"}


def test_harness_with_the_program_loads_no_jax():
    mods = _top_level(
        "import benchmark.run, benchmark.harness.cells, "
        "benchmark.harness.trace, benchmark.harness.readers\n"
        "from tpu3dssf_torch.cli import common\n"
        "import tpu3dssf_torch.train.loop, tpu3dssf_torch.train.graph")
    assert "tpu3dssf_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "tpu3dssf"}


def test_run_refuses_without_a_card(tmp_path):
    """A measuring run on a machine with no card exits non-zero and
    prints no result: it never falls back to the CPU."""
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("this machine has a card")
    name = spec.benchmark()["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, os.path.join(spec.ROOT, "run.py"), "--workload",
         name, "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300,
        cwd=spec.CHECKOUT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits non-zero and prints no result."""
    import shutil
    shutil.copy(os.path.join(spec.CHECKOUT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    name = spec.benchmark()["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "5", "--seconds", "1", "--trace", "0"], capture_output=True,
        text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
