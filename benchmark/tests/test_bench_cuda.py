"""On the card: each cell runs through the command, comes out correct,
reports what BENCHMARK.json promises, and its traced run's shares stay
under 100%."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import spec

BENCH = spec.benchmark()


def _run(workload, seed, trace):
    out = subprocess.run(
        [sys.executable, os.path.join(spec.ROOT, "run.py"), "--workload",
         workload, "--seed", str(seed), "--seconds", "2", "--trace",
         str(trace)], capture_output=True, text=True, timeout=1200,
        cwd=spec.CHECKOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(card, workload):
    cell = spec.Cell(workload, BENCH)
    plain = _run(workload, 2 ** 31 + 101, 0)
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {m["name"] for m in cell.end_to_end}
    traced = _run(workload, 2 ** 31 + 103, 1)
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
    for name, m in traced["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, (name, m)
