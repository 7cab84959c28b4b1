"""On the card, at the cells' own sizes: every cell runs and is correct,
and the control and each planted fault fail a limit (the readings the
limits were set from come from ``python -m benchmark.control``)."""
import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.common import Ctx
from benchmark.registry import ROOT, Registry

CELLS = [w["name"] for w in Registry().spec["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_on_the_card(workload):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload,
                          "--seed", str(2**31 + 101), "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["attempted"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_and_faults_fail_at_the_cells_size(workload):
    reg = Registry()
    w = reg.workload(workload)
    ctx = Ctx(cfg=reg.config(w["config"]), traffic=reg.traffic(w["traffic"]),
              limits=reg.limits(workload), seed=2**31 + 102, seconds=1.0, trace=False,
              device=torch.device("cuda", 0))
    readings = importlib.import_module(f"benchmark.{ctx.traffic['generator']}").readings(
        ctx, program=False)
    for kind, numbers in readings.items():
        assert any(v > ctx.limits[k] for k, v in numbers.items()), (kind, numbers)
