"""Every cell end to end on the card: ``run.py`` as the driver starts it, a
short window, ``correct`` true and the cell's metrics printed.  Skips
without a card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import spec


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_cell_runs_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, os.path.join("benchmark", "run.py"), "--workload",
                          workload, "--seed", "424242", "--seconds", "5", "--trace", "0"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    want = {m["name"] for m in spec.cell_metrics(spec.load_benchmark(), workload, "end_to_end")}
    assert set(line["metrics"]) <= want and "setup_s" in line["metrics"]
