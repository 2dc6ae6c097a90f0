"""Each cell's full run on the card, a short window: exit 0 and
correct. Run on the card machine with
    python -m pytest -p no:cacheprovider -m cuda portbench/tests
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["keck20.m-d1i"])
def test_cell_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", "2147483661", "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["checks"]["jobs_off_card"] == {"value": 0, "limit": 0}
    assert res["launches_per_job"]["count_tiles"] >= 1
