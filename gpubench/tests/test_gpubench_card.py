"""On the card: one short run of a cell, correct, with every number
compared beside its limit. Skips without a CUDA card."""
import json
import os
import subprocess
import sys

import pytest

from conftest import REPO


@pytest.mark.gpu
def test_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                          "splice.paf", "--seed", "17", "--seconds", "5",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=1200, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("compared ")
