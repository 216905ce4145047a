"""On a card: one short run of a cell through the command, whose last
line says the card's name and the metrics.  Skipped without a card (the
check is made inside the test)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from _tiny import ROOT


@pytest.mark.cuda
def test_one_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, str(ROOT / "perfbench/run.py"), "--workload",
                          "unet.train", "--seed", "4000000007", "--seconds", "2",
                          "--trace", "0"], capture_output=True, text=True, timeout=1200,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
    assert line["metrics"]["train_images_per_s"]["value"] > 0
