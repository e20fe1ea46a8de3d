"""The train-step A/B script: its run order, and its refusal without a card."""

import os
import subprocess
import sys

from instancerefer_tpu_torch.scripts import step_ab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_rounds_alternate_the_roots():
    assert step_ab._order(["p", "c"], 2) == ["p", "c", "c", "p", "p", "c", "c", "p"]
    assert step_ab._order(["p", "x", "c"], 1) == ["p", "x", "c", "c", "x", "p"]


def test_a_run_needs_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, step_ab.__file__, "--child", "--steps", "1"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert step_ab.PREFIX not in proc.stdout
