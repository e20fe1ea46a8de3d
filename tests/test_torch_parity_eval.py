"""Dry run of the port's parity runbook
(``instancerefer_tpu_torch/scripts/parity_eval.py``) on a fake ScanRefer
root, as ``tests/test_cli_e2e.py::test_parity_eval_runbook`` does for the
JAX package's ``scripts/parity_eval.sh``.

The port's train CLI trains 2 epochs on the CPU and writes the reference's
three checkpoint roles; the runbook takes each of them (``--device cpu
--allow_overflow``: the tiny caps overflow).  It writes the run's
``model_last.pth`` with the role's weights, clears a stale ``scores.npz``,
and prints the Acc table beside the published numbers; from
``model_last.pth`` and ``checkpoint.tar`` (the last epoch's weights both)
the table is the eval CLI's on the training run.  Without
``--allow_overflow`` the eval gate fails the run.
"""

import os

import numpy as np
import pytest
import torch

from instancerefer_tpu_torch.ops import precision
from instancerefer_tpu_torch.scripts import eval as eval_cli
from instancerefer_tpu_torch.scripts import parity_eval
from instancerefer_tpu_torch.scripts import train as train_cli

from fake_scanrefer import make_fake_root
from test_torch_no_jax import TINY

ROLES = ("model_last.pth", "model.pth", "checkpoint.tar")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("fake_sr_parity")
    make_fake_root(root, np.random.default_rng(0))
    (root / "tiny.yaml").write_text(TINY)
    argv = ["--config", str(root / "tiny.yaml"), "--log_dir", "trainrun", "--data_root",
            str(root), "--output_root", str(root / "outputs"), "--device", "cpu"]
    try:
        run = train_cli.main(argv).root
        direct = eval_cli.main(argv + ["--allow_overflow"])
    finally:
        precision.set_compute_dtype(None)
    return root, run, direct


def _runbook(root, reference, out_root, *flags):
    try:
        return parity_eval.main([str(root), reference, str(root / "tiny.yaml"), str(out_root),
                                 "--device", "cpu", *flags])
    finally:
        precision.set_compute_dtype(None)


@pytest.mark.parametrize("role", ROLES)
def test_runbook_dry_run(trained, role, capsys):
    root, run, direct = trained
    out_root = root / f"parity_{role.split('.')[0]}"
    run_dir = out_root / "ScanRefer" / "parity" / "checkpoints" / "parity_run"
    os.makedirs(run_dir)
    np.savez(run_dir / "scores.npz", ref_iou=np.zeros(1))  # another checkpoint's cache
    capsys.readouterr()
    table = _runbook(root, os.path.join(run, role), out_root, "--allow_overflow")
    out = capsys.readouterr().out
    assert "loading cached scores" not in out
    assert "acc@0.25iou" in out and "published 0.376" in out and "published 0.307" in out
    assert len(np.load(run_dir / "scores.npz")["ref_iou"]) == 6
    assert table["overall"]["overall"]["count"] == 6

    blob = torch.load(os.path.join(run, role), weights_only=True)
    want = blob["model_state_dict"] if role == "checkpoint.tar" else blob
    written = torch.load(run_dir / "model_last.pth", weights_only=True)
    assert list(written) == list(want)
    assert all(torch.equal(written[k], want[k]) for k in want)
    if role != "model.pth":  # the last epoch's weights, as the training run's model_last
        assert table == direct


def test_runbook_keeps_the_overflow_gate(trained):
    root, run, _ = trained
    with pytest.raises(SystemExit, match="capacity overflow"):
        _runbook(root, os.path.join(run, "model_last.pth"), root / "parity_gate")
    assert not os.path.exists(
        root / "parity_gate" / "ScanRefer" / "parity" / "checkpoints" / "parity_run" / "scores.npz")
