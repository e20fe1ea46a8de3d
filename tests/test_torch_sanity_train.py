"""The port's overfit check (``instancerefer_tpu_torch/scripts/sanity_train.py``)
for 3 steps on the CPU: its batches are the JAX package's
``scripts/sanity_train.py`` batches (largest-instance rule), and it reports
each step's ``ref_acc`` and loss and its verdict.  The check itself (60 steps,
late ``ref_acc`` >= 0.6) runs on the card, in ``chip_smoke.py``."""

import numpy as np
import pytest

from instancerefer_tpu.data import synthetic as jsynthetic
from instancerefer_tpu_torch.data import synthetic
from instancerefer_tpu_torch.scripts import sanity_train

from test_torch_host_pipeline import assert_same_batch, jax_spec


def test_three_steps_on_the_cpu(capsys):
    res = sanity_train.run(3, 2, "cpu")
    assert len(res["ref_acc"]) == len(res["loss"]) == 3
    assert all(np.isfinite(res["loss"])) and all(0.0 <= a <= 1.0 for a in res["ref_acc"])
    assert (res["early"], res["late"]) == (res["ref_acc"][0], res["ref_acc"][-1])
    assert res["passed"] == (res["late"] >= 0.6 and res["loss"][-1] < res["loss"][0])
    assert "step    2" in capsys.readouterr().out


def test_main_reports_its_verdict(capsys):
    rc = sanity_train.main(["3", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc in (0, 1) and "ref_acc early" in out
    assert ("SANITY PASS" in out) == (rc == 0)


def test_batches_are_the_jax_checks(monkeypatch):
    """The spec and scenes of the JAX package's check, in raster order."""
    seen = []
    real = synthetic.make_batch
    monkeypatch.setattr(synthetic, "make_batch",
                        lambda *a, **k: seen.append((a, k)) or real(*a, **k))
    sanity_train.run(1, 2, "cpu")
    (args, kw), *_ = seen
    assert kw["target_rule"] == "largest" and kw["num_points"] == 8000
    spec = args[1]
    assert (spec.max_tokens, spec.max_instances, spec.max_candidates) == (24, 16, 4)
    want = jsynthetic.make_batch(*args[:1], jax_spec(spec), **kw)
    assert_same_batch(real(*args, **kw), want)


def test_needs_a_card_unless_told_cpu():
    with pytest.raises(SystemExit, match="--device cpu"):
        sanity_train.main(["3", "2"])
