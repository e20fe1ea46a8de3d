"""The port runs where there is no jax, flax or yaml (an eval forward and
one train step), and ``chip_smoke.py`` refuses to run without a GPU.

The GPU machine has PyTorch but none of jax, flax or yaml, so the port —
host bridge included — must not import them, even indirectly.
"""

import ast
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "instancerefer_tpu_torch")
BANNED = {"jax", "flax", "yaml"}

SLICE_WITHOUT_JAX = """
import sys
sys.modules["jax"] = sys.modules["flax"] = sys.modules["yaml"] = None
import numpy as np
import torch
from instancerefer_tpu_torch.data.host import TEST_SPEC, batch_to_torch, make_batch
from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
from instancerefer_tpu_torch.train.evaluate import get_eval
from instancerefer_tpu_torch.train.losses import get_loss
from instancerefer_tpu_torch.train.solver import make_optimizer, train_step

dd = batch_to_torch(make_batch(2, TEST_SPEC, seed=0), TEST_SPEC, "cpu")
model = InstanceRefer(TEST_SPEC.feat_dim, TEST_SPEC.num_classes, TEST_SPEC.max_candidates,
                      generator=torch.Generator().manual_seed(0)).eval()
ms = torch.tensor(np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]]),
                  dtype=torch.float32)
with torch.no_grad():
    out = get_eval(get_loss(model(dd), ms))
assert torch.isfinite(out["loss"]) and out["lang_scores"].shape == (2, 18)
metrics, _ = train_step(model, make_optimizer(model.parameters(), 1e-3, 1e-5), dd, ms)
assert torch.isfinite(metrics["loss"]) and model.training
assert all(torch.isfinite(p.grad).all() for p in model.parameters() if p.grad is not None)
assert not any(m in sys.modules and sys.modules[m] is not None for m in ("jax", "flax", "yaml"))
print("ok")
"""


def test_slice_runs_without_jax_flax_yaml():
    res = subprocess.run([sys.executable, "-c", SLICE_WITHOUT_JAX], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"


def test_no_module_imports_jax_flax_or_yaml():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PACKAGE):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                roots = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not roots & BANNED, f"{path}:{node.lineno} imports {roots & BANNED}"


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """Here there is no CUDA device: nonzero exit and no ``ok`` line, from the
    repo and from a directory that holds the script alone."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), lone)
    for cwd in (ROOT, str(tmp_path)):
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
