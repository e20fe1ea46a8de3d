"""Overfit check, the port's counterpart of the JAX package's
``scripts/sanity_train.py``: train on learnable synthetic scenes and watch
``ref_acc``.

    python -m instancerefer_tpu_torch.scripts.sanity_train [steps] [batch] [--device cpu]

The synthetic ``largest`` rule makes the referred object the biggest of its
class's candidates, a signal the attribute encoder can learn.  A model that
learns drives the train ``ref_acc`` well above the 1/3 chance level within
~100 steps: 4 batches of ``batch`` scenes (8000 points, 8 instances, 3
candidates) cycled for ``steps`` steps (default 60 and 16), bf16 sparse
convs, Adam at lr 1e-3.  It exits 0 when the mean ``ref_acc`` of the last
sixth of the steps is at least 0.6 and the last loss is below the first.
The card by default; ``--device cpu`` runs the kernels' plain twins.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

N_BATCHES = 4
PASS_ACC = 0.6


def run(steps: int, batch_size: int, device) -> dict:
    """``steps`` train steps; returns the per-step ``ref_acc`` and loss, the
    early and late means of ``ref_acc`` (first and last sixth) and whether
    the check passed."""
    from instancerefer_tpu_torch.data.host import batch_to_torch
    from instancerefer_tpu_torch.data.pipeline import BatchSpec
    from instancerefer_tpu_torch.data.synthetic import make_batch
    from instancerefer_tpu_torch.models.instancerefer import InstanceRefer
    from instancerefer_tpu_torch.ops.precision import set_compute_dtype
    from instancerefer_tpu_torch.train.solver import make_optimizer, train_step

    device = torch.device(device)
    spec = BatchSpec(max_tokens=24, max_instances=16, max_candidates=4,
                     scene_caps=(4096, 2048, 1024, 512, 256),
                     inst_caps=(4096, 2048, 1024, 512, 256))
    mean_size = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])
    print("building synthetic batches (largest-instance rule)...", flush=True)
    batches = [batch_to_torch(make_batch(batch_size, spec, seed=s, num_points=8000,
                                         num_instances=8, num_candidates=3,
                                         mean_size_arr=mean_size, target_rule="largest"),
                              spec, device) for s in range(N_BATCHES)]
    set_compute_dtype("bfloat16")
    try:
        torch.manual_seed(0)
        model = InstanceRefer(spec.feat_dim, spec.num_classes, spec.max_candidates,
                              generator=torch.Generator().manual_seed(0)).to(device)
        opt = make_optimizer(model.parameters(), 1e-3, 1e-5)
        ms = torch.tensor(mean_size, dtype=torch.float32, device=device)
        t0 = time.time()
        accs, losses = [], []
        for step in range(steps):
            metrics, _ = train_step(model, opt, batches[step % N_BATCHES], ms)
            accs.append(float(metrics["ref_acc"]))
            losses.append(float(metrics["loss"]))
            if step % 10 == 0 or step == steps - 1:
                print(f"step {step:4d}  loss {losses[-1]:7.3f}  ref_acc {accs[-1]:.3f}"
                      f"  (elapsed {time.time() - t0:.0f}s)", flush=True)
    finally:
        set_compute_dtype(None)
    k = max(steps // 6, 1)
    early, late = float(np.mean(accs[:k])), float(np.mean(accs[-k:]))
    return {"ref_acc": accs, "loss": losses, "early": early, "late": late,
            "passed": late >= PASS_ACC and losses[-1] < losses[0]}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", type=int, nargs="?", default=60)
    ap.add_argument("batch", type=int, nargs="?", default=16)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default) needs a card; cpu must be asked for")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    res = run(args.steps, args.batch, args.device)
    print(f"\nref_acc early {res['early']:.3f} -> late {res['late']:.3f} (chance ~0.33)")
    if res["passed"]:
        print("SANITY PASS: the model learns the synthetic signal")
        return 0
    print("SANITY WEAK: ref_acc did not clearly improve")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
