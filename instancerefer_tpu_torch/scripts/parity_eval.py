"""Real-data accuracy-parity runbook, the port's counterpart of the JAX
package's ``scripts/parity_eval.sh``:

    python -m instancerefer_tpu_torch.scripts.parity_eval <data_root> <reference.pth> \\
        [config] [out_root] [--device cpu] [--allow_overflow]

* ``<data_root>``: a ScanRefer root (``scannet/pointgroup_data/*.npy``,
  ``glove.p``, ``ScanRefer_filtered_val.json``, ``scannet/meta_data/``).
* ``<reference.pth>``: a reference-layout checkpoint in any of the
  reference's three roles: ``model_last.pth`` or ``model.pth`` (a
  state_dict) or ``checkpoint.tar`` (its ``model_state_dict``); the
  published checkpoint is one of them, and so is every file the port's
  solver writes.
* ``[config]``: default ``config/InstanceRefer.yaml``; ``[out_root]``:
  default ``<data_root>/parity_outputs``.

It loads the weights into the config's model through
``utils/convert.load_reference_state_dict`` (a key or shape that does not
fit fails here), writes them as the run's ``model_last.pth`` under
``<out_root>/ScanRefer/parity/checkpoints/parity_run``, removes a
``scores.npz`` left there by an earlier run, and scores the val split with
the eval CLI, whose capacity-overflow gate stays on unless
``--allow_overflow`` is given (refit the caps with ``scripts/fit_caps``).
It prints the Acc table beside the published Acc@0.25 0.376 and Acc@0.5
0.307 (the reference's README).  ``--device`` is the eval CLI's: ``cuda``
by default.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

PUBLISHED = {"acc@0.25iou": 0.376, "acc@0.5iou": 0.307}


def main(argv: Optional[List[str]] = None) -> dict:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data_root")
    ap.add_argument("reference", help="model_last.pth / model.pth / checkpoint.tar")
    ap.add_argument("config", nargs="?", default=os.path.join(repo, "config", "InstanceRefer.yaml"))
    ap.add_argument("out_root", nargs="?", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--allow_overflow", action="store_true")
    args = ap.parse_args(argv)
    out_root = args.out_root or os.path.join(args.data_root, "parity_outputs")
    run = os.path.join(out_root, "ScanRefer", "parity", "checkpoints", "parity_run")

    from instancerefer_tpu_torch.config import load_config
    from instancerefer_tpu_torch.models.instancerefer import build_model
    from instancerefer_tpu_torch.scripts import eval as eval_cli
    from instancerefer_tpu_torch.utils.convert import (
        load_reference_state_dict,
        to_reference_state_dict,
    )

    os.makedirs(run, exist_ok=True)
    # a score cache of another checkpoint must not stand in for this one
    stale = os.path.join(run, "scores.npz")
    if os.path.exists(stale):
        os.remove(stale)

    blob = torch.load(args.reference, map_location="cpu", weights_only=True)
    is_tar = "model_state_dict" in blob
    model = build_model(load_config(["--config", args.config]))
    load_reference_state_dict(model, blob["model_state_dict"] if is_tar else blob)
    torch.save(to_reference_state_dict(model), os.path.join(run, "model_last.pth"))
    print(f"== {args.reference}" + (f" (checkpoint.tar, epoch {blob.get('epoch')})" if is_tar
                                    else "") + f" -> {run}/model_last.pth")

    print("== evaluating the val split")
    flags = ["--config", args.config, "--log_dir", run, "--data_root", args.data_root,
             "--output_root", out_root, "--device", args.device]
    table = eval_cli.main(flags + (["--allow_overflow"] if args.allow_overflow else []))
    overall = table["overall"]["overall"]
    print("== Acc over the val split: this run vs the reference's published numbers")
    for key, want in PUBLISHED.items():
        print(f"   {key}: {overall[key]:.4f}  published {want:.3f}")
    return table


if __name__ == "__main__":
    main()
