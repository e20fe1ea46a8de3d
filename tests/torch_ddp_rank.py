"""One rank of the port's 2-process data-parallel checks on the CPU (gloo),
run by ``tests/test_torch_distributed.py`` and ``tests/test_torch_no_jax.py``
in a process that imports no jax:

    python tests/torch_ddp_rank.py <rank> <world> <workdir>

The ranks meet through a ``file://`` store in ``workdir``.  Each rank:

* ``bn``: a ``MaskedBatchNorm`` in train mode over its own rows of
  ``bn_rows`` (with and without a row mask, and through ``fused`` with
  the mask, the ReLU and a residual), forward and backward of
  ``sum(y * g)``;
* ``full`` and ``partial``: one ``train_step`` of the ``Solver``'s DDP
  model on its ``PaddedLoader`` shard of a 4-sample (and a 3-sample)
  global batch of ``TEST_SPEC`` scenes, from the weights in
  ``workdir/init.pt``, dropout 0, f32;

and writes what it got to ``workdir/<case>_rank<rank>.pt``.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from instancerefer_tpu_torch.data import synthetic  # noqa: E402
from instancerefer_tpu_torch.data.dataset import PaddedLoader  # noqa: E402
from instancerefer_tpu_torch.data.host import batch_to_torch  # noqa: E402
from instancerefer_tpu_torch.models.basic_blocks import MaskedBatchNorm  # noqa: E402
from instancerefer_tpu_torch.models.instancerefer import InstanceRefer  # noqa: E402
from instancerefer_tpu_torch.parallel import distributed  # noqa: E402
from instancerefer_tpu_torch.train.solver import Solver, train_step  # noqa: E402

SPEC = synthetic.TEST_SPEC
MEAN_SIZE = np.linspace(0.3, 2.0, 18)[:, None] * np.array([[1.0, 0.9, 0.8]])
GLOBAL_BATCH = 4
CASES = {"full": 4, "partial": 3}  # samples in the dataset: one global batch
BN_ROWS, BN_C = (37, 20), 8  # rows of rank 0 and 1, channels


def cores(n):
    """The scenes of ``tests/test_torch_train.partial_batch``, ``n`` of them."""
    rng = np.random.default_rng(5)
    return [synthetic.make_core_sample(rng, num_instances=6, num_candidates=3, scan_idx=i,
                                       mean_size_arr=MEAN_SIZE) for i in range(n)]


class Scenes:
    """A dataset of ready ``CoreSample``s."""

    def __init__(self, samples):
        self.samples = samples
        self.static_scene_sampling, self.augment = False, False

    def __len__(self):
        return len(self.samples)

    def get_core(self, idx, rng=None, class_override=None):
        return self.samples[idx]


def bn_rows(rank):
    """Rank ``rank``'s rows, row mask, output gradient and residual of the
    BN check."""
    rng = np.random.default_rng(11)
    x = rng.normal(1.5, 2.0, size=(sum(BN_ROWS), BN_C)).astype(np.float32)
    mask = rng.random(sum(BN_ROWS)) < 0.7
    g = rng.normal(size=x.shape).astype(np.float32)
    res = rng.normal(size=x.shape).astype(np.float32)
    lo = sum(BN_ROWS[:rank])
    rows = slice(lo, lo + BN_ROWS[rank])
    return x[rows], mask[rows], g[rows], res[rows]


def run_bn(rank):
    x, mask, g, res = (torch.from_numpy(a) for a in bn_rows(rank))
    out = {}
    for name, m in (("masked", mask), ("all", None), ("fused", mask)):
        bn = MaskedBatchNorm(BN_C).train()
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
        xi = x.clone().requires_grad_(True)
        ri = res.clone().requires_grad_(True)
        y = bn.fused(xi, m, residual=ri) if name == "fused" else bn(xi, m)
        (y * g).sum().backward()
        out[name] = {"y": y.detach(), "dx": xi.grad, "dweight": bn.weight.grad,
                     "dbias": bn.bias.grad, "running_mean": bn.running_mean,
                     "running_var": bn.running_var, "dres": ri.grad}
    return out


def run_step(rank, world, n, workdir):
    loader = PaddedLoader(Scenes(cores(n)), SPEC, GLOBAL_BATCH // world, shuffle=False,
                          num_workers=0, process_index=rank, process_count=world)
    batch = next(iter(loader))
    model = InstanceRefer(SPEC.feat_dim, SPEC.num_classes, SPEC.max_candidates,
                          dropout_override=0.0)
    model.load_state_dict(torch.load(os.path.join(workdir, "init.pt"), weights_only=True))
    solver = Solver(model, MEAN_SIZE, SPEC, "cpu", output_dir=os.path.join(workdir, "runs"))
    metrics, _ = train_step(solver.train_model, solver.optimizer,
                            batch_to_torch(batch, SPEC, "cpu"), solver.mean_size)
    return {
        "wrapped": solver.train_model is not solver.model,
        "loss": float(metrics["loss"]),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
        "stats": {k: b.clone() for k, b in model.named_buffers() if "running" in k},
        "params": {k: p.detach().clone() for k, p in model.named_parameters()},
        "sample_valid": torch.from_numpy(batch["sample_valid"]),
    }


def main(rank, world, workdir):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    distributed.init_from_env("cpu", init_method="file://" + os.path.join(workdir, "store"))
    try:
        results = {"bn": run_bn(rank)}
        for case, n in CASES.items():
            results[case] = run_step(rank, world, n, workdir)
    finally:
        distributed.shutdown()
    for case, res in results.items():
        torch.save(res, os.path.join(workdir, f"{case}_rank{rank}.pt"))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
