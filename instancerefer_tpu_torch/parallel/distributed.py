"""Data parallelism over processes with ``torch.distributed``, the port's
counterpart of ``instancerefer_tpu/parallel/mesh.py``.

One process a card ("rank"), each with a replica of the model, the same
weights and its own local batch: a disjoint 1-in-``world`` slice of one
global permutation (``host_shard_indices``, ``data/dataset.PaddedLoader``).
What JAX gets from one global array, the port gets from sums across ranks:

* every masked BatchNorm takes its statistics over the global batch
  (``models/basic_blocks.MaskedBatchNorm``: one ``all_reduce_sum`` of
  [sum x, sum x^2, n] a layer, differentiable, so dX is that of one BN over
  the union of the rows);
* every loss and metric mean divides by the global valid count
  (``train/losses.py``, ``train/evaluate.py``); the loss is the global
  loss on every rank, and the backward of its all-reduce sums the ranks'
  gradients, so each rank's gradient is ``world`` times its share and
  ``DistributedDataParallel``'s average gives the gradient of the
  global-batch mean, as JAX's ``jax.grad`` of one global loss does;
* the parameters stay equal on every rank (DDP), and so do the running
  statistics (they come from global sums: ``broadcast_buffers=False``).

The JAX package builds one global array out of per-host pieces, which needs
``shard_batch`` and ``globalize_batch_indices`` (rebasing each host's row
indices to global rows), the ``shard_map`` wrappers of the banded kernels
and ``host_local`` (fetching a host's rows of a global array).  Under DDP
each rank keeps its own local batch and its row indices stay local, so
none of them is ported.

Only ``all_reduce`` and ``broadcast`` (DDP's) run on CUDA tensors: they
are the collectives that gloo supports there, so two ranks can share one
card over gloo (NCCL refuses two ranks on one device).  With no process
group, or at world size 1, every collective here is skipped and a train
step runs exactly the single-process code.

    torchrun --nproc_per_node N -m instancerefer_tpu_torch.scripts.train --config ...
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def host_shard_indices(num_samples: int, process_index: int, process_count: int) -> np.ndarray:
    """The positions of a global permutation that rank ``process_index``
    loads (``parallel/mesh.host_shard_indices``)."""
    return np.arange(process_index, num_samples, process_count)


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def is_main() -> bool:
    return rank() == 0


def init_from_env(device, *, backend: Optional[str] = None,
                  init_method: Optional[str] = None) -> torch.device:
    """Join the process group that ``torchrun``'s environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, and ``MASTER_ADDR``/
    ``MASTER_PORT`` for the default ``env://`` rendezvous); returns the
    rank's device.  Without ``WORLD_SIZE`` it does nothing and returns
    ``device``.  A CUDA rank takes ``cuda:LOCAL_RANK`` and raises when that
    card does not exist.  ``backend`` defaults to nccl on CUDA, gloo on the
    CPU; ``init_method`` (e.g. a ``file://`` store) replaces ``env://``.  An
    existing group is kept.  The caller that created the group ends it
    (``shutdown``)."""
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return device
    world, rank_ = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank_))
        if not 0 <= local < torch.cuda.device_count():
            raise RuntimeError(f"rank {rank_}: LOCAL_RANK {local} names no card "
                               f"({torch.cuda.device_count()} visible)")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if not active():
        dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                                init_method=init_method or "env://", rank=rank_,
                                world_size=world)
    return device


def shutdown() -> None:
    if active():
        dist.destroy_process_group()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, differentiable (the gradient of each
    rank's input is the sum of the ranks' output gradients); ``t`` itself
    at world size 1."""
    if world_size() == 1:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t)


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``t`` over the ranks, not differentiable."""
    if world_size() == 1:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t
