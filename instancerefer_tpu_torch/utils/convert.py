"""Weights in the reference's layout, and weights carried from the JAX package.

Every file the port writes or reads holds a state_dict in the reference's
layout: the names and tensor layouts of the reference's torch model, which is
also what the JAX package's exporter writes
(``instancerefer_tpu/utils/convert_torch.export_state_dict``).  The port's
sparse-conv kernels (``*.net.*.kernel``, [K, Cin, Cout]) are indexed in the
host maps' offset order (``ops/voxelize.KERNEL_OFFSETS_3/2``), the reference's
in torchsparse's; the exporter maps one onto the other with
``_PERM3``/``_PERM2``, found by matching offset vectors.  Both orders are
x-fastest today, so the permutations are the identity and a bare
``load_state_dict`` of a reference file happens to be right; a change to
either order would make it load without complaint and convolve wrongly.  So
every file goes through the permutation:

* ``to_reference_state_dict(model)`` writes the kernels in torchsparse's
  order (the permutations inverted);
* ``load_reference_state_dict(model, sd)`` permutes them back and loads;
* ``state_dict_from_jax(params, batch_stats)`` is ``export_state_dict``
  followed by the load-side permutation.

JAX gradients (and Adam's moments) have the tree of the params, so
``state_dict_from_jax(grads, batch_stats)`` names them as the port's
parameters, with the same layout changes and kernel permutation; the tests
hold the port's gradients and trajectories against JAX's that way.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

import instancerefer_tpu_torch.data.host  # noqa: F401  (installs the bridge)
from instancerefer_tpu.utils import convert_torch


def is_sparse_kernel(key: str) -> bool:
    """A sparse-conv kernel of an encoder (the BEV kernel is not one)."""
    return key.endswith(".kernel") and ".net." in key


def _perm(value) -> np.ndarray:
    """Reference (torchsparse) offset index of each host-map offset."""
    return convert_torch._PERM3 if value.shape[0] == 27 else convert_torch._PERM2


def from_reference(sd: Mapping) -> Dict[str, torch.Tensor]:
    """Reference-layout state_dict (tensors or numpy) -> the port's layout."""
    out = {}
    for key, value in sd.items():
        value = value.detach().cpu() if torch.is_tensor(value) else torch.from_numpy(np.array(value))
        if is_sparse_kernel(key):
            value = value[torch.from_numpy(_perm(value))]
        out[key] = value.clone()  # a writable copy, never a view of the input
    return out


def to_reference(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's layout -> the reference's, on the CPU."""
    out = {}
    for key, value in sd.items():
        value = value.detach().cpu()
        if is_sparse_kernel(key):
            value = value[torch.from_numpy(np.argsort(_perm(value)))]
        out[key] = value.clone()
    return out


def to_reference_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` in the reference's layout (CPU tensors)."""
    return to_reference(model.state_dict())


def load_reference_state_dict(model: torch.nn.Module, sd: Mapping):
    """Load a reference-layout state_dict (from ``torch.load`` of a ``.pth``,
    or ``export_state_dict``) into the port's ``model``."""
    return model.load_state_dict(from_reference(sd))


def state_dict_from_jax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """flax ``(params, batch_stats)`` as numpy trees -> port state_dict."""
    return from_reference(convert_torch.export_state_dict(params, batch_stats))
