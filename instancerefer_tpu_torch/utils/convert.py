"""Weights carried from the JAX package into the port.

``state_dict_from_jax`` runs the JAX package's numpy exporter
(``instancerefer_tpu/utils/convert_torch.export_state_dict``, reached
through the host bridge) and returns reference-named tensors that the port's
``InstanceRefer`` loads with ``load_state_dict``.  The exporter writes
sparse-conv kernels in torchsparse's offset order; the port keeps the host
maps' order (``ops/voxelize.KERNEL_OFFSETS_3/2``), so each kernel is
re-permuted here, once, with the exporter's own ``_PERM3``/``_PERM2``.

JAX gradients (and Adam's moments) have the tree of the params, so
``state_dict_from_jax(grads, batch_stats)`` names them as the port's
parameters, with the same layout changes and kernel permutation; the tests
hold the port's gradients and trajectories against JAX's that way.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

import instancerefer_tpu_torch.data.host  # noqa: F401  (installs the bridge)
from instancerefer_tpu.utils import convert_torch


def state_dict_from_jax(params, batch_stats) -> Dict[str, torch.Tensor]:
    """flax ``(params, batch_stats)`` as numpy trees -> port state_dict."""
    sd = convert_torch.export_state_dict(params, batch_stats)
    out = {}
    for key, value in sd.items():
        value = np.asarray(value)
        if key.endswith(".kernel") and ".net." in key:
            perm = convert_torch._PERM3 if value.shape[0] == 27 else convert_torch._PERM2
            value = value[perm]
        out[key] = torch.from_numpy(np.array(value))  # a writable copy
    return out
