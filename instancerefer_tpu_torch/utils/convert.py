"""Weights in the reference's layout, and ENet's weights carried from the JAX package.

Every file the port writes or reads holds a state_dict in the reference's
layout: the names and tensor layouts of the reference's torch model, which is
also what the JAX package's exporter writes
(``instancerefer_tpu/utils/convert_torch.export_state_dict``; the tests
carry JAX weights into the port through it and ``from_reference``).  The
port's sparse-conv kernels (``*.net.*.kernel``, [K, Cin, Cout]) are indexed
in the host maps' offset order (``ops/voxelize.KERNEL_OFFSETS_3/2``), the
reference's in torchsparse's; ``_PERM3``/``_PERM2`` map one onto the other,
found by matching offset vectors.  Both orders are x-fastest today, so the
permutations are the identity and a bare ``load_state_dict`` of a reference
file happens to be right; a change to either order would make it load
without complaint and convolve wrongly.  So every file goes through the
permutation:

* ``to_reference_state_dict(model)`` writes the kernels in torchsparse's
  order (the permutations inverted);
* ``load_reference_state_dict(model, sd)`` permutes them back and loads.

ENet (``models/enet.py``) keeps the reference's module tree, so its
published weights (``scannetv2_enet.pth``) need no conversion:
``load_enet`` is a strict ``load_state_dict``.  ``enet_state_dict_from_jax``
turns the JAX ``Enet``'s variables (the tree that
``scripts/convert_enet.convert_state_dict`` writes) back into that state
dict.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from instancerefer_tpu_torch.models.enet import BOTTLENECK_PLAN, FIRST_BOTTLENECK_INDEX, Enet
from instancerefer_tpu_torch.ops.voxelize import KERNEL_OFFSETS_2, KERNEL_OFFSETS_3


def torchsparse_offsets(kernel_size: int) -> np.ndarray:
    """torchsparse-1.2 kernel offset enumeration (``kernel_region.py``):
    per-axis offsets ``-ks//2+1 .. ks//2`` for odd ks, ``0 .. ks-1`` for even
    ks, composed x-fastest."""
    if kernel_size % 2:
        axis = np.arange(-(kernel_size // 2), kernel_size // 2 + 1)
    else:
        axis = np.arange(0, kernel_size)
    return np.array([[x, y, z] for z in axis for y in axis for x in axis], np.int32)


def _offset_permutation(ks: int, ours: np.ndarray) -> np.ndarray:
    """perm with ours[k] == torchsparse_offsets(ks)[perm[k]]."""
    index = {tuple(o): i for i, o in enumerate(torchsparse_offsets(ks))}
    perm = np.array([index[tuple(o)] for o in ours], np.int64)
    if len(set(perm.tolist())) != len(perm):
        raise AssertionError("offset permutation is not a bijection")
    return perm


_PERM3 = _offset_permutation(3, KERNEL_OFFSETS_3)
_PERM2 = _offset_permutation(2, KERNEL_OFFSETS_2)

def is_sparse_kernel(key: str) -> bool:
    """A sparse-conv kernel of an encoder (the BEV kernel is not one)."""
    return key.endswith(".kernel") and ".net." in key


def _perm(value) -> np.ndarray:
    """Reference (torchsparse) offset index of each host-map offset."""
    return _PERM3 if value.shape[0] == 27 else _PERM2


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
    """Load a reference-layout state_dict (from ``torch.load`` of a ``.pth``)
    into the port's ``model``."""
    return model.load_state_dict(from_reference(sd))


def enet_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``Enet``'s ``{"params", "batch_stats"}`` (numpy trees) ->
    the reference's ENet state_dict, which ``models/enet.Enet`` loads
    strictly: the inverse of ``scripts/convert_enet.convert_state_dict``
    (conv HWIO -> OIHW; BatchNorm scale/bias and mean/var -> weight/bias
    and running statistics; PReLU alpha -> weight)."""
    enc = variables["params"]["encoder"]
    stats = variables["batch_stats"]["encoder"]
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.ascontiguousarray(np.asarray(value, np.float32)))

    def conv(key, p):
        put(f"{key}.weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in p:
            put(f"{key}.bias", p["bias"])

    def bn(key, p, s):
        for name, value in (("weight", p["scale"]), ("bias", p["bias"]),
                            ("running_mean", s["mean"]), ("running_var", s["var"])):
            put(f"{key}.{name}", value)
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0)

    def prelu(key, p):
        put(f"{key}.weight", p["alpha"])

    conv("0.0", enc["initial"]["conv"])
    bn("2", enc["initial"]["bn"], stats["initial"]["bn"])
    prelu("3", enc["initial"]["prelu"])
    for j, (name, kw) in enumerate(BOTTLENECK_PLAN):
        idx = FIRST_BOTTLENECK_INDEX + j
        ext, p, s = f"{idx}.0.0", enc[name], stats[name]
        conv(f"{ext}.0", p["conv_reduce"])
        bn(f"{ext}.1", p["bn_reduce"], s["bn_reduce"])
        prelu(f"{ext}.2", p["prelu_reduce"])
        if kw.get("asymmetric"):
            conv(f"{ext}.3", p["conv_mid_a"])
            conv(f"{ext}.4", p["conv_mid_b"])
            mid = 5
        else:
            conv(f"{ext}.3", p["conv_mid"])
            mid = 4
        bn(f"{ext}.{mid}", p["bn_mid"], s["bn_mid"])
        prelu(f"{ext}.{mid + 1}", p["prelu_mid"])
        conv(f"{ext}.{mid + 2}", p["conv_expand"])
        bn(f"{ext}.{mid + 3}", p["bn_expand"], s["bn_expand"])
        prelu(f"{idx}.2", p["prelu_out"])
    conv(f"{FIRST_BOTTLENECK_INDEX + len(BOTTLENECK_PLAN)}.0",
         variables["params"]["classifier"]["conv"])
    return sd


def load_enet(path: str) -> Enet:
    """An ``Enet`` with the weights of the reference state_dict at ``path``
    (``scannetv2_enet.pth``), loaded strictly; eval mode, on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = Enet()
    model.load_state_dict(sd.state_dict() if hasattr(sd, "state_dict") else sd)
    return model.eval()
