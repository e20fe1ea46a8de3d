"""Voxels and kernel maps of the plain reference, in torch on any device.

What the reference's sparse convs need (torchsparse's semantics, which
InstanceRefer's encoders run on):

* ``quantize``: integer coordinates floor(xyz / voxel size); one voxel a
  distinct coordinate of a group, taking the features of its first point;
* stage s >= 1 of a pyramid: the coordinates floor(c / 2^s) * 2^s of the
  stage before, one voxel a distinct coordinate of a group;
* a 3^3 submanifold conv at stage s reads the voxel at c + o * 2^s for the
  27 offsets o in {-1, 0, 1}^3, x fastest (offset k = (ox+1) + 3 (oy+1) +
  9 (oz+1)); a 2^3 stride-2 conv into stage s reads the voxels of stage
  s - 1 at c + o * 2^(s-1), o in {0, 1}^3, x fastest.

Groups (a scene, a candidate instance) never see each other's voxels.
Rows are in no particular order: nothing here depends on one.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch

_BITS = 16
_OFF = 1 << (_BITS - 1)
OFFSETS_3 = [(x, y, z) for z in (-1, 0, 1) for y in (-1, 0, 1) for x in (-1, 0, 1)]
OFFSETS_2 = [(x, y, z) for z in (0, 1) for y in (0, 1) for x in (0, 1)]


@dataclasses.dataclass
class Stage:
    """One resolution of a batch of groups: ``coords`` [V, 3] int64 (base
    voxel units), ``group`` [V] int64, ``nbr`` [V, 27] rows of this stage
    (-1 none), ``down`` [V, 8] rows of the stage before (-1 none; stage 0
    has none) and ``up`` [V_prev] the row of this stage that each row of
    the stage before feeds, ``up_k`` its offset."""

    coords: torch.Tensor
    group: torch.Tensor
    stride: int
    nbr: torch.Tensor
    down: torch.Tensor = None
    up: torch.Tensor = None
    up_k: torch.Tensor = None


def _key(coords: torch.Tensor, group: torch.Tensor) -> torch.Tensor:
    c = coords + _OFF
    if c.numel() and (int(c.min()) < 0 or int(c.max()) >= 1 << _BITS):
        raise ValueError("voxel coordinates out of the key's range")
    return (((group << _BITS | c[:, 0]) << _BITS | c[:, 1]) << _BITS) | c[:, 2]


def _unique_first(keys: torch.Tensor):
    """(the distinct keys, sorted; the index of each one's first
    occurrence; each key's position among the distinct)."""
    uniq, inverse = torch.unique(keys, return_inverse=True)
    pos = torch.arange(len(keys), device=keys.device)
    first = torch.full((len(uniq),), len(keys), dtype=torch.long, device=keys.device)
    first = first.scatter_reduce(0, inverse, pos, "amin")
    return uniq, first, inverse


def _lookup(sorted_keys: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """The row of each query key among ``sorted_keys``, -1 where absent."""
    if len(sorted_keys) == 0:
        return torch.full_like(query, -1)
    pos = torch.searchsorted(sorted_keys, query).clamp(max=len(sorted_keys) - 1)
    return torch.where(sorted_keys[pos] == query, pos, -1)


def quantize(xyz: torch.Tensor, feats: torch.Tensor, group: torch.Tensor, voxel_size: float):
    """Points -> (coords, group, feats) of their voxels, sorted by key."""
    coords = torch.floor(xyz / voxel_size).long()
    uniq, first, _ = _unique_first(_key(coords, group))
    return coords[first], group[first], feats[first]


def pyramid(coords: torch.Tensor, group: torch.Tensor, stages: int) -> List[Stage]:
    """The ``stages`` resolutions of quantized voxels (rows sorted by
    key, as ``quantize`` gives them), with their maps."""
    out = []
    for s in range(stages):
        stride = 1 << s
        if s:
            prev = out[-1]
            parent = torch.div(prev.coords, 2 * prev.stride, rounding_mode="floor") * (2 * prev.stride)
            uniq, first, inverse = _unique_first(_key(parent, prev.group))
            coords, group = parent[first], prev.group[first]
            rel = torch.div(prev.coords - parent, prev.stride, rounding_mode="floor")
            up_k = rel[:, 0] + 2 * rel[:, 1] + 4 * rel[:, 2]
            down = torch.full((len(coords), 8), -1, dtype=torch.long, device=coords.device)
            down[inverse, up_k] = torch.arange(len(prev.coords), device=coords.device)
        keys = _key(coords, group)
        nbr = torch.stack([
            _lookup(keys, _key(coords + torch.tensor(o, device=coords.device) * stride, group))
            for o in OFFSETS_3], 1)
        out.append(Stage(coords, group, stride, nbr, *((down, inverse, up_k) if s else ())))
    return out
