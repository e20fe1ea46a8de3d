"""Host -> card: the padded numpy batch as tensors.

``batch_to_torch`` is the counterpart of the JAX package's
``data/pipeline.batch_to_device_dict``: the ``collate`` output of the port's
host pipeline (``data/pipeline.py``, ``data/synthetic.py``,
``ops/voxelize.py``) becomes the dict of tensors the port's model consumes.
The inverse down maps (``uprow``/``upk``) become each stage's ``up8``, the
map the down conv's dX gathers over.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from instancerefer_tpu_torch.data.pipeline import BatchSpec
from instancerefer_tpu_torch.ops import voxelize

# the voxel pyramid's keys, read into ``SparseStage``s (``uprow``/``upk``
# into ``up8``) rather than kept as dense tensors
_PYRAMID_STEMS = ("coords", "owner", "nbr3", "down", "uprow", "upk")


@dataclasses.dataclass
class SparseStage:
    """One resolution level of a batched sparse voxel tensor.

    Counterpart of ``instancerefer_tpu/ops/sparse.py:SparseStage`` without the
    TPU band fields.  Rows of sample ``b`` occupy the block ``[b*cap, (b+1)*cap)``.

    Attributes:
      coords: [V, 3] int32 voxel coords in base-voxel units.
      owner:  [V] int64 owner id (scene: batch index; instance: flat
        candidate id ``b * max_candidates + c``), -1 on padding rows.
      mask:   [V] bool, ``owner >= 0``.
      nbr3:   [V, 27] int32 same-stage 3^3 neighbour rows, -1 = empty.
      down:   [V, 8] int32 previous-stage 2^3 rows, -1 = empty; [V, 0] on
        stage 0.
      up8:    [V_prev, 8] int32 inverse of ``down``: ``up8[u, k]`` is the row
        of this stage that previous-stage row u feeds at offset k, -1 = none
        (``ops/voxelize.build_up8``); [V, 0] on stage 0.  The down conv's dX
        gathers over it.
      stride: tensor stride of the stage (1, 2, 4, 8, 16).
    """

    coords: torch.Tensor
    owner: torch.Tensor
    mask: torch.Tensor
    nbr3: torch.Tensor
    down: torch.Tensor
    up8: torch.Tensor
    stride: int


STAGE_FIELDS = ("coords", "owner", "mask", "nbr3", "down", "up8")  # a SparseStage's tensors


def _named_tensors(dd: Dict) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every tensor of a data dict, the pyramids' stages
    field by field (``"scene_pyramid[0].nbr3"``)."""
    for k, v in dd.items():
        if isinstance(v, torch.Tensor):
            yield k, v
        elif isinstance(v, tuple) and v and isinstance(v[0], SparseStage):
            for i, stage in enumerate(v):
                for f in STAGE_FIELDS:
                    yield f"{k}[{i}].{f}", getattr(stage, f)


def clone_data(dd: Dict) -> Dict:
    """A data dict whose tensors are copies of ``dd``'s."""
    def clone(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, tuple) and v and isinstance(v[0], SparseStage):
            return tuple(dataclasses.replace(s, **{f: getattr(s, f).clone() for f in STAGE_FIELDS})
                         for s in v)
        return v
    return {k: clone(v) for k, v in dd.items()}


def copy_data(src: Dict, dst: Dict) -> Dict:
    """Write data dict ``src`` into ``dst``'s tensors, which must have the
    same names, shapes and types; returns ``dst``."""
    want = dict(_named_tensors(dst))
    got = dict(_named_tensors(src))
    if got.keys() != want.keys():
        raise ValueError(f"the batch's tensors {sorted(got)} are not {sorted(want)}")
    for name, t in got.items():
        d = want[name]
        if d.shape != t.shape or d.dtype != t.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, where {tuple(d.shape)} "
                             f"{d.dtype} is wanted")
        d.copy_(t)
    return dst


def _dense(value: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(value)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    elif a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _check_map(name: str, nbr: np.ndarray, v_in: int) -> None:
    if nbr.size and int(nbr.max()) >= v_in:
        raise ValueError(
            f"{name} holds row {int(nbr.max())} but its input stage has {v_in} rows"
        )


def _pyramid(batch, prefix: str, num_stages: int, device) -> Tuple[SparseStage, ...]:
    stages = []
    v_prev = 0
    for s in range(num_stages):
        nbr3 = np.ascontiguousarray(batch[f"{prefix}_nbr3_{s}"], np.int32)
        v = nbr3.shape[0]
        _check_map(f"{prefix}_nbr3_{s}", nbr3, v)
        if s > 0:
            down = np.ascontiguousarray(batch[f"{prefix}_down_{s}"], np.int32)
            _check_map(f"{prefix}_down_{s}", down, v_prev)
            up8 = voxelize.build_up8(batch[f"{prefix}_uprow_{s}"], batch[f"{prefix}_upk_{s}"])
            _check_map(f"{prefix}_up8_{s}", up8, v)
        else:
            down = up8 = np.zeros((v, 0), np.int32)
        owner = torch.from_numpy(batch[f"{prefix}_owner_{s}"].astype(np.int64))
        stages.append(
            SparseStage(
                coords=torch.from_numpy(
                    np.ascontiguousarray(batch[f"{prefix}_coords_{s}"], np.int32)
                ).to(device),
                owner=owner.to(device),
                mask=(owner >= 0).to(device),
                nbr3=torch.from_numpy(nbr3).to(device),
                down=torch.from_numpy(down).to(device),
                up8=torch.from_numpy(up8).to(device),
                stride=1 << s,
            )
        )
        v_prev = v
    return tuple(stages)


def batch_to_torch(batch: Dict[str, np.ndarray], spec: BatchSpec, device,
                   out: Optional[Dict] = None) -> Dict:
    """Flat numpy batch (``collate`` output) -> the data dict of tensors.

    Dense keys keep their names: integer arrays become int64, floats f32,
    bools stay bool.  ``scene_pyramid`` / ``inst_pyramid`` are tuples of
    ``SparseStage``.  Raises ``ValueError`` if a neighbour map points past
    its input stage, since the kernel trusts its indices.  ``out``: a data
    dict of the same keys, shapes and types (a captured step's static
    inputs) that the batch is written into (``copy_data``) and returned.
    """
    if out is not None:
        return copy_data(batch_to_torch(batch, spec, "cpu"), out)
    drop = tuple(f"{p}_{s}" for p in ("scene", "inst") for s in _PYRAMID_STEMS)
    dd = {
        k: _dense(v, device)
        for k, v in batch.items()
        if not k.startswith(drop) and np.ndim(v) > 0
    }
    dd["scene_pyramid"] = _pyramid(batch, "scene", spec.num_stages, device)
    dd["inst_pyramid"] = _pyramid(batch, "inst", spec.num_stages, device)
    return dd
