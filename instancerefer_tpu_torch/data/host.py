"""Host -> card: the padded numpy batch as tensors.

``batch_to_torch`` is the counterpart of the JAX package's
``data/pipeline.batch_to_device_dict``: the ``collate`` output of the port's
host pipeline (``data/pipeline.py``, ``data/synthetic.py``,
``ops/voxelize.py``) becomes the dict of tensors the port's model consumes.
The inverse down maps (``uprow``/``upk``) become each stage's ``up8``, the
map the down conv's dX gathers over.

The same conversion in two halves, for a copy that overlaps the step
(``data/prefetch.DevicePrefetcher``):

* ``stage`` (host): the map bound checks, then each array ``finish`` reads
  into a host tensor in the dtype ``collate`` gave it (int32 stays int32;
  ``uprow``/``upk`` go over as they are), page-locked buffers of a
  ``Buffers`` set when one is given.
* ``finish`` (the staged tensors' device: on a card, the consumer's
  stream): the widening to int64, ``mask = owner >= 0`` and ``up8`` by a
  scatter of static shape, into new tensors or straight into a captured
  step's static inputs.

``finish(stage(b))`` equals ``batch_to_torch(b)`` bit for bit; the latter
does the whole conversion on the host with numpy and is the reference the
tests hold the two halves against.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from instancerefer_tpu_torch.data.pipeline import BatchSpec
from instancerefer_tpu_torch.ops import voxelize
from instancerefer_tpu_torch.utils.profiling import span

# the voxel pyramid's keys, read into ``SparseStage``s (``uprow``/``upk``
# into ``up8``) rather than kept as dense tensors
_PYRAMID_STEMS = ("coords", "owner", "nbr3", "down", "uprow", "upk")
_PYRAMID_KEYS = tuple(f"{p}_{s}" for p in ("scene", "inst") for s in _PYRAMID_STEMS)
UP8_OFFSETS = 8  # the 2^3 offsets of a down map: up8's columns


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
    dd = {
        k: _dense(v, device)
        for k, v in batch.items()
        if not k.startswith(_PYRAMID_KEYS) and np.ndim(v) > 0
    }
    dd["scene_pyramid"] = _pyramid(batch, "scene", spec.num_stages, device)
    dd["inst_pyramid"] = _pyramid(batch, "inst", spec.num_stages, device)
    return dd


class Buffers:
    """Tensors kept for reuse, one per (name, shape, dtype): a staging set.
    ``get`` returns the tensor of that key, made on first use on ``device``
    (page-locked if ``pin``; ``made`` is called on each new one), so a set
    that sees two language grids holds both grids' ``lang_feat`` and one of
    every other array."""

    def __init__(self, device="cpu", pin: bool = False,
                 made: Optional[Callable[[torch.Tensor], None]] = None):
        self.device = torch.device(device)
        self.pin = pin
        self.made = made
        self.tensors: Dict[tuple, torch.Tensor] = {}

    def get(self, name: str, shape, dtype: torch.dtype) -> torch.Tensor:
        key = (name, tuple(shape), dtype)
        t = self.tensors.get(key)
        if t is None:
            t = torch.empty(key[1], dtype=dtype, device=self.device, pin_memory=self.pin)
            if self.made is not None:
                self.made(t)
            self.tensors[key] = t
        return t


def _pyramid_stems(s: int) -> Tuple[str, ...]:
    return ("coords", "owner", "nbr3") + (("down", "uprow", "upk") if s else ())


def _staged_arrays(batch: Dict[str, np.ndarray], spec: BatchSpec) -> Dict[str, np.ndarray]:
    """Every array ``finish`` reads, as ``collate`` made it: the dense keys
    (those of rank >= 1) and each pyramid stage's maps."""
    arrays = {k: np.asarray(v) for k, v in batch.items() if not k.startswith(_PYRAMID_KEYS)}
    arrays = {k: a for k, a in arrays.items() if a.ndim > 0}
    for prefix in ("scene", "inst"):
        for s in range(spec.num_stages):
            for stem in _pyramid_stems(s):
                arrays[f"{prefix}_{stem}_{s}"] = np.asarray(batch[f"{prefix}_{stem}_{s}"])
    return arrays


def _check_maps(arrays: Dict[str, np.ndarray], spec: BatchSpec) -> None:
    """``batch_to_torch``'s bound checks on the staged maps: ``up8``'s rows
    are ``uprow`` where ``upk`` names an offset."""
    for prefix in ("scene", "inst"):
        v_prev = 0
        for s in range(spec.num_stages):
            nbr3 = arrays[f"{prefix}_nbr3_{s}"]
            v = nbr3.shape[0]
            _check_map(f"{prefix}_nbr3_{s}", nbr3, v)
            if s > 0:
                _check_map(f"{prefix}_down_{s}", arrays[f"{prefix}_down_{s}"], v_prev)
                upk = arrays[f"{prefix}_upk_{s}"]
                if upk.size and int(upk.max()) >= UP8_OFFSETS:
                    raise ValueError(f"{prefix}_upk_{s} holds offset {int(upk.max())} of a "
                                     f"{UP8_OFFSETS}-offset down map")
                top = int(np.max(arrays[f"{prefix}_uprow_{s}"], where=upk >= 0, initial=-1))
                if top >= v:
                    raise ValueError(
                        f"{prefix}_up8_{s} holds row {top} but its input stage has {v} rows")
            v_prev = v


def stage(batch: Dict[str, np.ndarray], spec: BatchSpec,
          pinned: Optional[Buffers] = None) -> Dict[str, torch.Tensor]:
    """The host half of ``batch_to_torch``: the map bound checks (a
    ``ValueError`` as there), then {key: host tensor} of every array
    ``finish`` reads, in ``collate``'s dtypes.  Into the buffers of
    ``pinned`` when given (reused; their earlier contents are overwritten),
    else tensors over the batch's own arrays.  A spec with a ``stage`` of
    its own (``data/pointgroup.PGSpec``) stages its batches itself."""
    if hasattr(spec, "stage"):
        return spec.stage(batch, pinned)
    arrays = _staged_arrays(batch, spec)
    _check_maps(arrays, spec)
    if pinned is None:
        return {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in arrays.items()}
    staged = {}
    for k, a in arrays.items():
        t = pinned.get(k, a.shape, torch.from_numpy(np.empty(0, a.dtype)).dtype)
        np.copyto(t.numpy(), a)
        staged[k] = t
    return staged


def _dense_dtype(dtype: torch.dtype) -> torch.dtype:
    """``_dense``'s types: integers int64, floats f32, bools as they are."""
    if dtype == torch.bool:
        return dtype
    return torch.float32 if dtype.is_floating_point else torch.int64


def _up8(uprow: torch.Tensor, upk: torch.Tensor) -> torch.Tensor:
    """``voxelize.build_up8`` on the tensors' device: a scatter of static
    shape into one spare column, which takes the rows with no offset (no
    ``nonzero``, so nothing waits for the device)."""
    up8 = torch.full((uprow.shape[0], UP8_OFFSETS + 1), -1, dtype=torch.int32,
                     device=uprow.device)
    col = upk.masked_fill(upk < 0, UP8_OFFSETS).long()
    up8.scatter_(1, col[:, None], uprow.to(torch.int32)[:, None])
    return up8[:, :UP8_OFFSETS]


def _finish_sources(staged: Dict[str, torch.Tensor], spec: BatchSpec):
    """(name as ``_named_tensors`` gives it, source tensor, wanted dtype) of
    every tensor of the data dict; each source is a staged tensor or made
    from them on their device."""
    out = [(k, t, _dense_dtype(t.dtype)) for k, t in staged.items()
           if not k.startswith(_PYRAMID_KEYS)]
    for prefix in ("scene", "inst"):
        for s in range(spec.num_stages):
            def get(stem):
                return staged[f"{prefix}_{stem}_{s}"]
            nbr3, owner = get("nbr3"), get("owner")
            if s > 0:
                down, up8 = get("down"), _up8(get("uprow"), get("upk"))
            else:
                down = up8 = torch.zeros((nbr3.shape[0], 0), dtype=torch.int32,
                                         device=nbr3.device)
            name = f"{prefix}_pyramid[{s}]."
            out += [(name + "coords", get("coords"), torch.int32),
                    (name + "owner", owner, torch.int64), (name + "mask", owner >= 0, torch.bool),
                    (name + "nbr3", nbr3, torch.int32), (name + "down", down, torch.int32),
                    (name + "up8", up8, torch.int32)]
    return out


def finish(staged: Dict[str, torch.Tensor], spec: BatchSpec, out: Optional[Dict] = None) -> Dict:
    """The device half of ``batch_to_torch``, on the staged tensors' device
    and, on a card, the current stream: the data dict of a ``stage``d batch.
    Into ``out``'s tensors when given (a captured step's static inputs: the
    same names, shapes and types, or it raises), each widened in its
    ``copy_``; else into new tensors, which never alias ``staged`` (a staging
    set is rewritten once ``finish`` has read it).  Its two parts run
    under the spans ``ir.load.sources`` and ``ir.load.copy``.  A spec with
    a ``finish`` of its own (``data/pointgroup.PGSpec``) finishes its
    batches itself."""
    if hasattr(spec, "finish"):
        with span("ir.load.copy"):
            return spec.finish(staged, out)
    with span("ir.load.sources"):
        sources = _finish_sources(staged, spec)
    with span("ir.load.copy"):
        want = dict(_named_tensors(out)) if out is not None else None
        if want is not None and want.keys() != {name for name, _, _ in sources}:
            raise ValueError(f"the batch's tensors {sorted(n for n, _, _ in sources)} are not "
                             f"{sorted(want)}")
        done = {}
        for name, src, dtype in sources:
            if want is None:
                dst = torch.empty(src.shape, dtype=dtype, device=src.device)
            else:
                dst = want[name]
                if dst.shape != src.shape or dst.dtype != dtype:
                    raise ValueError(f"{name}: {tuple(src.shape)} {dtype}, where "
                                     f"{tuple(dst.shape)} {dst.dtype} is wanted")
            done[name] = dst
        # one call for every copy: the feed's threads hold the interpreter
        # lock in turns, and each call into torch gives it up and waits to
        # take it back
        torch._foreach_copy_(list(done.values()), [src for _, src, _ in sources])
    if out is not None:
        return out
    dd = {k: done[k] for k in staged if not k.startswith(_PYRAMID_KEYS)}
    for prefix in ("scene", "inst"):
        dd[f"{prefix}_pyramid"] = tuple(
            SparseStage(**{f: done[f"{prefix}_pyramid[{s}].{f}"] for f in STAGE_FIELDS},
                        stride=1 << s)
            for s in range(spec.num_stages))
    return dd


def stage_to(batch: Dict[str, np.ndarray], spec: BatchSpec, device) -> Dict[str, torch.Tensor]:
    """A ``stage``d batch on ``device``, copied there synchronously: what a
    step's ``load`` takes, without the prefetcher (the eval CLI's loop)."""
    return {k: t.to(device) for k, t in stage(batch, spec).items()}
