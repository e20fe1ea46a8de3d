"""PointGroup's host pipeline: ScanNet scenes as the exporter writes them
(``data/prepare.py``: ``{scene}_aligned_vert.npy``, ``_sem_label.npy``,
``_ins_label.npy``) -> padded batches of voxel pyramids for
``models/pointgroup.py``, with the same staging as InstanceRefer's batches
(``stage`` on the host, ``finish`` on the card).

Per scene (PointGroup's ``data/scannetv2_inst.py`` train path, Jiang et
al., CVPR 2020; augmentation off, as ``PGSpec.augment`` is):

* ``scene_arrays``: xyz about its mean (``prepare_data_inst.py``), rgb / 127.5
  - 1, nyu40 ids -> ScanNet's 20 benchmark classes (``SEM_CLASS_IDS``,
  others -100), instance ids (0 = none -> -100);
* ``pad_sample``: xyz * ``scale`` shifted to its minimum, PointGroup's crop
  to ``max_npoint`` points (a room within it is kept whole); voxels of the
  integer coordinates, each taking the mean of its points' [rgb, xyz]
  (``use_coords``; spconv's voxelization mode 4); the voxel pyramid of
  ``num_levels`` levels (``ops/voxelize.build_pyramid_padded``, 3^3
  submanifold and 2^3 stride-2 maps, rows in raster order), each level
  padded to its cap in ``level_caps``; each point's row (``p2v``), its
  instance's centre minus the point (the offset target) and its labels,
  padded to ``point_cap`` points.
* ``collate``: a batch's samples side by side (sample b's rows at [b *
  cap, (b + 1) * cap) of each level, its points at [b * point_cap, ...)).

A batch dict holds ``feats`` [B cap_0, 6] f32, the pyramid's maps as
``pg_{coords,owner,nbr3,down,uprow,upk}_{level}``, ``p2v`` [B P] int32,
``point_mask``, ``sem_label`` (int32, -100 ignored), ``ins_valid``,
``gt_offset`` [B P, 3] and ``level_overflow`` [B, levels] (the share of a
sample's rows each cap cut; ``point_overflow`` the points').  ``PGSpec``
stages and finishes it: ``data/host.stage`` and ``finish`` hand a batch of
a spec that has its own ``stage`` to it, so ``data/prefetch`` and
``train/step_graph`` feed PointGroup as they feed InstanceRefer.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from instancerefer_tpu_torch.ops import voxelize

# ScanNet v2's 20 benchmark classes as nyu40 ids (PointGroup's remapper)
SEM_CLASS_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39)
IGNORE = -100
FEAT_DIM = 6  # rgb and xyz (use_coords)
_REMAP = np.full(256, IGNORE, np.int32)
_REMAP[list(SEM_CLASS_IDS)] = np.arange(len(SEM_CLASS_IDS))


@dataclasses.dataclass(frozen=True)
class PGSpec:
    """A PointGroup batch's fixed shapes and the voxelization's settings."""

    level_caps: Tuple[int, ...]  # rows a sample at each level of the pyramid
    point_cap: int  # points a sample
    scale: float = 50.0  # voxels a metre: 2 cm voxels
    full_scale: Tuple[int, int] = (128, 512)
    max_npoint: int = 250000
    augment: bool = False

    @property
    def num_stages(self) -> int:
        return len(self.level_caps)

    def stage(self, batch: Dict[str, np.ndarray], pinned=None) -> Dict[str, torch.Tensor]:
        """``data/host.stage`` of a PointGroup batch: its arrays as host
        tensors (into ``pinned``'s buffers when given)."""
        arrays = {k: np.asarray(v) for k, v in batch.items() if k not in ("level_overflow",
                                                                           "point_overflow")}
        for s in range(self.num_stages):
            _check_map(arrays, s)
        if pinned is None:
            return {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in arrays.items()}
        staged = {}
        for k, a in arrays.items():
            t = pinned.get(k, a.shape, torch.from_numpy(np.empty(0, a.dtype)).dtype)
            np.copyto(t.numpy(), a)
            staged[k] = t
        return staged

    def finish(self, staged: Dict[str, torch.Tensor], out: Optional[Dict] = None) -> Dict:
        """``data/host.finish`` of a staged PointGroup batch: the data dict
        of ``models/pointgroup.PointGroup`` (``pyramid``: a tuple of
        ``SparseStage``), into ``out``'s tensors when given."""
        from instancerefer_tpu_torch.data.host import (
            STAGE_FIELDS, SparseStage, _named_tensors, _up8,
        )

        sources = [("feats", staged["feats"], torch.float32),
                   ("p2v", staged["p2v"], torch.int64),
                   ("point_mask", staged["point_mask"], torch.bool),
                   ("sem_label", staged["sem_label"], torch.int64),
                   ("ins_valid", staged["ins_valid"], torch.bool),
                   ("gt_offset", staged["gt_offset"], torch.float32)]
        for s in range(self.num_stages):
            def get(stem):
                return staged[f"pg_{stem}_{s}"]
            nbr3, owner = get("nbr3"), get("owner")
            if s > 0:
                down, up8 = get("down"), _up8(get("uprow"), get("upk"))
            else:
                down = up8 = torch.zeros((nbr3.shape[0], 0), dtype=torch.int32,
                                         device=nbr3.device)
            name = f"pyramid[{s}]."
            sources += [(name + "coords", get("coords"), torch.int32),
                        (name + "owner", owner, torch.int64),
                        (name + "mask", owner >= 0, torch.bool),
                        (name + "nbr3", nbr3, torch.int32), (name + "down", down, torch.int32),
                        (name + "up8", up8, torch.int32)]
        want = dict(_named_tensors(out)) if out is not None else None
        done = {}
        for name, src, dtype in sources:
            if want is None:
                done[name] = torch.empty(src.shape, dtype=dtype, device=src.device)
            else:
                done[name] = want[name]
                if done[name].shape != src.shape or done[name].dtype != dtype:
                    raise ValueError(f"{name}: {tuple(src.shape)} {dtype}, where "
                                     f"{tuple(done[name].shape)} {done[name].dtype} is wanted")
        torch._foreach_copy_(list(done.values()), [src for _, src, _ in sources])
        if out is not None:
            return out
        dd = {k: done[k] for k in ("feats", "p2v", "point_mask", "sem_label", "ins_valid",
                                   "gt_offset")}
        dd["pyramid"] = tuple(
            SparseStage(**{f: done[f"pyramid[{s}].{f}"] for f in STAGE_FIELDS}, stride=1 << s)
            for s in range(self.num_stages))
        return dd


def _check_map(arrays: Dict[str, np.ndarray], s: int) -> None:
    v = arrays[f"pg_nbr3_{s}"].shape[0]
    if int(arrays[f"pg_nbr3_{s}"].max(initial=-1)) >= v:
        raise ValueError(f"pg_nbr3_{s} names a row past its {v} rows")
    if s:
        v_prev = arrays[f"pg_nbr3_{s - 1}"].shape[0]
        if int(arrays[f"pg_down_{s}"].max(initial=-1)) >= v_prev:
            raise ValueError(f"pg_down_{s} names a row past the level before's {v_prev}")
        upk = arrays[f"pg_upk_{s}"]
        if int(np.max(arrays[f"pg_uprow_{s}"], where=upk >= 0, initial=-1)) >= v:
            raise ValueError(f"pg_uprow_{s} names a row past its level's {v}")


@dataclasses.dataclass
class PGScene:
    """One scene as PointGroup's loader reads it, before any crop."""

    xyz: np.ndarray  # [N, 3] f32, metres about the scene's mean
    rgb: np.ndarray  # [N, 3] f32 in [-1, 1]
    sem_label: np.ndarray  # [N] int32, 0..19 or -100
    ins_label: np.ndarray  # [N] int32, 0.. or -100


def scene_arrays(xyz: np.ndarray, rgb: np.ndarray, sem_nyu40: np.ndarray,
                 ins_ids: np.ndarray) -> PGScene:
    """A scene from the exporter's arrays: aligned xyz, rgb 0-255, nyu40
    ids, instance ids (1.., 0 = none)."""
    xyz = np.asarray(xyz, np.float64)
    sem = _REMAP[np.clip(np.asarray(sem_nyu40, np.int64), 0, 255)]
    ins = np.asarray(ins_ids, np.int64)
    ins = np.where(ins > 0, ins - 1, IGNORE).astype(np.int32)
    return PGScene((xyz - xyz.mean(0)).astype(np.float32),
                   (np.asarray(rgb, np.float32) / 127.5 - 1.0).astype(np.float32), sem, ins)


def crop(xyz: np.ndarray, spec: PGSpec, rng: np.random.Generator) -> np.ndarray:
    """PointGroup's ``crop``: the points kept, a room of more than
    ``max_npoint`` points cut to a window of ``full_scale[1]`` voxels, the
    window narrowed by 32 voxels in x and y until it holds few enough (an
    offset drawn from ``rng`` each time)."""
    valid = xyz.min(1) >= 0
    full = np.array([spec.full_scale[1]] * 3, np.float64)
    room = xyz.max(0) - xyz.min(0)
    while valid.sum() > spec.max_npoint:
        offset = np.clip(full - room + 0.001, None, 0) * rng.random(3)
        moved = xyz + offset
        valid = (moved.min(1) >= 0) & ((moved < full).sum(1) == 3)
        full[:2] -= 32
    return valid


def pad_sample(scene: PGScene, spec: PGSpec, rng: Optional[np.random.Generator] = None
               ) -> Dict[str, np.ndarray]:
    """One scene's padded arrays (local rows; see the module docstring)."""
    if spec.augment:
        raise NotImplementedError("PointGroup's augmentation (jitter, flip, rotation, elastic "
                                  "distortion) is not ported; train with augment off")
    rng = rng or np.random.default_rng(0)
    xyz = scene.xyz.astype(np.float64) * spec.scale
    xyz -= xyz.min(0)
    keep = crop(xyz, spec, rng)
    idx = np.nonzero(keep)[0]
    xyz_m, rgb = scene.xyz[idx], scene.rgb[idx]
    sem, ins = scene.sem_label[idx], scene.ins_label[idx]
    coords = np.floor(xyz[idx]).astype(np.int32)
    # voxels in raster order (sorted by packed key), each the mean of its points
    uniq, p2v = np.unique(voxelize.pack_coords(coords), return_inverse=True)
    p2v = p2v.reshape(-1)
    first = np.zeros(len(uniq), np.int64)
    first[p2v[::-1]] = np.arange(len(p2v))[::-1]
    counts = np.bincount(p2v, minlength=len(uniq)).astype(np.float64)
    point_feats = np.concatenate([rgb, xyz_m], 1).astype(np.float64)
    feats = np.stack([np.bincount(p2v, point_feats[:, c], len(uniq)) for c in range(FEAT_DIM)],
                     1) / counts[:, None]
    caps = spec.level_caps
    stages, n_rows = voxelize.build_pyramid_padded([coords[first]], [0], caps)
    # instance centres: the mean xyz of each instance's points
    centre = np.zeros((max(int(ins.max(initial=-1)) + 1, 1), 3), np.float64)
    has = ins >= 0
    if has.any():
        n = np.bincount(ins[has], minlength=len(centre)).astype(np.float64)
        for c in range(3):
            centre[:, c] = np.bincount(ins[has], xyz_m[has, c].astype(np.float64),
                                       len(centre)) / np.maximum(n, 1)
    gt_offset = np.where(has[:, None], centre[np.maximum(ins, 0)] - xyz_m, 0.0)
    # points whose voxel a cap cut are left out, as are those past point_cap
    npts = min(len(idx), spec.point_cap)
    in_cap = p2v[:npts] < caps[0]
    pc = spec.point_cap
    out = {
        "feats": np.zeros((caps[0], FEAT_DIM), np.float32),
        "p2v": np.zeros(pc, np.int32),
        "point_mask": np.zeros(pc, bool),
        "sem_label": np.full(pc, IGNORE, np.int32),
        "ins_valid": np.zeros(pc, bool),
        "gt_offset": np.zeros((pc, 3), np.float32),
    }
    nv = min(len(uniq), caps[0])
    out["feats"][:nv] = feats[:nv]
    out["p2v"][:npts] = np.where(in_cap, p2v[:npts], 0)
    out["point_mask"][:npts] = in_cap
    out["sem_label"][:npts] = np.where(in_cap, sem[:npts], IGNORE)
    out["ins_valid"][:npts] = in_cap & has[:npts]
    out["gt_offset"][:npts] = np.where(in_cap[:, None], gt_offset[:npts], 0.0)
    for s, st in enumerate(stages):
        up_row, up_k = (voxelize.invert_down(st.down, caps[s - 1]) if s else
                        (np.zeros(0, np.int32), np.zeros(0, np.int32)))
        out.update({f"pg_coords_{s}": st.coords, f"pg_owner_{s}": st.owner,
                    f"pg_nbr3_{s}": st.nbr3, f"pg_down_{s}": st.down,
                    f"pg_uprow_{s}": up_row, f"pg_upk_{s}": up_k})
    out["level_overflow"] = np.array([max(0, n - c) / max(n, 1) for n, c in zip(n_rows, caps)],
                                     np.float32)
    out["point_overflow"] = np.float32(max(0, len(idx) - pc) / max(len(idx), 1))
    return out


def collate(samples: List[Dict[str, np.ndarray]], spec: PGSpec) -> Dict[str, np.ndarray]:
    """A batch of ``pad_sample`` outputs: rows and points of sample b offset
    by b caps (map entries -1 stay -1; owners become the sample's index)."""
    caps, pc = spec.level_caps, spec.point_cap
    batch: Dict[str, np.ndarray] = {}

    def shifted(key, off):
        return np.concatenate([np.where(s[key] >= 0, s[key] + b * off, s[key])
                               for b, s in enumerate(samples)])

    for key in ("feats", "point_mask", "sem_label", "ins_valid", "gt_offset"):
        batch[key] = np.concatenate([s[key] for s in samples])
    batch["p2v"] = np.concatenate([s["p2v"] + b * caps[0] for b, s in enumerate(samples)]
                                  ).astype(np.int32)
    for lvl in range(spec.num_stages):
        batch[f"pg_coords_{lvl}"] = np.concatenate([s[f"pg_coords_{lvl}"] for s in samples])
        batch[f"pg_owner_{lvl}"] = np.concatenate(
            [np.where(s[f"pg_owner_{lvl}"] >= 0, b, -1) for b, s in enumerate(samples)]
        ).astype(np.int32)
        batch[f"pg_nbr3_{lvl}"] = shifted(f"pg_nbr3_{lvl}", caps[lvl]).astype(np.int32)
        if lvl:
            batch[f"pg_down_{lvl}"] = shifted(f"pg_down_{lvl}", caps[lvl - 1]).astype(np.int32)
            batch[f"pg_uprow_{lvl}"] = shifted(f"pg_uprow_{lvl}", caps[lvl]).astype(np.int32)
            batch[f"pg_upk_{lvl}"] = np.concatenate([s[f"pg_upk_{lvl}"] for s in samples])
        else:
            batch[f"pg_down_{lvl}"] = np.zeros((len(samples) * caps[0], 0), np.int32)
            batch[f"pg_uprow_{lvl}"] = np.zeros(0, np.int32)
            batch[f"pg_upk_{lvl}"] = np.zeros(0, np.int32)
    batch["level_overflow"] = np.stack([s["level_overflow"] for s in samples])
    batch["point_overflow"] = np.array([s["point_overflow"] for s in samples], np.float32)
    return batch


def read_scene(root: str, scene_id: str) -> PGScene:
    """The exporter's files of ``scene_id`` under ``root`` (its
    ``pointgroup_data`` directory)."""
    base = os.path.join(root, scene_id)
    vert = np.load(base + "_aligned_vert.npy")
    return scene_arrays(vert[:, :3], vert[:, 3:6], np.load(base + "_sem_label.npy"),
                        np.load(base + "_ins_label.npy"))


class PointGroupDataset:
    """The scenes of a split as PointGroup trains on them: every scene id
    whose exporter files are under ``root``, one sample each."""

    def __init__(self, root: str, scene_ids: Sequence[str], spec: PGSpec):
        self.root, self.spec = root, spec
        self.scene_ids = [s for s in scene_ids
                          if os.path.exists(os.path.join(root, s + "_aligned_vert.npy"))]
        if not self.scene_ids:
            raise FileNotFoundError(f"no scene of {list(scene_ids)[:4]}... has its exported "
                                    f"files under {root}")

    def __len__(self) -> int:
        return len(self.scene_ids)

    def sample(self, i: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        return pad_sample(read_scene(self.root, self.scene_ids[i]), self.spec, rng)


class PointGroupLoader:
    """Batches of ``batch_size`` scenes, shuffled each epoch from ``seed``
    (the last, short batch dropped, as PointGroup's train loader drops
    it); ``len`` is the batches an epoch."""

    def __init__(self, dataset: PointGroupDataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True):
        self.dataset, self.batch_size = dataset, batch_size
        self.shuffle, self.seed, self.drop_last = shuffle, seed, drop_last
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng((self.seed, self.epoch))
        self.epoch += 1
        order = rng.permutation(len(self.dataset)) if self.shuffle else np.arange(
            len(self.dataset))
        for i in range(len(self)):
            ids = order[i * self.batch_size:(i + 1) * self.batch_size]
            yield collate([self.dataset.sample(int(j), rng) for j in ids], self.dataset.spec)
