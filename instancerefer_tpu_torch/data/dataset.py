"""ScanRefer dataset: per-annotation CoreSample assembly from ScanNet artifacts.

The port's copy of ``instancerefer_tpu/data/dataset.py`` (each rank of a
data-parallel run loads its own shard), itself a port of
reference ``lib/dataset.py`` (``ScannetReferenceDataset``) with the
augmentation/instance-grouping semantics preserved, emitting ``CoreSample``s
that the padded pipeline (``pipeline.pad_sample``/``collate``) turns into
static batches.  Differences by design:

* explicit numpy RNG instead of the reference's mixed ``np.random``/
  ``torch.rand`` worker nondeterminism (SURVEY.md §7 hard part 4),
* candidate filtering and voxelization happen here (not mid-forward),
* ragged per-sample lists never cross into the device step.

Expected on-disk layout (identical to the reference's, ``lib/config.py:49-63``):
  {data_root}/scannet/pointgroup_data/{scene_id}_aligned_vert.npy        [N, 6+]
  {data_root}/scannet/pointgroup_data/{scene_id}_ins_label_pg.npy        [N]
  {data_root}/scannet/pointgroup_data/{scene_id}_sem_label_pg.npy        [N]
  {data_root}/scannet/pointgroup_data/{scene_id}_aligned_bbox.npy        [K, 8]
  {data_root}/glove.p                      (pickled {token: [300] float})
  {data_root}/ScanRefer_filtered_{split}.json
  {data_root}/enet_feats_maxpool.hdf5      (optional, use_multiview)
"""

from __future__ import annotations

import collections
import json
import os
import pickle
import sys
import threading
from typing import Dict, List, Optional

import numpy as np

from instancerefer_tpu_torch.data.pipeline import (
    MEAN_COLOR_RGB,
    BatchSpec,
    CoreSample,
    build_scene_block,
    compute_height_feature,
    finalize_batch,
    pad_sample,
    random_sampling,
)
from instancerefer_tpu_torch.data.scannet_config import ScannetDatasetConfig
from instancerefer_tpu_torch.parallel.distributed import host_shard_indices


# rotation matrices of utils/pc_utils.py
def rotx(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def roty(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rotz(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def rotate_aligned_boxes_along_axis(boxes, rot_mat, axis):
    """Port of data/scannet/model_util_scannet.py:51-83."""
    centers, lengths = boxes[:, 0:3], boxes[:, 3:6]
    new_centers = np.dot(centers, rot_mat.T)
    if axis == "x":
        d1, d2 = lengths[:, 1] / 2.0, lengths[:, 2] / 2.0
    elif axis == "y":
        d1, d2 = lengths[:, 0] / 2.0, lengths[:, 2] / 2.0
    else:
        d1, d2 = lengths[:, 0] / 2.0, lengths[:, 1] / 2.0
    new_1 = np.zeros((d1.shape[0], 4))
    new_2 = np.zeros((d1.shape[0], 4))
    for i, crnr in enumerate([(-1, -1), (1, -1), (1, 1), (-1, 1)]):
        crnrs = np.zeros((d1.shape[0], 3))
        crnrs[:, 0] = crnr[0] * d1
        crnrs[:, 1] = crnr[1] * d2
        crnrs = np.dot(crnrs, rot_mat.T)
        new_1[:, i] = crnrs[:, 0]
        new_2[:, i] = crnrs[:, 1]
    new_d1 = 2.0 * np.max(new_1, 1)
    new_d2 = 2.0 * np.max(new_2, 1)
    if axis == "x":
        new_lengths = np.stack((lengths[:, 0], new_d1, new_d2), axis=1)
    elif axis == "y":
        new_lengths = np.stack((new_d1, lengths[:, 1], new_d2), axis=1)
    else:
        new_lengths = np.stack((new_d1, new_d2, lengths[:, 2]), axis=1)
    return np.concatenate([new_centers, new_lengths], axis=1)


class _CoalescingLRU:
    """Thread-safe LRU with in-flight miss coalescing and an optional byte
    budget (entries report their size via ``nbytes_fn``).

    Same pattern as ``ScannetReferenceDataset._load_scene``: annotations are
    grouped by scene, so at a scene boundary every loader thread misses at
    once — the in-flight event makes exactly one thread build while the rest
    wait, instead of duplicating the (tens of ms) build per worker.
    """

    def __init__(self, max_entries: int = 0, max_bytes: int = 0, nbytes_fn=None):
        self._data: "collections.OrderedDict" = collections.OrderedDict()
        self._bytes: Dict = {}
        self._total_bytes = 0
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._nbytes_fn = nbytes_fn or (lambda v: 0)
        self._lock = threading.Lock()
        self._inflight: Dict = {}

    def get(self, key, builder):
        while True:
            with self._lock:
                if key in self._data:
                    self._data.move_to_end(key)
                    return self._data[key]
                ev = self._inflight.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[key] = ev
                    break
            ev.wait()
        try:
            val = builder()
            nb = int(self._nbytes_fn(val))
            with self._lock:
                if key not in self._data:
                    self._data[key] = val
                    self._bytes[key] = nb
                    self._total_bytes += nb
                    self._data.move_to_end(key)
                    while (self.max_entries and len(self._data) > self.max_entries) or (
                        self.max_bytes and self._total_bytes > self.max_bytes
                    ):
                        k, _ = self._data.popitem(last=False)
                        self._total_bytes -= self._bytes.pop(k, 0)
            return val
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            ev.set()


def _dict_nbytes(d: Dict[str, np.ndarray]) -> int:
    return sum(int(np.asarray(v).nbytes) for v in d.values())


class ScannetReferenceDataset:
    """Per-annotation sample assembly (lib/dataset.py:37-300)."""

    def __init__(
        self,
        scanrefer: List[dict],
        split: str = "train",
        *,
        data_root: str = "data",
        num_points: int = 40000,
        use_color: bool = True,
        use_height: bool = True,
        use_normal: bool = False,
        use_multiview: bool = False,
        use_augment: bool = True,
        seed: int = 42,
        dc: Optional[ScannetDatasetConfig] = None,
        allow_missing_tsv: bool = False,
        scene_cache_size: int = 128,
        static_scene_sampling: Optional[bool] = None,
        scene_block_cache_mb: int = 1024,
    ):
        self.scanrefer = scanrefer
        self.split = split
        self.data_root = data_root
        self.num_points = num_points
        self.use_color = use_color
        self.use_height = use_height
        self.use_normal = use_normal
        self.use_multiview = use_multiview
        self.augment = use_augment if split == "train" else False
        self.seed = seed
        self.scannet_data = os.path.join(data_root, "scannet", "pointgroup_data")
        meta_dir = os.path.join(data_root, "scannet", "meta_data")
        self.dc = dc or ScannetDatasetConfig(meta_dir=meta_dir)
        tsv = os.path.join(meta_dir, "scannetv2-labels.combined.tsv")
        if os.path.exists(tsv):
            self.raw2label = self.dc.raw2label_from_tsv(tsv)
        elif allow_missing_tsv:
            # every object maps to class 17 ("others") — only acceptable in
            # tests that opt in explicitly
            self.raw2label = {}
        else:
            raise FileNotFoundError(
                f"ScanNet metadata not found: {tsv}. Without it every object "
                "would silently map to class 17 ('others') and training would "
                "be garbage. Place scannetv2-labels.combined.tsv under "
                f"{meta_dir} (see reference lib/dataset.py:302-320), or pass "
                "allow_missing_tsv=True (tests only)."
            )
        self.unique_multiple_lookup = self._get_unique_multiple_lookup()

        glove_path = os.path.join(data_root, "glove.p")
        with open(glove_path, "rb") as f:
            self.glove = pickle.load(f)
        # LRU over the four per-scene .npy loads: ScanRefer averages ~65
        # annotations per scene, so uncached epochs re-read each scene's
        # arrays ~65 times.  Thread-safe (PaddedLoader builds samples from a
        # thread pool); callers never mutate the returned arrays before
        # copying (views are rebound by random_sampling/concatenate).
        self._scene_cache: "collections.OrderedDict[str, tuple]" = (
            collections.OrderedDict()
        )
        self._scene_cache_max = scene_cache_size
        self._cache_lock = threading.Lock()
        self._inflight: Dict[str, threading.Event] = {}
        self._multiview = None
        self._mv_lock = threading.Lock()
        # Deterministic PER-SCENE point sampling for non-train splits (default
        # on for val/test when augmentation is off): all ~65 annotations share
        # one 40k subsample + instance grouping, drawn from a scene-keyed RNG
        # instead of a per-annotation one.  Deliberate deviation from the
        # reference (lib/dataset.py:125 draws per annotation): each draw is
        # still an unbiased sample of the scene, eval becomes epoch-
        # deterministic, and the scene's padded voxel pyramid becomes
        # cacheable across annotations AND epochs — the val feed drops from
        # ~65 pyramid builds per scene to 1.  Train (augment on) never uses it.
        if static_scene_sampling is None:
            # Default on for non-train splits only: a train run with
            # use_augment=False must still redraw the 40k subsample and
            # instance draws every epoch (reference lib/dataset.py:125
            # samples per annotation) — freezing them would silently
            # collapse training-data diversity.  Explicit opt-in still wins.
            static_scene_sampling = not self.augment and split != "train"
        self.static_scene_sampling = static_scene_sampling and not self.augment
        if self.static_scene_sampling:
            # self-describing runs (ADVICE r4): this deviation changes which
            # points eval sees vs reference-evaluated checkpoints, so say so
            # once up front rather than only in docstrings / DEVIATIONS.md
            print(
                f"[dataset] static_scene_sampling ON for split={split!r}: one "
                "deterministic 40k subsample + instance draw per scene, shared "
                "by all its annotations (deviation from reference per-annotation "
                "sampling, lib/dataset.py:125 — see DEVIATIONS.md D1)",
                file=sys.stderr,
            )
        # (point_cloud, instance grouping) per scene — deterministic bundles
        self._bundle_cache = _CoalescingLRU(max_entries=scene_cache_size)
        # padded scene voxel blocks (build_scene_block results, ~7 MB each at
        # production caps) — byte-budgeted; PaddedLoader consults this via
        # cached_scene_block
        self._block_cache = _CoalescingLRU(
            max_bytes=scene_block_cache_mb * (1 << 20), nbytes_fn=_dict_nbytes
        )

    def cached_scene_block(self, scene_id: str, key, builder):
        """Padded scene-block cache (valid only under static_scene_sampling
        with augmentation off — the loader checks).  ``key`` carries the
        spec/voxel-size fingerprint so blocks from a different geometry can
        never be served."""
        return self._block_cache.get((scene_id, key), builder)

    def __len__(self):
        return len(self.scanrefer)

    # ------------------------------------------------------------------ lookup
    def _object_cat(self, object_name: str) -> int:
        return self.raw2label.get(object_name, 17)

    def _get_unique_multiple_lookup(self):
        """lib/dataset.py:322-372: 0 if the target class is unique in its scene."""
        all_sem: Dict[str, List[int]] = {}
        seen: Dict[str, set] = {}
        for data in self.scanrefer:
            sid = data["scene_id"]
            name = " ".join(data["object_name"].split("_"))
            all_sem.setdefault(sid, [])
            seen.setdefault(sid, set())
            if data["object_id"] not in seen[sid]:
                seen[sid].add(data["object_id"])
                all_sem[sid].append(self._object_cat(name))
        all_sem = {k: np.array(v) for k, v in all_sem.items()}
        lut: Dict[str, Dict[str, Dict[str, int]]] = {}
        for data in self.scanrefer:
            sid, oid, aid = data["scene_id"], data["object_id"], data["ann_id"]
            name = " ".join(data["object_name"].split("_"))
            sem = self._object_cat(name)
            um = 0 if (all_sem[sid] == sem).sum() == 1 else 1
            lut.setdefault(sid, {}).setdefault(str(oid), {})[str(aid)] = um
        return lut

    # ------------------------------------------------------------------- build
    def _load_scene(self, scene_id: str):
        # Misses are coalesced: annotations are grouped by scene, so at a
        # scene boundary every worker thread misses at once — without the
        # in-flight event the four .npy reads would be duplicated per worker
        # on exactly the hot path the LRU exists for.
        while True:
            with self._cache_lock:
                hit = self._scene_cache.get(scene_id)
                if hit is not None:
                    self._scene_cache.move_to_end(scene_id)
                    return hit
                ev = self._inflight.get(scene_id)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[scene_id] = ev
                    break  # this thread loads
            ev.wait()  # another thread is loading; re-check the cache after
        try:
            base = os.path.join(self.scannet_data, scene_id)
            verts = np.load(base + "_aligned_vert.npy")
            ins = np.load(base + "_ins_label_pg.npy")
            sem = np.load(base + "_sem_label_pg.npy")
            bboxes = np.load(base + "_aligned_bbox.npy")
            out = (verts, ins, sem, bboxes)
            if self._scene_cache_max > 0:
                with self._cache_lock:
                    self._scene_cache[scene_id] = out
                    self._scene_cache.move_to_end(scene_id)
                    while len(self._scene_cache) > self._scene_cache_max:
                        self._scene_cache.popitem(last=False)
            return out
        finally:
            # on failure waiters re-check, miss, and become loaders (raising
            # the same IO error themselves)
            with self._cache_lock:
                self._inflight.pop(scene_id, None)
            ev.set()

    def _multiview_feats(self, scene_id):
        import h5py

        # one handle, reads serialized: h5py/HDF5 (non-threadsafe build) must
        # not be entered from several loader threads concurrently
        with self._mv_lock:
            if self._multiview is None:
                self._multiview = h5py.File(
                    os.path.join(self.data_root, "enet_feats_maxpool.hdf5"),
                    "r", libver="latest", swmr=True,
                )
            return np.array(self._multiview[scene_id])

    @staticmethod
    def _count_lang_len(tokens) -> int:
        """lang_len: non-whitespace tokens, capped at MAX_DES_LEN=126
        (lib/dataset.py:76-92)."""
        return min(len([t for t in tokens if not t.isspace()]), 126)

    def lang_lengths(self) -> np.ndarray:
        """Every sample's lang_len, from the annotations alone (no GloVe
        lookups, no scene IO): each rank derives the global batch's language
        grid from them (``PaddedLoader._global_lang_grids``)."""
        if getattr(self, "_lang_lens", None) is None:
            self._lang_lens = np.array(
                [self._count_lang_len(d["token"]) for d in self.scanrefer], np.int32)
        return self._lang_lens

    def get_lang(self, idx: int):
        """Language-only assembly (lang_feat [T,300], lang_len) — the cheap
        slice of ``get_core`` used by the use_gt_lang=False prediction pass
        (no scene IO, no voxelization).  The single source of the embedding
        quirks (whitespace-token skip, unk fallback, 126-token cap,
        lib/dataset.py:72-92): ``get_core`` calls this same method, so the
        prediction pass always sees bit-identical language features."""
        tokens = self.scanrefer[idx]["token"]
        max_len = 126
        emb = np.zeros((max_len, 300), np.float32)
        for t, token in enumerate(tokens[:max_len]):
            if token.isspace():
                continue
            emb[t] = self.glove.get(token, self.glove["unk"])
        # NOTE deliberate reference parity, not a bug: embeddings stay at
        # their ORIGINAL token positions while lang_len counts only
        # non-whitespace tokens (lib/dataset.py:76-92) — so when a whitespace
        # token precedes the last real token, the trailing tokens fall past
        # the length mask, exactly as the reference's pack_padded_sequence
        # drops them.
        lang_len = self._count_lang_len(tokens)
        return emb, lang_len

    def _assemble_points(self, scene_id: str, rng: np.random.Generator):
        """Feature assembly + 40k sampling (lib/dataset.py:94-125)."""
        mesh_vertices, instance_labels, semantic_labels, _ = \
            self._load_scene(scene_id)
        if not self.use_color:
            point_cloud = mesh_vertices[:, 0:3]
        else:
            point_cloud = mesh_vertices[:, 0:6].copy()
            point_cloud[:, 3:6] = (point_cloud[:, 3:6] - MEAN_COLOR_RGB) / 256.0
        if self.use_normal:
            point_cloud = np.concatenate([point_cloud, mesh_vertices[:, 6:9]], 1)
        if self.use_multiview:
            point_cloud = np.concatenate(
                [point_cloud, self._multiview_feats(scene_id)], 1
            )
        if self.use_height:
            height = compute_height_feature(point_cloud)
            point_cloud = np.concatenate([point_cloud, height[:, None]], 1)

        point_cloud, choices = random_sampling(point_cloud, self.num_points, rng)
        return point_cloud, instance_labels[choices], semantic_labels[choices]

    def _group_instances(self, point_cloud, instance_labels, semantic_labels, rng):
        """Per-instance split on PointGroup ids (lib/dataset.py:201-245).
        Returns (instance_points, instance_class, instance_obbs,
        instance_ids) — ``instance_ids`` are the raw PointGroup labels, for
        the caller's ``ref_target`` (gt marker) computation."""
        instance_points, instance_class, instance_obbs, instance_ids = [], [], [], []
        for i_instance in np.unique(instance_labels):
            ind = np.nonzero(instance_labels == i_instance)[0]
            ins_class = semantic_labels[ind[0]]
            if ins_class in self.dc.nyu40ids:
                x = point_cloud[ind]
                cls18 = self.dc.nyu40id2class[int(ins_class)]
                instance_class.append(cls18)
                pc = x[:, :3]
                center = 0.5 * (pc.min(0) + pc.max(0))
                size = pc.max(0) - pc.min(0)
                instance_obbs.append(
                    np.concatenate([center, size, [0.0]]).astype(np.float32)
                )
                sampled, _ = random_sampling(x, 1024, rng)
                instance_points.append(sampled.astype(np.float32))
                instance_ids.append(int(i_instance))
        return instance_points, instance_class, instance_obbs, instance_ids

    def get_scene_bundle(self, scene_id: str):
        """Deterministic per-scene (point_cloud, instance grouping) bundle for
        static_scene_sampling pipelines — one draw shared by every annotation
        of the scene, from a scene-keyed RNG (independent of epoch/annotation).
        Cached (LRU, ``scene_cache_size`` entries); callers must not mutate."""
        import zlib

        def build():
            rng = np.random.default_rng(
                (self.seed, zlib.crc32(scene_id.encode()))
            )
            point_cloud, instance_labels, semantic_labels = \
                self._assemble_points(scene_id, rng)
            point_cloud = point_cloud.astype(np.float32)
            groups = self._group_instances(
                point_cloud, instance_labels, semantic_labels, rng
            )
            return (point_cloud,) + groups

        return self._bundle_cache.get(scene_id, build)

    def get_core(
        self,
        idx: int,
        rng: Optional[np.random.Generator] = None,
        class_override: Optional[int] = None,
    ) -> CoreSample:
        """Build one sample; ``class_override`` substitutes the candidate
        filter class (use_gt_lang=False second pass) while labels keep the GT
        ``object_cat``."""
        rng = rng or np.random.default_rng(self.seed + idx)
        entry = self.scanrefer[idx]
        scene_id = entry["scene_id"]
        object_id = int(entry["object_id"])
        object_name = " ".join(entry["object_name"].split("_"))
        ann_id = int(entry["ann_id"])
        object_cat = self._object_cat(object_name)

        # ---- language (lib/dataset.py:72-92) — shared with the
        # use_gt_lang=False prediction pass
        emb, lang_len = self.get_lang(idx)

        # ---- point cloud features (:94-123)
        static = self.static_scene_sampling and not self.augment
        if static:
            (point_cloud, instance_points, instance_class, instance_obbs,
             instance_ids) = self.get_scene_bundle(scene_id)
            instance_bboxes = self._load_scene(scene_id)[3]
        else:
            point_cloud, instance_labels, semantic_labels = \
                self._assemble_points(scene_id, rng)
            instance_bboxes = self._load_scene(scene_id)[3]

        # ---- labels + augmentation (:130-197)
        MAX_NUM_OBJ = 128
        target_bboxes = np.zeros((MAX_NUM_OBJ, 6))
        size_classes = np.zeros(MAX_NUM_OBJ)
        size_residuals = np.zeros((MAX_NUM_OBJ, 3))
        ref_center = np.zeros(3, np.float32)
        ref_size_class = 0
        ref_size_residual = np.zeros(3, np.float32)
        if self.split != "test":
            num_bbox = min(instance_bboxes.shape[0], MAX_NUM_OBJ)
            target_bboxes[:num_bbox] = instance_bboxes[:num_bbox, 0:6]

            if self.augment:
                if rng.random() > 0.5:  # flip YZ plane
                    point_cloud[:, 0] = -point_cloud[:, 0]
                    target_bboxes[:, 0] = -target_bboxes[:, 0]
                if rng.random() > 0.5:  # flip XZ plane
                    point_cloud[:, 1] = -point_cloud[:, 1]
                    target_bboxes[:, 1] = -target_bboxes[:, 1]
                for rot_fn, axis in ((rotx, "x"), (roty, "y"), (rotz, "z")):
                    rot_angle = (rng.random() * np.pi / 18) - np.pi / 36  # ±5°
                    rot_mat = rot_fn(rot_angle)
                    point_cloud[:, 0:3] = np.dot(point_cloud[:, 0:3], rot_mat.T)
                    target_bboxes = rotate_aligned_boxes_along_axis(
                        target_bboxes, rot_mat, axis
                    )
                factor = rng.random(3) - 0.5  # translation (:442-454)
                point_cloud[:, :3] += factor
                target_bboxes[:, :3] += factor

            class_ind = [
                self.dc.nyu40id2class[int(x)] for x in instance_bboxes[:num_bbox, -2]
            ]
            size_classes[:num_bbox] = class_ind
            size_residuals[:num_bbox] = (
                target_bboxes[:num_bbox, 3:6] - self.dc.mean_size_arr[class_ind]
            )
            for i, gt_id in enumerate(instance_bboxes[:num_bbox, -1]):
                if gt_id == object_id:
                    ref_center = target_bboxes[i, 0:3].astype(np.float32)
                    ref_size_class = int(size_classes[i])
                    ref_size_residual = size_residuals[i].astype(np.float32)

        # ---- instance grouping (:201-245)
        if not static:
            instance_points, instance_class, instance_obbs, instance_ids = \
                self._group_instances(
                    point_cloud, instance_labels, semantic_labels, rng
                )
        ref_target = [1 if iid == object_id + 1 else 0 for iid in instance_ids]

        return CoreSample(
            lang_feat=emb,
            lang_len=lang_len,
            object_cat=object_cat,
            # static bundles are already float32 and shared read-only
            point_cloud=point_cloud if static else point_cloud.astype(np.float32),
            instance_points=instance_points,
            instance_class=instance_class,
            instance_obbs=instance_obbs,
            ref_center_label=ref_center,
            ref_size_class_label=ref_size_class,
            ref_size_residual_label=ref_size_residual,
            unique_multiple=self.unique_multiple_lookup[scene_id][str(object_id)][
                str(ann_id)
            ],
            object_id=object_id,
            ann_id=ann_id,
            scan_idx=idx,
            ref_target=np.array(ref_target, np.int32),
            filter_class=class_override,
        )


def get_scanrefer(data_root: str, split: str, num_scenes: int = -1) -> List[dict]:
    """Load + optionally subset the ScanRefer annotation list
    (scripts/train.py:165-190)."""
    path = os.path.join(data_root, f"ScanRefer_filtered_{split}.json")
    with open(path) as f:
        scanrefer = json.load(f)
    scene_list = sorted(set(d["scene_id"] for d in scanrefer))
    if num_scenes > 0:
        scene_list = scene_list[:num_scenes]
        scanrefer = [d for d in scanrefer if d["scene_id"] in scene_list]
    return scanrefer


class PaddedLoader:
    """Batched loader: CoreSample -> pad_sample -> collate.

    The reference parallelizes with 4 DataLoader workers
    (``config/InstanceRefer.yaml:45``); here a thread pool of
    ``num_workers`` builds padded samples (voxel pyramids and kernel maps
    included: the C++ voxelizer and numpy release the interpreter lock for
    much of it), and one more thread collates each batch while the consumer
    runs the previous one.

    ``drop_last`` defaults False, matching the reference's torch DataLoader
    default (``scripts/train.py:61-68`` trains on the partial final batch).
    A partial batch is padded to the static batch size by repeating the last
    sample, with ``sample_valid`` marking real rows AND the duplicates'
    voxel owners cleared to -1 — so BatchNorm statistics, pools, and every
    loss/metric denominator see exactly the reference's smaller batch.

    Data parallelism: pass ``process_index``/``process_count`` (the rank
    and the world size) and the PER-RANK ``batch_size`` (global batch /
    world); each rank loads a disjoint 1-in-``process_count`` slice of the
    same global permutation (``host_shard_indices``).  Per-sample RNG seeds
    are positional in the global permutation, so the union of the ranks'
    samples is the single-process epoch, and each rank collates its batch
    on the global batch's language grid: a rank's batch equals the JAX
    package's host batch bit for bit.  Every rank yields the same number of
    batches (from the smallest shard), so the collectives of a step stay in
    lockstep; at most ``process_count - 1`` samples an epoch land on no rank
    when the sample count does not divide.
    """

    def __init__(
        self,
        dataset: ScannetReferenceDataset,
        spec: BatchSpec,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        drop_last: bool = False,
        voxel_size_ap: float = 0.02,
        voxel_size_glp: float = 0.05,
        class_overrides: Optional[Dict[int, int]] = None,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.dataset = dataset
        self.spec = spec
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.voxel_size_ap = voxel_size_ap
        self.voxel_size_glp = voxel_size_glp
        # sample idx -> predicted class for the use_gt_lang=False second pass
        self.class_overrides = class_overrides
        self.process_index = process_index
        self.process_count = max(process_count, 1)
        self.epoch = 0
        # scene-block reuse (val/eval): valid only when every annotation of a
        # scene sees the same point cloud (static_scene_sampling, augment
        # off); the key pins what the block depends on
        self._scene_blocks_on = bool(dataset.static_scene_sampling and not dataset.augment)
        self._scene_block_key = (tuple(spec.scene_caps), spec.feat_dim, float(voxel_size_glp))

    def __len__(self):
        # the smallest rank's shard, so every rank runs the same batch count
        shard = len(self.dataset) // self.process_count
        return shard // self.batch_size if self.drop_last else -(-shard // self.batch_size)

    def _build_one(self, args):
        idx, sample_seed = args
        rng = np.random.default_rng(sample_seed)
        override = self.class_overrides.get(idx) if self.class_overrides else None
        core = self.dataset.get_core(idx, rng, class_override=override)
        scene_block = None
        if self._scene_blocks_on:
            scene_block = self.dataset.cached_scene_block(
                self.dataset.scanrefer[idx]["scene_id"],
                self._scene_block_key,
                lambda: build_scene_block(core.point_cloud, self.spec, self.voxel_size_glp),
            )
        return pad_sample(
            core, self.spec, self.voxel_size_ap, self.voxel_size_glp, scene_block=scene_block,
        )

    def _finalize(self, batch, lang_grid=None, pool=None):
        return finalize_batch(batch, self.batch_size, self.spec, lang_grid=lang_grid, pool=pool)

    def _global_lang_grids(self, order, nb):
        """Each batch's bucketed language grid, from the global batch: the
        ranks share ``order``, and global batch ``b`` is
        ``order[b*G:(b+1)*G]`` (rank p holds its positions ``== p (mod
        process_count)``).  None when bucketing is off."""
        if not self.spec.lang_bucket:
            return None
        glens = np.minimum(self.dataset.lang_lengths(), self.spec.max_tokens)[order]
        g = self.batch_size * self.process_count
        return [self.spec.bucketed_tokens(int(glens[b * g:min((b + 1) * g, len(order))].max()))
                for b in range(nb)]

    def _epoch_plan(self):
        """(order, seeds, mine) of the current epoch, no state change: the
        global permutation, each position's RNG seed, and the positions this
        rank loads."""
        n = len(self.dataset)
        order = np.arange(n)
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.shuffle:
            rng.shuffle(order)
        seeds = rng.integers(2**31, size=n) if n else np.zeros(0, np.int64)
        return order, seeds, host_shard_indices(n, self.process_index, self.process_count)

    def __iter__(self):
        order, seeds, mine = self._epoch_plan()
        self.epoch += 1
        tasks = [(int(order[j]), int(seeds[j])) for j in mine]
        nb = len(self)
        lang_grids = self._global_lang_grids(order, nb)

        def gen_padded():
            if self.num_workers > 0:
                # Submission is windowed for backpressure: Executor.map would
                # enqueue the whole epoch upfront, so a stalled consumer lets
                # finished padded samples (MBs each) pile up unboundedly.
                from concurrent.futures import ThreadPoolExecutor

                window = self.num_workers * 4
                pending = collections.deque()
                with ThreadPoolExecutor(self.num_workers) as pool:
                    try:
                        for t in tasks:
                            pending.append(pool.submit(self._build_one, t))
                            if len(pending) >= window:
                                yield pending.popleft().result()
                        while pending:
                            yield pending.popleft().result()
                    finally:
                        for f in pending:
                            f.cancel()
            else:
                for t in tasks:
                    yield self._build_one(t)

        def gen_batches():
            batch, done = [], 0
            for padded in gen_padded():
                batch.append(padded)
                if len(batch) == self.batch_size:
                    yield batch, (lang_grids[done] if lang_grids else None)
                    batch = []
                    done += 1
                    if done >= nb:
                        return
            if batch and done < nb and not self.drop_last:
                yield batch, (lang_grids[done] if lang_grids else None)

        if self.num_workers <= 0:
            for bl, grid in gen_batches():
                yield self._finalize(bl, grid)
            return

        # Collate off the consumer thread, double-buffered (batch b collates
        # while the consumer processes b-1), its per-key memory passes fanned
        # out over a small dedicated pool.  At most two collated batches are
        # in flight on top of the sample window.
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(1) as fpool, \
                ThreadPoolExecutor(min(4, self.num_workers)) as cpool:
            fin = None
            for bl, grid in gen_batches():
                nxt = fpool.submit(self._finalize, bl, grid, cpool)
                if fin is not None:
                    yield fin.result()
                fin = nxt
            if fin is not None:
                yield fin.result()


class PredictedClassLoader:
    """use_gt_lang=False at TRAIN time: candidates filtered by the language
    classifier's prediction instead of the GT class
    (reference ``models/attribute_module.py:93-97`` — when ``use_gt_lang``
    is off, ``lang_cls_pred = argmax(lang_scores)`` drives
    ``filter_candidates`` during training too).

    Candidate filtering lives in the input pipeline here, so each epoch runs
    a cheap language-only prediction pass (``dataset.get_lang`` — no scene
    IO or voxelization) with the CURRENT model parameters, then iterates a
    fresh ``PaddedLoader`` with those per-sample ``class_overrides``.

    Deliberate approximation vs the reference: the reference re-predicts at
    every forward, so candidates can change within an epoch as the language
    weights move; here they refresh once per epoch (documented; the default
    config trains with ``use_gt_lang: True``, where this class is unused).
    """

    def __init__(
        self,
        dataset: ScannetReferenceDataset,
        spec: BatchSpec,
        batch_size: int,
        predict_fn,
        *,
        predict_batch: int = 64,
        **loader_kwargs,
    ):
        self.dataset = dataset
        self.spec = spec
        self.batch_size = batch_size
        # predict_fn(lang_feat [B,T,300], lang_len [B]) -> [B] class ids,
        # evaluated with the current weights at each epoch start; T is the
        # full grid, or the chunk's lang_bucket multiple when bucketing is on
        self.predict_fn = predict_fn
        self.predict_batch = predict_batch
        self.loader_kwargs = dict(loader_kwargs)
        self.epoch = 0

    def __len__(self):
        return len(
            PaddedLoader(
                self.dataset, self.spec, self.batch_size, **self.loader_kwargs
            )
        )

    def _predict_overrides(self, sample_idxs=None):
        """The predicted class of each of ``sample_idxs`` (default: every
        sample), with the current weights."""
        all_idxs = list(range(len(self.dataset))) if sample_idxs is None else [
            int(i) for i in sample_idxs]
        overrides = {}
        for lo in range(0, len(all_idxs), self.predict_batch):
            idxs = all_idxs[lo : lo + self.predict_batch]
            pairs = [self.dataset.get_lang(i) for i in idxs]
            # pad the tail chunk to the static predict_batch
            while len(pairs) < self.predict_batch:
                pairs.append(pairs[-1])
            # clamp to the spec's token grid exactly as pad_sample does —
            # get_lang returns the reference's full 126-token grid, but the
            # checkpoint was trained on max_tokens, and predicting off a
            # longer grid can argmax a different class
            feats = np.stack([p[0][: self.spec.max_tokens] for p in pairs])
            lens = np.minimum(
                np.asarray([p[1] for p in pairs], np.int32),
                self.spec.max_tokens,
            )
            # the bucketed grid of collate
            t_b = self.spec.bucketed_tokens(int(lens.max()))
            feats = np.ascontiguousarray(feats[:, :t_b])
            pred = np.asarray(self.predict_fn(feats, lens))
            for i, p in zip(idxs, pred):
                overrides[int(i)] = int(p)
        return overrides

    def __iter__(self):
        inner = PaddedLoader(
            self.dataset, self.spec, self.batch_size, **self.loader_kwargs
        )
        inner.epoch = self.epoch
        self.epoch += 1
        # a rank predicts only the samples of its own shard this epoch
        shard = None
        if inner.process_count > 1:
            order, _, mine = inner._epoch_plan()
            shard = sorted(int(order[j]) for j in mine)
        inner.class_overrides = self._predict_overrides(shard)
        yield from inner
