"""Host-side sample construction and padded-batch collation.

The port's copy of ``instancerefer_tpu/data/pipeline.py`` up to
``finalize_batch``: everything the reference computes in Python loops inside
the forward pass (candidate filtering, per-candidate re-voxelization,
relation node features — ``models/attribute_module.py:42-81``,
``models/relation_module.py:38-78``) happens here, in the loader's workers,
so the card sees one padded batch of static shapes.

What the copy leaves out: the TPU band metadata (window starts, the
``up8`` bands and their drop counters) and the switch of row order.  Voxel
rows are always in raster order, the order the JAX package's
``pallas_conv=True`` selects, so the port's ``collate`` equals the JAX
package's under that flag on every key the port reads
(``tests/test_torch_host_pipeline.py``).

All per-sample voxel arrays occupy uniform blocks of ``cap`` rows, so the
leading dimension of every array is a multiple of the batch size.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from instancerefer_tpu_torch.ops import voxelize as V

MEAN_COLOR_RGB = np.array([109.8, 97.2, 83.8])  # lib/dataset.py:22


@contextlib.contextmanager
def _phase(timings: Optional[Dict[str, float]], name: str):
    """Add the wall-clock seconds of the enclosed block to ``timings[name]``:
    the phases of ``pad_sample`` measured inside the real call, so they sum
    to at most its total (``scripts/bench_host_pipeline.phase_split``).
    ``timings`` None does nothing."""
    if timings is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        timings[name] = timings.get(name, 0.0) + (time.perf_counter() - t0)


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """Static capacities of a padded batch (all shapes derive from these)."""

    max_tokens: int = 126  # CONF.TRAIN.MAX_DES_LEN (lib/config.py:74)
    # collate rounds the batch's language grid up to the smallest multiple
    # of lang_bucket covering the batch's longest description (capped at
    # max_tokens); 0 keeps the full grid.  The packed GRU gives the same
    # result on any grid.
    lang_bucket: int = 0
    max_instances: int = 128  # MAX_NUM_OBJ (lib/dataset.py:21)
    max_candidates: int = 16
    num_stages: int = 5
    # per-sample voxel row budgets per pyramid stage
    scene_caps: Sequence[int] = (20480, 8192, 4096, 2048, 1024)
    inst_caps: Sequence[int] = (4096, 2048, 1024, 512, 256)
    num_classes: int = 18
    feat_dim: int = 7  # xyz + rgb + height (train.py:74-75 channel arithmetic)

    def bucketed_tokens(self, tmax: int) -> int:
        """Language-grid length for a batch whose longest sequence is
        ``tmax``: the smallest ``lang_bucket`` multiple covering it, capped
        at ``max_tokens`` (the full grid when bucketing is off)."""
        if not self.lang_bucket:
            return self.max_tokens
        return min(self.max_tokens, -(-max(int(tmax), 1) // self.lang_bucket) * self.lang_bucket)


def compute_height_feature(point_cloud: np.ndarray) -> np.ndarray:
    """z - floor height; floor = 0.99th percentile of z (lib/dataset.py:120-123
    — the reference passes 0.99 to np.percentile, i.e. the 0.99th
    percentile ≈ the floor, a quirk kept here)."""
    floor = np.percentile(point_cloud[:, 2], 0.99)
    return point_cloud[:, 2] - floor


def random_sampling(points: np.ndarray, n: int, rng: np.random.Generator):
    """utils/pc_utils.py:32-40: choice with replacement iff fewer points."""
    replace = points.shape[0] < n
    idx = rng.choice(points.shape[0], n, replace=replace)
    return points[idx], idx


@dataclasses.dataclass
class CoreSample:
    """Unpadded per-annotation sample (what lib/dataset.py __getitem__ builds)."""

    lang_feat: np.ndarray  # [T, 300]
    lang_len: int
    object_cat: int
    point_cloud: np.ndarray  # [N, 7]
    instance_points: List[np.ndarray]  # Ki x [1024, 7]
    instance_class: List[int]
    instance_obbs: List[np.ndarray]  # Ki x [7]
    ref_center_label: np.ndarray  # [3]
    ref_size_class_label: int
    ref_size_residual_label: np.ndarray  # [3]
    unique_multiple: int
    object_id: int
    ann_id: int
    scan_idx: int
    ref_target: Optional[np.ndarray] = None  # [Ki] 0/1 (gt instance marker)
    # candidate-filter class; defaults to object_cat (use_gt_lang=True).  The
    # use_gt_lang=False path overrides it with the language classifier's
    # prediction (models/attribute_module.py:93-97 semantics).
    filter_class: Optional[int] = None


def _overflow(counts: Sequence[int], caps: Sequence[int]) -> np.float32:
    """The largest fraction of a stage's rows that its cap cut off."""
    return np.float32(max(max(0, n - cap) / max(n, 1) for n, cap in zip(counts, caps)))


def build_scene_block(
    point_cloud: np.ndarray, spec: BatchSpec, voxel_size_glp: float = 0.05,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, np.ndarray]:
    """The scene-level half of ``pad_sample``: voxelize the full scene at
    ``voxel_size_glp`` (lib/dataset.py:256-261), build the padded conv
    pyramid, and the point extent.

    A pure function of (point_cloud, spec): when the point cloud is the same
    for every annotation of a scene (``static_scene_sampling``), the block is
    shared (``ScannetReferenceDataset.cached_scene_block``).  Callers treat
    the returned arrays as immutable (collate copies, never mutates).
    ``timings``: as ``pad_sample``'s.
    """
    with _phase(timings, "scene_quantize"):
        coords, feats = V.quantize(point_cloud[:, :3], point_cloud[:, : spec.feat_dim],
                                   voxel_size_glp)
    with _phase(timings, "scene_pyramid"):
        stages, counts = V.build_pyramid_padded([coords], [0], spec.scene_caps)
    out = {"scene_overflow": _overflow(counts, spec.scene_caps)}
    out.update(_pack_pyramid(stages, feats.astype(np.float32), spec.scene_caps, "scene",
                             spec.feat_dim, timings))
    with _phase(timings, "sample_misc"):
        out["point_min"], out["point_max"] = V.point_minmax3(point_cloud)
    return out


def pad_sample(
    core: CoreSample,
    spec: BatchSpec,
    voxel_size_ap: float = 0.02,
    voxel_size_glp: float = 0.05,
    scene_block: Optional[Dict[str, np.ndarray]] = None,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, np.ndarray]:
    """CoreSample -> per-sample padded arrays (local voxel-row indices).

    ``scene_block``: a precomputed ``build_scene_block`` result for this
    sample's point cloud (the scene-block cache's hit path); None recomputes.
    ``timings``: a dict that gathers the seconds of the phases, under the
    JAX package's names (``scene_quantize``, ``scene_pyramid``,
    ``scene_inverse``, ``inst_quantize``, ``inst_pyramid``,
    ``inst_inverse``, ``sample_misc``; the port builds no band metadata);
    None times nothing and gives the same arrays.
    """
    t = spec.max_tokens
    m = spec.max_instances
    cmax = spec.max_candidates

    out: Dict[str, np.ndarray] = {}
    with _phase(timings, "sample_misc"):
        lang_feat = np.zeros((t, 300), np.float32)
        lang_feat[: core.lang_feat.shape[0]] = core.lang_feat[:t]
        out["lang_feat"] = lang_feat
        out["lang_len"] = np.int32(min(core.lang_len, t))
        out["object_cat"] = np.int32(core.object_cat)

        k = min(len(core.instance_points), m)
        inst_mask = np.zeros(m, bool)
        inst_mask[:k] = True
        inst_class = np.zeros(m, np.int32)
        inst_obbs = np.zeros((m, 7), np.float32)
        node_feat = np.zeros((m, spec.feat_dim), np.float32)
        for i in range(k):
            inst_class[i] = core.instance_class[i]
            inst_obbs[i] = core.instance_obbs[i]
            # relation node feature: mean point feature, xyz <- obb center
            # (models/relation_module.py:66-69)
            mean_feat = core.instance_points[i].mean(0).astype(np.float32)
            mean_feat[:3] = core.instance_obbs[i][:3]
            node_feat[i] = mean_feat[: spec.feat_dim]
        out["instance_mask"] = inst_mask
        out["instance_class"] = inst_class
        out["instance_obbs"] = inst_obbs
        out["instance_node_feat"] = node_feat

        # ---- candidates: instances whose class == filter class (GT object
        # class under use_gt_lang=True; the language prediction otherwise)
        fclass = core.object_cat if core.filter_class is None else core.filter_class
        matching = [i for i in range(k) if inst_class[i] == fclass]
        # matching instances beyond the max_instances cap are also candidate drops
        total_match = len(matching) + sum(1 for c in core.instance_class[k:] if int(c) == fclass)
        cand_idx = matching[:cmax]
        num_cand = len(cand_idx)
        # candidate-capacity overflow: the reference keeps every filtered
        # candidate (models/attribute_module.py:42-81); a truncation here can
        # drop the GT instance, so it is reported like the voxel caps' overflow
        out["cand_overflow"] = np.float32(max(0, total_match - num_cand) / max(total_match, 1))
        cand_mask = np.zeros(cmax, bool)
        cand_mask[:num_cand] = True
        cand_slot = np.zeros(cmax, np.int32)
        cand_slot[:num_cand] = cand_idx
        pred_obb = np.zeros((cmax, 7), np.float32)
        pred_obb[:num_cand] = inst_obbs[cand_idx]
        out["cand_mask"] = cand_mask
        out["cand_slot"] = cand_slot
        out["pred_obb_batch"] = pred_obb

    # ---- instance voxel pyramid: only when >=2 candidates (the reference
    # never runs the encoder otherwise — models/attribute_module.py:75-76 —
    # which also keeps BatchNorm statistics identical)
    group_coords, inst_feat_rows = [], []
    if num_cand >= 2:
        with _phase(timings, "inst_quantize"):
            for i in cand_idx:
                pts = core.instance_points[i]
                coords, feats = V.quantize(pts[:, :3], pts[:, : spec.feat_dim], voxel_size_ap)
                group_coords.append(coords)
                inst_feat_rows.append(feats.astype(np.float32))
    with _phase(timings, "inst_pyramid"):
        inst_stages, inst_counts = V.build_pyramid_padded(
            group_coords, range(len(group_coords)), spec.inst_caps)
    inst_feats = (
        np.concatenate(inst_feat_rows, axis=0)
        if inst_feat_rows
        else np.zeros((0, spec.feat_dim), np.float32)
    )
    # overflow across all stages: deeper stages can bust their caps even
    # when stage 0 fits
    out["inst_overflow"] = _overflow(inst_counts, spec.inst_caps)
    out.update(_pack_pyramid(inst_stages, inst_feats, spec.inst_caps, "inst", spec.feat_dim,
                             timings))

    # ---- scene voxel pyramid at voxel_size_glp (lib/dataset.py:256-261)
    out.update(
        build_scene_block(core.point_cloud, spec, voxel_size_glp, timings)
        if scene_block is None
        else scene_block
    )

    with _phase(timings, "sample_misc"):
        out["ref_center_label"] = core.ref_center_label.astype(np.float32)
        out["ref_heading_class_label"] = np.int32(0)
        out["ref_heading_residual_label"] = np.int32(0)
        out["ref_size_class_label"] = np.int32(core.ref_size_class_label)
        out["ref_size_residual_label"] = core.ref_size_residual_label.astype(np.float32)
        out["unique_multiple"] = np.int32(core.unique_multiple)
        out["object_id"] = np.int32(core.object_id)
        out["ann_id"] = np.int32(core.ann_id)
        out["scan_idx"] = np.int32(core.scan_idx)
    return out


def _pack_pyramid(
    stages: List[V.StageArrays],
    feats: np.ndarray,
    caps: Sequence[int],
    prefix: str,
    feat_dim: int,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, np.ndarray]:
    """Padded stages (``build_pyramid_padded``) -> the per-sample arrays,
    with each down map's inverse (``uprow``/``upk``, from which
    ``data/host.batch_to_torch`` builds the down conv's ``up8``; timed as
    ``{prefix}_inverse``)."""
    out: Dict[str, np.ndarray] = {}
    n0 = min(len(feats), caps[0])
    f = np.zeros((caps[0], feat_dim), np.float32)
    f[:n0] = feats[:n0]
    out[f"{prefix}_feats"] = f
    for s, st in enumerate(stages):
        out[f"{prefix}_coords_{s}"] = st.coords
        out[f"{prefix}_owner_{s}"] = st.owner
        out[f"{prefix}_nbr3_{s}"] = st.nbr3
        if s > 0:
            out[f"{prefix}_down_{s}"] = st.down
            with _phase(timings, f"{prefix}_inverse"):
                out[f"{prefix}_uprow_{s}"], out[f"{prefix}_upk_{s}"] = V.invert_down(
                    st.down, caps[s - 1])
    return out


def collate(
    samples: List[Dict[str, np.ndarray]], spec: BatchSpec, lang_grid: Optional[int] = None,
    pool=None,
) -> Dict[str, np.ndarray]:
    """Stack per-sample arrays; flatten voxel blocks with index offsets.

    The flat layout gives every voxel array a leading dim of ``B * cap`` with
    sample ``b`` owning rows ``[b*cap, (b+1)*cap)``; neighbor maps get the
    same offset (padding -1 preserved); owners become global ids
    (scene: batch index, instance: ``b * max_candidates + local_candidate``).

    ``lang_grid`` overrides the bucketed language-grid length (a rank's
    loader takes it from the global batch, so every rank collates the same
    T); None derives it from this batch.

    ``pool``: optional ThreadPoolExecutor for the per-key memory passes
    (``np.copyto`` releases the GIL, so keys concatenate in parallel).  It
    must not be a pool whose workers can themselves be running this collate
    (deadlock); ``PaddedLoader`` owns a dedicated one.
    """
    b = len(samples)
    cmax = spec.max_candidates
    out: Dict[str, np.ndarray] = {}

    pyramid_keys = {
        k for k in samples[0] if k.startswith(("scene_", "inst_")) and not k.endswith("_overflow")
    }
    for k in samples[0]:
        if k not in pyramid_keys:
            out[k] = np.stack([s[k] for s in samples])

    if spec.lang_bucket:
        # GRU outputs past each sample's length are zeros either way, so
        # slicing the grid to the batch's bucket is exact
        t_b = lang_grid if lang_grid is not None else spec.bucketed_tokens(
            int(out["lang_len"].max()))
        out["lang_feat"] = np.ascontiguousarray(out["lang_feat"][:, :t_b])

    def cat_off(key, off_per_sample, signed=True):
        """Concatenate the samples' ``key`` arrays, adding ``bi * off`` to
        the index values (rows of the referenced stage); ``signed`` keeps -1
        sentinels.  One copy into the output and one masked in-place add per
        sample."""
        a0 = samples[0][key]
        n = a0.shape[0]
        dst = np.empty((b * n,) + a0.shape[1:], a0.dtype)
        for bi, s in enumerate(samples):
            a = s[key]
            d = dst[bi * n : (bi + 1) * n]
            np.copyto(d, a)
            off = bi * off_per_sample
            if off:
                if signed:
                    np.add(d, a0.dtype.type(off), out=d, where=a >= 0)
                else:
                    d += a0.dtype.type(off)
        return dst

    def owner_job(prefix, s_i):
        ow = np.stack([s[f"{prefix}_owner_{s_i}"] for s in samples])
        if prefix == "scene":
            ids = np.broadcast_to(np.arange(b, dtype=np.int32)[:, None], ow.shape)
        else:
            ids = ow + (np.arange(b, dtype=np.int32) * cmax)[:, None]
        return np.where(ow >= 0, ids, -1).reshape(-1)

    def concat(key):
        return functools.partial(np.concatenate, [s[key] for s in samples])

    # independent per-key jobs, so a pool can run them concurrently
    jobs: List = []
    for prefix, caps in (("scene", spec.scene_caps), ("inst", spec.inst_caps)):
        jobs.append((f"{prefix}_feats", concat(f"{prefix}_feats")))
        for s_i, cap in enumerate(caps):
            jobs.append((f"{prefix}_coords_{s_i}", concat(f"{prefix}_coords_{s_i}")))
            jobs.append((f"{prefix}_owner_{s_i}", functools.partial(owner_job, prefix, s_i)))
            jobs.append((f"{prefix}_nbr3_{s_i}",
                         functools.partial(cat_off, f"{prefix}_nbr3_{s_i}", cap)))
            if s_i > 0:
                prev_cap = caps[s_i - 1]
                jobs += [
                    (f"{prefix}_down_{s_i}",
                     functools.partial(cat_off, f"{prefix}_down_{s_i}", prev_cap)),
                    # the inverse maps index this stage's rows
                    (f"{prefix}_uprow_{s_i}",
                     functools.partial(cat_off, f"{prefix}_uprow_{s_i}", cap)),
                    (f"{prefix}_upk_{s_i}", concat(f"{prefix}_upk_{s_i}")),
                ]
    if pool is None:
        for key, fn in jobs:
            out[key] = fn()
    else:
        futs = [(key, pool.submit(fn)) for key, fn in jobs]
        for key, f in futs:
            out[key] = f.result()
    return out


def finalize_batch(
    samples: List[Dict[str, np.ndarray]], batch_size: int, spec: BatchSpec,
    lang_grid: Optional[int] = None, pool=None,
) -> Dict[str, np.ndarray]:
    """Collate, padding a partial batch to the static ``batch_size`` by
    repeating the last sample.

    ``sample_valid`` marks the real rows, and the duplicated samples' voxel
    owners are cleared to -1 — their rows become padding, so masked
    BatchNorm statistics and pooling match a genuinely smaller batch exactly
    (the loss/eval means already divide by the valid count; reference
    parity: torch trains on the true smaller final batch,
    ``scripts/train.py:61-68`` + ``lib/loss_helper.py:263``).
    """
    samples = list(samples)
    valid = len(samples)
    assert 0 < valid <= batch_size, (valid, batch_size)
    while len(samples) < batch_size:
        samples.append(samples[-1])
    out = collate(samples, spec, lang_grid=lang_grid, pool=pool)
    mask = np.zeros(batch_size, bool)
    mask[:valid] = True
    out["sample_valid"] = mask
    if valid < batch_size:
        for prefix, caps in (("scene", spec.scene_caps), ("inst", spec.inst_caps)):
            for s, cap in enumerate(caps):
                out[f"{prefix}_owner_{s}"][valid * cap:] = -1
    return out
