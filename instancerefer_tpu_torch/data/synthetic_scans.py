"""Synthetic ScanNet scans in the raw layouts the exporter reads
(``data/prepare.py``), for the tests and the card's smoke run.

A scan is a room in a mesh: a floor, four walls and furniture boxes, each
surface a grid of vertices cut into two triangles a cell.  Per scan, in
ScanNet's own formats:

  {root}/scans/{scan}/{scan}_vh_clean_2.ply                 binary_little_endian:
      float x y z, uchar red green blue alpha; list uchar int vertex_indices
  {root}/scans/{scan}/{scan}_vh_clean_2.0.010000.segs.json  {"segIndices": [...]}
  {root}/scans/{scan}/{scan}.aggregation.json                {"segGroups": [...]}
  {root}/scans/{scan}/{scan}.txt                             axisAlignment = (16 numbers)
  {root}/PointGroupInst/{split}/{scan}.txt                   "pred_mask/{file} class score" lines
  {root}/PointGroupInst/{split}/pred_mask/{scan}_{i}.txt     one 0/1 a vertex
  {root}/meta_data/scannetv2-labels.combined.tsv, scannetv2_{split}.txt

``write_fake_scanrefer`` writes a prepared ScanRefer root instead (the
layout ``data/dataset.py`` reads), drawn as ``data/synthetic.py`` draws a
scene.

The mesh is written in the scan's raw frame: the aligned room moved by the
inverse of a rotation about z and a translation, whose matrix the ``.txt``
holds.  Segments are 8 x 8-vertex tiles of the surfaces, their ids spread
out as ScanNet's are; every object's id is contiguous from 0, as in
ScanNet; a few vertices lie in no face and no object.  Files are written
from numpy arrays in bulk (a scan of 150 000 vertices in well under a
second).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

# (nyu40 id, nyu40 class) of 18 furniture classes (the tsv's columns 4 and
# 7); the last is not one of the 18 class names and maps to "others"
NYU40 = ((3, "cabinet"), (4, "bed"), (5, "chair"), (6, "sofa"), (7, "table"), (8, "door"),
         (9, "window"), (10, "bookshelf"), (11, "picture"), (12, "counter"), (14, "desk"),
         (16, "curtain"), (24, "refrigerator"), (28, "shower curtain"), (33, "toilet"),
         (34, "sink"), (36, "bathtub"), (35, "lamp"))
STRUCTURE = ((1, "wall"), (2, "floor"))
TILE = 8  # a segment's side, in grid vertices
ISOLATED = 17  # vertices in no face
FIRST_BOX = 5  # objects 0-4 are the floor and the walls
_VERTEX = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"), ("green", "u1"),
                    ("blue", "u1"), ("alpha", "u1")])
_FACE = np.dtype([("n", "u1"), ("v", "<i4", (3,))])


def write_label_tsv(path: str) -> None:
    """The combined-labels tsv of ``NYU40`` and ``STRUCTURE``: raw category
    = nyu40 class name."""
    with open(path, "w") as f:
        f.write("id\traw_category\tcategory\tcount\tnyu40id\teigen13id\tnyuClass\tnyu40class\n")
        for i, (nyu, name) in enumerate(STRUCTURE + NYU40):
            f.write(f"{i + 1}\t{name}\t{name}\t1\t{nyu}\t0\t{name}\t{name}\n")


def _patch(origin, u, v, nu: int, nv: int):
    """A grid of nu x nv vertices spanning ``origin + [0, 1] u + [0, 1] v``:
    (vertices [nu * nv, 3], the two triangles of every cell [2 (nu-1)(nv-1),
    3], the other diagonal's two [same], segment tile [nu * nv])."""
    a, b = np.meshgrid(np.linspace(0, 1, nu), np.linspace(0, 1, nv), indexing="ij")
    xyz = origin + a.reshape(-1, 1) * u + b.reshape(-1, 1) * v
    i, j = np.meshgrid(np.arange(nu - 1), np.arange(nv - 1), indexing="ij")
    p00 = (i * nv + j).reshape(-1)
    p01, p10, p11 = p00 + 1, p00 + nv, p00 + nv + 1
    tris = np.concatenate([np.stack([p00, p10, p11], 1), np.stack([p00, p11, p01], 1)])
    other = np.concatenate([np.stack([p00, p10, p01], 1), np.stack([p10, p11, p01], 1)])
    tiles_v = -(-nv // TILE)
    tile = ((a * (nu - 1)).round().astype(int) // TILE * tiles_v
            + (b * (nv - 1)).round().astype(int) // TILE).reshape(-1)
    return xyz, tris, other, tile


def _grid(n: int, lu: float, lv: float) -> Tuple[int, int]:
    """The grid of about n vertices over a lu x lv rectangle."""
    nu = max(2, int(round((n * lu / lv) ** 0.5)))
    return nu, max(2, int(n // nu))


def make_scan(rng: np.random.Generator, num_verts: int, num_faces: int, num_objects: int):
    """A room in the aligned frame: (xyz [V, 3] float64, rgb [V, 3] uint8,
    faces [F, 3] int64, segment of each vertex [V], object of each vertex
    [V] (-1: none), objects: a list of (label name, nyu40 id, segment
    ids)).  Objects: the floor, 4 walls, then ``num_objects`` boxes."""
    room = rng.uniform([5.0, 4.0, 2.4], [8.0, 7.0, 3.0])
    kinds = rng.integers(len(NYU40), size=num_objects)
    budget = num_verts - ISOLATED
    # (origin, u, v, vertex budget, object index)
    surfaces = [(np.zeros(3), np.array([room[0], 0, 0]), np.array([0, room[1], 0]),
                 0.2 * budget, 0)]
    corners = ((0, 0), (room[0], 0), (room[0], room[1]), (0, room[1]), (0, 0))
    for w in range(4):
        a, b = np.array([*corners[w], 0.0]), np.array([*corners[w + 1], 0.0])
        surfaces.append((a, b - a, np.array([0, 0, room[2]]), 0.05 * budget, 1 + w))
    for k in range(num_objects):
        size = rng.uniform([0.3, 0.3, 0.3], [1.6, 1.2, 1.5])
        lo = np.append(rng.uniform(0.2, room[:2] - size[:2] - 0.2), 0.0)
        ex, ey, ez = np.diag(size)
        share = 0.6 * budget / num_objects / 5
        for origin, u, v in ((lo + ez, ex, ey), (lo, ex, ez), (lo + ey, ex, ez), (lo, ey, ez),
                             (lo + ex, ey, ez)):
            surfaces.append((origin, u, v, share, FIRST_BOX + k))
    xyz, seg, faces, spare, owner = [], [], [], [], []
    start = seg_base = 0
    for origin, u, v, n, obj in surfaces:
        nu, nv = _grid(n, np.linalg.norm(u), np.linalg.norm(v))
        pts, tris, other, tile = _patch(origin, u, v, nu, nv)
        xyz.append(pts)
        seg.append(seg_base + tile)
        faces.append(tris + start)
        spare.append(other + start)
        owner.append(np.full(tile.max() + 1, obj))
        start += len(pts)
        seg_base += tile.max() + 1
    extra = num_verts - start
    if extra < ISOLATED:
        raise ValueError(f"{num_verts} vertices leave no room for the isolated ones")
    xyz.append(rng.uniform([0, 0, 0], room, size=(extra, 3)))
    seg.append(np.full(extra, seg_base))
    owner.append(np.full(1, -1))
    xyz, seg, owner = np.concatenate(xyz), np.concatenate(seg), np.concatenate(owner)
    faces, spare = np.concatenate(faces), np.concatenate(spare)
    if len(faces) >= num_faces:
        faces = faces[:num_faces]
    else:
        pick = rng.choice(len(spare), num_faces - len(faces), replace=False)
        faces = np.concatenate([faces, spare[np.sort(pick)]])
    # ScanNet's segment ids are sparse
    seg_ids = np.sort(rng.choice(50 * (seg_base + 1), seg_base + 1, replace=False))
    objects = [("floor", 2, [])] + [("wall", 1, []) for _ in range(4)]
    objects += [(NYU40[kind][1], NYU40[kind][0], []) for kind in kinds]
    for s, obj in enumerate(owner):
        if obj >= 0:
            objects[obj][2].append(int(seg_ids[s]))
    colors = rng.integers(40, 216, size=(len(objects), 3))
    vert_obj = owner[seg]
    rgb = np.clip(colors[vert_obj] + rng.integers(-30, 31, size=(num_verts, 3)), 0, 255)
    return xyz, rgb.astype(np.uint8), faces.astype(np.int64), seg_ids[seg], vert_obj, objects


def write_ply(path: str, xyz: np.ndarray, rgb: np.ndarray, faces: np.ndarray) -> None:
    """A ScanNet ``_vh_clean_2.ply`` (binary little endian)."""
    vert = np.empty(len(xyz), _VERTEX)
    for i, k in enumerate("xyz"):
        vert[k] = xyz[:, i]
    for i, k in enumerate(("red", "green", "blue")):
        vert[k] = rgb[:, i]
    vert["alpha"] = 255
    face = np.empty(len(faces), _FACE)
    face["n"] = 3
    face["v"] = faces
    header = ("ply\nformat binary_little_endian 1.0\ncomment synthetic scan\n"
              f"element vertex {len(xyz)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\nproperty uchar blue\n"
              "property uchar alpha\n"
              f"element face {len(faces)}\n"
              "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vert.tobytes())
        f.write(face.tobytes())


def _alignment(rng: np.random.Generator) -> np.ndarray:
    """A rotation about z and a translation, as ScanNet's axisAlignment."""
    a = rng.uniform(-np.pi, np.pi)
    m = np.eye(4)
    m[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    m[:3, 3] = rng.uniform([-5.0, -5.0, -0.2], [5.0, 5.0, 0.2])
    return m


def write_scannet_scans(root: str, scans: Sequence[str], rng: np.random.Generator, *,
                        split: str = "train", num_verts: int = 150000, num_faces: int = 300000,
                        num_objects: Tuple[int, int] = (12, 20), num_masks: int = 12,
                        ) -> Dict[str, List[Tuple[int, str]]]:
    """Write ``scans`` under ``root`` (layout in the module docstring), with
    the split file of ``split`` and PointGroup's masks of the first
    ``num_masks`` boxes of each scan (a mask misses ~5% of its object's
    vertices); returns {scan: [(objectId, name) of its boxes]}."""
    scan_dir = os.path.join(root, "scans")
    meta = os.path.join(root, "meta_data")
    pg = os.path.join(root, "PointGroupInst", split)
    os.makedirs(meta, exist_ok=True)
    os.makedirs(os.path.join(pg, "pred_mask"), exist_ok=True)
    write_label_tsv(os.path.join(meta, "scannetv2-labels.combined.tsv"))
    with open(os.path.join(meta, f"scannetv2_{split}.txt"), "w") as f:
        f.write("".join(f"{s}\n" for s in scans))
    boxes = {}
    for scan in scans:
        out = os.path.join(scan_dir, scan)
        os.makedirs(out, exist_ok=True)
        xyz, rgb, faces, seg, vert_obj, objects = make_scan(
            rng, num_verts, num_faces, int(rng.integers(num_objects[0], num_objects[1] + 1)))
        align = _alignment(rng)
        raw = (xyz - align[:3, 3]) @ align[:3, :3]  # the inverse of the alignment
        write_ply(os.path.join(out, f"{scan}_vh_clean_2.ply"), raw, rgb, faces)
        with open(os.path.join(out, f"{scan}_vh_clean_2.0.010000.segs.json"), "w") as f:
            json.dump({"sceneId": scan, "segIndices": seg.tolist()}, f)
        groups = [{"id": i, "objectId": i, "segments": segs, "label": name}
                  for i, (name, _, segs) in enumerate(objects)]
        with open(os.path.join(out, f"{scan}.aggregation.json"), "w") as f:
            json.dump({"sceneId": scan, "segGroups": groups}, f)
        with open(os.path.join(out, f"{scan}.txt"), "w") as f:
            f.write("axisAlignment = " + " ".join(f"{v:f}" for v in align.reshape(-1)) + "\n")
            f.write(f"numVertices = {num_verts}\nsceneType = Living room / Lounge\n")
        boxes[scan] = [(i, name) for i, (name, _, _) in enumerate(objects) if i >= FIRST_BOX]
        lines = []
        for m, obj in enumerate(range(FIRST_BOX, min(FIRST_BOX + num_masks, len(objects)))):
            mask = (vert_obj == obj) & (rng.random(num_verts) > 0.05)
            name = f"pred_mask/{scan}_{m:03d}.txt"
            with open(os.path.join(pg, name), "wb") as f:
                f.write(np.array([b"0\n", b"1\n"])[mask.astype(int)].tobytes())
            lines.append(f"{name} {objects[obj][1]} {rng.uniform(0.5, 1.0):.4f}\n")
        with open(os.path.join(pg, f"{scan}.txt"), "w") as f:
            f.write("".join(lines))
    return boxes


# the words of the synthetic descriptions, besides the objects' names
WORDS = ("the", "a", "is", "it", "this", "that", "of", "to", "in", "on", "with", "and",
         "next", "near", "left", "right", "front", "behind", "corner", "room", "wall",
         "brown", "white", "black", "small", "large", "wooden", "square", "round", "facing")
# ScanRefer-layout scenes of each split: 8 train and 4 val scenes
SCANREFER_SCENES = {"train": range(0, 8), "val": range(8, 12)}
# an instance's class slot in its scene: three pairs share a class, six
# instances are alone in theirs
_SLOTS = (0, 0, 1, 1, 2, 2, 3, 4, 5, 6, 7, 8)


def write_glove(root: str, rng: np.random.Generator) -> None:
    """A GloVe pickle of ``WORDS``, the class names' words and ``unk``."""
    vocab = set(WORDS) | {w for _, name in NYU40 for w in name.split()} | {"unk"}
    with open(os.path.join(root, "glove.p"), "wb") as f:
        pickle.dump({w: rng.normal(size=300).astype(np.float32) for w in sorted(vocab)}, f)


def description(rng: np.random.Generator, scene_id: str, obj: int, name: str, ann_id: int):
    """A ScanRefer entry: 6-39 random ``WORDS`` with the object's name."""
    tokens = [str(w) for w in rng.choice(WORDS, size=int(rng.integers(6, 40)))]
    tokens[1:1] = name.split()
    return {"scene_id": scene_id, "object_id": str(obj), "object_name": name.replace(" ", "_"),
            "ann_id": str(ann_id), "token": tokens, "description": " ".join(tokens)}


def write_fake_scanrefer(root: str, rng: np.random.Generator, batches: Mapping[str, int],
                         batch_size: int, *,
                         scenes: Mapping[str, Sequence[int]] = SCANREFER_SCENES,
                         num_points: int = 40000, points_per_instance: int = 256,
                         extent: float = 4.0) -> None:
    """A prepared ScanRefer root under ``root``: per-scene PointGroup npys,
    the label tsv, a GloVe pickle and ``ScanRefer_filtered_{split}.json``
    of ``batches[split] * batch_size`` descriptions over the split's
    ``scenes``.  A scene is drawn as ``data/synthetic.py`` draws one: an
    ``extent`` x ``extent`` x 0.1 m floor of unlabelled points and 12 boxes
    of ``points_per_instance`` points, ``num_points`` in all; of its 12
    instances three pairs share a class and six are alone in theirs.  No
    multiview features (the port reads them only with ``use_multiview``)."""
    pg = os.path.join(root, "scannet", "pointgroup_data")
    meta = os.path.join(root, "scannet", "meta_data")
    os.makedirs(pg)
    os.makedirs(meta)
    n_inst = len(_SLOTS)
    n_floor = num_points - n_inst * points_per_instance
    if n_floor < 0:
        raise ValueError(f"{num_points} points do not hold {n_inst} x {points_per_instance}")
    objects = {}
    for si in sorted({si for ids in scenes.values() for si in ids}):
        scene_id = f"scene{si:04d}_00"
        classes = rng.permutation(len(NYU40))[:max(_SLOTS) + 1]
        xyz = [rng.uniform([0, 0, 0], [extent, extent, 0.1], size=(n_floor, 3))]
        ins, sem = [np.zeros(n_floor, np.int64)], [np.ones(n_floor, np.int64)]  # nyu40 1: wall
        boxes = []
        for i, slot in enumerate(_SLOTS):
            nyu = NYU40[classes[slot]][0]
            center = rng.uniform(0.5, extent - 0.5, size=3)
            center[2] = rng.uniform(0.2, 1.5)
            pts = center + rng.uniform(-0.5, 0.5, size=(points_per_instance, 3)) \
                * rng.uniform(0.2, 0.9, size=3)
            xyz.append(pts)
            ins.append(np.full(points_per_instance, i + 1, np.int64))
            sem.append(np.full(points_per_instance, nyu, np.int64))
            mn, mx = pts.min(0), pts.max(0)
            boxes.append(np.concatenate([(mn + mx) / 2, mx - mn, [nyu, i]]))
        xyz = np.concatenate(xyz)
        nrm = rng.normal(size=xyz.shape)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        verts = np.concatenate([xyz, rng.uniform(0, 255, size=xyz.shape), nrm], 1)
        np.save(os.path.join(pg, f"{scene_id}_aligned_vert.npy"), verts.astype(np.float32))
        np.save(os.path.join(pg, f"{scene_id}_ins_label_pg.npy"), np.concatenate(ins))
        np.save(os.path.join(pg, f"{scene_id}_sem_label_pg.npy"), np.concatenate(sem))
        np.save(os.path.join(pg, f"{scene_id}_aligned_bbox.npy"), np.stack(boxes))
        objects[si] = [NYU40[classes[slot]][1] for slot in _SLOTS]

    write_label_tsv(os.path.join(meta, "scannetv2-labels.combined.tsv"))
    write_glove(root, rng)
    for split, ids in scenes.items():
        anns, seen = [], {}
        for _ in range(batches[split] * batch_size):
            si = int(rng.choice(ids))
            obj = int(rng.integers(n_inst))
            ann_id = seen[si, obj] = seen.get((si, obj), -1) + 1
            anns.append(description(rng, f"scene{si:04d}_00", obj, objects[si][obj], ann_id))
        with open(os.path.join(root, f"ScanRefer_filtered_{split}.json"), "w") as f:
            json.dump(anns, f)
