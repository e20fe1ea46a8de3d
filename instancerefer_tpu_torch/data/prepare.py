"""ScanNet exporter: raw scans + PointGroup outputs -> per-scene npy files.

The port's counterpart of ``instancerefer_tpu/data/prepare.py`` (reference
``data/scannet/prepare_data.py`` + ``load_scannet_data.py`` +
``scannet_utils.py``), writing the artifact set the dataset reads
(``data/dataset.py``), with the same names, shapes and dtypes:

  {scene}_vert.npy            [N, 9] float32  xyz rgb(0-255) normals
  {scene}_aligned_vert.npy    [N, 9] float32  axis-aligned via the scene's 4x4 matrix
  {scene}_sem_label.npy       [N]    uint32   nyu40 ids (GT)
  {scene}_ins_label.npy       [N]    uint32   1..#instances (GT)
  {scene}_sem_label_pg.npy    [N]    uint32   nyu40 ids (PointGroup predictions)
  {scene}_ins_label_pg.npy    [N]    uint32   1..#instances (PointGroup)
  {scene}_bbox.npy            [K, 8] float64  cx cy cz dx dy dz nyu40id objid
  {scene}_aligned_bbox.npy    [K, 8] float64

The files are parsed on the host (a minimal PLY reader, the json and tsv
files, PointGroup's mask files); the per-vertex arithmetic runs in torch on
``device``, the card unless the caller asks for the CPU:

* normals: every face's unit normal added to its three vertices in one
  float64 ``index_add_``, then normalized (float64 as the JAX package,
  whose ``np.add.at`` sums in another order: the normals may differ in the
  last float32 bit);
* the axis alignment, a float64 product stored as float32;
* the boxes: per-instance min / max in one ``scatter_reduce`` each, over
  the float32 coordinates, so a box equals the JAX package's wherever the
  coordinates do.

The label writes, the class filter and the 50 000-point subsample
(``np.random.default_rng(0)``) stay in numpy, so those files equal the JAX
package's bit for bit.

CLI: ``python -m instancerefer_tpu_torch.scripts.prepare_data --split train
--scannet_path ... --pointgroupinst_path ... --output_path ... [--device cpu]``
"""

from __future__ import annotations

import csv
import json
import os
import struct
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

MAX_NUM_POINT = 50000
# exclude wall (1), floor (2), ceiling (22)
OBJ_CLASS_IDS = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 23,
     24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40]
)
ARTIFACTS = ("vert", "aligned_vert", "sem_label", "ins_label", "sem_label_pg", "ins_label_pg",
             "bbox", "aligned_bbox")
PER_VERTEX = ARTIFACTS[:6]

_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def torch_device(device) -> torch.device:
    """``cuda`` (the default of the exporter; it needs a card) or ``cpu``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return device


def _read_uniform_list(f, count: int, prop) -> Optional[np.ndarray]:
    """The records of an element whose one property is a list, read in one
    ``np.frombuffer`` when every list has the first one's length: [count,
    n], int64 or float64 as the record-by-record read builds it.  None (and
    the file back where it was) otherwise."""
    start = f.tell()
    cc, csz = _PLY_TYPES[prop[1]]
    ic = _PLY_TYPES[prop[2]][0]
    head = f.read(csz)
    f.seek(start)
    if count == 0 or len(head) < csz:
        return None
    (n,) = struct.unpack("<" + cc, head)
    if n == 0:  # numpy makes empty lists float64, whatever their type
        return None
    rec = np.dtype([("n", "<" + cc), ("v", "<" + ic, (n,))])
    buf = f.read(rec.itemsize * count)
    if len(buf) == rec.itemsize * count:
        arr = np.frombuffer(buf, dtype=rec)
        if (arr["n"] == n).all():
            return arr["v"].astype(np.float64 if ic in "fd" else np.int64).reshape(count, n)
    f.seek(start)
    return None


def read_ply(path: str):
    """Minimal PLY reader (ascii + binary_little_endian) for mesh files.

    Returns {element_name: {prop_name: np.ndarray}}; list properties (faces)
    come back as an object array of int arrays or an [F, 3] int array when
    uniform.  A binary element whose one property is a list of uniform
    length (a triangle mesh's faces) is read in one ``np.frombuffer``; any
    other list element record by record.
    """
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply", "not a PLY file"
        fmt = None
        elements: List[Tuple[str, int, list]] = []
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("comment"):
                continue
            elif line.startswith("element"):
                _, name, count = line.split()
                elements.append((name, int(count), []))
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    elements[-1][2].append(("scalar", parts[1], parts[2]))
            elif line == "end_header":
                break

        out: Dict[str, Dict[str, np.ndarray]] = {}
        if fmt == "ascii":
            for name, count, props in elements:
                cols: Dict[str, list] = {p[-1]: [] for p in props}
                for _ in range(count):
                    vals = f.readline().decode("ascii").split()
                    i = 0
                    for p in props:
                        if p[0] == "scalar":
                            cols[p[2]].append(float(vals[i]))
                            i += 1
                        else:
                            n = int(vals[i])
                            cols[p[3]].append([float(v) for v in vals[i + 1 : i + 1 + n]])
                            i += 1 + n
                out[name] = {
                    k: np.array(v) for k, v in cols.items()
                }
            return out

        assert fmt == "binary_little_endian", f"unsupported PLY format {fmt}"
        for name, count, props in elements:
            fixed = all(p[0] == "scalar" for p in props)
            if fixed:
                fmt_str = "<" + "".join(_PLY_TYPES[p[1]][0] for p in props)
                rec = struct.calcsize(fmt_str)
                buf = f.read(rec * count)
                arr = np.frombuffer(
                    buf,
                    dtype=np.dtype(
                        [(p[2], "<" + _PLY_TYPES[p[1]][0]) for p in props]
                    ),
                )
                out[name] = {p[2]: np.array(arr[p[2]]) for p in props}
                continue
            if len(props) == 1:
                lists = _read_uniform_list(f, count, props[0])
                if lists is not None:
                    out[name] = {props[0][3]: lists}
                    continue
            cols = {p[-1]: [] for p in props}
            for _ in range(count):
                for p in props:
                    if p[0] == "scalar":
                        c, sz = _PLY_TYPES[p[1]]
                        (v,) = struct.unpack("<" + c, f.read(sz))
                        cols[p[2]].append(v)
                    else:
                        cc, csz = _PLY_TYPES[p[1]]
                        (n,) = struct.unpack("<" + cc, f.read(csz))
                        ic, isz = _PLY_TYPES[p[2]]
                        vals = struct.unpack("<" + ic * n, f.read(isz * n))
                        cols[p[3]].append(list(vals))
            out[name] = {
                k: (np.array(v) if v and all(len(x) == len(v[0]) for x in v)
                    else np.array(v, dtype=object))
                for k, v in cols.items()
            }
        return out


def normalize_v3(arr: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return arr / (torch.linalg.vector_norm(arr, dim=1) + eps)[:, None]


def compute_normal(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Per-vertex normals [N, 3] of ``vertices`` [N, 3] (float64) over
    ``faces`` [F, 3] (int64), on their device: the sum of the unit normals
    of the faces a vertex is in, normalized; 0 for a vertex in no face
    (scannet_utils.py:26-45 semantics)."""
    tris = vertices[faces]
    n = normalize_v3(torch.linalg.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]))
    normals = torch.zeros_like(vertices)
    normals.index_add_(0, faces.reshape(-1), n.repeat_interleave(3, dim=0))
    return normalize_v3(normals)


def read_label_mapping(path: str, label_from="raw_category", label_to="nyu40id"):
    mapping = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f, delimiter="\t"):
            mapping[row[label_from]] = int(row[label_to])
    return mapping


def read_aggregation(path: str):
    """aggregation json -> (object_id->segs, label->segs); ids 1-indexed."""
    object_id_to_segs: Dict[int, list] = {}
    label_to_segs: Dict[str, list] = {}
    with open(path) as f:
        data = json.load(f)
    for group in data["segGroups"]:
        object_id = group["objectId"] + 1
        object_id_to_segs[object_id] = group["segments"]
        label_to_segs.setdefault(group["label"], []).extend(group["segments"])
    return object_id_to_segs, label_to_segs


def read_segmentation(path: str):
    with open(path) as f:
        data = json.load(f)
    seg_indices = np.asarray(data["segIndices"])
    seg_to_verts: Dict[int, np.ndarray] = {}
    order = np.argsort(seg_indices, kind="stable")
    sorted_segs = seg_indices[order]
    bounds = np.flatnonzero(np.diff(sorted_segs)) + 1
    for chunk, seg in zip(
        np.split(order, bounds), sorted_segs[np.concatenate([[0], bounds])]
    ):
        seg_to_verts[int(seg)] = chunk
    return seg_to_verts, len(seg_indices)


def _axis_align_matrix(meta_file: str) -> Optional[np.ndarray]:
    with open(meta_file) as f:
        for line in f:
            if "axisAlignment" in line:
                vals = [float(x) for x in line.rstrip().strip("axisAlignment = ").split(" ")]
                return np.array(vals).reshape(4, 4)
    return None


def _instance_bboxes(xyz: torch.Tensor, instance_ids: torch.Tensor,
                     object_id_to_label_id: Dict[int, int], num_instances: int) -> np.ndarray:
    """[num_instances, 8] float64: row ``obj_id - 1`` holds the AABB of the
    points ``xyz`` [N, 3] (float32) whose ``instance_ids`` [N] (int64, 0 =
    none, on the same device) is ``obj_id``, its center and lengths computed
    in float32, then its nyu40 id and ``obj_id - 1``; an object with no
    point keeps a zero row."""
    if int(instance_ids.max()) > num_instances:
        raise ValueError(f"instance id {int(instance_ids.max())} beyond the "
                         f"{num_instances} objects of the aggregation")
    rows = num_instances + 1
    idx = instance_ids[:, None].expand(-1, 3)
    mn = xyz.new_zeros(rows, 3).scatter_reduce_(0, idx, xyz, "amin", include_self=False)
    mx = xyz.new_zeros(rows, 3).scatter_reduce_(0, idx, xyz, "amax", include_self=False)
    count = torch.bincount(instance_ids, minlength=rows)
    center, size = ((mn + mx) / 2)[1:].cpu().numpy(), (mx - mn)[1:].cpu().numpy()
    labels = np.zeros(rows - 1)
    for obj_id, label_id in object_id_to_label_id.items():
        labels[obj_id - 1] = label_id
    boxes = np.concatenate([center, size, labels[:, None],
                            np.arange(rows - 1, dtype=np.float64)[:, None]], axis=1)
    # an object with a vertex had a segment, so it has a label
    return np.where((count[1:] > 0).cpu().numpy()[:, None], boxes, 0.0)


def _read_pointgroup(pointgroup_dir: Optional[str], scene_id: Optional[str], num_verts: int):
    """(nyu40 ids, instance ids) [num_verts] uint32 of PointGroup's masks
    (prepare_data.py:144-151): the scene's list file in the first of
    ``train``/``val``/``test`` that has one, each line ``mask_path class
    score``; mask i writes i + 1, a later mask over an earlier one."""
    label_ids_pg = np.zeros(num_verts, np.uint32)
    instance_ids_pg = np.zeros(num_verts, np.uint32)
    if pointgroup_dir is None or scene_id is None:
        return label_ids_pg, instance_ids_pg
    list_file = None
    for split_dir in ("train", "val", "test"):
        cand = os.path.join(pointgroup_dir, split_dir, scene_id + ".txt")
        if os.path.exists(cand):
            list_file = cand
            break
    if list_file:
        base = os.path.dirname(list_file)
        with open(list_file) as f:
            for inst_id, line in enumerate(l.strip() for l in f if l.strip()):
                txt_path, cls, _ = line.split(" ")
                mask = np.loadtxt(os.path.join(base, txt_path))
                instance_ids_pg[mask != 0] = inst_id + 1
                label_ids_pg[mask != 0] = int(cls)
    return label_ids_pg, instance_ids_pg


def export_scene(
    mesh_file: str,
    agg_file: str,
    seg_file: str,
    meta_file: str,
    label_map_file: str,
    pointgroup_dir: Optional[str] = None,
    scene_id: Optional[str] = None,
    device="cuda",
    times: Optional[Dict[str, float]] = None,
):
    """One scene -> the artifact dict (prepare_data.py export semantics).
    ``times``, if given, receives the ms of the host's parse (the files and
    the label writes) and of the device's work (copies included) as
    ``parse`` and ``device``."""
    device = torch_device(device)
    t0 = time.perf_counter()
    ply = read_ply(mesh_file)
    label_map = read_label_mapping(label_map_file)
    align = _axis_align_matrix(meta_file) if os.path.exists(meta_file) else None

    v = ply["vertex"]
    mesh_vertices = np.zeros((len(v["x"]), 9), np.float32)
    for col, key in enumerate(("x", "y", "z", "red", "green", "blue")):
        mesh_vertices[:, col] = v[key]
    face_key = "vertex_indices" if "vertex_indices" in ply.get("face", {}) else "vertex_index"
    faces = np.asarray(ply["face"][face_key], dtype=np.int64) if "face" in ply else None

    agg = os.path.isfile(agg_file)
    if agg:
        object_id_to_segs, label_to_segs = read_aggregation(agg_file)
        seg_to_verts, num_verts = read_segmentation(seg_file)
        label_ids = np.zeros(num_verts, np.uint32)
        for label, segs in label_to_segs.items():
            label_id = label_map.get(label, 0)
            for seg in segs:
                label_ids[seg_to_verts[seg]] = label_id
        instance_ids = np.zeros(num_verts, np.uint32)
        object_id_to_label_id: Dict[int, int] = {}
        for object_id, segs in object_id_to_segs.items():
            for seg in segs:
                verts = seg_to_verts[seg]
                instance_ids[verts] = object_id
                if object_id not in object_id_to_label_id and len(verts):
                    object_id_to_label_id[object_id] = int(label_ids[verts[0]])
    else:
        num_verts = len(mesh_vertices)
        label_ids = np.zeros(num_verts, np.uint32)
        instance_ids = np.zeros(num_verts, np.uint32)
    label_ids_pg, instance_ids_pg = _read_pointgroup(pointgroup_dir, scene_id, num_verts)
    t1 = time.perf_counter()

    xyz = torch.from_numpy(mesh_vertices[:, :3]).to(device)
    if faces is not None:
        normals = compute_normal(xyz.double(), torch.from_numpy(faces).to(device))
        mesh_vertices[:, 6:9] = normals.float().cpu().numpy()
    aligned = mesh_vertices.copy()
    aligned_xyz = xyz
    if align is not None:
        pts = torch.cat([xyz.double(), xyz.new_ones(len(xyz), 1, dtype=torch.float64)], 1)
        aligned_xyz = (pts @ torch.from_numpy(align).to(device).T)[:, :3].float()
        aligned[:, :3] = aligned_xyz.cpu().numpy()
    if agg:
        ids = torch.from_numpy(instance_ids.astype(np.int64)).to(device)
        num_instances = len(object_id_to_segs)
        bboxes = _instance_bboxes(xyz, ids, object_id_to_label_id, num_instances)
        aligned_bboxes = _instance_bboxes(aligned_xyz, ids, object_id_to_label_id, num_instances)
    else:
        bboxes = np.zeros((1, 8))
        aligned_bboxes = np.zeros((1, 8))
    if times is not None:
        times["parse"] = (t1 - t0) * 1e3
        times["device"] = (time.perf_counter() - t1) * 1e3

    return {
        "vert": mesh_vertices,
        "aligned_vert": aligned,
        "sem_label": label_ids,
        "ins_label": instance_ids,
        "sem_label_pg": label_ids_pg,
        "ins_label_pg": instance_ids_pg,
        "bbox": bboxes,
        "aligned_bbox": aligned_bboxes,
    }


def export_one_scan(
    scannet_dir: str,
    scan_name: str,
    output_prefix: str,
    label_map_file: str,
    pointgroup_dir: Optional[str],
    rng: Optional[np.random.Generator] = None,
    device="cuda",
    times: Optional[Dict[str, float]] = None,
):
    """Filter + subsample + save (prepare_data.py:166-216); ``times`` as
    ``export_scene``'s, plus ``save``."""
    scan = os.path.join(scannet_dir, scan_name)
    arts = export_scene(
        os.path.join(scan, scan_name + "_vh_clean_2.ply"),
        os.path.join(scan, scan_name + ".aggregation.json"),
        os.path.join(scan, scan_name + "_vh_clean_2.0.010000.segs.json"),
        os.path.join(scan, scan_name + ".txt"),
        label_map_file,
        pointgroup_dir,
        scan_name,
        device,
        times,
    )

    t0 = time.perf_counter()
    if arts["bbox"].shape[0] > 1:
        keep = np.isin(arts["bbox"][:, -2], OBJ_CLASS_IDS)
        arts["bbox"] = arts["bbox"][keep]
        arts["aligned_bbox"] = arts["aligned_bbox"][keep]

    n = len(arts["vert"])
    if n > MAX_NUM_POINT:
        rng = rng or np.random.default_rng(0)
        choices = rng.choice(n, MAX_NUM_POINT, replace=False)
        for key in PER_VERTEX:
            arts[key] = arts[key][choices]

    for key, arr in arts.items():
        np.save(f"{output_prefix}_{key}.npy", arr)
    if times is not None:
        times["save"] = (time.perf_counter() - t0) * 1e3
    return arts


def batch_export(split: str, scannet_dir: str, pointgroup_dir: str,
                 output_dir: str, meta_dir: str, device="cuda") -> Dict[str, Dict[str, float]]:
    """Every scan of ``scannetv2_{split}.txt``; returns {scan: its ``times``}."""
    device = torch_device(device)
    os.makedirs(output_dir, exist_ok=True)
    split_file = os.path.join(meta_dir, f"scannetv2_{split}.txt")
    with open(split_file) as f:
        scan_names = sorted(line.strip() for line in f)
    label_map = os.path.join(meta_dir, "scannetv2-labels.combined.tsv")
    out = {}
    for scan_name in scan_names:
        times = out[scan_name] = {}
        export_one_scan(
            scannet_dir, scan_name, os.path.join(output_dir, scan_name),
            label_map, pointgroup_dir, device=device, times=times,
        )
        print(f"{scan_name}: parse {times['parse']:.1f} ms, {device.type} {times['device']:.1f} ms, "
              f"save {times['save']:.1f} ms")
    return out
