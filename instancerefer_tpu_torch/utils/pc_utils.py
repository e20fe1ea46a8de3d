"""Point-cloud utilities: rotations, sampling, PLY/OBJ mesh writers.

The port's copy of ``instancerefer_tpu/utils/pc_utils.py``, itself a port
of reference ``utils/pc_utils.py``: rotation matrices, random sampling, the
volume / image / BEV converters, box helpers, and the visualization writers
the reference uses for manual inspection (``write_ply``, ``write_ply_rgb``,
``write_bbox``, OBJ dumps).  Host tools in numpy, as in the JAX package;
the writers emit the same bytes.  Writers are dependency-free (no
plyfile/trimesh): they emit standard ascii PLY / OBJ.  Functions that draw
take ``rng`` (an ``np.random.Generator``; ``np.random`` when omitted).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


# ---------------------------------------------------------------------------
# rotations (utils/pc_utils.py rotx/roty/rotz)
# ---------------------------------------------------------------------------

def rotx(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def roty(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rotz(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def random_sampling(pc: np.ndarray, num_sample: int, replace: Optional[bool] = None,
                    return_choices: bool = False, rng=None):
    """utils/pc_utils.py:32-40 semantics (module-level RNG unless given)."""
    rng = rng or np.random
    if replace is None:
        replace = pc.shape[0] < num_sample
    choices = rng.choice(pc.shape[0], num_sample, replace=replace)
    if return_choices:
        return pc[choices], choices
    return pc[choices]


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

def write_ply(points: np.ndarray, filename: str, text: bool = True):
    """Write xyz points to an ascii PLY."""
    points = np.asarray(points)
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for p in points:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


def write_ply_rgb(points: np.ndarray, colors: np.ndarray, filename: str):
    """Write colored points to an ascii PLY (colors uint8 0-255)."""
    points = np.asarray(points)
    colors = np.asarray(colors).astype(np.uint8)
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(points, colors):
            f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")


def write_obj(points: np.ndarray, faces: Optional[np.ndarray], filename: str,
              colors: Optional[np.ndarray] = None):
    """OBJ dump (data/scannet/visualize.py capability)."""
    with open(filename, "w") as f:
        for i, p in enumerate(np.asarray(points)):
            if colors is not None:
                c = colors[i]
                f.write(f"v {p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        if faces is not None:
            for face in np.asarray(faces):
                f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")


_BOX_FACES = [
    (0, 1, 2), (0, 2, 3), (4, 6, 5), (4, 7, 6),
    (0, 4, 5), (0, 5, 1), (1, 5, 6), (1, 6, 2),
    (2, 6, 7), (2, 7, 3), (3, 7, 4), (3, 4, 0),
]


def construct_bbox_corners(center, box_size):
    """utils/util.py:21-32 corner ordering."""
    cx, cy, cz = center
    sx, sy, sz = box_size
    x = [cx - sx / 2, cx + sx / 2]
    y = [cy - sy / 2, cy + sy / 2]
    z = [cz - sz / 2, cz + sz / 2]
    order = [
        (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
        (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
    ]
    return np.array([[x[i], y[j], z[k]] for i, j, k in order])


def write_bbox(obbs: np.ndarray, filename: str):
    """Write axis-aligned obb boxes ([K, 7] cx..dz,heading) as an OBJ mesh
    (capability of utils/pc_utils.py write_bbox/write_oriented_bbox; ScanNet
    headings are always 0)."""
    verts = []
    faces = []
    for k, obb in enumerate(np.asarray(obbs).reshape(-1, 7)):
        corners = construct_bbox_corners(obb[:3], obb[3:6])
        base = len(verts)
        verts.extend(corners.tolist())
        faces.extend([(a + base, b + base, c + base) for a, b, c in _BOX_FACES])
    write_obj(np.array(verts), np.array(faces), filename)


# ---------------------------------------------------------------------------
# point-cloud <-> volume / image conversions (reference utils/pc_utils.py:46-185)
# ---------------------------------------------------------------------------

def point_cloud_to_volume(points: np.ndarray, vsize: int, radius: float = 1.0):
    """[N,3] points in [-radius, radius] -> [V,V,V] occupancy
    (reference utils/pc_utils.py:63-73)."""
    vol = np.zeros((vsize, vsize, vsize))
    voxel = 2 * radius / float(vsize)
    loc = ((np.asarray(points) + radius) / voxel).astype(int)
    vol[loc[:, 0], loc[:, 1], loc[:, 2]] = 1.0
    return vol


def point_cloud_to_volume_batch(point_clouds, vsize: int = 12, radius: float = 1.0,
                                flatten: bool = True):
    """[B,N,3] -> [B, V^3] (flatten) or [B,V,V,V,1] (reference ``:46-60``)."""
    vols = [point_cloud_to_volume(pc, vsize, radius) for pc in point_clouds]
    if flatten:
        return np.vstack([v.flatten() for v in vols])
    return np.stack([v[..., None] for v in vols])


def volume_to_point_cloud(vol: np.ndarray):
    """Occupancy [V,V,V] -> [N,3] voxel-index points (reference ``:75-90``)."""
    pts = np.argwhere(np.asarray(vol) == 1)
    return pts if len(pts) else np.zeros((0, 3))


def _cells_to_samples(points, cell_of_point, cell_centers, cell_scale,
                      num_sample, out_shape, rng=None, normalize_dims=3):
    """Shared core of the v2 volume / image converters: per-cell gather,
    sample/pad to ``num_sample`` rows, center + scale normalize."""
    rng = rng or np.random
    out = np.zeros(out_shape)
    cells: dict = {}
    for n, c in enumerate(map(tuple, cell_of_point)):
        cells.setdefault(c, []).append(points[n])
    for c, rows in cells.items():
        pc = np.vstack(rows)
        if pc.shape[0] > num_sample:
            pc = random_sampling(pc, num_sample, replace=False, rng=rng)
        elif pc.shape[0] < num_sample:
            pc = np.pad(pc, ((0, num_sample - pc.shape[0]), (0, 0)), "edge")
        pc = pc.copy()
        pc[:, :normalize_dims] = (
            pc[:, :normalize_dims] - cell_centers[c]
        ) / cell_scale
        out[c] = pc
    return out


def point_cloud_to_volume_v2(points, vsize, radius=1.0, num_sample=128, rng=None):
    """[N,3] -> [V,V,V,num_sample,3] per-voxel normalized point samples
    (reference ``:92-134``; note the reference appends every point twice
    before sampling — a duplication bug with no effect on the padded result,
    not reproduced)."""
    voxel = 2 * radius / float(vsize)
    points = np.asarray(points)
    loc = ((points + radius) / voxel).astype(int)
    centers = {
        tuple(c): (np.array(c) + 0.5) * voxel - radius
        for c in map(tuple, loc)
    }
    return _cells_to_samples(
        points, loc, centers, voxel, num_sample,
        (vsize, vsize, vsize, num_sample, 3), rng,
    )


def point_cloud_to_volume_v2_batch(point_clouds, vsize=12, radius=1.0,
                                   num_sample=128, rng=None):
    return np.stack([
        point_cloud_to_volume_v2(pc, vsize, radius, num_sample, rng)
        for pc in point_clouds
    ])


def point_cloud_to_image(points, imgsize, radius=1.0, num_sample=128, rng=None):
    """[N,3] -> [I,I,num_sample,3]: per-pixel xy-normalized samples
    (reference ``:148-180``; z stays unnormalized there too)."""
    pixel = 2 * radius / float(imgsize)
    points = np.asarray(points)
    loc = ((points[:, 0:2] + radius) / pixel).astype(int)
    centers = {
        tuple(c): (np.array(c) + 0.5) * pixel - radius
        for c in map(tuple, loc)
    }
    return _cells_to_samples(
        points, loc, centers, pixel, num_sample,
        (imgsize, imgsize, num_sample, 3), rng, normalize_dims=2,
    )


def point_cloud_to_image_batch(point_clouds, imgsize, radius=1.0, num_sample=128,
                               rng=None):
    return np.stack([
        point_cloud_to_image(pc, imgsize, radius, num_sample, rng)
        for pc in point_clouds
    ])


# ---------------------------------------------------------------------------
# simple point manipulations + bbox helpers (reference ``:282-360``)
# ---------------------------------------------------------------------------

def rotate_point_cloud(points, rotation_matrix=None, rng=None):
    """Rotate around the cloud's centroid (reference ``:289-300``)."""
    rng = rng or np.random
    if rotation_matrix is None:
        a = rng.uniform() * 2 * np.pi
        s, c = np.sin(a), np.cos(a)
        rotation_matrix = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    ctr = points.mean(axis=0)
    return np.dot(points - ctr, rotation_matrix) + ctr, rotation_matrix


def rotate_pc_along_y(pc, rot_angle):
    """In-place xz-plane rotation (camera coords; reference ``:302-309``)."""
    c, s = np.cos(rot_angle), np.sin(rot_angle)
    rotmat = np.array([[c, -s], [s, c]])
    pc[:, [0, 2]] = np.dot(pc[:, [0, 2]], rotmat.T)
    return pc


def bbox_corner_dist_measure(crnr1, crnr2):
    """Corner-distance box-similarity in [0, 1] (reference ``:326-347``):
    min over the 4 yaw-aligned corner correspondences of the mean corner
    distance, normalized by the mean diagonal."""
    dist = min(
        float(np.linalg.norm(
            crnr2[[(x + y) % 4 for x in range(4)]
                  + [4 + (x + y) % 4 for x in range(4)], :] - crnr1, axis=1
        ).sum()) / 8.0
        for y in range(4)
    )
    u = sum(np.linalg.norm(x[0, :] - x[6, :]) for x in (crnr1, crnr2)) / 2.0
    return max(1.0 - dist / u, 0)


def point_cloud_to_bbox(points):
    """[N,3] or [B,N,3] -> 6-dim AABB (center, lengths) (reference ``:349-359``)."""
    which_dim = len(points.shape) - 2
    mn, mx = points.min(which_dim), points.max(which_dim)
    return np.concatenate([0.5 * (mn + mx), mx - mn], axis=which_dim)


# ---------------------------------------------------------------------------
# oriented-bbox / line mesh writers (reference ``:361-537``; the reference
# shells out to trimesh — these emit the equivalent box/cylinder meshes as
# binary-free ascii PLY directly)
# ---------------------------------------------------------------------------

_UNIT_BOX_CORNERS = np.array(
    [[i - 0.5, j - 0.5, k - 0.5] for i, j, k in
     [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
      (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]]
)


def _write_ply_mesh(verts, faces, filename):
    verts = np.asarray(verts)
    faces = np.asarray(faces, int)
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for p in verts:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def _boxes_to_mesh(scene_bbox, heading2rotmat):
    verts, faces = [], []
    for box in np.asarray(scene_bbox):
        corners = _UNIT_BOX_CORNERS * np.asarray(box[3:6])
        if len(box) > 6:
            corners = corners @ heading2rotmat(box[6]).T
        corners = corners + np.asarray(box[:3])
        base = len(verts)
        verts.extend(corners.tolist())
        faces.extend([(a + base, b + base, c + base) for a, b, c in _BOX_FACES])
    return verts, faces


def write_oriented_bbox(scene_bbox, out_filename):
    """[N,7] (center, lengths, Z-heading) -> PLY box meshes
    (reference ``write_oriented_bbox``, utils/pc_utils.py:425-459)."""

    def heading2rotmat(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    _write_ply_mesh(*_boxes_to_mesh(scene_bbox, heading2rotmat), out_filename)


def write_oriented_bbox_camera_coord(scene_bbox, out_filename):
    """[N,7] with Y-axis heading (camera coords; reference ``:461-497``)."""

    def heading2rotmat(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    _write_ply_mesh(*_boxes_to_mesh(scene_bbox, heading2rotmat), out_filename)


def write_lines_as_cylinders(pcl, filename, rad=0.005, res=64):
    """[N,2,3] point pairs -> PLY cylinder meshes (reference ``:499-517``).
    The output file is ``{filename}.ply`` exactly as in the reference."""
    verts, faces = [], []
    theta = np.linspace(0, 2 * np.pi, res, endpoint=False)
    ring = np.stack([np.cos(theta), np.sin(theta)], axis=1)  # [res, 2]
    for src, tgt in np.asarray(pcl):
        vec = tgt - src
        height = float(np.linalg.norm(vec))
        z = vec / max(height, 1e-12)
        # orthonormal frame around the segment direction
        ref = np.array([1.0, 0.0, 0.0]) if abs(z[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        x = np.cross(ref, z)
        x /= max(np.linalg.norm(x), 1e-12)
        y = np.cross(z, x)
        mid = 0.5 * (src + tgt)
        lo = mid - 0.5 * height * z
        hi = mid + 0.5 * height * z
        base = len(verts)
        for center in (lo, hi):
            for cx, cy in ring:
                verts.append((center + rad * (cx * x + cy * y)).tolist())
        for i in range(res):
            j = (i + 1) % res
            faces.append((base + i, base + j, base + res + i))
            faces.append((base + j, base + res + j, base + res + i))
    _write_ply_mesh(verts, faces, f"{filename}.ply")


def write_ply_color(points, labels, filename, num_classes=None, colormap=None):
    """Label-colored points as ascii PLY (reference ``:141-160``; the default
    jet colormap is synthesized if matplotlib is unavailable)."""
    labels = np.asarray(labels).astype(int)
    if num_classes is None:
        num_classes = int(labels.max()) + 1
    else:
        assert num_classes > labels.max()
    if colormap is None:
        try:
            from matplotlib import pyplot
            colormap = pyplot.cm.jet
        except Exception:
            def colormap(x):  # crude jet fallback
                r = np.clip(1.5 - abs(4 * x - 3), 0, 1)
                g = np.clip(1.5 - abs(4 * x - 2), 0, 1)
                b = np.clip(1.5 - abs(4 * x - 1), 0, 1)
                return (r, g, b, 1.0)
    colors = np.array(
        [[int(v * 255) for v in colormap(i / float(num_classes))[:3]]
         for i in range(num_classes)], np.uint8,
    )
    write_ply_rgb(points, colors[labels], filename)


def point_cloud_to_bev(points: np.ndarray, xy_min, xy_max, resolution: int = 64):
    """Occupancy BEV image from points (volume/image conversion capability)."""
    xy = points[:, :2]
    grid = np.zeros((resolution, resolution), np.float32)
    scale = (np.asarray(xy_max) - np.asarray(xy_min)) / resolution
    idx = np.floor((xy - np.asarray(xy_min)) / np.maximum(scale, 1e-9)).astype(int)
    ok = ((idx >= 0) & (idx < resolution)).all(1)
    np.add.at(grid, (idx[ok, 0], idx[ok, 1]), 1.0)
    return grid
