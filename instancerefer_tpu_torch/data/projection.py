"""Multiview 2D <-> 3D projection: frustum culling, pixel correspondence and
fusion, in PyTorch on a device (the card unless the caller passes the CPU).

Counterpart of ``instancerefer_tpu/data/projection.py`` (the reference's
``lib/projection.py``), with the same arithmetic:

* the geometry runs in float64, as the numpy version does, so that the
  frustum test ``round(x * 100) / 100 < 0`` and the ``round`` of the pixel
  coordinates land on the same side of their boundaries (``torch.round``
  rounds half to even, as ``np.round`` does);
* a float32 pose is inverted in float64 and rounded to float32, as
  ``np.linalg.inv`` returns a float32 array for a float32 input;
* a depth value is compared with ``depth_min``/``depth_max`` in its own
  float32, as numpy compares a float32 array with a Python float;
* the index layout: arrays of length ``num_points + 1`` whose element 0
  holds the count.

``FrameFeatureFuser`` keeps both overlap policies of
``scripts/project_multiview_features.py`` on the same device.

For synthetic frames (the tests and ``chip_smoke.py``): ``room_scene``
draws points on the surfaces of a room with boxes in it, ``look_at`` a
camera pose, and ``zbuffer_depth`` renders the depth frame a pose sees, so
the occlusion test keeps the visible points.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# 640x480 ScanNet color intrinsics, scaled by scannet_projection_helper
SCANNET_INTRINSIC = ((577.870605, 0.0, 319.5), (0.0, 577.870605, 239.5), (0.0, 0.0, 1.0))


def _tensor(x, device, dtype=None) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=dtype or t.dtype)


class ProjectionHelper:
    """``intrinsic`` [3, 3]; ``image_dims`` (W, H), the reference's order."""

    def __init__(self, intrinsic, depth_min, depth_max, image_dims, accuracy, device="cuda"):
        self.device = torch.device(device)
        self.intrinsic = _tensor(intrinsic, self.device, torch.float64)
        self.depth_min = depth_min
        self.depth_max = depth_max
        self.image_dims = image_dims
        self.accuracy = accuracy
        self.corner_points = self._compute_corner_points()

    def depth_to_skeleton(self, ux, uy, depth) -> torch.Tensor:
        k = self.intrinsic
        x = (ux - k[0, 2]) / k[0, 0]
        y = (uy - k[1, 2]) / k[1, 1]
        return torch.stack([depth * x, depth * y, k.new_tensor(float(depth))])

    def skeleton_to_depth(self, p) -> torch.Tensor:
        k = self.intrinsic
        x = (p[0] * k[0, 0]) / p[2] + k[0, 2]
        y = (p[1] * k[1, 1]) / p[2] + k[1, 2]
        return torch.stack([x, y, p[2]])

    def _compute_corner_points(self) -> torch.Tensor:
        w, h = self.image_dims
        corners = torch.ones(8, 4, dtype=torch.float64, device=self.device)
        for i, (ux, uy, d) in enumerate([
            (0, 0, self.depth_min), (w - 1, 0, self.depth_min),
            (w - 1, h - 1, self.depth_min), (0, h - 1, self.depth_min),
            (0, 0, self.depth_max), (w - 1, 0, self.depth_max),
            (w - 1, h - 1, self.depth_max), (0, h - 1, self.depth_max),
        ]):
            corners[i, :3] = self.depth_to_skeleton(ux, uy, d)
        return corners

    def compute_frustum_corners(self, camera_to_world) -> torch.Tensor:
        c2w = _tensor(camera_to_world, self.device, torch.float64)
        return (c2w @ self.corner_points.T).T  # [8, 4]

    def compute_frustum_normals(self, corner_coords) -> torch.Tensor:
        c = corner_coords[:, :3]
        pairs = ((3, 0, 1, 0), (2, 1, 5, 1), (3, 2, 6, 2), (0, 3, 7, 3), (1, 0, 4, 0), (6, 5, 4, 5))
        # front, right, roof, left, bottom, back
        return torch.stack([torch.linalg.cross(c[a] - c[b], c[d] - c[e]) for a, b, d, e in pairs])

    def points_in_frustum(self, corner_coords, normals, points) -> torch.Tensor:
        """The half-space test with the reference's round-to-2-decimals
        tolerance; a bool mask over ``points`` [N, 3] float64."""
        p1 = points - corner_coords[2, :3]
        p2 = points - corner_coords[4, :3]
        mask = torch.ones(len(points), dtype=torch.bool, device=points.device)
        for k in range(6):
            ref = p1 if k < 3 else p2
            mask &= torch.round(ref @ normals[k] * 100) / 100 < 0
        return mask

    def compute_projection(self, points, depth, camera_to_world
                           ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """3D <-> 2D correspondence of ``points`` [N, 3] seen in ``depth``
        [H, W] from ``camera_to_world`` [4, 4]: (indices_3d, indices_2d),
        int64 [N + 1] with the count in element 0, or None where no point
        corresponds."""
        points = _tensor(points, self.device, torch.float64)
        depth = _tensor(depth, self.device)
        pose = _tensor(camera_to_world, self.device)
        num_points = len(points)
        world_to_camera = torch.linalg.inv(pose.double()).to(pose.dtype).double()

        corner_coords = self.compute_frustum_corners(pose)
        normals = self.compute_frustum_normals(corner_coords)
        ind_points = torch.nonzero(self.points_in_frustum(corner_coords, normals, points))[:, 0]
        if len(ind_points) == 0:
            return None

        coords = torch.ones(4, len(ind_points), dtype=torch.float64, device=self.device)
        coords[:3] = points[ind_points].T
        camera = world_to_camera @ coords
        k = self.intrinsic
        px = torch.round(camera[0] * k[0, 0] / camera[2] + k[0, 2]).long()
        py = torch.round(camera[1] * k[1, 1] / camera[2] + k[1, 2]).long()

        w, h = self.image_dims
        valid = (px >= 0) & (py >= 0) & (px < w) & (py < h)
        image_ind = py[valid] * w + px[valid]
        depth_vals = depth.reshape(-1)[image_ind]
        z = camera[2][valid]
        depth_mask = ((depth_vals >= self.depth_min) & (depth_vals <= self.depth_max)
                      & ((depth_vals.double() - z).abs() <= self.accuracy))
        ind_update = ind_points[valid][depth_mask]
        n = len(ind_update)
        if n == 0:
            return None
        indices_3d = torch.zeros(num_points + 1, dtype=torch.long, device=self.device)
        indices_2d = torch.zeros(num_points + 1, dtype=torch.long, device=self.device)
        indices_3d[0] = indices_2d[0] = n
        indices_3d[1:1 + n] = ind_update
        indices_2d[1:1 + n] = image_ind[depth_mask]
        return indices_3d, indices_2d

    @staticmethod
    def project(label, lin_indices_3d, lin_indices_2d, num_points) -> torch.Tensor:
        """Back-project ``label`` [C, H, W] (or [H, W]) onto the points:
        [C, num_points], zeros where no correspondence exists."""
        if label.dim() == 2:
            label = label[None]
        c = label.shape[0]
        output = label.new_zeros(c, num_points)
        n = int(lin_indices_3d[0])
        if n > 0:
            output[:, lin_indices_3d[1:1 + n]] = label.reshape(c, -1)[:, lin_indices_2d[1:1 + n]]
        return output


def scannet_projection_helper(image_dims=(41, 32), depth_min=0.1, depth_max=4.0, accuracy=0.05,
                              device="cuda") -> ProjectionHelper:
    """ScanNet's 640x480 intrinsics scaled to ``image_dims`` (the
    reference's ``adjust_intrinsic``)."""
    out = np.array(SCANNET_INTRINSIC)
    sx, sy = image_dims[0] / 640.0, image_dims[1] / 480.0
    out[0, 0] *= sx
    out[0, 2] = (out[0, 2] + 0.5) * sx - 0.5
    out[1, 1] *= sy
    out[1, 2] = (out[1, 2] + 0.5) * sy - 0.5
    return ProjectionHelper(out, depth_min, depth_max, image_dims, accuracy, device)


class FrameFeatureFuser:
    """Per-frame fusion with the reference's overlap policies
    (``scripts/project_multiview_features.py:180-213``), on ``device``.

    ``maxpool``: a point not yet covered takes the frame's features; a point
    covered before and by this frame takes the elementwise max (only over
    covering frames: an uncovered frame's zeros never clip negative
    features).  ``first``: the first frame's features, then each still
    empty point ("covered" = any nonzero channel) takes the next frame's.
    """

    def __init__(self, num_points: int, num_channels: int, mode: str = "maxpool",
                 device="cuda"):
        if mode not in ("maxpool", "first"):
            raise ValueError(f"unknown fusion mode {mode!r}")
        self.mode = mode
        self.point_features = torch.zeros(num_points, num_channels, device=device)
        self._first = True

    def add(self, proj_feat: torch.Tensor) -> None:
        """proj_feat: [N, C] back-projected features of one frame."""
        c = proj_feat.shape[1]
        pf = self.point_features
        if self.mode == "maxpool":
            feat_mask = (proj_feat == 0).sum(1) != c
            point_mask = (pf == 0).sum(1) == c
            fill = point_mask & feat_mask
            pf[fill] = proj_feat[fill].float()
            pool = ~point_mask & feat_mask
            pf[pool] = torch.maximum(pf[pool], proj_feat[pool].float())
        elif self._first:
            self.point_features = proj_feat.float().clone()
        else:
            mask = (pf == 0).sum(1) == c
            pf[mask] = proj_feat[mask].float()
        self._first = False

    def result(self) -> torch.Tensor:
        return self.point_features


def room_scene(rng: np.random.Generator, num_points: int, size=(6.0, 5.0, 3.0),
               num_boxes: int = 8) -> np.ndarray:
    """[num_points, 3] float32 points on the surfaces of a room of ``size``
    (floor and four walls, a scan has no ceiling) and of ``num_boxes``
    boxes standing on its floor: half the points on the room, half on the
    boxes, uniform over each surface."""
    sx, sy, sz = size
    faces = [((0, 0, 0), (sx, 0, 0), (0, sy, 0)),   # floor
             ((0, 0, 0), (sx, 0, 0), (0, 0, sz)), ((0, sy, 0), (sx, 0, 0), (0, 0, sz)),
             ((0, 0, 0), (0, sy, 0), (0, 0, sz)), ((sx, 0, 0), (0, sy, 0), (0, 0, sz))]
    for _ in range(num_boxes):
        lo = rng.uniform([0.5, 0.5, 0.0], [sx - 1.5, sy - 1.5, 0.0])
        dx, dy, dz = rng.uniform([0.3, 0.3, 0.3], [1.0, 1.0, 1.2])
        faces += [(lo + (0, 0, dz), (dx, 0, 0), (0, dy, 0)),   # top
                  (lo, (dx, 0, 0), (0, 0, dz)), (lo + (0, dy, 0), (dx, 0, 0), (0, 0, dz)),
                  (lo, (0, dy, 0), (0, 0, dz)), (lo + (dx, 0, 0), (0, dy, 0), (0, 0, dz))]
    origin, u, v = (np.array(f, np.float64) for f in zip(*faces))
    area = np.linalg.norm(np.cross(u, v), axis=1)
    n_room = num_points // 2
    weights = np.concatenate([area[:5] / area[:5].sum() * n_room,
                              area[5:] / area[5:].sum() * (num_points - n_room)])
    face = rng.choice(len(faces), size=num_points, p=weights / weights.sum())
    a, b = rng.random((2, num_points, 1))
    return (origin[face] + a * u[face] + b * v[face]).astype(np.float32)


def look_at(eye, target) -> np.ndarray:
    """float32 camera_to_world [4, 4] of a camera at ``eye`` looking at
    ``target`` with z up: camera x right, y down, z forward."""
    eye, target = np.asarray(eye, np.float64), np.asarray(target, np.float64)
    forward = (target - eye) / np.linalg.norm(target - eye)
    right = np.cross(forward, (0.0, 0.0, 1.0))
    right /= np.linalg.norm(right)
    pose = np.eye(4)
    pose[:3, :3] = np.stack([right, np.cross(forward, right), forward], 1)
    pose[:3, 3] = eye
    return pose.astype(np.float32)


def zbuffer_depth(points, camera_to_world, helper: ProjectionHelper) -> torch.Tensor:
    """[H, W] float32 depth frame of ``points`` [N, 3] seen from
    ``camera_to_world`` at ``helper``'s intrinsics and size: each pixel the
    nearest camera z among the points that round to it, 0 (below every
    ``depth_min``: matches nothing) where none does."""
    pts = _tensor(points, helper.device, torch.float64)
    w2c = torch.linalg.inv(_tensor(camera_to_world, helper.device, torch.float64))
    cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    k = helper.intrinsic
    z = cam[:, 2]
    px = torch.round(cam[:, 0] * k[0, 0] / z + k[0, 2]).long()
    py = torch.round(cam[:, 1] * k[1, 1] / z + k[1, 2]).long()
    w, h = helper.image_dims
    ok = (z > 0) & (px >= 0) & (py >= 0) & (px < w) & (py < h)
    depth = torch.full((h * w,), float("inf"), dtype=torch.float64, device=helper.device)
    depth.scatter_reduce_(0, (py * w + px)[ok], z[ok], "amin")
    return torch.where(torch.isinf(depth), 0.0, depth).view(h, w).float()
