"""Cameras: view/projection matrices, projection and pixel rays, and the
viewer's orbit camera (`Orientation`, `OrbitCamera`).

Counterpart of the JAX package's `render/camera.py`, with the same
conventions: right-handed world, the view matrix maps world -> camera with
the camera looking down -z, GL-style projection with NDC depth in [-1, 1];
pixel (x, y) has x growing right and y growing down (row 0 is the top of
the image), and its ray passes through ((x + 0.5) / W, (y + 0.5) / H).

A camera is host state: its vectors and matrices are float32 CPU tensors,
so the per-frame geometry derived from it costs no device round trip.
"""

from __future__ import annotations

import dataclasses
import math
from enum import Enum
from typing import Sequence, Tuple

import numpy as np
import torch


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=eps)


def look_at(eye: torch.Tensor, center: torch.Tensor, up: torch.Tensor
            ) -> torch.Tensor:
    """World -> view matrix (4, 4); camera at ``eye`` looking at ``center``."""
    eye, center, up = (torch.as_tensor(a, dtype=torch.float32)
                       for a in (eye, center, up))
    f = normalize(center - eye)
    s = normalize(torch.linalg.cross(f, up))
    u = torch.linalg.cross(s, f)
    rot = torch.stack([s, u, -f])
    m = torch.eye(4, dtype=torch.float32)
    m[:3, :3] = rot
    m[:3, 3] = -rot @ eye
    return m


def perspective(fov_y_degrees: float, aspect: float,
                z_near: float, z_far: float) -> torch.Tensor:
    """GL-style perspective projection (4, 4), NDC depth in [-1, 1]."""
    f = 1.0 / math.tan(math.radians(float(fov_y_degrees)) / 2.0)
    m = torch.zeros((4, 4), dtype=torch.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (z_far + z_near) / (z_near - z_far)
    m[2, 3] = 2.0 * z_far * z_near / (z_near - z_far)
    m[3, 2] = -1.0
    return m


def project(mvp: torch.Tensor, p_world: torch.Tensor) -> torch.Tensor:
    """Project world points (..., 3) to NDC (..., 3) through a 4x4 MVP.

    ``mvp`` is a host matrix; its entries enter as scalars, so the points
    may live on any device without a copy of the matrix."""
    m = mvp.tolist()
    x, y, z = p_world[..., 0], p_world[..., 1], p_world[..., 2]
    clip = [x * r[0] + y * r[1] + z * r[2] + r[3] for r in m]
    return torch.stack(clip[:3], -1) / clip[3][..., None]


@dataclasses.dataclass
class CameraParams:
    """Everything the renderer needs about one camera pose."""

    eye: torch.Tensor          # (3,) float32, host
    look_at_pt: torch.Tensor   # (3,)
    up: torch.Tensor           # (3,)
    fov_y_degrees: float
    z_near: float = 0.1
    z_far: float = 10.0

    @classmethod
    def create(cls, eye: Sequence[float],
               look_at_pt: Sequence[float] = (0, 0, 0),
               up: Sequence[float] = (0, 1, 0), fov_y_degrees: float = 45.0,
               z_near: float = 0.1, z_far: float = 10.0) -> "CameraParams":
        def vec(a):
            return torch.as_tensor(a, dtype=torch.float32).reshape(3).cpu()
        return cls(vec(eye), vec(look_at_pt), vec(up), float(fov_y_degrees),
                   float(z_near), float(z_far))

    def view_matrix(self) -> torch.Tensor:
        return look_at(self.eye, self.look_at_pt, self.up)

    def mvp(self, width: int, height: int) -> torch.Tensor:
        proj = perspective(self.fov_y_degrees, width / height,
                           self.z_near, self.z_far)
        return proj @ self.view_matrix()

    def normal_matrix(self) -> torch.Tensor:
        """3x3 rotation mapping world normals to view space."""
        return self.view_matrix()[:3, :3]

    def pixel_rays(self, width: int, height: int, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The ray origin (the host eye, (3,)) and the normalized world
        direction of each pixel's ray, (H, W, 3) on ``device`` (the CPU by
        default); the top row looks up."""
        rot = self.view_matrix()[:3, :3].tolist()     # rows: right, up, back
        tan_half = math.tan(math.radians(self.fov_y_degrees) / 2.0)
        aspect = width / height
        x = (torch.arange(width, dtype=torch.float32, device=device)
             + 0.5) / width
        y = (torch.arange(height, dtype=torch.float32, device=device)
             + 0.5) / height
        dx = ((2.0 * x - 1.0) * (tan_half * aspect))[None, :].expand(
            height, width)
        dy = ((1.0 - 2.0 * y) * tan_half)[:, None].expand(height, width)
        # (dx, dy, -1) rotated from view to world space
        d = torch.stack([dx * rot[0][j] + dy * rot[1][j] - rot[2][j]
                         for j in range(3)], -1)
        return self.eye, d / torch.clamp(norm3(d)[..., None], min=1e-12)


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean length over the last axis of size 3, summed in order."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


class Orientation(Enum):
    """Which world axis is "up" for the orbit camera: each value carries
    (up vector, 1-indexed signed permutation of the orbit's coordinates,
    whether the yaw is inverted)."""

    Xp = 1, (1, 0, 0), (2, -1, -3), True
    Xm = 2, (-1, 0, 0), (-2, 1, 3), False
    Yp = 3, (0, 1, 0), (1, 2, 3), False
    Ym = 4, (0, -1, 0), (-1, -2, -3), True
    Zp = 5, (0, 0, 1), (-3, -1, 2), False
    Zm = 6, (0, 0, -1), (3, 1, -2), True

    def __new__(cls, value, up, permute, inv_yaw):
        obj = object.__new__(cls)
        obj._value_ = value
        obj.up = up
        obj.permute = permute
        obj.inv_yaw = inv_yaw
        return obj


class OrbitCamera:
    """The viewer's interactive camera: pitch, yaw and zoom around a
    look-at point.  A drag moves by ``speed`` radians a pixel from the
    pose at `start_move`, the pitch clamped to +-80 degrees; the zoom is
    exponential, ``distance = base * zoom_speed ** zoom_value``.  Host
    state only: `params` makes the renderer's `CameraParams`."""

    def __init__(self, res_x: int, res_y: int,
                 origin: Sequence[float] = (0.0, 1.0, -1.7),
                 fov_y_degrees: float = 45.0):
        self.res_x = res_x
        self.res_y = res_y
        self.look_at_pt = [0.0, 0.0, 0.0]
        self.speed = 0.01
        self.zoom_speed = 1.1
        self.fov_y_degrees = fov_y_degrees
        self.orientation = Orientation.Yp
        d, p, yaw = self.to_angles(origin)
        self.current_distance = d
        self.current_pitch = p
        self.current_yaw = yaw
        self.base_distance = d
        self.zoom_value = 0.0
        self._old = (d, p, yaw)

    @staticmethod
    def to_angles(pos: Sequence[float]) -> Tuple[float, float, float]:
        """(distance, pitch, yaw) of a position around the origin."""
        length = math.sqrt(pos[0] ** 2 + pos[1] ** 2 + pos[2] ** 2)
        return length, math.asin(pos[1] / length), math.atan2(pos[2],
                                                              pos[0])

    @staticmethod
    def from_angles(length: float, pitch: float, yaw: float) -> list:
        return [math.cos(pitch) * math.cos(yaw) * length,
                math.sin(pitch) * length,
                math.cos(pitch) * math.sin(yaw) * length]

    def get_origin(self) -> list:
        """The eye, the orbit's coordinates permuted by the orientation."""
        yaw = self.current_yaw * (-1 if self.orientation.inv_yaw else 1)
        o1 = self.from_angles(self.current_distance, self.current_pitch, yaw)
        return [o1[abs(p) - 1] * (1 if p > 0 else -1)
                for p in self.orientation.permute]

    def get_up(self) -> Tuple[float, float, float]:
        return self.orientation.up

    def start_move(self):
        self._old = (self.current_distance, self.current_pitch,
                     self.current_yaw)

    def move(self, dx: float, dy: float):
        _, old_pitch, old_yaw = self._old
        self.current_pitch = max(math.radians(-80),
                                 min(math.radians(80),
                                     old_pitch + self.speed * dy))
        self.current_yaw = old_yaw + self.speed * dx

    def zoom(self, delta: float):
        self.zoom_value += delta
        self.current_distance = (self.base_distance
                                 * self.zoom_speed ** self.zoom_value)

    def params(self, z_near: float = 0.1, z_far: float = 10.0
               ) -> CameraParams:
        return CameraParams.create(self.get_origin(), self.look_at_pt,
                                   self.get_up(), self.fov_y_degrees,
                                   z_near, z_far)


def random_sphere_camera(rng: np.random.RandomState,
                         distance_range: Tuple[float, float] = (1.2, 2.0),
                         fov_y_degrees: float = 45.0) -> CameraParams:
    """A camera at a uniformly random direction and distance from the
    origin, looking at it (the data generator's and the all-angle PSNR
    harness's draw)."""
    v = rng.normal(size=3)
    v /= np.linalg.norm(v)
    d = rng.uniform(*distance_range)
    up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(v, up)) > 0.95:
        up = np.array([1.0, 0.0, 0.0])
    return CameraParams.create(v * d, (0, 0, 0), up, fov_y_degrees)
