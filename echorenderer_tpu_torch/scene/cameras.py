"""Cameras: host-side description + batched ray generation (counterpart
of echorenderer_tpu/scene/cameras.py; the host classes are copied as they
are, `spawn_rays` is written for torch).

Rebuild of the reference camera layer (Scenic/Cameras/): horizontal
field-of-view perspective camera with thin-lens depth of field
(PerspectiveCamera.cs:15-63), orthographic, and 360° cylindrical cameras.
Image-plane convention matches RaySpawner.cs: x in [-1/2, 1/2], y scaled
proportionally by aspect; local forward is +z.
"""

from __future__ import annotations

import math

import numpy as np

from .entities import Entity
from ..utils import rng as rng_mod

PERSPECTIVE = 0
ORTHOGRAPHIC = 1
CYLINDRICAL = 2


class Camera(Entity):
    kind = PERSPECTIVE

    def __init__(self, name=None, **kw):
        super().__init__(name=name, **kw)

    def pack(self, world: np.ndarray) -> dict:
        """Host -> device parameter dict used by spawn_rays."""
        rot = world[:3, :3].copy()
        scale = np.linalg.norm(rot[:, 0])
        rot /= max(scale, 1e-20)
        return dict(
            kind=self.kind,
            position=world[:3, 3].astype(np.float32),
            rotation=rot.astype(np.float32),
            forward_length=np.float32(1.0),
            lens_radius=np.float32(0.0),
            focal_distance=np.float32(0.0),
        )


class PerspectiveCamera(Camera):
    kind = PERSPECTIVE

    def __init__(self, field_of_view=65.0, lens_radius=0.0, focal_distance=0.0, **kw):
        super().__init__(**kw)
        self.field_of_view = float(field_of_view)  # horizontal, degrees
        self.lens_radius = float(lens_radius)
        self.focal_distance = float(focal_distance)

    def pack(self, world):
        p = super().pack(world)
        p["forward_length"] = np.float32(
            0.5 / np.tan(np.radians(self.field_of_view) / 2.0)
        )
        if self.lens_radius > 0.0 and self.focal_distance > 0.0:
            p["lens_radius"] = np.float32(self.lens_radius)
            p["focal_distance"] = np.float32(self.focal_distance)
        return p


class OrthographicCamera(Camera):
    kind = ORTHOGRAPHIC

    def __init__(self, width=1.0, **kw):
        super().__init__(**kw)
        self.width = float(width)

    def pack(self, world):
        p = super().pack(world)
        p["forward_length"] = np.float32(self.width)  # reused as view width
        return p


class CylindricalCamera(Camera):
    """360° panoramic camera (reference CylindricalCamera.cs)."""

    kind = CYLINDRICAL


def spawn_rays(cam, pixel_xy, shift, lens_u, resolution):
    """Generate camera rays for a batch of pixels on the camera's device.

    cam: PackedCamera (scene/prepare.py)
    pixel_xy: (N, 2) integer pixel coordinates (x right, y up)
    shift: (N, 2) in [0,1)^2 sub-pixel jitter
    lens_u: (N, 2) lens samples for depth of field
    resolution: (width, height)
    Returns (origin (N,3), direction (N,3)).
    """
    import torch

    width, height = resolution
    size_r = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(width), dtype=torch.float32)
    aspect_y = torch.tensor(float(height), dtype=torch.float32) / torch.tensor(
        float(width), dtype=torch.float32
    )
    size_r, aspect_y = float(size_r), float(aspect_y)

    xy = pixel_xy.to(torch.float32) + shift
    x = xy[..., 0] * size_r - 0.5
    y = xy[..., 1] * size_r - aspect_y * 0.5

    rot = cam.rotation  # (3, 3) local->world
    pos = cam.position
    kind = int(cam.kind)

    if kind == PERSPECTIVE:
        fl = cam.forward_length
        local_dir = torch.stack([x, y, fl.expand(x.shape)], dim=-1)
        lens_radius = cam.lens_radius
        focal = cam.focal_distance
        has_dof = (lens_radius > 0.0) & (focal > 0.0)
        lens = rng_mod.concentric_disk(lens_u) * lens_radius
        focus_scale = focal / fl
        focus = torch.stack(
            [x * focus_scale, y * focus_scale, focal.expand(x.shape)], dim=-1
        )
        local_origin = torch.where(
            has_dof,
            torch.cat([lens, torch.zeros_like(lens[..., :1])], dim=-1),
            torch.zeros_like(focus),
        )
        local_dir = torch.where(has_dof, focus - local_origin, local_dir)
        origin = local_origin @ rot.T + pos
        direction = local_dir @ rot.T
    elif kind == ORTHOGRAPHIC:
        w = cam.forward_length
        local_origin = torch.stack([x * w, y * w, torch.zeros_like(x)], dim=-1)
        origin = local_origin @ rot.T + pos
        direction = rot[:, 2].expand(origin.shape)
    else:  # CYLINDRICAL: 360 pano, x -> azimuth, y -> elevation
        phi = (x + 0.5) * (2.0 * math.pi)
        theta = torch.atan2(y, torch.ones_like(y))
        local_dir = torch.stack(
            [torch.sin(phi) * torch.cos(theta), torch.sin(theta), torch.cos(phi) * torch.cos(theta)],
            dim=-1,
        )
        origin = pos.expand(local_dir.shape)
        direction = local_dir @ rot.T

    norm = torch.sqrt(torch.sum(direction * direction, dim=-1, keepdim=True))
    return origin, direction / torch.clamp(norm, min=1e-20)
