"""Ray-primitive intersection math (counterpart of
echorenderer_tpu/ops/intersect.py): Möller-Trumbore triangles, spheres with
the findFar rule, and the brute-force linear accelerator that serves
scenes under 32 prims. Plain torch: every ray against every prim as one
dense broadcast.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils import vec

INF = 3.4e38
# minimum travel distance for new rays (reference TraceQuery.cs epsilon)
RAY_EPSILON = 2.4e-4


class Hit(NamedTuple):
    """SoA hit record for a batch of rays."""

    t: torch.Tensor  # (N,) distance, INF on miss
    prim: torch.Tensor  # (N,) int32 original primitive id, -1 on miss
    uv: torch.Tensor  # (N, 2) triangle barycentrics (spheres: see interact())
    # (N,) int32 instance of the hit, zeros without instancing; None where
    # the accelerator does not report it
    inst: torch.Tensor | None = None

    @property
    def found(self) -> torch.Tensor:
        return self.prim >= 0

    @property
    def inst_or_zero(self) -> torch.Tensor:
        """`inst`, or zeros like `prim` where the accelerator reports none."""
        return torch.zeros_like(self.prim) if self.inst is None else self.inst


def ray_triangle(o, d, v0, e1, e2):
    """Möller-Trumbore. Shapes broadcast; returns (t, u, v, valid)."""
    p = vec.cross(d, e2)
    det = vec.dot(e1, p)
    inv = torch.where(
        torch.abs(det) > 1e-12, 1.0 / torch.where(det == 0, torch.ones_like(det), det), 0.0
    )
    s = o - v0
    u = vec.dot(s, p) * inv
    q = vec.cross(s, e1)
    v = vec.dot(d, q) * inv
    t = vec.dot(e2, q) * inv
    valid = (torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return t, u, v, valid


def ray_sphere_roots(o, d, center, radius):
    """Both roots (t_near <= t_far) and the discriminant validity mask."""
    f = o - center
    b = vec.dot(f, d)
    c = vec.length_squared(f) - radius * radius
    disc = b * b - c
    ok = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    return -b - sq, -b + sq, ok


def sphere_pick_root(t_near, t_far, ok, ignored, eps=RAY_EPSILON):
    """Ignored spheres contribute only their far root (the exit interface),
    everything else takes the first root beyond eps."""
    t_std = torch.where(t_near > eps, t_near, t_far)
    t = torch.where(ignored, t_far, t_std)
    return t, ok & (t > eps)


# odd minimax polynomial of atan on [0, 1] (max error ~1e-6 rad), the JAX
# megakernel's `_matan2` (echorenderer_tpu/ops/megakernel.py:700)
_ATAN_COEFFS = (0.99997726, -0.33262347, 0.19354346, -0.11643287, 0.05265332, -0.01172120)


def poly_atan2(y, x):
    """atan2 from an octant reduction and _ATAN_COEFFS in Horner form, one
    rounding per op. csrc/megakernel.cu repeats it op for op (-fmad=false),
    so the kernel's sphere uv equals the wavefront's on the card; it lies
    within ~1e-6 rad of torch.atan2."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    t = torch.minimum(ax, ay) / torch.clamp(hi, min=1e-30)
    z = t * t
    acc = z * _ATAN_COEFFS[-1]
    for c in _ATAN_COEFFS[-2:0:-1]:
        acc = z * (acc + c)
    r = t * (acc + _ATAN_COEFFS[0])
    r = torch.where(ay > ax, math.pi / 2 - r, r)
    r = torch.where(x < 0.0, math.pi - r, r)
    return torch.where(y < 0.0, -r, r)


def poly_acos(z):
    """acos(z) = atan2(sqrt(1 - z^2), z) through poly_atan2."""
    return poly_atan2(torch.sqrt(torch.clamp(1.0 - z * z, min=0.0)), z)


def sphere_uv(local_point, radius):
    """Equirectangular (u, v) of a point on a sphere surface, through
    poly_atan2 / poly_acos (the megakernel's texture stage computes the
    same expression), scaled by products with 1/(2 pi) and 1/pi: a float
    tensor divided by a Python number runs as a product with its
    reciprocal on the card but as a division on the CPU."""
    p = local_point / torch.clamp(radius[..., None], min=1e-20)
    theta = poly_acos(torch.clamp(p[..., 1], -1.0, 1.0))
    phi = poly_atan2(p[..., 0], p[..., 2])
    u = phi * (0.5 / math.pi) + 0.5
    v = 1.0 - theta * (1.0 / math.pi)
    return torch.stack([u, v], dim=-1)


class FlatGeometry(NamedTuple):
    """Prepared SoA geometry. Primitive index space: [0, T) triangles,
    [T, T+S) spheres."""

    tri_v0: torch.Tensor  # (T, 3)
    tri_e1: torch.Tensor  # (T, 3)
    tri_e2: torch.Tensor  # (T, 3)
    tri_n0: torch.Tensor  # (T, 3) shading normals
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_uv0: torch.Tensor  # (T, 2)
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor
    tri_mat: torch.Tensor  # (T,) int32
    sph_center: torch.Tensor  # (S, 3)
    sph_radius: torch.Tensor  # (S,)
    sph_mat: torch.Tensor  # (S,) int32

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def num_primitives(self) -> int:
        return self.num_triangles + self.num_spheres


def _first_min(t):
    """(min over the last axis, index of its first occurrence)."""
    tj = torch.amin(t, dim=1)
    first = torch.argmax((t == tj[:, None]).to(torch.int8), dim=1)
    return tj, first


def intersect_linear(geom: FlatGeometry, o, d, t_max, ignore) -> Hit:
    """Brute-force closest hit over all prims as one dense broadcast."""
    n = o.shape[0]
    best_t = torch.clamp(
        torch.as_tensor(t_max, dtype=torch.float32, device=o.device), max=INF
    ).expand(n)
    best_prim = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    best_uv = torch.zeros((n, 2), dtype=torch.float32, device=o.device)
    inf = torch.tensor(INF, dtype=torch.float32, device=o.device)

    if geom.num_triangles:
        t, u, v, valid = ray_triangle(
            o[:, None, :], d[:, None, :], geom.tri_v0[None], geom.tri_e1[None], geom.tri_e2[None]
        )  # (N, T)
        prim_ids = torch.arange(geom.num_triangles, dtype=torch.int32, device=o.device)[None, :]
        valid &= (t > RAY_EPSILON) & (prim_ids != ignore[:, None])
        t = torch.where(valid, t, inf)
        tj, j = _first_min(t)
        closer = tj < best_t
        best_prim = torch.where(closer, j.to(torch.int32), best_prim)
        uj = torch.gather(u, 1, j[:, None])[:, 0]
        vj = torch.gather(v, 1, j[:, None])[:, 0]
        best_uv = torch.where(closer[:, None], torch.stack([uj, vj], dim=-1), best_uv)
        best_t = torch.where(closer, tj, best_t)

    if geom.num_spheres:
        t_near, t_far, ok = ray_sphere_roots(
            o[:, None, :], d[:, None, :], geom.sph_center[None], geom.sph_radius[None]
        )
        prim_ids = (
            torch.arange(geom.num_spheres, dtype=torch.int32, device=o.device)[None, :]
            + geom.num_triangles
        )
        t, valid = sphere_pick_root(t_near, t_far, ok, prim_ids == ignore[:, None])
        t = torch.where(valid, t, inf)
        tj, j = _first_min(t)
        closer = tj < best_t
        best_prim = torch.where(closer, j.to(torch.int32) + geom.num_triangles, best_prim)
        best_t = torch.where(closer, tj, best_t)

    return Hit(t=best_t, prim=best_prim, uv=best_uv)


def occlude_linear(geom: FlatGeometry, o, d, t_max, ignore) -> torch.Tensor:
    """Any-hit test: True where the segment [eps, t_max) is blocked."""
    n = o.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).expand(n)
    blocked = torch.zeros((n,), dtype=torch.bool, device=o.device)
    if geom.num_triangles:
        t, _, _, valid = ray_triangle(
            o[:, None, :], d[:, None, :], geom.tri_v0[None], geom.tri_e1[None], geom.tri_e2[None]
        )
        prim_ids = torch.arange(geom.num_triangles, dtype=torch.int32, device=o.device)[None, :]
        valid &= (t > RAY_EPSILON) & (t < t_max[:, None]) & (prim_ids != ignore[:, None])
        blocked |= torch.any(valid, dim=1)
    if geom.num_spheres:
        t_near, t_far, ok = ray_sphere_roots(
            o[:, None, :], d[:, None, :], geom.sph_center[None], geom.sph_radius[None]
        )
        prim_ids = (
            torch.arange(geom.num_spheres, dtype=torch.int32, device=o.device)[None, :]
            + geom.num_triangles
        )
        t, valid = sphere_pick_root(t_near, t_far, ok, prim_ids == ignore[:, None])
        valid &= t < t_max[:, None]
        blocked |= torch.any(valid, dim=1)
    return blocked
