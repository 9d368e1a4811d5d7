"""Closest-hit and any-hit queries of the reference.

Every prim outside a mesh (spheres, planes) is tested by every ray. A
mesh's triangles sit in a BVH of their own: sorted by the Morton code of
their centroids, LEAF to a leaf, under a complete binary tree whose boxes
are padded outward so that no box test drops a triangle the exact test
would hit. A query walks the tree breadth first, one level at a time,
keeping the (ray, node) pairs whose box the ray enters before its t_max,
and tests every triangle of the leaves it reaches. The hit is the least t
over all triangles and spheres, then the least prim id; the tests are
Möller-Trumbore and the two-root sphere of the port's plain versions
(echorenderer_tpu_torch/ops/intersect.py), with its epsilon and its rule
for the prim a ray left: a triangle is skipped, a sphere gives its far
root.
"""

from __future__ import annotations

import numpy as np
import torch

from .bsdf import cross, dot
from .flat import Flat

RAY_EPSILON = 2.4e-4
INF = 3.4e38
LEAF = 8
RAYS_PER_WALK = 4096


def ray_triangle(o, d, v0, e1, e2):
    p = cross(d, e2)
    det = dot(e1, p)
    inv = torch.where(torch.abs(det) > 1e-12,
                      1.0 / torch.where(det == 0, torch.ones_like(det), det), 0.0)
    s = o - v0
    u = dot(s, p) * inv
    q = cross(s, e1)
    v = dot(d, q) * inv
    t = dot(e2, q) * inv
    valid = (torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return t, u, v, valid


def ray_sphere(o, d, center, radius, ignored):
    f = o - center
    b = dot(f, d)
    c = dot(f, f) - radius * radius
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_near, t_far = -b - sq, -b + sq
    t = torch.where(ignored, t_far, torch.where(t_near > RAY_EPSILON, t_near, t_far))
    return t, (disc >= 0.0) & (t > RAY_EPSILON)


def _morton(c):
    """30-bit Morton codes of points in [0, 1)^3."""
    q = np.clip((c * 1024.0).astype(np.int64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


class Accel:
    def __init__(self, flat: Flat, device, dtype):
        f = lambda a: torch.as_tensor(a, device=device).to(dtype)
        self.device, self.dtype = device, dtype
        self.tri_v0, self.tri_e1, self.tri_e2 = f(flat.tri_v0), f(flat.tri_e1), f(flat.tri_e2)
        self.n_tris = flat.num_tris
        in_bvh = np.zeros(flat.num_tris, bool)
        in_bvh[flat.bvh_tris] = True
        self.loose = torch.as_tensor(np.nonzero(~in_bvh)[0], device=device)
        self.sph_center, self.sph_radius = f(flat.sph_center), f(flat.sph_radius)
        self.levels = self._build(flat, flat.bvh_tris) if len(flat.bvh_tris) else None

    def _build(self, flat: Flat, ids):
        v0 = flat.tri_v0[ids]
        v1, v2 = v0 + flat.tri_e1[ids], v0 + flat.tri_e2[ids]
        lo = np.minimum(np.minimum(v0, v1), v2)
        hi = np.maximum(np.maximum(v0, v1), v2)
        cen = (lo + hi) * 0.5
        span = np.maximum(cen.max(0) - cen.min(0), 1e-12)
        order = np.argsort(_morton((cen - cen.min(0)) / span * (1 - 1e-7)), kind="stable")
        leaves = -(-len(ids) // LEAF)
        depth = max(0, int(np.ceil(np.log2(leaves))))
        slots = (1 << depth) * LEAF
        tri = np.full(slots, -1, np.int64)
        tri[:len(ids)] = ids[order]
        lo_s = np.full((slots, 3), np.inf, np.float64)
        hi_s = np.full((slots, 3), -np.inf, np.float64)
        lo_s[:len(ids)], hi_s[:len(ids)] = lo[order], hi[order]
        lo_l = lo_s.reshape(-1, LEAF, 3).min(1)
        hi_l = hi_s.reshape(-1, LEAF, 3).max(1)
        pad = 1e-4 + 1e-5 * np.abs(np.concatenate([lo, hi])).max()
        levels = []
        for _ in range(depth + 1):
            valid = np.isfinite(lo_l[:, 0])
            levels.append(tuple(torch.as_tensor(a, device=self.device) for a in (
                np.where(valid[:, None], lo_l - pad, 0.0).astype(np.float32),
                np.where(valid[:, None], hi_l + pad, 0.0).astype(np.float32), valid)))
            lo_l = np.minimum(lo_l[0::2], lo_l[1::2])
            hi_l = np.maximum(hi_l[0::2], hi_l[1::2])
        levels.reverse()  # root first
        self.leaf_tris = torch.as_tensor(tri.reshape(-1, LEAF), device=self.device)
        return levels

    def _pairs(self, o, d, t_max):
        """(ray, triangle) pairs of every leaf whose box the ray enters
        within [0, t_max]."""
        o32, d32 = o.float(), d.float()
        inv = 1.0 / torch.where(d32.abs() < 1e-30, torch.full_like(d32, 1e-30), d32)
        tm = torch.clamp(t_max.float(), max=3.0e38)
        ray = torch.arange(o.shape[0], device=self.device)
        node = torch.zeros_like(ray)
        for k, (lo, hi, valid) in enumerate(self.levels):
            a = (lo[node] - o32[ray]) * inv[ray]
            b = (hi[node] - o32[ray]) * inv[ray]
            near = torch.minimum(a, b).amax(-1)
            far = torch.maximum(a, b).amin(-1)
            keep = valid[node] & (near <= far) & (far >= 0.0) & (near <= tm[ray])
            ray, node = ray[keep], node[keep]
            if k + 1 < len(self.levels):
                ray = ray.repeat_interleave(2)
                node = torch.stack([2 * node, 2 * node + 1], -1).reshape(-1)
        tri = self.leaf_tris[node].reshape(-1)
        ray = ray.repeat_interleave(LEAF)
        keep = tri >= 0
        return ray[keep], tri[keep]

    def _mesh(self, o, d, t_max, ignore, any_hit: bool):
        """Least (t, triangle) over the BVH's triangles, or any hit."""
        n = o.shape[0]
        best_t = torch.full((n,), float("inf"), device=self.device)
        best = torch.full((n,), -1, dtype=torch.long, device=self.device)
        hit = torch.zeros(n, dtype=torch.bool, device=self.device)
        for a in range(0, n, RAYS_PER_WALK):
            sl = slice(a, a + RAYS_PER_WALK)
            ray, tri = self._pairs(o[sl], d[sl], t_max[sl])
            if ray.numel() == 0:
                continue
            ray_g = ray + a
            t, _, _, valid = ray_triangle(o[ray_g], d[ray_g], self.tri_v0[tri],
                                          self.tri_e1[tri], self.tri_e2[tri])
            valid = valid & (t > RAY_EPSILON) & (tri != ignore[ray_g])
            if any_hit:
                valid = valid & (t < t_max[ray_g])
                hit[sl] |= torch.zeros(o[sl].shape[0], dtype=torch.bool,
                                       device=self.device).index_fill_(0, ray[valid], True)
                continue
            tf = torch.where(valid, t.float(), float("inf"))
            bt = best_t[sl].scatter_reduce(0, ray, tf, "amin")
            first = torch.where(valid & (tf == bt[ray]), tri, 1 << 62)
            bp = torch.full_like(best[sl], 1 << 62).scatter_reduce(0, ray, first, "amin")
            best_t[sl] = bt
            best[sl] = torch.where(bp < (1 << 62), bp, -1)
        return hit if any_hit else (best_t, best)

    def trace(self, o, d, ignore):
        """(t, prim, (u, v)) of each ray's closest hit; prim -1, t INF on
        a miss."""
        n = o.shape[0]
        dt = o.dtype
        inf_t = torch.full((n,), min(INF, torch.finfo(dt).max), dtype=dt, device=self.device)
        best_t = inf_t.float()
        best = torch.full((n,), -1, dtype=torch.long, device=self.device)
        if self.loose.numel():
            tri = self.loose
            t, _, _, valid = ray_triangle(o[:, None], d[:, None], self.tri_v0[tri][None],
                                          self.tri_e1[tri][None], self.tri_e2[tri][None])
            valid = valid & (t > RAY_EPSILON) & (tri[None] != ignore[:, None])
            tf = torch.where(valid, t.float(), float("inf"))
            tj, j = tf.min(dim=1)
            closer = tj < best_t
            best = torch.where(closer, tri[j], best)
            best_t = torch.where(closer, tj, best_t)
        if self.levels is not None:
            mt, mp = self._mesh(o, d, inf_t, ignore, any_hit=False)
            closer = (mt < best_t) | ((mt == best_t) & (mp >= 0) & (mp < best) & (best >= 0))
            best = torch.where(closer, mp, best)
            best_t = torch.where(closer, mt, best_t)
        if self.sph_center.shape[0]:
            ids = torch.arange(self.sph_center.shape[0], device=self.device) + self.n_tris
            t, valid = ray_sphere(o[:, None], d[:, None], self.sph_center[None],
                                  self.sph_radius[None], ids[None] == ignore[:, None])
            tf = torch.where(valid, t.float(), float("inf"))
            tj, j = tf.min(dim=1)
            closer = tj < best_t
            best = torch.where(closer, ids[j], best)
            best_t = torch.where(closer, tj, best_t)
        found = best >= 0
        tri = torch.clamp(best, 0, max(self.n_tris - 1, 0))
        _, u, v, _ = ray_triangle(o, d, self.tri_v0[tri], self.tri_e1[tri], self.tri_e2[tri])
        uv = torch.where((found & (best < self.n_tris))[..., None], torch.stack([u, v], -1), 0.0)
        t = torch.where(found, best_t.to(dt), inf_t)
        return t, best, uv

    def occlude(self, o, d, t_max, ignore):
        """True where something lies on the segment (eps, t_max)."""
        blocked = torch.zeros(o.shape[0], dtype=torch.bool, device=self.device)
        if self.loose.numel():
            tri = self.loose
            t, _, _, valid = ray_triangle(o[:, None], d[:, None], self.tri_v0[tri][None],
                                          self.tri_e1[tri][None], self.tri_e2[tri][None])
            valid = valid & (t > RAY_EPSILON) & (t < t_max[:, None]) \
                & (tri[None] != ignore[:, None])
            blocked |= valid.any(dim=1)
        if self.levels is not None:
            blocked |= self._mesh(o, d, t_max, ignore, any_hit=True)
        if self.sph_center.shape[0]:
            ids = torch.arange(self.sph_center.shape[0], device=self.device) + self.n_tris
            t, valid = ray_sphere(o[:, None], d[:, None], self.sph_center[None],
                                  self.sph_radius[None], ids[None] == ignore[:, None])
            blocked |= (valid & (t < t_max[:, None])).any(dim=1)
        return blocked
