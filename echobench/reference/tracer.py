"""The plain reference path tracer of the benchmark.

A straightforward statement, in plain PyTorch, of what the port renders:
camera rays, closest-hit and any-hit queries, the BSDFs, next-event
estimation toward the ambient light and the emitters with the power
heuristic, Russian roulette and the per-pixel mean of the samples. The
estimator is the port's, draw for draw (the same sample streams and
dimensions, echorenderer_tpu_torch/evaluation/integrators.py `path_step`),
so a pixel's reference value matches the port's up to rounding and the
rare path that rounding sends another way. It shares no code with the
program: the scene comes from `flat.flatten` of the benchmark's own
arrays, and the intersection is its own (every prim for small scenes,
a breadth-first walk of a Morton-ordered BVH for meshes, `accel.py`).

Each path runs all its bounces in lockstep with the other lanes; lanes
that end are dropped. `dtype` is the float type of every per-path value
(the control computes in bfloat16); sums of samples stay float32.
"""

from __future__ import annotations

import math

import torch

from . import bsdf as B
from . import rng
from .accel import Accel
from .flat import EMISSIVE, LIGHT_AMBIENT, LIGHT_EMISSIVE, Flat

CAMERA_DIMS = 2
BOUNCE_DIM_STRIDE = 8
INF = 3.4e38


def _ph(a, b):
    """Power heuristic, exponent 2."""
    sq = a * a
    return sq / torch.clamp(sq + b * b, min=1e-20)


def _offset(point, geo_n, direction):
    side = torch.sign(B.dot(geo_n, direction))[..., None]
    return point + geo_n * side * 1e-4


class Reference:
    def __init__(self, flat: Flat, device, dtype=torch.float32):
        self.dtype, self.device = dtype, torch.device(device)
        self.inf = min(INF, torch.finfo(dtype).max)
        f = lambda a: torch.as_tensor(a, device=self.device).to(dtype)
        i = lambda a: torch.as_tensor(a, device=self.device).long()
        self.n_tris = flat.num_tris
        self.tri_n = f(flat.tri_n)
        self.tri_geo_n = f(flat.tri_geo_n)
        self.prim_mat = i(list(flat.tri_mat) + list(flat.sph_mat))
        self.sph_center, self.sph_radius = f(flat.sph_center), f(flat.sph_radius)
        self.prim_area = f(list(flat.tri_area) + list(flat.sph_area))
        self.mat = B.Material(torch.as_tensor(flat.mat_type, device=self.device),
                              f(flat.mat_albedo), f(flat.mat_params), f(flat.mat_extra))
        self.light_kind = torch.as_tensor(flat.light_kind, device=self.device)
        self.light_power, self.light_cdf = f(flat.light_power), f(flat.light_cdf)
        self.light_emitter = i(flat.light_emitter)
        self.prim_light = i(flat.prim_light)
        self.emit_prim, self.emit_area = i(flat.emit_prim), f(flat.emit_area)
        self.emit_radiance = f(flat.emit_radiance)
        self.ambient = f(flat.ambient)
        self.cam_pos, self.cam_rot = f(flat.cam_position), f(flat.cam_rotation)
        self.cam_forward = f(flat.cam_forward)
        self.accel = Accel(flat, self.device, dtype)
        total = torch.clamp(torch.sum(self.light_power), min=1e-20)
        self.light_pmf = self.light_power / total
        amb = torch.sum(torch.where(self.light_kind == LIGHT_AMBIENT, self.light_power, 0.0))
        self.amb_pmf = amb / total

    # --- camera ---

    def camera(self, xy, shift, resolution):
        width, height = resolution
        size_r = float(torch.tensor(1.0, dtype=torch.float32)
                       / torch.tensor(float(width), dtype=torch.float32))
        aspect_y = float(torch.tensor(float(height), dtype=torch.float32)
                         / torch.tensor(float(width), dtype=torch.float32))
        p = xy.to(torch.float32).to(self.dtype) + shift
        x = p[..., 0] * size_r - 0.5
        y = p[..., 1] * size_r - aspect_y * 0.5
        local = torch.stack([x, y, self.cam_forward.expand(x.shape)], dim=-1)
        origin = B.rotate(torch.zeros_like(local), self.cam_rot) + self.cam_pos
        d = B.rotate(local, self.cam_rot)
        return origin, d / torch.clamp(torch.sqrt(B.dot(d, d))[..., None], min=1e-20)

    # --- shading ---

    def interact(self, prim, t, uv, o, d):
        """(point, geometric normal, shading normal, material) of each hit."""
        point = o + d * t[..., None]
        tri = torch.clamp(prim, 0, max(self.n_tris - 1, 0))
        u, v = uv[..., 0], uv[..., 1]
        w = 1.0 - u - v
        n = self.tri_n[tri]
        tri_shade = B.normalize(w[..., None] * n[:, 0] + u[..., None] * n[:, 1]
                                + v[..., None] * n[:, 2])
        is_sph = prim >= self.n_tris
        if self.sph_center.shape[0]:
            s = torch.clamp(prim - self.n_tris, 0, self.sph_center.shape[0] - 1)
            sph_n = B.normalize(point - self.sph_center[s])
            geo = torch.where(is_sph[..., None], sph_n, self.tri_geo_n[tri])
            shade = torch.where(is_sph[..., None], sph_n, tri_shade)
        else:
            geo, shade = self.tri_geo_n[tri], tri_shade
        m = self.prim_mat[torch.clamp(prim, min=0)]
        mat = B.Material(self.mat.type[m], self.mat.albedo[m], self.mat.params[m],
                         self.mat.extra[m])
        return point, geo, shade, mat

    def pick_light(self, u):
        idx = torch.searchsorted(self.light_cdf, u.contiguous(), right=True)
        idx = torch.clamp(idx, 0, self.light_kind.shape[0] - 1)
        return idx, self.light_pmf[idx]

    def sample_light(self, record, x, u2):
        """(radiance, direction, distance, solid-angle pdf) toward each
        lane's light record: the ambient light uniformly over the sphere,
        an emitter by area (triangles) or uniformly over its surface."""
        kind = self.light_kind[record]
        n = x.shape[0]
        wi_a = rng.uniform_sphere(u2)
        amb_pdf = torch.full((n,), 1.0 / (4.0 * math.pi), dtype=self.dtype, device=self.device)
        rad_a = self.ambient.expand(x.shape)
        if self.emit_prim.shape[0]:
            e = torch.clamp(self.light_emitter[record], 0, self.emit_prim.shape[0] - 1)
            prim = self.emit_prim[e]
            is_sph = prim >= self.n_tris
            s = torch.clamp(prim - self.n_tris, 0, max(self.sph_center.shape[0] - 1, 0))
            tri = torch.clamp(prim, 0, self.n_tris - 1)
            acc = self.accel
            bary = rng.uniform_triangle(u2)
            p_tri = acc.tri_v0[tri] + bary[..., 0:1] * acc.tri_e1[tri] \
                + bary[..., 1:2] * acc.tri_e2[tri]
            sp_dir = rng.uniform_sphere(u2)
            if self.sph_center.shape[0]:
                p_sph = self.sph_center[s] + sp_dir * self.sph_radius[s][..., None]
                p_l = torch.where(is_sph[..., None], p_sph, p_tri)
                n_l = torch.where(is_sph[..., None], sp_dir, self.tri_geo_n[tri])
            else:
                p_l, n_l = p_tri, self.tri_geo_n[tri]
            delta = p_l - x
            dist2 = torch.clamp(B.dot(delta, delta), min=1e-12)
            dist = torch.sqrt(dist2)
            wi_e = delta / dist[..., None]
            cos_l = B.dot(n_l, -wi_e)
            rad_e = torch.where((cos_l > 0.0)[..., None], self.emit_radiance[e], 0.0)
            pdf_e = dist2 / torch.clamp(torch.abs(cos_l) * self.emit_area[e], min=1e-12)
        else:
            wi_e = rad_e = torch.zeros_like(x)
            dist = torch.zeros(n, dtype=self.dtype, device=self.device)
            pdf_e = torch.ones(n, dtype=self.dtype, device=self.device)
        inf = torch.full((n,), self.inf, dtype=self.dtype, device=self.device)

        def sel(amb, emi):
            ka = kind == LIGHT_AMBIENT
            ke = kind == LIGHT_EMISSIVE
            exp = lambda m, v: m[..., None] if v.dim() > 1 else m
            out = torch.where(exp(ka, amb), amb, torch.zeros_like(amb))
            return torch.where(exp(ke, emi), emi, out)

        return sel(rad_a, rad_e), sel(wi_a, wi_e), sel(inf, dist), sel(amb_pdf, pdf_e)

    # --- paths ---

    def radiance(self, seed, pixel, xy, sample, resolution, bounce_limit: int,
                 survivability: float):
        """One path sample a lane: (L, 3) radiance in float32, non-finite
        samples as 0 (rejected, as the port rejects them)."""
        dt, dev = self.dtype, self.device
        lanes = pixel.shape[0]
        out = torch.zeros((lanes, 3), dtype=dt, device=dev)
        st = rng.Stream(seed, pixel, sample, dt)
        o, d = self.camera(xy, st.next_2d(0), resolution)
        live = torch.arange(lanes, device=dev)
        tp = torch.ones((lanes, 3), dtype=dt, device=dev)
        prev_pdf = torch.zeros(lanes, dtype=dt, device=dev)
        prev_spec = torch.ones(lanes, dtype=torch.bool, device=dev)
        prev_point = o
        ignore = torch.full((lanes,), -1, dtype=torch.long, device=dev)
        for depth in range(bounce_limit + 1):
            if live.numel() == 0:
                break
            st = rng.Stream(seed[live], pixel[live], sample[live], dt)
            t, prim, uv = self.accel.trace(o, d, ignore)
            found = prim >= 0
            point, geo, shade, mat = self.interact(prim, t, uv, o, d)
            rad = torch.zeros_like(tp)

            # emission at the hit, MIS-weighted against NEE
            facing = B.dot(geo, -d) > 0.0
            emitted = torch.where((facing & (mat.type == EMISSIVE))[..., None], mat.albedo, 0.0)
            rec = self.prim_light[torch.clamp(prim, min=0)]
            light_pm = torch.where(rec >= 0, self.light_pmf[torch.clamp(rec, min=0)], 0.0)
            delta = point - prev_point
            dist2 = torch.clamp(B.dot(delta, delta), min=1e-12)
            cos_l = torch.abs(B.dot(geo, d))
            area = self.prim_area[torch.clamp(prim, min=0)]
            fwd_pdf = light_pm * (dist2 / torch.clamp(cos_l * area, min=1e-12))
            em_w = torch.where(prev_spec, 1.0, _ph(prev_pdf, fwd_pdf))
            rad = rad + torch.where(found[..., None], tp * emitted * em_w[..., None], 0.0)

            # escaped: the ambient light, MIS-weighted against its NEE
            inf_pdf = self.amb_pmf * (1.0 / (4.0 * math.pi))
            inf_w = torch.where(prev_spec, 1.0, _ph(prev_pdf, inf_pdf))
            env = self.ambient.expand(d.shape) if depth == 0 \
                else self.ambient.expand(d.shape) * inf_w[..., None]
            rad = rad + torch.where((~found)[..., None], tp * env, 0.0)

            # NEE and the BSDF sample
            tangent, bitangent = B.frame(shade)
            wo_local = B.to_local(-d, tangent, bitangent, shade)
            dim = CAMERA_DIMS + BOUNCE_DIM_STRIDE * depth
            u_bsdf, u_lobe = st.next_2d(dim), st.next_1d(dim + 1)
            u_pick, u_light, u_rr = st.next_1d(dim + 2), st.next_2d(dim + 3), st.next_1d(dim + 4)
            bs = B.sample(mat, wo_local, u_bsdf, u_lobe)
            cos_i = torch.abs(bs.incident[..., 2])
            has_bounce = found & (bs.pdf > 0.0) & (depth < bounce_limit)

            record, pick_pmf = self.pick_light(u_pick)
            l_rad, l_wi, l_travel, l_pdf = self.sample_light(record, point, u_light)
            wi_l = B.to_local(l_wi, tangent, bitangent, shade)
            f_l, scatter_pdf = B.evaluate_pdf(mat, wo_local, wi_l)
            f_l = f_l * torch.abs(B.dot(shade, l_wi))[..., None]
            nee_pdf = pick_pmf * l_pdf
            candidate = (found & ~bs.specular & (nee_pdf > 1e-12)
                         & torch.any(f_l * l_rad > 0.0, dim=-1))
            shadow_o = _offset(point, geo, l_wi)
            shadow_t = torch.where(l_travel >= self.inf, self.inf, l_travel * (1.0 - 1e-3))
            blocked = torch.zeros_like(candidate)
            c = torch.nonzero(candidate)[:, 0]
            if c.numel():
                blocked[c] = self.accel.occlude(shadow_o[c], l_wi[c], shadow_t[c],
                                                torch.clamp(prim[c], min=0))
            visible = candidate & ~blocked
            mis_w = _ph(nee_pdf, scatter_pdf)  # every light here has a non-delta pdf
            nee = l_rad * f_l * (mis_w / torch.clamp(nee_pdf, min=1e-20))[..., None]
            rad = rad + torch.where(visible[..., None], tp * nee, 0.0)
            out[live] = out[live] + rad

            # continue or end (Russian roulette)
            weight = bs.value * (cos_i / torch.clamp(bs.pdf, min=1e-20))[..., None]
            new_tp = tp * torch.where(has_bounce[..., None], weight, 1.0)
            rr = torch.clamp(survivability * B.luminance(new_tp), 0.0, 1.0)
            new_tp = new_tp / torch.clamp(rr, min=1e-20)[..., None]
            keep = torch.nonzero(has_bounce & (u_rr < rr))[:, 0]
            wi_world = B.to_world(bs.incident, tangent, bitangent, shade)
            live = live[keep]
            o = _offset(point, geo, wi_world)[keep]
            d, tp = wi_world[keep], new_tp[keep]
            prev_pdf, prev_spec, prev_point = bs.pdf[keep], bs.specular[keep], point[keep]
            ignore = torch.clamp(prim, min=0)[keep]
        out = out.to(torch.float32)
        return torch.where(torch.isfinite(B.vsum(out))[..., None], out, 0.0)

    def samples(self, seeds, pids, starts, count: int, resolution, bounce_limit: int,
                survivability: float, lanes_per_batch: int = 1 << 18):
        """Per-pixel sums of samples [start, start + count) of each (seed,
        pixel id) pair, sample by sample in order: (sum, sum of squares),
        each (P, 3) float32. `starts` is an int or a (P,) tensor."""
        width = resolution[0]
        m_all = pids.shape[0]
        starts = torch.as_tensor(starts, dtype=torch.long, device=self.device).expand(m_all)
        s_sum = torch.zeros((m_all, 3), dtype=torch.float32, device=self.device)
        s_sq = torch.zeros_like(s_sum)
        per = max(1, lanes_per_batch // count)
        for a in range(0, m_all, per):
            p, sd, st = pids[a:a + per], seeds[a:a + per], starts[a:a + per]
            m = p.shape[0]
            pix = p.repeat_interleave(count)
            xy = torch.stack([pix % width, pix // width], dim=-1)
            sample = (st.repeat_interleave(count)
                      + torch.arange(count, device=self.device).repeat(m)) & rng.MASK32
            rad = self.radiance(sd.repeat_interleave(count), pix, xy, sample, resolution,
                                bounce_limit, survivability).reshape(m, count, 3)
            total, sq = torch.zeros_like(rad[:, 0]), torch.zeros_like(rad[:, 0])
            for i in range(count):
                total = total + rad[:, i]
                sq = sq + rad[:, i] * rad[:, i]
            s_sum[a:a + m], s_sq[a:a + m] = total, sq
        return s_sum, s_sq

    def _lanes(self, seeds, pixel_ids):
        seeds = torch.as_tensor(seeds, dtype=torch.long, device=self.device) & rng.MASK32
        return seeds, torch.as_tensor(pixel_ids, dtype=torch.long, device=self.device)

    def pixels(self, seeds, pixel_ids, resolution, spp: int, bounce_limit: int,
               survivability: float):
        """The mean of samples [0, spp) of each (seed, pixel id) pair:
        (P, 3) float32."""
        seeds, pids = self._lanes(seeds, pixel_ids)
        s_sum, _ = self.samples(seeds, pids, 0, spp, resolution, bounce_limit, survivability)
        return s_sum / float(spp)

    def adaptive(self, seeds, pixel_ids, resolution, spe: int, min_epoch: int,
                 max_epoch: int, threshold: float, bounce_limit: int, survivability: float):
        """The adaptive path layer's value of each pair: `min_epoch` epochs
        of `spe` samples, then an epoch more for each pixel whose own
        relative noise is above `threshold`, until `max_epoch`; each epoch
        merged into the pixel's Welford accumulator (acc_add)."""
        seeds, pids = self._lanes(seeds, pixel_ids)
        n = pids.shape[0]
        acc = acc_new(n, self.device)
        drawn = torch.zeros(n, dtype=torch.long, device=self.device)
        for epoch in range(max_epoch):
            if epoch < min_epoch:
                ids = torch.arange(n, device=self.device)
            else:
                ids = torch.nonzero(acc_max_noise(acc) > threshold)[:, 0]
                if ids.numel() == 0:
                    break
            s_sum, s_sq = self.samples(seeds[ids], pids[ids], drawn[ids], spe, resolution,
                                       bounce_limit, survivability)
            full = lambda x: torch.zeros((n, 3), dtype=torch.float32,
                                         device=self.device).index_copy_(0, ids, x)
            k = torch.zeros((n, 1), dtype=torch.float32, device=self.device)
            k[ids] = float(spe)
            acc = acc_add(acc, full(s_sum), full(s_sq), k)
            drawn[ids] = (drawn[ids] + spe) & rng.MASK32
        return acc[0]

    def first_hits(self, seeds, pixel_ids, resolution, count: int):
        """The albedo and the normal-and-depth AOVs of each pair: the mean
        over samples [0, count) of the first hit's albedo (the ambient light
        on a miss), and of its shading normal and distance (zero and INF on
        a miss). Returns ((P, 3), (P, 4)) float32."""
        seeds, pids = self._lanes(seeds, pixel_ids)
        width = resolution[0]
        xy = torch.stack([pids % width, pids // width], dim=-1)
        alb = torch.zeros((pids.shape[0], 3), dtype=torch.float32, device=self.device)
        nd = torch.zeros((pids.shape[0], 4), dtype=torch.float32, device=self.device)
        for i in range(count):
            st = rng.Stream(seeds, pids, torch.full_like(pids, i), self.dtype)
            o, d = self.camera(xy, st.next_2d(0), resolution)
            t, prim, uv = self.accel.trace(o, d, torch.full_like(pids, -1))
            found = prim >= 0
            _, _, shade, mat = self.interact(prim, t, uv, o, d)
            alb = alb + torch.where(found[..., None], mat.albedo, self.ambient).float()
            nd = nd + torch.cat([torch.where(found[..., None], shade, 0.0),
                                 torch.where(found, t, self.inf)[..., None]], -1).float()
        return alb / float(count), nd / float(count)


def acc_new(n: int, device):
    z = lambda c: torch.zeros((n, c), dtype=torch.float32, device=device)
    return z(3), z(3), z(1)


def acc_add(acc, s_sum, s_sq, k):
    """Chan's merge of a batch of k samples (sum, sum of squares) into a
    Welford (mean, m2, count) accumulator, the port's accumulator
    arithmetic."""
    mean, m2, count = acc
    nz = k > 0.0
    safe_n = torch.clamp(k, min=1.0)
    batch_mean = s_sum / safe_n
    batch_m2 = s_sq - safe_n * batch_mean * batch_mean
    total = count + k
    safe_total = torch.clamp(total, min=1.0)
    delta = batch_mean - mean
    mean = mean + torch.where(nz, delta * (k / safe_total), 0.0)
    m2 = m2 + torch.where(nz, torch.clamp(batch_m2, min=0.0)
                          + delta * delta * (count * k / safe_total), 0.0)
    return mean, m2, total


def acc_max_noise(acc):
    """Each pixel's largest relative noise over its channels:
    sqrt(m2 / ((count - 1)^3 mean^2)), 0 where the mean is 0 or count < 2."""
    mean, m2, n = acc
    one_less = torch.clamp(n - 1.0, min=1.0)
    numerator = mean * mean * (one_less ** 3)
    ratio = numerator / torch.clamp(m2, min=1e-38)
    result = torch.rsqrt(torch.clamp(ratio, min=1e-38))
    result = torch.where(numerator > 0.0, result, 0.0)
    return torch.amax(torch.where(n < 2.0, 0.0, result), dim=-1)
