"""PyTorch port: the path pool of the megakernel's untextured and textured
forms (csrc/megakernel.cu `run_pool`, kernel 3 of the JAX package).

A block of the CUDA kernel keeps one path a thread in shared memory and runs
each bounce as stages over queues: trace every live path; place the hits by
material type (a counting sort whose order within a type is whatever the
atomics give); shade them (interaction, texture stage, emission, the draws,
BSDF sample, NEE light pick, sample and evaluation, Russian roulette),
queueing the shadow rays; trace the queued shadow rays and add the
unblocked terms; then each entry banks its ended path and regenerates: its
pixel's next sample, its lane's next slot (slot j of lane L is pixel
j * n_lanes + L), or a new item from the launch's work counter. The split
form, for launches with fewer pixels than the card holds paths, takes
(pixel, sample) units instead, writes each sample's radiance to a buffer and
sums each pixel's samples in sample order afterwards (`bank_kernel`). The
prims are staged as records, in slot order, without the slots no ray can hit.

`PoolModel` replays that scheduling in torch with the plain version's physics
(scene_ops, bsdf, path_step's formulas) on index sets: several blocks whose
bounces interleave in a random order, queues in random orders, the types of
the sort in a random order, items handed out by one counter. The tests hold
its per-pixel sums bitwise to `sample_frame_mega_plain` (the wavefront) on
sphere_field(12), material_ball and a textured scene, for lanes of one and
of three slots and for the split form, with non-finite samples; and the
record staging's rule (the slots it leaves out never hit), also on
sphere_grid(1900), 2048 padded prims, the top of the envelope. The CUDA kernel
is held bitwise to the plain version on the card:

    python -m pytest --noconftest tests/test_torch_mega_pool.py -k cuda
"""

import numpy as np
import pytest
import torch

from echorenderer_tpu_torch.evaluation import bsdf as bsdf_mod
from echorenderer_tpu_torch.evaluation import scene_ops
from echorenderer_tpu_torch.evaluation.integrators import (BOUNCE_DIM_STRIDE, CAMERA_DIMS,
                                                           DIM_BSDF, DIM_LIGHT_PICK,
                                                           DIM_LIGHT_SAMPLE, DIM_LOBE, DIM_RR,
                                                           _offset_origin, _power_heuristic)
from echorenderer_tpu_torch.models import scenes as tscenes
from echorenderer_tpu_torch.ops import megakernel as tmk
from echorenderer_tpu_torch.ops import pallas_intersect as tpi
from echorenderer_tpu_torch.ops.intersect import INF, Hit
from echorenderer_tpu_torch.scene.cameras import spawn_rays
from echorenderer_tpu_torch.scene.prepare import LIGHT_AMBIENT
from echorenderer_tpu_torch.scene.prepare import prepare_scene as tprepare
from echorenderer_tpu_torch.utils import colors, vec
from echorenderer_tpu_torch.utils.rng import SampleStream, as_u32

torch.set_num_threads(1)

SCENES = {
    "sphere_field(12)": lambda: tscenes.sphere_field(12),
    "material_ball": lambda: tscenes.material_ball(),
    "textured": lambda: _textured("textured"),
}
# besides: the Cornell box, and the top of the envelope (1,924 triangles,
# 2048 padded prims; one material type, so the pool schedule's replay, which
# must see two, leaves it out)
MORE = {"cornell": tscenes.cornell_box, "sphere_grid(1900)": lambda: tscenes.sphere_grid(1900)}
BOUNCE = 6
SURV = 2.5


def _textured(name):
    import test_torch_textures

    return test_torch_textures.SCENES[name]("torch")


class PoolModel:
    """csrc/megakernel.cu's path pool on the CPU: `blocks` blocks of
    `entries` paths. Every state tensor has one row an entry (all blocks'
    entries together); a stage works on a tensor of entry indices, in the
    order given. `rs` draws every order the kernel leaves to the hardware."""

    def __init__(self, scene, pixel_id, pixel_xy, res, seed, s0, count, *, blocks, entries,
                 k_slots, split, rs):
        self.scene, self.res, self.count, self.rs = scene, res, count, rs
        self.pid, self.pxy = as_u32(pixel_id), pixel_xy
        self.n = n = pixel_id.shape[0]
        self.s0 = as_u32(s0).expand(n).contiguous()
        self.seed = as_u32(seed)
        self.k = k_slots
        self.n_lanes = -(-n // k_slots)
        self.split = split
        self.items = n * count if split else self.n_lanes
        self.work = 0  # the launch's work counter
        self.blocks, self.entries = blocks, entries
        m = blocks * entries
        f3 = lambda: torch.zeros((m, 3), dtype=torch.float32)
        i1 = lambda: torch.zeros(m, dtype=torch.int64)
        self.o, self.d, self.tp, self.rad, self.prev_point = f3(), f3(), f3(), f3(), f3()
        self.prev_pdf = torch.zeros(m, dtype=torch.float32)
        self.prev_spec = torch.zeros(m, dtype=torch.bool)
        self.depth, self.ignore = i1(), i1()
        self.alive, self.ended = torch.zeros(m, dtype=torch.bool), torch.zeros(m, dtype=torch.bool)
        self.item, self.slot, self.sample, self.pix = i1(), i1(), i1(), i1()
        self.s_sum, self.s_sq = f3(), f3()
        self.hit_t = torch.zeros(m, dtype=torch.float32)
        self.hit_prim = torch.full((m,), -1, dtype=torch.int32)
        self.hit_uv = torch.zeros((m, 2), dtype=torch.float32)
        self.shadow = {}  # entry -> (origin, direction, t_max, term)
        self.out_sum = torch.full((n, 3), float("nan"))
        self.out_sq = torch.full((n, 3), float("nan"))
        self.samples = torch.full((n, count, 3), float("nan")) if split else None
        self.log = dict(sorted_types=0, shadow_queues=0, regenerated=0, items=0, nonfinite=0)

    # --- items, pixels, camera rays ---

    def perm(self, idx):
        return idx[torch.as_tensor(self.rs.permutation(len(idx)), dtype=torch.long)]

    def stream(self, idx):
        pix = self.pix[idx]
        return SampleStream(pixel_id=self.pid[pix],
                            sample_id=(self.s0[pix] + self.sample[idx]) & 0xFFFFFFFF,
                            seed=self.seed)

    def spawn(self, idx):
        s = self.stream(idx)
        o, d = spawn_rays(self.scene.camera, self.pxy[self.pix[idx]], s.next_2d(0), s.next_2d(1),
                          self.res)
        self.o[idx], self.d[idx], self.prev_point[idx] = o, d, o
        self.rad[idx] = 0.0
        self.tp[idx] = 1.0
        self.prev_pdf[idx] = 0.0
        self.prev_spec[idx] = True
        self.depth[idx] = 0
        self.ignore[idx] = -1
        self.alive[idx] = True
        self.ended[idx] = False

    def take_item(self, e) -> bool:
        item, self.work = self.work, self.work + 1
        if item >= self.items:
            self.alive[e] = False
            return False
        self.log["items"] += 1
        self.item[e] = item
        if self.split:
            self.pix[e], self.sample[e] = item % self.n, item // self.n
        else:
            self.pix[e], self.sample[e], self.slot[e] = item, 0, 0
            self.s_sum[e] = 0.0
            self.s_sq[e] = 0.0
        self.spawn(torch.tensor([e]))
        return True

    # --- the stages ---

    def trace(self, idx):
        sc = self.scene
        hit = scene_ops.trace(sc, self.o[idx], self.d[idx], torch.full((len(idx),), INF),
                              self.ignore[idx].to(torch.int32))
        self.hit_t[idx], self.hit_prim[idx], self.hit_uv[idx] = hit.t, hit.prim, hit.uv
        miss = ~hit.found
        if bool(miss.any()):  # path_step's escaped term; the path ends
            m = idx[miss]
            d = self.d[m]
            lt = sc.lights
            amb_pmf = torch.sum(torch.where(lt.kind == LIGHT_AMBIENT, lt.power, 0.0)) / \
                torch.clamp(torch.sum(lt.power), min=1e-20)
            inf_pdf = amb_pmf * scene_ops.env_pdf(sc, d)
            inf_w = torch.where(self.prev_spec[m], 1.0, _power_heuristic(self.prev_pdf[m], inf_pdf))
            self.rad[m] = self.rad[m] + self.tp[m] * torch.where(
                (self.depth[m] == 0)[..., None], scene_ops.eval_infinite(sc, d, True),
                scene_ops.eval_infinite(sc, d, False) * inf_w[..., None])
            self.ended[m] = True
        hits = idx[hit.found]
        return hits, self.contact(hits)

    def contact(self, idx):
        hit = Hit(t=self.hit_t[idx], prim=self.hit_prim[idx], uv=self.hit_uv[idx])
        return scene_ops.interact(self.scene, hit, self.o[idx], self.d[idx])

    def sort(self, hits, contact):
        """The hits grouped by material type, the types in a random order,
        each type's paths in a random order."""
        types = self.scene.materials.type[contact.mat_id.long()]
        groups = [self.perm(hits[types == t]) for t in torch.unique(types).tolist()]
        self.log["sorted_types"] = max(self.log["sorted_types"], len(groups))
        return torch.cat([groups[i] for i in self.rs.permutation(len(groups))]) if groups else hits

    def shade(self, idx):
        sc = self.scene
        hit = Hit(t=self.hit_t[idx], prim=self.hit_prim[idx], uv=self.hit_uv[idx])
        d, tp = self.d[idx], self.tp[idx]
        contact = scene_ops.interact(sc, hit, self.o[idx], d)
        zero = torch.zeros_like(hit.prim)
        emitted = scene_ops.emission_at(sc, contact, -d)
        hit_light = scene_ops.hit_light_record(sc, torch.clamp(hit.prim, min=0), zero)
        light_pm = scene_ops.light_pmf(sc, hit_light, self.prev_point[idx])
        fwd_pdf = light_pm * scene_ops.area_light_pdf(
            sc, hit.prim, self.prev_point[idx], contact.point, contact.geo_normal, d, inst=zero)
        em_w = torch.where(self.prev_spec[idx], 1.0, _power_heuristic(self.prev_pdf[idx], fwd_pdf))
        self.rad[idx] = self.rad[idx] + tp * emitted * em_w[..., None]

        wo = -d
        tangent, bitangent = vec.orthonormal_frame(contact.shade_normal)
        wo_local = vec.to_local(wo, tangent, bitangent, contact.shade_normal)
        stream = self.stream(idx)
        dim = CAMERA_DIMS + BOUNCE_DIM_STRIDE * self.depth[idx].to(torch.int32)
        u_bsdf = stream.next_2d(dim + DIM_BSDF)
        u_lobe = stream.next_1d(dim + DIM_LOBE)
        u_pick = stream.next_1d(dim + DIM_LIGHT_PICK)
        u_light = stream.next_2d(dim + DIM_LIGHT_SAMPLE)
        u_rr = stream.next_1d(dim + DIM_RR)
        bs = bsdf_mod.sample(contact.material, wo_local, u_bsdf, u_lobe)
        has_bounce = (bs.pdf > 0.0) & (self.depth[idx] < BOUNCE)

        record, pick_pmf = scene_ops.pick_light(sc, u_pick, contact.point)
        ls = scene_ops.sample_light(sc, record, contact.point, u_light)
        wi_l = vec.to_local(ls.incident, tangent, bitangent, contact.shade_normal)
        f_l = bsdf_mod.evaluate(contact.material, wo_local, wi_l)
        f_l = f_l * torch.abs(vec.dot(contact.shade_normal, ls.incident))[..., None]
        nee_pdf = pick_pmf * ls.pdf
        candidate = ~bs.specular & (nee_pdf > 1e-12) & torch.any(f_l * ls.radiant > 0.0, dim=-1)
        scatter_pdf_l = bsdf_mod.pdf(contact.material, wo_local, wi_l)
        mis_w = torch.where(ls.use_mis, _power_heuristic(nee_pdf, scatter_pdf_l), 1.0)
        nee = ls.radiant * f_l * (mis_w / torch.clamp(nee_pdf, min=1e-20))[..., None]
        shadow_o = _offset_origin(contact.point, contact.geo_normal, ls.incident)
        shadow_t = torch.where(ls.travel >= INF, INF, ls.travel * (1.0 - 1e-3))
        term = tp * nee
        for j in torch.nonzero(candidate).flatten().tolist():
            self.shadow[int(idx[j])] = (shadow_o[j], ls.incident[j], shadow_t[j], term[j])

        cos_i = torch.abs(bs.incident[..., 2])
        weight = bs.value * (cos_i / torch.clamp(bs.pdf, min=1e-20))[..., None]
        new_tp = tp * torch.where(has_bounce[..., None], weight, 1.0)
        rr = torch.clamp(SURV * colors.luminance(new_tp), 0.0, 1.0)
        new_tp = new_tp / torch.clamp(rr, min=1e-20)[..., None]
        cont = has_bounce & (u_rr < rr)
        wi_world = vec.to_world(bs.incident, tangent, bitangent, contact.shade_normal)
        cont_o = _offset_origin(contact.point, contact.geo_normal, wi_world)
        c = idx[cont]
        self.tp[c], self.o[c], self.d[c] = new_tp[cont], cont_o[cont], wi_world[cont]
        self.prev_point[c], self.prev_pdf[c] = contact.point[cont], bs.pdf[cont]
        self.prev_spec[c] = bs.specular[cont]
        self.depth[c] += 1
        self.ignore[c] = torch.clamp(hit.prim[cont], min=0).long()
        self.ended[idx[~cont]] = True

    def shadows(self):
        """The queued shadow rays, in a random order, one batch."""
        if not self.shadow:
            return
        self.log["shadow_queues"] += 1
        q = self.perm(torch.tensor(sorted(self.shadow)))
        o, d, t, term = (torch.stack([self.shadow[int(e)][i] for e in q]) for i in range(4))
        blocked = scene_ops.occlude(self.scene, o, d, t,
                                    torch.clamp(self.hit_prim[q], min=0), None)
        for j, e in enumerate(q.tolist()):
            if not bool(blocked[j]):
                self.rad[e] = self.rad[e] + term[j]
        self.shadow = {}

    def end(self, idx):
        """Entries of one block bank their ended paths and regenerate."""
        for e in self.perm(idx).tolist():
            if not (self.alive[e] and self.ended[e]):
                continue
            r = self.rad[e]
            pix = int(self.pix[e])
            if self.split:
                self.samples[pix, int(self.sample[e])] = r
                self.take_item(e)
                continue
            if bool(torch.isfinite(r[0] + r[1] + r[2])):
                self.s_sum[e] = self.s_sum[e] + r
                self.s_sq[e] = self.s_sq[e] + r * r
            else:
                self.log["nonfinite"] += 1
            self.sample[e] += 1
            if int(self.sample[e]) < self.count:
                self.log["regenerated"] += 1
                self.spawn(torch.tensor([e]))
                continue
            self.out_sum[pix], self.out_sq[pix] = self.s_sum[e], self.s_sq[e]
            slot = int(self.slot[e]) + 1
            nxt = slot * self.n_lanes + int(self.item[e])
            if slot >= self.k or nxt >= self.n:
                self.take_item(e)
                continue
            self.slot[e], self.pix[e], self.sample[e] = slot, nxt, 0
            self.s_sum[e] = 0.0
            self.s_sq[e] = 0.0
            self.spawn(torch.tensor([e]))

    def bounce(self, b):
        """One bounce of block b: its five stages."""
        own = torch.arange(b * self.entries, (b + 1) * self.entries)
        live = self.perm(own[self.alive[own]])
        if len(live) == 0:
            return False
        hits, contact = self.trace(live)
        if len(hits):
            self.shade(self.sort(hits, contact))
        self.shadows()
        self.end(own)
        return True

    def run(self):
        for e in range(self.blocks * self.entries):
            self.take_item(e)
        busy = list(range(self.blocks))
        while busy:
            b = busy[self.rs.randint(len(busy))]
            if not self.bounce(b):
                busy.remove(b)
        if self.split:  # bank_kernel: each pixel's samples in sample order
            for pix in range(self.n):
                s = torch.zeros(3)
                q = torch.zeros(3)
                for r in self.samples[pix]:
                    if bool(torch.isfinite(r[0] + r[1] + r[2])):
                        s, q = s + r, q + r * r
                    else:
                        self.log["nonfinite"] += 1
                self.out_sum[pix], self.out_sq[pix] = s, q
        return self.out_sum, self.out_sq


def _lanes(res, rs):
    """The pixels of a small frame in a shuffled order, with their coordinates."""
    pid = rs.permutation(res[0] * res[1]).astype(np.int64)
    pxy = np.stack([pid % res[0], pid // res[0]], -1).astype(np.int32)
    return torch.as_tensor(pid), torch.as_tensor(pxy)


def _nonfinite(scene):
    """The scene with an infinite emitter: paths that reach it bank nothing."""
    emissive = torch.nonzero(scene.mat_pack[:, 10] == 4).flatten()
    assert len(emissive), "the scene needs an emitter"
    pack = scene.mat_pack.clone()
    pack[emissive[0], 0:3] = float("inf")  # its albedo: the emitted radiance
    return scene._replace(mat_pack=pack)


CASES = [(name, mode) for name in SCENES for mode in ("lanes k=1", "lanes k=3", "split")]


@pytest.mark.parametrize("name,mode", CASES)
def test_pool_schedule_is_bitwise_the_plain_version(name, mode):
    """Any grouping of the hits by type, any queue order, any interleaving of
    blocks and any handing out of items give the plain version's sums."""
    rs = np.random.RandomState(sum(map(ord, name + mode)))
    scene = tprepare(SCENES[name](), device="cpu")
    res, count = (6, 5), 3
    pid, pxy = _lanes(res, rs)
    model = PoolModel(scene, pid, pxy, res, 5, 2, count, blocks=2, entries=4,
                      k_slots=3 if mode == "lanes k=3" else 1, split=mode == "split", rs=rs)
    got_s, got_q = model.run()
    want_s, want_q = tmk.sample_frame_mega_plain(scene, pid, pxy, res, 5, 2, count,
                                                 bounce_limit=BOUNCE, survivability=SURV)
    assert torch.equal(got_s, want_s) and torch.equal(got_q, want_q)
    assert float(want_s.sum()) > 0
    log = model.log
    # the schedule took the branches it is meant to test
    assert log["items"] == model.items and log["shadow_queues"] > 0 and log["sorted_types"] >= 2
    assert mode == "split" or log["regenerated"] > 0


@pytest.mark.parametrize("mode", ["lanes k=2", "split"])
def test_pool_leaves_out_nonfinite_samples(mode):
    """A sample whose radiance is not finite is banked by neither."""
    rs = np.random.RandomState(3)
    scene = _nonfinite(tprepare(tscenes.cornell_box(), device="cpu"))
    res, count = (5, 4), 4
    pid, pxy = _lanes(res, rs)
    model = PoolModel(scene, pid, pxy, res, 9, 0, count, blocks=3, entries=3,
                      k_slots=2, split=mode == "split", rs=rs)
    got_s, got_q = model.run()
    want_s, want_q = tmk.sample_frame_mega_plain(scene, pid, pxy, res, 9, 0, count,
                                                 bounce_limit=BOUNCE, survivability=SURV)
    assert model.log["nonfinite"] > 0 and bool(torch.isfinite(want_s).all())
    assert torch.equal(got_s, want_s) and torch.equal(got_q, want_q)


def _kept(rows, has_tri, has_sph):
    """csrc/megakernel.cu stage_records' rule: a slot is staged unless it is
    tested as a triangle with its b or c rows zero."""
    as_tri = has_tri & ~(has_sph & (rows[9] > 0.5))
    b_zero = (rows[3:6] == 0.0).all(0)
    c_zero = (rows[6:9] == 0.0).all(0)
    return ~as_tri | ~(b_zero | c_zero)


@pytest.mark.parametrize("name", ["sphere_field(12)", "material_ball", "cornell",
                                  "sphere_grid(1900)"])
def test_record_staging_leaves_out_only_slots_that_never_hit(name):
    """The slots the staging leaves out (padding, zero-area triangles) hit no
    ray, so closest hits over the kept slots in slot order are the full
    table's: the same (t, prim, u, v) and occlusion flags."""
    make = {**MORE, **SCENES}[name]
    soa = tprepare(make(), device="cpu").prim_soa
    has_tri, has_sph = soa.num_tris > 0, soa.num_prims > soa.num_tris
    keep = _kept(soa.rows, has_tri, has_sph)
    assert int((~keep).sum()) >= soa.padded - soa.num_prims
    rs = np.random.RandomState(1)
    n = 4096
    lo, hi = soa.rows[0:3, :soa.num_prims].amin(1), soa.rows[0:3, :soa.num_prims].amax(1)
    o = torch.as_tensor(rs.uniform(lo - 2.0, hi + 2.0, (n, 3)), dtype=torch.float32)
    d = torch.as_tensor(rs.normal(size=(n, 3)), dtype=torch.float32)
    d = d / torch.sqrt(vec.dot(d, d))[..., None]
    rays = torch.cat([o, d], -1).T.contiguous()
    ignore = torch.as_tensor(rs.randint(-1, soa.num_prims, n), dtype=torch.int32)
    t, u, v, ok = tpi._chunk_hits(soa.rows, 0, rays, ignore, has_tri, has_sph)
    assert not bool(ok[:, ~keep].any()), "a left-out slot hit a ray"
    assert bool(ok[:, keep].any())


# --- on the card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the megakernel needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sphere_field(12)", "material_ball", "textured", "cornell",
                                  "sphere_grid(1900)"])
def test_cuda_pool_bitwise(cuda, name):
    """Both forms, lanes of one and of four slots, the split form (a small
    frame at 4 spp) and the lanes form (the same frame at 1 spp, and a frame
    larger than the card holds paths): bitwise the plain version."""
    make = {**MORE, **SCENES}[name]
    scene = tprepare(make(), device=cuda)
    occ = tmk.occupancy(scene.tex_atlas.shape[0] > 0, scene.prim_soa.padded)
    big = (occ["paths"] // 128 + 1) * 128
    kw = dict(bounce_limit=BOUNCE, survivability=SURV)
    for res, count, k in [((32, 24), 4, None), ((32, 24), 1, None), ((128, big // 128), 2, None),
                          ((128, big // 128), 2, 4)]:
        pid = torch.arange(res[0] * res[1], device=cuda)
        pxy = torch.stack([pid % res[0], pid // res[0]], -1).to(torch.int32)
        a, a2 = tmk.sample_frame_mega(scene, pid, pxy, res, 3, 1, count, k_slots=k, **kw)
        b, b2 = tmk.sample_frame_mega_plain(scene, pid, pxy, res, 3, 1, count, **kw)
        torch.cuda.synchronize()
        assert torch.equal(a, b) and torch.equal(a2, b2), (res, count, k)


@pytest.mark.cuda
def test_cuda_pool_nonfinite_bitwise(cuda):
    scene = _nonfinite(tprepare(tscenes.cornell_box(), device=cuda))
    res = (32, 32)
    pid = torch.arange(res[0] * res[1], device=cuda)
    pxy = torch.stack([pid % res[0], pid // res[0]], -1).to(torch.int32)
    kw = dict(bounce_limit=BOUNCE, survivability=SURV)
    for count in (1, 4):
        a, a2 = tmk.sample_frame_mega(scene, pid, pxy, res, 2, 0, count, **kw)
        b, b2 = tmk.sample_frame_mega_plain(scene, pid, pxy, res, 2, 0, count, **kw)
        torch.cuda.synchronize()
        assert torch.equal(a, b) and torch.equal(a2, b2) and bool(torch.isfinite(a).all())
