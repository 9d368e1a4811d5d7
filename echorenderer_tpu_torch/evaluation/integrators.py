"""Integrators ("evaluators"), counterpart of
echorenderer_tpu/evaluation/integrators.py.

`path_step` is the path tracer's one physics function: trace the pending
ray, add MIS-weighted emission and infinite-light radiance, run NEE with
a shadow ray, sample the BSDF and apply Russian roulette, for every lane
at once under masks. Op for op the JAX package's, so the same lanes draw
the same samples and take the same decisions. The other evaluators:
  - path_trace: the lockstep path tracer over `path_step` (the
    "path_lockstep" evaluator), the A/B reference of the wavefront's
    regeneration: its per-sample sums equal the wavefront's bitwise;
  - naive_trace: brute-force paths without NEE or MIS;
  - albedo, normal_depth, aggregator_quality: first-hit AOVs (the last
    one a false colour of each ray's BVH traversal cost).
"""

from __future__ import annotations

import math

import torch

from ..aggregation.bvh import trace_cost
from ..ops.intersect import INF
from ..scene.prepare import LIGHT_AMBIENT, PreparedScene
from ..utils import colors, diagnostics, vec
from ..utils.rng import SampleStream
from . import bsdf as bsdf_mod
from . import scene_ops

# Dimension layout of the sample streams: the camera owns dims
# [0, CAMERA_DIMS) (0 = subpixel jitter, 1 = lens); bounce b draws from
# CAMERA_DIMS + BOUNCE_DIM_STRIDE * b + offset.
CAMERA_DIMS = 2
DIM_BSDF = 0
DIM_LOBE = 1
DIM_LIGHT_PICK = 2
DIM_LIGHT_SAMPLE = 3
DIM_RR = 4
BOUNCE_DIM_STRIDE = 8


def _power_heuristic(pdf0, pdf1):
    """Veach power heuristic, exponent 2."""
    sq = pdf0 * pdf0
    return sq / torch.clamp(sq + pdf1 * pdf1, min=1e-20)


def _offset_origin(point, geo_normal, direction):
    """Offset a spawned ray origin along the geometric normal."""
    side = torch.sign(vec.dot(geo_normal, direction))[..., None]
    return point + geo_normal * side * 1e-4


def path_step(scene: PreparedScene, stream: SampleStream, st: dict, live, *,
              bounce_limit: int, survivability: float, coherent: bool = False):
    """One path-tracing iteration for every lane. `st` carries radiance,
    throughput, o, d, depth, prev_pdf, prev_specular, prev_point, ignore
    and (optional) ignore_inst, the instance of the ignored prim.
    Returns the updated radiance, the post-bounce throughput (new_tp), the
    continuation mask/ray (continues, cont_o, wi_world), next-iteration MIS
    state (bs_pdf, bs_specular, contact_point, hit_prim, hit_inst) and an
    `aux` dict of event masks for the statistics counters. `coherent` marks
    the wavefront's first wave for the trace and the shadow rays
    (`scene_ops.trace`)."""
    # --- trace the pending ray ---
    seg_t = torch.where(live, INF, 0.0)
    hit = scene_ops.trace(scene, st["o"], st["d"], seg_t, st["ignore"], st.get("ignore_inst"),
                          coherent=coherent)
    hit_inst = hit.inst_or_zero
    found = live & hit.found
    contact = scene_ops.interact(scene, hit, st["o"], st["d"])

    # --- emission at the hit, MIS-weighted against NEE ---
    emitted = scene_ops.emission_at(scene, contact, -st["d"])
    hit_light = scene_ops.hit_light_record(scene, torch.clamp(hit.prim, min=0), hit_inst)
    light_pm = scene_ops.light_pmf(scene, hit_light, st["prev_point"])
    fwd_pdf = light_pm * scene_ops.area_light_pdf(
        scene, hit.prim, st["prev_point"], contact.point, contact.geo_normal, st["d"],
        inst=hit_inst,
    )
    em_w = torch.where(st["prev_specular"], 1.0, _power_heuristic(st["prev_pdf"], fwd_pdf))
    radiance = st["radiance"] + torch.where(
        found[..., None], st["throughput"] * emitted * em_w[..., None], 0.0
    )

    # --- miss: infinite lights, MIS against ambient NEE ---
    lt = scene.lights
    amb_pmf = torch.sum(torch.where(lt.kind == LIGHT_AMBIENT, lt.power, 0.0)) / torch.clamp(
        torch.sum(lt.power), min=1e-20
    )
    inf_pdf = amb_pmf * scene_ops.env_pdf(scene, st["d"])
    inf_w = torch.where(st["prev_specular"], 1.0, _power_heuristic(st["prev_pdf"], inf_pdf))
    escaped = live & ~hit.found
    is_camera = st["depth"] == 0
    radiance = radiance + torch.where(
        escaped[..., None],
        st["throughput"] * torch.where(
            is_camera[..., None],
            scene_ops.eval_infinite(scene, st["d"], True),
            scene_ops.eval_infinite(scene, st["d"], False) * inf_w[..., None],
        ),
        0.0,
    )

    # --- shade the found lanes: NEE + BSDF bounce ---
    wo = -st["d"]
    tangent, bitangent = vec.orthonormal_frame(contact.shade_normal)
    wo_local = vec.to_local(wo, tangent, bitangent, contact.shade_normal)
    dim = CAMERA_DIMS + BOUNCE_DIM_STRIDE * st["depth"]
    u_bsdf = stream.next_2d(dim + DIM_BSDF)
    u_lobe = stream.next_1d(dim + DIM_LOBE)
    u_pick = stream.next_1d(dim + DIM_LIGHT_PICK)
    u_light = stream.next_2d(dim + DIM_LIGHT_SAMPLE)
    u_rr = stream.next_1d(dim + DIM_RR)

    bs = bsdf_mod.sample(contact.material, wo_local, u_bsdf, u_lobe)
    cos_i = torch.abs(bs.incident[..., 2])
    has_bounce = found & (bs.pdf > 0.0) & (st["depth"] < bounce_limit)

    do_nee = found & ~bs.specular
    record, pick_pmf = scene_ops.pick_light(scene, u_pick, contact.point)
    ls = scene_ops.sample_light(scene, record, contact.point, u_light)
    wi_l = vec.to_local(ls.incident, tangent, bitangent, contact.shade_normal)
    f_l = bsdf_mod.evaluate(contact.material, wo_local, wi_l)
    f_l = f_l * torch.abs(vec.dot(contact.shade_normal, ls.incident))[..., None]
    nee_pdf = pick_pmf * ls.pdf
    candidate = do_nee & (nee_pdf > 1e-12) & torch.any(f_l * ls.radiant > 0.0, dim=-1)
    shadow_o = _offset_origin(contact.point, contact.geo_normal, ls.incident)
    shadow_t = torch.where(ls.travel >= INF, INF, ls.travel * (1.0 - 1e-3))
    shadow_t = torch.where(candidate, shadow_t, 0.0)
    blocked = scene_ops.occlude(
        scene, shadow_o, ls.incident, shadow_t, torch.clamp(hit.prim, min=0), hit_inst,
        coherent=coherent,
    )
    visible = candidate & ~blocked
    scatter_pdf_l = bsdf_mod.pdf(contact.material, wo_local, wi_l)
    mis_w = torch.where(ls.use_mis, _power_heuristic(nee_pdf, scatter_pdf_l), 1.0)
    nee = ls.radiant * f_l * (mis_w / torch.clamp(nee_pdf, min=1e-20))[..., None]
    radiance = radiance + torch.where(visible[..., None], st["throughput"] * nee, 0.0)

    # --- continue or die (Russian roulette) ---
    weight = bs.value * (cos_i / torch.clamp(bs.pdf, min=1e-20))[..., None]
    new_tp = st["throughput"] * torch.where(has_bounce[..., None], weight, 1.0)
    rr = torch.clamp(survivability * colors.luminance(new_tp), 0.0, 1.0)
    survived = u_rr < rr
    new_tp = new_tp / torch.clamp(rr, min=1e-20)[..., None]
    continues = has_bounce & survived

    wi_world = vec.to_world(bs.incident, tangent, bitangent, contact.shade_normal)
    cont_o = _offset_origin(contact.point, contact.geo_normal, wi_world)

    # device-side invariants (reference Ensure.cs class of checks), built
    # only when ECHO_DEBUG_DEVICE=1 and the frame runs under run_checked:
    # eager torch would launch the predicates even if dcheck dropped them
    if diagnostics.checks_active():
        diagnostics.dcheck(torch.isfinite(radiance), "path_step: non-finite radiance")
        diagnostics.dcheck(torch.isfinite(new_tp) & (new_tp >= 0.0),
                           "path_step: invalid throughput (NaN/Inf/negative)")
        diagnostics.dcheck(~has_bounce | (bs.pdf >= 0.0), "path_step: negative BSDF pdf")

    return dict(
        radiance=radiance,
        new_tp=new_tp,
        continues=continues,
        cont_o=cont_o,
        wi_world=wi_world,
        bs_pdf=bs.pdf,
        bs_specular=bs.specular,
        contact_point=contact.point,
        hit_prim=torch.clamp(hit.prim, min=0),
        hit_inst=hit_inst,
        aux=dict(found=found, candidate=candidate, has_bounce=has_bounce, survived=survived),
    )


def path_trace(scene: PreparedScene, stream: SampleStream, origin, direction, *,
               bounce_limit: int = 128, survivability: float = 2.5,
               first_wave_coherent: bool = False):
    """Radiance along camera rays, every lane through the bounce loop
    together under masks until none is live (a host read an iteration).
    `first_wave_coherent` marks relative sample 0: its camera bounce is
    traced with `coherent=True`, as the wavefront's peeled iteration 0 is,
    so both keep the same per-sample sums."""
    n = origin.shape[0]
    dev = origin.device
    st = dict(
        radiance=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
        o=origin,
        d=direction,
        depth=torch.zeros(n, dtype=torch.int32, device=dev),
        prev_pdf=torch.zeros(n, dtype=torch.float32, device=dev),
        prev_specular=torch.ones(n, dtype=torch.bool, device=dev),  # camera rays: specular
        prev_point=origin,
        ignore=torch.full((n,), -1, dtype=torch.int32, device=dev),
        ignore_inst=torch.zeros(n, dtype=torch.int32, device=dev),
    )
    live = torch.ones(n, dtype=torch.bool, device=dev)

    def body(live, st, coherent=False):
        out = path_step(scene, stream, st, live, bounce_limit=bounce_limit,
                        survivability=survivability, coherent=coherent)
        return live & out["continues"], dict(
            radiance=out["radiance"],
            throughput=out["new_tp"],
            o=out["cont_o"],
            d=out["wi_world"],
            depth=st["depth"] + 1,
            prev_pdf=out["bs_pdf"],
            prev_specular=out["bs_specular"],
            prev_point=out["contact_point"],
            ignore=out["hit_prim"].to(torch.int32),
            ignore_inst=out["hit_inst"].to(torch.int32),
        )

    if first_wave_coherent:
        live, st = body(live, st, coherent=True)
    while bool(live.any()):
        live, st = body(live, st)
    return st["radiance"]


def naive_trace(scene: PreparedScene, stream: SampleStream, origin, direction, *,
                bounce_limit: int = 8):
    """Brute-force path tracer without NEE or MIS (white-noise BSDF draws):
    the ground truth the MIS machinery is checked against."""
    n = origin.shape[0]
    dev = origin.device
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    o, d = origin, direction
    active = torch.ones(n, dtype=torch.bool, device=dev)
    ignore = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ignore_inst = torch.zeros(n, dtype=torch.int32, device=dev)

    for depth in range(bounce_limit + 1):
        seg_t = torch.where(active, INF, 0.0)
        hit = scene_ops.trace(scene, o, d, seg_t, ignore, ignore_inst)
        found = active & hit.found
        escaped = active & ~hit.found
        radiance = radiance + torch.where(
            escaped[..., None], throughput * scene_ops.eval_infinite(scene, d, depth == 0), 0.0
        )
        contact = scene_ops.interact(scene, hit, o, d)
        radiance = radiance + torch.where(
            found[..., None], throughput * scene_ops.emission_at(scene, contact, -d), 0.0
        )
        if depth == bounce_limit:
            break
        tangent, bitangent = vec.orthonormal_frame(contact.shade_normal)
        wo_local = vec.to_local(-d, tangent, bitangent, contact.shade_normal)
        dim = CAMERA_DIMS + BOUNCE_DIM_STRIDE * depth
        u2 = stream.white_2d(dim + DIM_BSDF)
        ul = stream.white_1d(dim + DIM_LOBE)
        bs = bsdf_mod.sample(contact.material, wo_local, u2, ul)
        cos_i = torch.abs(bs.incident[..., 2])
        weight = bs.value * (cos_i / torch.clamp(bs.pdf, min=1e-20))[..., None]
        throughput = throughput * torch.where(
            found[..., None] & (bs.pdf > 0.0)[..., None], weight, 1.0
        )
        active = found & (bs.pdf > 0.0)
        wi_world = vec.to_world(bs.incident, tangent, bitangent, contact.shade_normal)
        o = _offset_origin(contact.point, contact.geo_normal, wi_world)
        d = torch.where(active[..., None], wi_world, d)
        ignore = torch.clamp(hit.prim, min=0).to(torch.int32)
        ignore_inst = hit.inst_or_zero.to(torch.int32)
    return radiance


def _first_hit(scene: PreparedScene, origin, direction):
    n = origin.shape[0]
    dev = origin.device
    hit = scene_ops.trace(scene, origin, direction,
                          torch.full((n,), INF, dtype=torch.float32, device=dev),
                          torch.full((n,), -1, dtype=torch.int32, device=dev))
    return hit, scene_ops.interact(scene, hit, origin, direction)


def albedo(scene: PreparedScene, stream: SampleStream, origin, direction):
    """First-hit surface albedo AOV; misses evaluate the infinite lights
    seen by the camera."""
    hit, contact = _first_hit(scene, origin, direction)
    miss = scene_ops.eval_infinite(scene, direction, True)
    return torch.where(hit.found[..., None], contact.material.albedo, miss)


def aggregator_quality(scene: PreparedScene, stream: SampleStream, origin, direction):
    """False-colour traversal-cost AOV: each camera ray's BVH cost
    (`aggregation/bvh.trace_cost`) on a soft log scale, cheap rays blue,
    expensive ones through green to red (~32 visits is mid-range)."""
    cost = trace_cost(scene.bvh, origin, direction)
    x = torch.clamp(torch.log1p(cost) / math.log(256.0), 0.0, 1.0)
    r = torch.clamp(2.0 * x - 0.5, 0.0, 1.0)
    g = 1.0 - torch.abs(2.0 * x - 1.0)
    b = torch.clamp(1.0 - 2.0 * x, 0.0, 1.0)
    return torch.stack([r, g, b], dim=-1)


def normal_depth(scene: PreparedScene, stream: SampleStream, origin, direction):
    """Shading normal and hit distance AOV, (N, 4): zero normal and INF
    depth on a miss."""
    hit, contact = _first_hit(scene, origin, direction)
    normal = torch.where(hit.found[..., None], contact.shade_normal, 0.0)
    depth = torch.where(hit.found, hit.t, INF)
    return torch.cat([normal, depth[..., None]], dim=-1)
