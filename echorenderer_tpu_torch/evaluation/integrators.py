"""The path tracer's one physics function (counterpart of
echorenderer_tpu/evaluation/integrators.py `path_step`): trace the pending
ray, add MIS-weighted emission and infinite-light radiance, run NEE with
a shadow ray, sample the BSDF and apply Russian roulette, for every lane
at once under masks. Op for op the JAX package's, so the same lanes draw
the same samples and take the same decisions.
"""

from __future__ import annotations

import torch

from ..ops.intersect import INF
from ..scene.prepare import LIGHT_AMBIENT, PreparedScene
from ..utils import colors, vec
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
    hit_inst = hit.inst if hit.inst is not None else torch.zeros_like(hit.prim)
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
