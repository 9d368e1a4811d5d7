"""Scene queries: trace, occlude, interact, light sampling (counterpart of
echorenderer_tpu/evaluation/scene_ops.py), batched over a leading lane
axis on the scene's device.

Accelerator rule, as in the JAX package: scenes under LINEAR_THRESHOLD
prims take the plain dense broadcast; scenes with a chunk tree and at
least HIER_TRACE_MIN padded prims take the binned traversal
(ops/binned_trace.py), except for a population marked `coherent` (the
wavefront's first wave: camera rays in tile-major order and their shadow
rays), which takes the chunk-tree walk (ops/pallas_hier.py); every other
scene takes the dense chunk kernels of ops/pallas_intersect.py. Inside
`walk_only()` every population of a flat scene with chunk-tree tables
takes the walk, whatever its size (the plain version of the megakernel's
chunk-tree form, and the dispatch before the binned traversal).

Integrator rule (`dispatch_summary`): a CUDA scene inside the
megakernel's envelope takes the fused kernel; with `ECHO_MEGA_HIER` set
in the environment, a CUDA scene outside it but inside the chunk-tree
form's envelope takes that form (`_use_mega_hier`, the JAX package's
gate); every other frame runs the wavefront.

TLAS-instanced scenes (`scene.instances`) keep their packs in pack space,
so every ray takes the instanced walk or, from HIER_TRACE_MIN unrolled
prims on (`_use_binned_instanced`) and but for the coherent population,
the instanced binned traversal; hits carry their instance, and `interact`
moves the pack-space shading rows into world space with the instance row
and remaps the material through the instance's swatch.

Textured materials sample the scene's atlas at the contact's uv
(`_sample_atlas`): albedo, a tangent-space normal map and roughness. Env
maps (textured ambient lights) add their radiance to escaped rays and are
importance-sampled by NEE, as a power-weighted mixture when there are
several (`eval_infinite`, `env_pdf`, `sample_light`).
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import NamedTuple

import torch

from ..aggregation import light_tree
from ..ops import megakernel
from ..ops.binned_trace import occlude_binned, trace_binned
from ..ops.intersect import INF, Hit, intersect_linear, occlude_linear, sphere_uv
from ..ops.pallas_hier import HCHUNK, intersect_hier, occlude_hier
from ..ops.pallas_intersect import intersect_pallas, occlude_pallas
from ..scene.materials import EMISSIVE, INVISIBLE
from ..scene.prepare import (
    LIGHT_AMBIENT,
    LIGHT_DIRECTIONAL,
    LIGHT_EMISSIVE_TRI,
    LIGHT_POINT,
    PreparedScene,
)
from ..utils import rng as rng_mod
from ..utils import vec
from .bsdf import GatheredMaterial

LINEAR_THRESHOLD = 32
# padded prim count from which a scene's rays walk the chunk tree instead of
# streaming every dense chunk
HIER_TRACE_MIN = 65536


# set by walk_only()
_WALK_ONLY = False


def _use_hier(scene: PreparedScene) -> bool:
    return (scene.hier_soa is not None and scene.prim_soa is not None
            and (_WALK_ONLY or scene.prim_soa.padded >= HIER_TRACE_MIN))


def _use_binned(scene: PreparedScene) -> bool:
    """The binned traversal takes every population but the coherent one
    wherever the chunk tree would, outside `walk_only()`."""
    return not _WALK_ONLY and _use_hier(scene)


@contextlib.contextmanager
def walk_only():
    """While open, every trace and occlude of a flat scene with chunk-tree
    tables goes to the walk, whatever the scene's size: no population is
    binned, as under the JAX package's ECHO_NO_BINNED. The plain version of
    the megakernel's chunk-tree form runs the wavefront so; so does the
    comparison of the binned dispatch with the walk."""
    global _WALK_ONLY
    saved, _WALK_ONLY = _WALK_ONLY, True
    try:
        yield
    finally:
        _WALK_ONLY = saved


def _use_mega_hier(scene: PreparedScene) -> bool:
    """The JAX package's gate of the megakernel's chunk-tree form: a CUDA
    scene outside the megakernel's envelope but inside the chunk-tree
    form's, with ECHO_MEGA_HIER set. Off by default."""
    return (scene.device.type == "cuda" and not megakernel.supported(scene)
            and megakernel.supported_hier(scene) and bool(os.environ.get("ECHO_MEGA_HIER")))


def _use_binned_instanced(scene: PreparedScene) -> bool:
    """An instanced scene takes the binned traversal (but for the coherent
    population) when its unrolled extent, global chunks x HCHUNK, reaches
    HIER_TRACE_MIN, as flat scenes do (tests patch this off to run the walk
    alone)."""
    soa = scene.hier_soa
    return (soa is not None and soa.instanced
            and soa.binned_g2c.shape[0] * HCHUNK >= HIER_TRACE_MIN)


def dispatch_summary(scene: PreparedScene, return_stats: bool = False) -> dict:
    """Which accelerator and integrator this scene's renders take, and why
    (a render that asks for the wavefront's stats bypasses the megakernel)."""
    kind = "CUDA kernel" if scene.device.type == "cuda" else "plain PyTorch version"
    if scene.instances is not None:
        soa = scene.hier_soa
        unrolled = soa.binned_g2c.shape[0] * HCHUNK
        if _use_binned_instanced(scene):
            acc = "binned"
            why = (f"large TLAS scene: per-ray binned traversal of the instances ({kind}, "
                   f"{soa.binned_g2c.shape[0]} global chunks, {unrolled} unrolled slots >= "
                   f"{HIER_TRACE_MIN}, {scene.instances.num_instances} instances); the "
                   f"coherent first wave takes the instanced chunk-tree walk")
        else:
            acc = "hier-packet"
            why = (f"TLAS scene: instanced chunk-tree walk ({kind}, "
                   f"{scene.instances.num_instances} instances, {unrolled} unrolled slots "
                   f"< {HIER_TRACE_MIN} or binned traversal off)")
    elif scene.geometry.num_primitives < LINEAR_THRESHOLD:
        acc, why = "linear", f"< {LINEAR_THRESHOLD} prims"
    elif _use_binned(scene):
        acc = "binned"
        why = (f"large scene: per-ray binned traversal ({kind}, {scene.prim_soa.padded} padded "
               f"prims >= {HIER_TRACE_MIN}, {scene.hier_soa.num_chunks} chunks); the coherent "
               f"first wave takes the chunk-tree walk")
    elif _use_hier(scene):
        acc = "hier-packet"
        why = (f"chunk-tree walk ({kind}, {scene.prim_soa.padded} padded prims >= "
               f"{HIER_TRACE_MIN}, {scene.hier_soa.num_chunks} chunks); binned traversal off")
    else:
        acc = "dense-stream"
        why = f"dense chunk trace/occlude ({kind}, {scene.prim_soa.padded} padded prims)"
    if scene.device.type != "cuda":
        integ, iwhy = "wavefront", "not on CUDA"
    elif return_stats:
        integ, iwhy = "wavefront", "stats render (megakernel bypassed)"
    elif megakernel.supported(scene):
        form = "textured" if scene.tex_atlas.shape[0] else "untextured"
        integ, iwhy = "megakernel", f"fully fused trace+shade, {form} form"
    elif _use_mega_hier(scene):
        integ, iwhy = "megakernel-hier", "ECHO_MEGA_HIER fat-chunk kernel"
    else:
        integ = "wavefront"
        iwhy = megakernel.unsupported_reason(scene) or "outside megakernel envelope"
    return {
        "accelerator": acc, "accelerator_reason": why,
        "integrator": integ, "integrator_reason": iwhy,
    }


def trace(scene: PreparedScene, o, d, t_max, ignore, ignore_inst=None,
          coherent: bool = False) -> Hit:
    """`coherent=True` marks a tile-coherent population (the wavefront's
    first wave), which a large scene sends to the chunk-tree walk; every
    other population of such a scene takes the binned traversal.
    `ignore_inst` is the instance of each ray's ignored prim (TLAS scenes;
    other scenes ignore it)."""
    if scene.instances is not None:
        if _use_binned_instanced(scene) and not coherent:
            return trace_binned(scene.geometry, scene.hier_soa, o, d, t_max, ignore, ignore_inst)
        return intersect_hier(scene.geometry, scene.hier_soa, o, d, t_max, ignore, ignore_inst)
    if scene.geometry.num_primitives < LINEAR_THRESHOLD:
        return intersect_linear(scene.geometry, o, d, t_max, ignore)
    if _use_binned(scene) and not coherent:
        return trace_binned(scene.geometry, scene.hier_soa, o, d, t_max, ignore)
    if _use_hier(scene):
        return intersect_hier(scene.geometry, scene.hier_soa, o, d, t_max, ignore)
    return intersect_pallas(scene.geometry, scene.prim_soa, o, d, t_max, ignore)


def occlude(scene: PreparedScene, o, d, t_max, ignore, ignore_inst=None,
            coherent: bool = False) -> torch.Tensor:
    """See trace()."""
    if scene.instances is not None:
        if _use_binned_instanced(scene) and not coherent:
            return occlude_binned(scene.geometry, scene.hier_soa, o, d, t_max, ignore,
                                  ignore_inst)
        return occlude_hier(scene.geometry, scene.hier_soa, o, d, t_max, ignore, ignore_inst)
    if scene.geometry.num_primitives < LINEAR_THRESHOLD:
        return occlude_linear(scene.geometry, o, d, t_max, ignore)
    if _use_binned(scene) and not coherent:
        return occlude_binned(scene.geometry, scene.hier_soa, o, d, t_max, ignore)
    if _use_hier(scene):
        return occlude_hier(scene.geometry, scene.hier_soa, o, d, t_max, ignore)
    return occlude_pallas(scene.geometry, scene.prim_soa, o, d, t_max, ignore)


def _sample_atlas(atlas, tid, uv):
    """Repeat-wrapped bilinear sample of the (T, R, R, 4) atlas at texture
    ids `tid` (clamped to >= 0 here: a -1 id must not wrap to the last
    slice) -> linear RGB (N, 3). csrc/megakernel.cu's texture stage repeats
    this arithmetic op for op."""
    r = atlas.shape[1]
    tid = torch.clamp(tid, min=0).long()
    u = torch.remainder(uv[..., 0], 1.0) * r - 0.5
    v = torch.remainder(uv[..., 1], 1.0) * r - 0.5
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u0w, u1w = torch.remainder(u0, r), torch.remainder(u0 + 1, r)
    v0w, v1w = torch.remainder(v0, r), torch.remainder(v0 + 1, r)
    t00 = atlas[tid, v0w, u0w]
    t01 = atlas[tid, v0w, u1w]
    t10 = atlas[tid, v1w, u0w]
    t11 = atlas[tid, v1w, u1w]
    top = t00 * (1 - fu) + t01 * fu
    bot = t10 * (1 - fu) + t11 * fu
    return (top * (1 - fv) + bot * fv)[..., :3]


class Contact(NamedTuple):
    """Shading contact (reference Contact.cs)."""

    point: torch.Tensor  # (N, 3)
    geo_normal: torch.Tensor  # (N, 3)
    shade_normal: torch.Tensor  # (N, 3)
    uv: torch.Tensor  # (N, 2)
    material: GatheredMaterial
    mat_id: torch.Tensor  # (N,) int32


def interact(scene: PreparedScene, hit: Hit, o, d) -> Contact:
    """Shading contact for each lane's hit (lanes without hits get clamped
    garbage that callers mask): one packed-row gather per prim and one
    per material. On a TLAS scene one more gather of the hit's instance row
    rotates the pack-space normals into world space, places the sphere
    (centre and radius) and remaps the material through the swatch."""
    prim = torch.clamp(hit.prim, min=0).long()
    row = scene.shade_pack[prim]  # (N, 24)
    is_sph = row[..., 20] > 0.5

    point = o + d * hit.t[..., None]

    it = scene.instances
    if it is not None:
        inst = torch.clamp(hit.inst, 0, it.num_instances - 1).long()
        irow = it.rows[inst]  # (N, 16)
        rot = irow[..., 0:9].reshape(irow.shape[:-1] + (3, 3))
        rot_w = lambda x: vec.affine(x, rot)  # world = R @ local
    else:
        rot_w = lambda x: x

    u, v = hit.uv[..., 0], hit.uv[..., 1]
    w = 1.0 - u - v
    tri_geo = rot_w(row[..., 0:3])
    tri_shade = vec.normalize(rot_w(
        w[..., None] * row[..., 3:6] + u[..., None] * row[..., 6:9] + v[..., None] * row[..., 9:12]
    ))
    tri_uv = w[..., None] * row[..., 12:14] + u[..., None] * row[..., 14:16] + v[..., None] * row[..., 16:18]
    if it is not None:
        sph_center = rot_w(row[..., 0:3]) * irow[..., 12:13] + irow[..., 9:12]
        sph_radius = row[..., 3] * irow[..., 12]
    else:
        sph_center = row[..., 0:3]
        sph_radius = row[..., 3]
    sph_geo = vec.normalize(point - sph_center)
    geo_n = torch.where(is_sph[..., None], sph_geo, tri_geo)
    shade_n = torch.where(is_sph[..., None], sph_geo, tri_shade)
    sph_uv = sphere_uv(point - sph_center, sph_radius)
    uv_out = torch.where(is_sph[..., None], sph_uv, tri_uv)
    mat_id = row[..., 18].to(torch.int32)
    if it is not None:
        mat_id = it.mat_remap[inst * it.num_materials + mat_id.long()]

    m = scene.materials
    mrow = scene.mat_pack[mat_id.long()]  # (N, 16)
    albedo = mrow[..., 0:3]
    params = mrow[..., 3:7]
    atlas = scene.tex_atlas
    if atlas.shape[0]:  # textured materials: albedo, normal map, roughness
        tid = mrow[..., 11].to(torch.int32)
        albedo = torch.where((tid >= 0)[..., None], _sample_atlas(atlas, tid, uv_out), albedo)
        # tangent-space normal map, scaled by the material's intensity
        ntid = mrow[..., 13].to(torch.int32)
        tn = _sample_atlas(atlas, ntid, uv_out) * 2.0 - 1.0
        intensity = mrow[..., 14:15]
        t_, b_ = vec.orthonormal_frame(shade_n)
        perturbed = vec.normalize(
            t_ * tn[..., 0:1] * intensity
            + b_ * tn[..., 1:2] * intensity
            + shade_n * torch.clamp(tn[..., 2:3], min=0.1)
        )
        shade_n = torch.where((ntid >= 0)[..., None], perturbed, shade_n)
        # texture-valued roughness: the mean of the sample's RGB
        rtid = mrow[..., 15].to(torch.int32)
        rough = vec.component_sum(_sample_atlas(atlas, rtid, uv_out)) * (1.0 / 3.0)
        params = torch.cat(
            [torch.where(rtid >= 0, rough, params[..., 0])[..., None], params[..., 1:]], dim=-1
        )
    mat_type = mrow[..., 10].to(torch.int32)
    if INVISIBLE in (m.present or ()):  # OneSided wrappers: backfaces pass through
        backface = vec.dot(geo_n, -d) < 0.0
        one_sided = mrow[..., 12] > 0.5
        mat_type = torch.where(backface & one_sided, INVISIBLE, mat_type)
    material = GatheredMaterial(
        type=mat_type,
        albedo=albedo,
        params=params,
        extra=mrow[..., 7:10],
        present=m.present if m.present else GatheredMaterial._field_defaults["present"],
    )
    return Contact(point=point, geo_normal=geo_n, shade_normal=shade_n, uv=uv_out,
                   material=material, mat_id=mat_id)


def emission_at(scene: PreparedScene, contact: Contact, wo) -> torch.Tensor:
    """Emitted radiance toward wo (one-sided by the geometric normal)."""
    facing = vec.dot(contact.geo_normal, wo) > 0.0
    is_emissive = contact.material.type == EMISSIVE
    return torch.where((facing & is_emissive)[..., None], contact.material.albedo, 0.0)


def eval_infinite(scene: PreparedScene, d, directly_visible_only: bool) -> torch.Tensor:
    """Total infinite-light radiance along d: the constant ambient aggregate
    plus every env map, each with its own rotation, intensity and camera
    visibility."""
    lt = scene.lights
    base = lt.ambient_camera if directly_visible_only else lt.ambient_all
    out = base.expand(d.shape)
    for e, env in enumerate(scene.env_maps):
        rad = env.evaluate(vec.rotate(d, lt.env_rotation[e])) * lt.env_scale[e]
        if directly_visible_only:
            rad = rad * lt.env_camera[e]
        out = out + rad
    return out


def env_pdf(scene: PreparedScene, d) -> torch.Tensor:
    """Solid-angle pdf of ambient-light direction sampling: the
    power-weighted mixture over the LIGHT_AMBIENT records (each env map,
    and the uniform constant record when present). Times the total ambient
    pick probability it is sum_r pmf_r * pdf_r(d), the forward-MIS density
    of the two-stage pick and sample."""
    lt = scene.lights
    n_env = len(scene.env_maps)
    if n_env == 0:
        return torch.full(d.shape[:-1], 1.0 / (4.0 * math.pi), device=d.device)
    if n_env == 1 and lt.amb_const_power.shape[0] == 0:
        # one env map alone: its own pdf
        return scene.env_maps[0].pdf(vec.rotate(d, lt.env_rotation[0]))
    total = torch.sum(lt.env_power) + torch.sum(lt.amb_const_power)
    acc = (torch.sum(lt.amb_const_power) * (1.0 / (4.0 * math.pi))).expand(d.shape[:-1])
    for e, env in enumerate(scene.env_maps):
        acc = acc + lt.env_power[e] * env.pdf(vec.rotate(d, lt.env_rotation[e]))
    return acc / torch.clamp(total, min=1e-20)


class LightSample(NamedTuple):
    radiant: torch.Tensor  # (N, 3) emitted radiance toward the surface
    incident: torch.Tensor  # (N, 3) direction surface -> light
    travel: torch.Tensor  # (N,) distance to the light (INF for infinite)
    pdf: torch.Tensor  # (N,) solid-angle pdf (1 for delta lights)
    target_prim: torch.Tensor  # (N,) prim to ignore in the shadow ray (-1)
    target_inst: torch.Tensor  # (N,) int32 instance of target_prim (0 unless TLAS)
    use_mis: torch.Tensor  # (N,) bool — non-delta light, MIS applies


def _infinite_split(lt):
    """Power fraction routed to infinite lights, and the masked power rows
    (the infinite-vs-finite split of the two-stage pick)."""
    inf_mask = (lt.kind == LIGHT_DIRECTIONAL) | (lt.kind == LIGHT_AMBIENT)
    w_inf = torch.where(inf_mask, lt.power, 0.0)
    total = torch.clamp(torch.sum(lt.power), min=1e-20)
    p_inf = torch.sum(w_inf) / total
    return p_inf, w_inf


def pick_light(scene: PreparedScene, u, x=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Light selection: the flat power CDF for scenes without a light tree,
    otherwise a two-stage pick: infinite lights by power, finite lights by
    the tree descent from the shading points x. Returns (record, pmf)."""
    lt = scene.lights
    if lt.tree is None or x is None:
        idx = torch.searchsorted(lt.cdf, u.contiguous(), right=True)
        idx = torch.clamp(idx, 0, lt.num_lights - 1)
        total = torch.sum(lt.power)
        pmf = lt.power[idx] / torch.clamp(total, min=1e-20)
        return idx.to(torch.int32), pmf

    p_inf, w_inf = _infinite_split(lt)
    pick_inf = u < p_inf
    # infinite branch: flat CDF over the masked rows
    u_inf = torch.clamp(u / torch.clamp(p_inf, min=1e-12), 0.0, 1.0 - 1e-7)
    sum_inf = torch.clamp(torch.sum(w_inf), min=1e-20)
    cdf_inf = torch.cumsum(w_inf, 0) / sum_inf
    idx_inf = torch.clamp(
        torch.searchsorted(cdf_inf, u_inf.contiguous(), right=True), 0, lt.num_lights - 1
    )
    pmf_inf = w_inf[idx_inf] / sum_inf * p_inf
    # finite branch: tree descent
    u_fin = torch.clamp((u - p_inf) / torch.clamp(1.0 - p_inf, min=1e-12), 0.0, 1.0 - 1e-7)
    leaf, pmf_tree = light_tree.pick(lt.tree, x, u_fin)
    rec_fin = lt.tree_records[leaf.long()].long()
    record = torch.where(pick_inf, idx_inf, rec_fin)
    pmf = torch.where(pick_inf, pmf_inf, pmf_tree * (1.0 - p_inf))
    return record.to(torch.int32), pmf


def light_pmf(scene: PreparedScene, record, x=None) -> torch.Tensor:
    """Probability `pick_light` returns `record` from points x (for
    forward-hit MIS)."""
    lt = scene.lights
    ok = record >= 0
    rec = torch.clamp(record, min=0).long()
    if lt.tree is None or x is None:
        total = torch.sum(lt.power)
        p = lt.power[rec] / torch.clamp(total, min=1e-20)
        return torch.where(ok, p, 0.0)

    p_inf, w_inf = _infinite_split(lt)
    sum_inf = torch.clamp(torch.sum(w_inf), min=1e-20)
    is_inf = w_inf[rec] > 0.0
    p_flat = w_inf[rec] / sum_inf * p_inf
    tree_id = lt.record_tree[rec]
    p_tree = light_tree.pmf_of_light(lt.tree, tree_id, x) * (1.0 - p_inf)
    return torch.where(ok, torch.where(is_inf, p_flat, p_tree), 0.0)


def sample_light(scene: PreparedScene, record, x, u2) -> LightSample:
    """Sample a direction/radiance from the selected light record toward
    surface points x, branchless over kinds."""
    lt = scene.lights
    n = x.shape[0]
    dev = x.device
    record = torch.clamp(record, min=0).long()
    kind = lt.kind[record]
    index = lt.index[record].long()

    if lt.point_pos.shape[0]:
        pi = torch.clamp(index, 0, lt.point_pos.shape[0] - 1)
        delta_p = lt.point_pos[pi] - x
        dist2_p = torch.clamp(vec.length_squared(delta_p), min=1e-12)
        dist_p = torch.sqrt(dist2_p)
        wi_p = delta_p / dist_p[..., None]
        rad_p = lt.point_intensity[pi] / dist2_p[..., None]
    else:
        wi_p = torch.zeros_like(x)
        dist_p = torch.zeros(n, device=dev)
        rad_p = torch.zeros_like(x)

    if lt.dir_dir.shape[0]:
        di = torch.clamp(index, 0, lt.dir_dir.shape[0] - 1)
        wi_d = -lt.dir_dir[di]
        rad_d = lt.dir_intensity[di].expand(x.shape)
    else:
        wi_d = torch.zeros_like(x)
        rad_d = torch.zeros_like(x)

    # ambient: the picked record (env map e or the constant aggregate)
    # supplies the direction; the radiance is the total infinite radiance
    # along it, and the pdf the ambient mixture density rescaled so that
    # pick pmf * pdf = p_ambient * mixture(d) whichever record was picked:
    # the NEE density equals the forward-hit one (amb_pmf * env_pdf), so
    # the power-heuristic pair sums to 1 with several env maps
    n_env = len(scene.env_maps)
    if n_env == 1 and lt.amb_const_power.shape[0] == 0:
        # one env map alone: its own sample and pdf
        local_dir, amb_pdf = scene.env_maps[0].sample(u2)
        wi_a = vec.rotate(local_dir, lt.env_rotation[0].T)  # env local -> world
        rad_a = lt.ambient_all + scene.env_maps[0].evaluate(local_dir) * lt.env_scale[0]
    elif n_env:
        wi_a = torch.zeros_like(x)
        for e, env in enumerate(scene.env_maps):
            local_dir, _ = env.sample(u2)
            wi_a = torch.where((index == e)[..., None],
                               vec.rotate(local_dir, lt.env_rotation[e].T), wi_a)
        w_amb = torch.cat([lt.env_power, lt.amb_const_power])
        if lt.amb_const_power.shape[0]:
            wi_a = torch.where((index >= n_env)[..., None], rng_mod.uniform_sphere(u2), wi_a)
        # the record's share of the ambient power (index E: the constant)
        frac = (w_amb / torch.clamp(torch.sum(w_amb), min=1e-20))[
            torch.clamp(index, 0, w_amb.shape[0] - 1)]
        amb_pdf = env_pdf(scene, wi_a) / torch.clamp(frac, min=1e-20)
        rad_a = eval_infinite(scene, wi_a, False)
    else:
        wi_a = rng_mod.uniform_sphere(u2)
        amb_pdf = torch.full((n,), 1.0 / (4.0 * math.pi), device=dev)
        rad_a = lt.ambient_all.expand(x.shape)

    if lt.emissive_prim.shape[0]:
        ei = torch.clamp(index, 0, lt.emissive_prim.shape[0] - 1)
        prim = lt.emissive_prim[ei]
        target_inst_e = lt.emissive_inst[ei]
        erow = scene.emissive_pack[ei]  # (N, 20)
        is_sph_e = erow[..., 16] > 0.5

        bary = rng_mod.uniform_triangle(u2)
        p_tri = erow[..., 0:3] + bary[..., 0:1] * erow[..., 3:6] + bary[..., 1:2] * erow[..., 6:9]
        n_tri = erow[..., 9:12]
        sp_dir = rng_mod.uniform_sphere(u2)
        p_sph = erow[..., 0:3] + sp_dir * erow[..., 3:4]
        p_l = torch.where(is_sph_e[..., None], p_sph, p_tri)
        n_l = torch.where(is_sph_e[..., None], sp_dir, n_tri)
        area = erow[..., 15]

        delta_e = p_l - x
        dist2_e = torch.clamp(vec.length_squared(delta_e), min=1e-12)
        dist_e = torch.sqrt(dist2_e)
        wi_e = delta_e / dist_e[..., None]
        cos_l = vec.dot(n_l, -wi_e)
        emitted = erow[..., 12:15]
        rad_e = torch.where((cos_l > 0.0)[..., None], emitted, 0.0)
        pdf_e = dist2_e / torch.clamp(torch.abs(cos_l) * area, min=1e-12)
        target_e = prim
    else:
        wi_e = torch.zeros_like(x)
        dist_e = torch.zeros(n, device=dev)
        rad_e = torch.zeros_like(x)
        pdf_e = torch.ones(n, device=dev)
        target_e = torch.full((n,), -1, dtype=torch.int32, device=dev)
        target_inst_e = torch.zeros(n, dtype=torch.int32, device=dev)

    def sel(point_v, dir_v, amb_v, emi_v):
        out = torch.where(_exp(kind == LIGHT_POINT, point_v), point_v, 0.0)
        out = torch.where(_exp(kind == LIGHT_DIRECTIONAL, dir_v), dir_v, out)
        out = torch.where(_exp(kind == LIGHT_AMBIENT, amb_v), amb_v, out)
        out = torch.where(_exp(kind == LIGHT_EMISSIVE_TRI, emi_v), emi_v, out)
        return out

    inf = torch.full((n,), INF, device=dev)
    one = torch.ones(n, device=dev)
    return LightSample(
        radiant=sel(rad_p, rad_d, rad_a, rad_e),
        incident=sel(wi_p, wi_d, wi_a, wi_e),
        travel=sel(dist_p, inf, inf, dist_e),
        pdf=sel(one, one, amb_pdf, pdf_e),
        target_prim=torch.where(kind == LIGHT_EMISSIVE_TRI, target_e, -1),
        target_inst=torch.where(kind == LIGHT_EMISSIVE_TRI, target_inst_e, 0),
        use_mis=(kind == LIGHT_AMBIENT) | (kind == LIGHT_EMISSIVE_TRI),
    )


def area_light_pdf(scene: PreparedScene, prim, origin, point, geo_normal, direction, inst=None):
    """Solid-angle pdf of NEE having sampled `direction` toward the
    emissive `prim` hit at `point`; on a TLAS scene the prim's pack-space
    area times its instance's scale^2."""
    area = scene.shade_pack[torch.clamp(prim, min=0).long(), 19]
    it = scene.instances
    if it is not None and inst is not None:
        area = area * it.rows[torch.clamp(inst, 0, it.num_instances - 1).long(), 13]
    delta = point - origin
    dist2 = torch.clamp(vec.length_squared(delta), min=1e-12)
    cos_l = torch.abs(vec.dot(geo_normal, direction))
    return dist2 / torch.clamp(cos_l * area, min=1e-12)


def hit_light_record(scene: PreparedScene, prim, inst=None) -> torch.Tensor:
    """Light record id of the emissive (prim, inst) pair, or -1: the prim's
    record on a baked scene; on a TLAS scene the instance's first emissive
    record plus the prim's rank in its profile."""
    it = scene.instances
    prim_c = torch.clamp(prim, min=0).long()
    if it is None:
        return scene.lights.prim_light[prim_c]
    inst_c = torch.clamp(inst if inst is not None else torch.zeros_like(prim), 0,
                         it.num_instances - 1).long()
    irow = it.rows[inst_c]
    emi_base = irow[..., 14].to(torch.int32)
    profile = irow[..., 15].long()
    ordv = it.emi_ordinal[profile * it.num_storage + prim_c]
    return torch.where((ordv >= 0) & (emi_base >= 0), emi_base + ordv, -1)


def _exp(mask, like):
    return mask[..., None] if like.dim() > mask.dim() else mask
