"""Scene preparation: mutable scene graph -> render-ready tensors on one
device (counterpart of echorenderer_tpu/scene/prepare.py).

The host walk, material interning, light census, SAH BVH order and the
packed row layouts are the JAX package's, table for table:
  shade_pack (P, 24)  tri: [geo_n(3) n0(3) n1(3) n2(3) uv0(2) uv1(2) uv2(2) mat area 0]
                      sph: [center(3) radius .. mat area 1]
  mat_pack (M, 16)    [albedo(3) params(4) extra(3) type tex one_sided ntex nint rtex]
  emissive_pack (Le, 20) [v0(3) e1(3) e2(3) n(3) albedo(3) area is_sph]
  tex_atlas (T, R, R, 4) every albedo, normal-map and roughness texture,
                      resampled to ATLAS_RES and rounded to bf16 values
plus the dense kernels' `PrimSoA` and, from HIER_BUILD_MIN prims on, the
chunk-tree walk's `HierSoA` (ops/pallas_hier.py), both from the same BVH
leaf order, and that BVH itself (`bvh`, for the traversal-cost AOV).
`subdivide` splits oversized triangles before any of these are built. Every table lives on the `device` given to `prepare_scene`;
everything downstream follows the scene's device.

From LIGHT_TREE_THRESHOLD finite lights on, the light table carries an
Estevez-Kulla light tree (aggregation/light_tree.py), built as the JAX
package builds it. Packs placed by PackInstances are baked into the world
("bake"), or kept once in pack space and traced through a TLAS ("tlas";
scene/instancing.py), as the JAX package decides (`_shared_packs`).
Each textured AmbientLight becomes an env map (`env_maps`) with a light
record of its own; constant ambients add up into one record after them.
The SAH BVH comes from aggregation/bvh.build_bvh (the C++ builder).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..aggregation.bvh import FlatBVH, build_bvh, geometry_bounds, on_device
from ..aggregation.light_tree import FlatLightTree, build_light_tree
from ..ops.intersect import FlatGeometry
from ..ops.pallas_hier import HIER_BUILD_MIN, HierSoA, build_hier_soa
from ..ops.pallas_intersect import PrimSoA, build_prim_soa, pack_sorted_prims
from ..textures.grids import rgba
from . import materials as mat_mod
from .cameras import Camera, PerspectiveCamera
from .entities import Entity, PackInstance, Scene
from .geometries import GeometryEntity
from .lights import AmbientLight, DirectionalLight, PointLight

_LUM = np.asarray([0.212671, 0.715160, 0.072169], np.float32)

# light record kinds in the selection table
LIGHT_POINT = 0
LIGHT_DIRECTIONAL = 1
LIGHT_AMBIENT = 2
LIGHT_EMISSIVE_TRI = 3

# finite-light count from which the light tree replaces the flat power CDF
LIGHT_TREE_THRESHOLD = 64
# unrolled prim count up to which "auto" instancing bakes shared packs
AUTO_BAKE_LIMIT = 2048
# side of every atlas slice: one fixed size keeps the shading lookup one gather
ATLAS_RES = 256


class PackedCamera(NamedTuple):
    kind: int
    position: torch.Tensor  # (3,)
    rotation: torch.Tensor  # (3, 3) local->world
    forward_length: torch.Tensor  # ()
    lens_radius: torch.Tensor
    focal_distance: torch.Tensor


class MaterialTable(NamedTuple):
    """Interned material parameter blocks. `present` lists the material
    type ids in the scene so BSDF dispatch only evaluates those models."""

    type: torch.Tensor  # (M,) int32
    albedo: torch.Tensor  # (M, 3)
    params: torch.Tensor  # (M, 4) [roughness, p1, p2, p3]
    extra: torch.Tensor  # (M, 3)
    one_sided: torch.Tensor  # (M,) int32
    albedo_tex: torch.Tensor  # (M,) int32 texture id or -1
    present: tuple = ()
    # (any albedo texture, any normal map, any roughness texture): the
    # megakernel's launch reads these without a device readback
    tex_flags: tuple = (False, False, False)


class LightTable(NamedTuple):
    """Flat light records + power CDF for selection, plus per-kind data."""

    kind: torch.Tensor  # (L,) int32
    index: torch.Tensor  # (L,) int32 into the per-kind arrays
    power: torch.Tensor  # (L,)
    cdf: torch.Tensor  # (L,) inclusive prefix of power / total
    point_pos: torch.Tensor  # (Lp, 3)
    point_intensity: torch.Tensor  # (Lp, 3)
    dir_dir: torch.Tensor  # (Ld, 3) direction the light travels
    dir_intensity: torch.Tensor  # (Ld, 3)
    emissive_prim: torch.Tensor  # (Le,) int32 original prim ids
    emissive_inst: torch.Tensor  # (Le,) int32 (0: no instancing)
    emissive_light: torch.Tensor  # (Le,) int32 back-map to light record
    prim_light: torch.Tensor  # (P,) int32 prim -> light record or -1
    ambient_all: torch.Tensor  # (3,) constant env radiance (indirect rays)
    ambient_camera: torch.Tensor  # (3,) env radiance visible to camera rays
    # per env map e (record index e < E): rotation, intensity scale, camera
    # visibility and selection power. The constant aggregate owns record
    # index E when present; amb_const_power then has shape (1,), else (0,)
    env_rotation: torch.Tensor  # (E, 3, 3) world -> env-local rotations
    env_scale: torch.Tensor  # (E, 3)
    env_camera: torch.Tensor  # (E,) 1.0 where directly visible to the camera
    env_power: torch.Tensor  # (E,) selection power (mixture pdf weights)
    amb_const_power: torch.Tensor  # (0|1,) power of the constant record
    tree: FlatLightTree | None  # tree over the finite lights, or None (few lights)
    tree_records: torch.Tensor  # (F,) int32 tree light id -> light record
    record_tree: torch.Tensor  # (L,) int32 light record -> tree light id or -1

    @property
    def num_lights(self) -> int:
        return self.kind.shape[0]


class PreparedScene(NamedTuple):
    """Immutable render-ready world on one device."""

    geometry: FlatGeometry
    materials: MaterialTable
    lights: LightTable
    camera: PackedCamera
    env_maps: tuple  # textures/directional.PreparedDirectional per env map
    tex_atlas: torch.Tensor  # (T, R, R, 4) float32, bf16 values; (0, 1, 1, 4) untextured
    prim_soa: PrimSoA | None  # None for a TLAS scene (its rays take the instanced walk)
    shade_pack: torch.Tensor  # (P, 24) float32
    mat_pack: torch.Tensor  # (M, 16) float32
    emissive_pack: torch.Tensor  # (Le, 20) float32
    # chunk-tree walk tables from HIER_BUILD_MIN prims on (and, instanced,
    # for every TLAS scene); None below
    hier_soa: HierSoA | None = None
    # TLAS tables (scene/instancing.InstanceTable) when the scene keeps
    # shared packs; None for a baked scene. Then the geometry and shade
    # rows of a pack's prims are in pack space.
    instances: object = None
    # the SAH tree the prim order came from, on the scene's device
    # (aggregation/bvh.on_device); a TLAS scene's joins its packs' trees,
    # in pack space. Only the traversal-cost AOV walks it.
    bvh: FlatBVH | None = None

    @property
    def device(self) -> torch.device:
        return self.shade_pack.device


def _iter_world(entity: Entity, parent, swatch, stop_shared=None, inst_specs=None):
    """Depth-first walk yielding (entity, world_matrix, swatch). A
    PackInstance of a pack in `stop_shared` (a set of pack ids) is not
    descended into: its (pack, world, merged swatch) goes to `inst_specs`
    (the TLAS path). Every other PackInstance is baked."""
    world = parent @ entity.transform.matrix()
    yield entity, world, swatch
    if isinstance(entity, PackInstance):
        merged = {**swatch, **{id(k): v for k, v in entity.material_swatch.items()}}
        if stop_shared is not None and id(entity.pack) in stop_shared:
            inst_specs.append((entity.pack, world, merged))
        else:
            for child in entity.pack.children:
                yield from _iter_world(child, world, merged, stop_shared, inst_specs)
    for child in entity.children:
        yield from _iter_world(child, world, swatch, stop_shared, inst_specs)


class Collector:
    """Accumulates flattened entities from one walk (the root scene in
    world space, or one shared pack in pack space)."""

    def __init__(self):
        self.tri_v, self.tri_f, self.tri_n, self.tri_uv, self.tri_m = [], [], [], [], []
        self.sph_c, self.sph_r, self.sph_m = [], [], []
        self.cameras: list[tuple[Camera, np.ndarray]] = []
        self.point_lights, self.dir_lights, self.ambient_lights = [], [], []
        # (entity material, its id, claimed by a swatch of the walk): an
        # instance's swatch may remap the id unless an inner one claimed it
        self.mat_pairs: list[tuple[object, int, bool]] = []

    def add(self, entity, world, swatch, intern):
        if isinstance(entity, GeometryEntity):
            mat = swatch.get(id(entity.material), entity.material)
            mid = intern(mat)
            self.mat_pairs.append((entity.material, mid, id(entity.material) in swatch))
            tris = entity.extract_triangles(world)
            if tris is not None and len(tris["faces"]):
                base = sum(len(v) for v in self.tri_v)
                self.tri_v.append(np.asarray(tris["vertices"], np.float32))
                self.tri_f.append(np.asarray(tris["faces"], np.int32) + base)
                n = tris.get("normals")
                u = tris.get("uvs")
                self.tri_n.append(None if n is None else np.asarray(n, np.float32))
                self.tri_uv.append(None if u is None else np.asarray(u, np.float32))
                if tris.get("face_materials") is not None:
                    fm = np.asarray(tris["face_materials"], np.int32)
                    sub = []
                    for m in tris["materials"]:
                        sub.append(intern(swatch.get(id(m), m)))
                        self.mat_pairs.append((m, sub[-1], id(m) in swatch))
                    table = np.asarray(sub + [mid], np.int32)
                    self.tri_m.append(table[np.where(fm >= 0, fm, len(sub))])
                else:
                    self.tri_m.append(np.full(len(tris["faces"]), mid, np.int32))
            sph = entity.extract_sphere(world)
            if sph is not None:
                self.sph_c.append(np.asarray(sph[0], np.float32))
                self.sph_r.append(np.float32(sph[1]))
                self.sph_m.append(np.int32(mid))
        elif isinstance(entity, Camera):
            self.cameras.append((entity, world))
        elif isinstance(entity, PointLight):
            self.point_lights.append(
                (world[:3, 3].astype(np.float32), entity.intensity, entity.power)
            )
        elif isinstance(entity, DirectionalLight):
            d = world[:3, :3] @ np.asarray([0.0, 0.0, 1.0])
            d = (d / np.linalg.norm(d)).astype(np.float32)
            self.dir_lights.append((d, entity.intensity, entity))
        elif isinstance(entity, AmbientLight):
            rot = world[:3, :3] / max(np.linalg.norm(world[:3, 0]), 1e-20)
            self.ambient_lights.append((entity, rot.astype(np.float32)))


def _resample_texture(tex, res: int = ATLAS_RES) -> np.ndarray:
    """Host bilinear resample of a Texture's data() to (res, res, 4)."""
    src = rgba(tex.data())
    h, w = src.shape[:2]
    v = (np.arange(res, dtype=np.float32) + 0.5) / res * h - 0.5
    u = (np.arange(res, dtype=np.float32) + 0.5) / res * w - 0.5
    v0 = np.clip(np.floor(v).astype(np.int64), 0, h - 1)
    u0 = np.clip(np.floor(u).astype(np.int64), 0, w - 1)
    v1 = np.minimum(v0 + 1, h - 1)
    u1 = np.minimum(u0 + 1, w - 1)
    fv = np.clip(v - v0, 0.0, 1.0)[:, None, None]
    fu = np.clip(u - u0, 0.0, 1.0)[None, :, None]
    top = src[v0][:, u0] * (1 - fu) + src[v0][:, u1] * fu
    bot = src[v1][:, u0] * (1 - fu) + src[v1][:, u1] * fu
    return top * (1 - fv) + bot * fv


def build_material_arrays(materials):
    """Interned material list -> packed parameter arrays + texture atlas:
    albedo, normal-map and roughness textures are interned by identity
    and resampled to ATLAS_RES (normal maps share the atlas; the ids tell
    them apart)."""
    mtypes = np.asarray([m.type_id for m, _ in materials], np.int32)
    malbedo = np.stack([m.constant_albedo() for m, _ in materials], 0)
    mparams = np.stack([m.params() for m, _ in materials], 0)
    mextra = np.stack([m.extra_color() for m, _ in materials], 0)
    mone = np.asarray([os for _, os in materials], np.int32)

    mtex = np.full(len(materials), -1, np.int32)
    mntex = np.full(len(materials), -1, np.int32)
    mnint = np.zeros(len(materials), np.float32)
    mrtex = np.full(len(materials), -1, np.int32)
    atlas_slices: list[np.ndarray] = []
    tex_ids: dict[int, int] = {}

    def intern_tex(tex) -> int:
        if id(tex) not in tex_ids:
            tex_ids[id(tex)] = len(atlas_slices)
            atlas_slices.append(_resample_texture(tex))
        return tex_ids[id(tex)]

    for mi, (m, _) in enumerate(materials):
        tex = m.albedo_texture()
        if tex is not None:
            mtex[mi] = intern_tex(tex)
        ntex = getattr(m, "normal", None)
        if ntex is not None and hasattr(ntex, "data"):
            mntex[mi] = intern_tex(ntex)
            mnint[mi] = float(getattr(m, "normal_intensity", 1.0))
        rtex = m.roughness_texture()
        if rtex is not None:
            mrtex[mi] = intern_tex(rtex)
    if atlas_slices:
        # texel values rounded once to bf16 (round to nearest even), so the
        # plain version and the megakernel read the same values whether a
        # table is stored in f32 or bf16; at most 2^-9 relative
        tex_atlas = torch.from_numpy(np.stack(atlas_slices, 0).astype(np.float32))
        tex_atlas = tex_atlas.to(torch.bfloat16).to(torch.float32).numpy()
    else:
        tex_atlas = np.zeros((0, 1, 1, 4), np.float32)
    return mtypes, malbedo, mparams, mextra, mone, mtex, mntex, mnint, mrtex, tex_atlas


def tex_flags(mtex, mntex, mrtex) -> tuple:
    """(any albedo texture, any normal map, any roughness texture)."""
    return bool((mtex >= 0).any()), bool((mntex >= 0).any()), bool((mrtex >= 0).any())


def fill_mat_pack(malbedo, mparams, mextra, mtypes, mone, mtex, mntex, mnint, mrtex):
    """The (M, 16) packed material rows."""
    mat_pack = np.zeros((len(mtypes), 16), np.float32)
    mat_pack[:, 0:3] = malbedo
    mat_pack[:, 3:7] = mparams
    mat_pack[:, 7:10] = mextra
    mat_pack[:, 10] = mtypes
    mat_pack[:, 11] = mtex  # albedo texture id or -1
    mat_pack[:, 12] = mone
    mat_pack[:, 13] = mntex  # normal-map texture id or -1
    mat_pack[:, 14] = mnint  # normal-map intensity
    mat_pack[:, 15] = mrtex  # roughness texture id or -1
    return mat_pack


class EnvCensus:
    """Ambient lights of one prepare: each textured one becomes an env map
    with its own light record (index = env map id), rotation, intensity,
    camera visibility and power; constant ones add up into one record at
    index E."""

    def __init__(self, device):
        self.device = device
        self.maps, self.rotations, self.scales, self.cameras, self.powers = [], [], [], [], []
        self.ambient_all = np.zeros(3, np.float32)
        self.ambient_camera = np.zeros(3, np.float32)

    def add(self, ent, rot) -> float | None:
        """Counts one ambient light; returns an env map's power, None for a
        constant light."""
        if ent.texture is None:
            self.ambient_all += ent.intensity
            if ent.directly_visible:
                self.ambient_camera += ent.intensity
            return None
        prepared = ent.texture.prepare(self.device)
        self.maps.append(prepared)
        self.rotations.append(rot.T)  # world -> env local
        self.scales.append(np.asarray(ent.intensity, np.float32))
        self.cameras.append(1.0 if ent.directly_visible else 0.0)
        power = 4.0 * np.pi * (
            float(prepared.mean_luminance()) * float(_LUM @ ent.intensity) * 3.0
        )
        self.powers.append(max(power, 1e-6))
        return self.powers[-1]

    def constant_power(self) -> float | None:
        """The constant record's power, or None without constant ambients."""
        if float(self.ambient_all.sum()) > 0.0:
            return max(float(4.0 * np.pi * (_LUM @ self.ambient_all)), 1e-6)
        return None

    def tables(self, put) -> dict:
        """The LightTable fields of the ambient lights."""
        p_c = self.constant_power()
        return dict(
            ambient_all=put(self.ambient_all),
            ambient_camera=put(self.ambient_camera),
            env_rotation=put(np.stack(self.rotations, 0) if self.rotations
                             else np.zeros((0, 3, 3), np.float32), np.float32),
            env_scale=put(np.stack(self.scales, 0) if self.scales
                          else np.zeros((0, 3), np.float32), np.float32),
            env_camera=put(self.cameras, np.float32),
            env_power=put(self.powers, np.float32),
            amb_const_power=put([] if p_c is None else [p_c], np.float32),
        )


def assemble_triangles(tri_v, tri_f, tri_n, tri_uv, tri_m):
    """Indexed triangle lists -> flat per-face arrays
    (v0, e1, e2, n0, n1, n2, uv0, uv1, uv2, tmat)."""
    verts = np.concatenate([np.asarray(v, np.float32) for v in tri_v], 0)
    faces = np.concatenate(tri_f, 0)
    norms, uvs = [], []
    for v, n, u in zip(tri_v, tri_n, tri_uv):
        norms.append(np.zeros((len(v), 3), np.float32) if n is None else np.asarray(n, np.float32))
        uvs.append(np.zeros((len(v), 2), np.float32) if u is None else np.asarray(u, np.float32))
    vn = np.concatenate(norms, 0)
    vuv = np.concatenate(uvs, 0)
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    e1, e2 = v1 - v0, v2 - v0
    gn = np.cross(e1, e2)
    gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    n0, n1, n2 = vn[faces[:, 0]], vn[faces[:, 1]], vn[faces[:, 2]]
    # faces without shading normals fall back to the geometric normal
    for arr in (n0, n1, n2):
        missing = np.linalg.norm(arr, axis=-1) < 1e-6
        arr[missing] = gn[missing]
    uv0, uv1, uv2 = vuv[faces[:, 0]], vuv[faces[:, 1]], vuv[faces[:, 2]]
    tmat = np.concatenate(tri_m, 0)
    return v0, e1, e2, n0, n1, n2, uv0, uv1, uv2, tmat


def subdivide_triangles(parts: dict, threshold: float, max_iteration: int = 3):
    """4-way midpoint subdivision of triangles whose area exceeds
    `threshold` (oversized triangles, typically ground planes, otherwise
    inflate acceleration bounds), one level a pass over the whole soup: the
    JAX package's function, op for op. `parts` holds per-face arrays (v0,
    e1, e2, n0, n1, n2, uv0, uv1, uv2, tmat); returns the same dict."""
    for _ in range(max_iteration):
        v0, e1, e2 = parts["v0"], parts["e1"], parts["e2"]
        area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        split = area > threshold
        if not split.any():
            break
        keep = {k: v[~split] for k, v in parts.items()}
        s = {k: v[split] for k, v in parts.items()}

        def lerp3(a, b):
            m = 0.5 * (a + b)
            n = np.linalg.norm(m, axis=-1, keepdims=True)
            return m / np.maximum(n, 1e-20)

        # corners and midpoints (positions exact, normals renormalized,
        # uvs linear)
        A, B, C = s["v0"], s["v0"] + s["e1"], s["v0"] + s["e2"]
        Mab, Mbc, Mca = 0.5 * (A + B), 0.5 * (B + C), 0.5 * (C + A)
        nA, nB, nC = s["n0"], s["n1"], s["n2"]
        nab, nbc, nca = lerp3(nA, nB), lerp3(nB, nC), lerp3(nC, nA)
        uA, uB, uC = s["uv0"], s["uv1"], s["uv2"]
        uab, ubc, uca = 0.5 * (uA + uB), 0.5 * (uB + uC), 0.5 * (uC + uA)

        children = [
            (A, Mab, Mca, nA, nab, nca, uA, uab, uca),
            (Mab, B, Mbc, nab, nB, nbc, uab, uB, ubc),
            (Mca, Mbc, C, nca, nbc, nC, uca, ubc, uC),
            (Mab, Mbc, Mca, nab, nbc, nca, uab, ubc, uca),
        ]
        new = {k: [keep[k]] for k in parts}
        for (a, b, c, na, nb, nc, ua, ub, uc) in children:
            new["v0"].append(a.astype(np.float32))
            new["e1"].append((b - a).astype(np.float32))
            new["e2"].append((c - a).astype(np.float32))
            new["n0"].append(na.astype(np.float32))
            new["n1"].append(nb.astype(np.float32))
            new["n2"].append(nc.astype(np.float32))
            new["uv0"].append(ua.astype(np.float32))
            new["uv1"].append(ub.astype(np.float32))
            new["uv2"].append(uc.astype(np.float32))
            new["tmat"].append(s["tmat"])
        parts = {k: np.concatenate(v, 0) for k, v in new.items()}
    return parts


def _unrolled_prim_estimate(scene: Scene) -> int | None:
    """Total prim count if every PackInstance were baked, or None when an
    unknown geometry type makes it unknowable without extraction."""
    from .geometries import BoxEntity, MeshEntity, PlaneEntity, SphereEntity, TriangleEntity

    unknown = False

    def count(entity) -> int:
        nonlocal unknown
        total = 0
        if isinstance(entity, MeshEntity):
            total += len(entity.faces)
        elif isinstance(entity, (TriangleEntity, SphereEntity)):
            total += 1
        elif isinstance(entity, PlaneEntity):
            total += 2
        elif isinstance(entity, BoxEntity):
            total += 12
        elif isinstance(entity, GeometryEntity):
            unknown = True
        if isinstance(entity, PackInstance):
            total += count(entity.pack)
        for child in entity.children:
            total += count(child)
        return total

    n = count(scene)
    return None if unknown else n


def _shared_packs(scene: Scene, instancing: str) -> set[int]:
    """ids of the packs that keep one pack-space copy traced through a TLAS
    instead of being baked: in "tlas" mode every instanced pack, in "auto"
    mode every pack placed by two or more PackInstances, none in "bake".
    "auto" bakes a scene whose unrolled prim count is at most
    AUTO_BAKE_LIMIT (the megakernel's prim limit), as the JAX package
    does."""
    if instancing == "bake":
        return set()
    counts: dict[int, int] = {}

    def walk(entity):
        if isinstance(entity, PackInstance):
            counts[id(entity.pack)] = counts.get(id(entity.pack), 0) + 1
            for child in entity.pack.children:
                walk(child)
        for child in entity.children:
            walk(child)

    walk(scene)
    need = 1 if instancing == "tlas" else 2
    shared = {pid for pid, c in counts.items() if c >= need}
    if shared and instancing == "auto":
        est = _unrolled_prim_estimate(scene)
        if est is not None and est <= AUTO_BAKE_LIMIT:
            return set()
    return shared


def prepare_scene(scene: Scene, camera_name: str | None = None,
                  instancing: str = "auto", subdivide: float | None = None,
                  device="cuda") -> PreparedScene:
    """Flatten `scene` into tables on `device` (the card unless the caller
    asks for another device). `instancing` is "auto", "tlas" or "bake"
    (`_shared_packs`). `subdivide`: split the baked triangles larger than
    this area (`subdivide_triangles`), as the JAX package does; a TLAS
    scene's packs are not split."""
    device = torch.device(device)
    shared = _shared_packs(scene, instancing)
    if shared:
        from .instancing import prepare_scene_instanced

        return prepare_scene_instanced(scene, camera_name, shared, device)

    materials: list = []
    mat_index: dict = {}

    def intern(mat) -> int:
        one_sided = 0
        if isinstance(mat, mat_mod.OneSided):
            one_sided, mat = 1, mat.base
        key = (id(mat), one_sided)
        if key not in mat_index:
            mat_index[key] = len(materials)
            materials.append((mat, one_sided))
        return mat_index[key]

    col = Collector()
    for entity, world, swatch in _iter_world(scene, np.eye(4), {}):
        col.add(entity, world, swatch, intern)

    # --- flat geometry ---
    if col.tri_v:
        v0, e1, e2, n0, n1, n2, uv0, uv1, uv2, tmat = assemble_triangles(
            col.tri_v, col.tri_f, col.tri_n, col.tri_uv, col.tri_m
        )
        if subdivide is not None:
            parts = subdivide_triangles(
                dict(v0=v0, e1=e1, e2=e2, n0=n0, n1=n1, n2=n2,
                     uv0=uv0, uv1=uv1, uv2=uv2, tmat=tmat),
                float(subdivide),
            )
            v0, e1, e2 = parts["v0"], parts["e1"], parts["e2"]
            n0, n1, n2 = parts["n0"], parts["n1"], parts["n2"]
            uv0, uv1, uv2 = parts["uv0"], parts["uv1"], parts["uv2"]
            tmat = parts["tmat"]
    else:
        # degenerate far-away invisible triangle keeps shapes non-empty
        mid = intern(mat_mod.Invisible())
        v0 = np.asarray([[1e7, 1e7, 1e7]], np.float32)
        e1 = np.asarray([[1e-3, 0, 0]], np.float32)
        e2 = np.asarray([[0, 1e-3, 0]], np.float32)
        n0 = n1 = n2 = np.asarray([[0, 0, 1]], np.float32)
        uv0 = uv1 = uv2 = np.zeros((1, 2), np.float32)
        tmat = np.asarray([mid], np.int32)

    sph_c, sph_r, sph_m = col.sph_c, col.sph_r, col.sph_m
    geom_np = dict(
        tri_v0=v0, tri_e1=e1, tri_e2=e2, tri_n0=n0, tri_n1=n1, tri_n2=n2,
        tri_uv0=uv0, tri_uv1=uv1, tri_uv2=uv2, tri_mat=tmat,
        sph_center=np.stack(sph_c, 0) if sph_c else np.zeros((0, 3), np.float32),
        sph_radius=np.asarray(sph_r, np.float32) if sph_r else np.zeros(0, np.float32),
        sph_mat=np.asarray(sph_m, np.int32) if sph_m else np.zeros(0, np.int32),
    )
    num_tris = geom_np["tri_v0"].shape[0]
    num_prims = num_tris + geom_np["sph_center"].shape[0]

    (mtypes, malbedo, mparams, mextra, mone, mtex, mntex, mnint, mrtex,
     tex_atlas) = build_material_arrays(materials)

    # --- light census ---
    kinds, indices, powers = [], [], []
    for i, (pos, inten, power) in enumerate(col.point_lights):
        kinds.append(LIGHT_POINT)
        indices.append(i)
        powers.append(max(power, 1e-6))
    for i, (d, inten, ent) in enumerate(col.dir_lights):
        kinds.append(LIGHT_DIRECTIONAL)
        indices.append(i)
        powers.append(max(float(np.pi * _LUM @ inten), 1e-6))

    env = EnvCensus(device)
    for ent, rot in col.ambient_lights:
        power = env.add(ent, rot)
        if power is not None:  # an env map: its own record, index = its id
            kinds.append(LIGHT_AMBIENT)
            indices.append(len(env.maps) - 1)
            powers.append(power)
    if env.constant_power() is not None:
        kinds.append(LIGHT_AMBIENT)
        indices.append(len(env.maps))  # index E = the constant record
        powers.append(env.constant_power())

    # emissive geometry census
    emissive_prims = []
    geo_normal = np.cross(geom_np["tri_e1"], geom_np["tri_e2"])
    tri_area2 = np.linalg.norm(geo_normal, axis=-1)
    geo_normal /= np.maximum(tri_area2[:, None], 1e-20)
    tri_area = 0.5 * tri_area2
    mat_power = np.asarray(
        [m.power if isinstance(m, mat_mod.Emissive) else 0.0 for m, _ in materials],
        np.float64,
    )
    tri_power = mat_power[geom_np["tri_mat"]]
    for p in np.nonzero(tri_power > 0.0)[0]:
        emissive_prims.append((int(p), float(tri_power[p] * tri_area[p] * np.pi)))
    if geom_np["sph_center"].shape[0]:
        sph_power = mat_power[geom_np["sph_mat"]]
        sph_area = 4.0 * np.pi * geom_np["sph_radius"].astype(np.float64) ** 2
        for s in np.nonzero(sph_power > 0.0)[0]:
            emissive_prims.append(
                (num_tris + int(s), float(sph_power[s] * sph_area[s] * np.pi))
            )

    emissive_light = []
    for p, power in emissive_prims:
        emissive_light.append(len(kinds))
        kinds.append(LIGHT_EMISSIVE_TRI)
        indices.append(len(emissive_light) - 1)
        powers.append(max(power, 1e-6))

    if not kinds:  # degenerate: a black ambient record
        kinds, indices, powers = [LIGHT_AMBIENT], [0], [1e-6]

    powers = np.asarray(powers, np.float64)
    cdf = np.cumsum(powers / powers.sum()).astype(np.float32)
    cdf[-1] = 1.0

    prim_light = np.full(num_prims, -1, np.int32)
    for (p, _), lrec in zip(emissive_prims, emissive_light):
        prim_light[p] = lrec

    # --- Estevez-Kulla light tree over the finite lights ---
    record_tree = np.full(len(kinds), -1, np.int32)
    tree_records = np.zeros(0, np.int32)
    tree_args = None
    finite = []  # (record, center, radius, axis, theta_o, theta_e, power)
    for rec, (k, idx) in enumerate(zip(kinds, indices)):
        if k == LIGHT_POINT:
            pos = col.point_lights[idx][0]
            finite.append((rec, pos, 0.0, np.asarray([0.0, 0.0, 1.0]), np.pi, np.pi / 2, powers[rec]))
        elif k == LIGHT_EMISSIVE_TRI:
            p = emissive_prims[idx][0]
            if p < num_tris:
                v0 = geom_np["tri_v0"][p]
                v1 = v0 + geom_np["tri_e1"][p]
                v2 = v0 + geom_np["tri_e2"][p]
                c = (v0 + v1 + v2) / 3.0
                r = float(max(np.linalg.norm(v0 - c), np.linalg.norm(v1 - c), np.linalg.norm(v2 - c)))
                nrm = np.cross(geom_np["tri_e1"][p], geom_np["tri_e2"][p])
                nrm = nrm / max(np.linalg.norm(nrm), 1e-20)
                finite.append((rec, c, r, nrm, 0.0, np.pi / 2, powers[rec]))
            else:
                s = p - num_tris
                c = geom_np["sph_center"][s]
                r = float(geom_np["sph_radius"][s])
                finite.append((rec, c, r, np.asarray([0.0, 0.0, 1.0]), np.pi, np.pi / 2, powers[rec]))
    if len(finite) >= LIGHT_TREE_THRESHOLD:
        tree_records = np.asarray([f[0] for f in finite], np.int32)
        for ti, f in enumerate(finite):
            record_tree[f[0]] = ti
        tree_args = (
            np.stack([f[1] for f in finite], 0),
            np.asarray([f[2] for f in finite]),
            np.stack([f[3] for f in finite], 0),
            np.asarray([f[4] for f in finite]),
            np.asarray([f[5] for f in finite]),
            np.asarray([f[6] for f in finite]),
        )

    put = lambda x, dt=None: torch.as_tensor(np.asarray(x, dt), device=device)
    stack3 = lambda rows: np.stack(rows, 0) if rows else np.zeros((0, 3), np.float32)
    lights = LightTable(
        kind=put(kinds, np.int32),
        index=put(indices, np.int32),
        power=put(powers, np.float32),
        cdf=put(cdf),
        point_pos=put(stack3([p for p, _, _ in col.point_lights]), np.float32),
        point_intensity=put(stack3([i for _, i, _ in col.point_lights]), np.float32),
        dir_dir=put(stack3([d for d, _, _ in col.dir_lights]), np.float32),
        dir_intensity=put(stack3([i for _, i, _ in col.dir_lights]), np.float32),
        emissive_prim=put([p for p, _ in emissive_prims], np.int32),
        emissive_inst=put(np.zeros(len(emissive_prims), np.int32)),
        emissive_light=put(emissive_light, np.int32),
        prim_light=put(prim_light),
        **env.tables(put),
        tree=None if tree_args is None else build_light_tree(*tree_args, device=device),
        tree_records=put(tree_records),
        record_tree=put(record_tree),
    )

    # --- camera ---
    cam_entity, cam_world = None, np.eye(4)
    for c, w in col.cameras:
        if camera_name is None or c.name == camera_name:
            cam_entity, cam_world = c, w
            break
    if cam_entity is None:
        cam_entity = PerspectiveCamera()
    packed_cam = cam_entity.pack(cam_world)
    camera = PackedCamera(
        kind=int(packed_cam["kind"]),
        position=put(packed_cam["position"]),
        rotation=put(packed_cam["rotation"]),
        forward_length=put(packed_cam["forward_length"]),
        lens_radius=put(packed_cam["lens_radius"]),
        focal_distance=put(packed_cam["focal_distance"]),
    )

    # --- kernel prim layout in BVH-leaf order ---
    bmin, bmax = geometry_bounds(geom_np)
    bvh = build_bvh(bmin, bmax)
    order = bvh.prim_order
    packed = pack_sorted_prims(geom_np, order, bounds=(bmin, bmax))
    prim_soa = build_prim_soa(geom_np, order=order, packed=packed, device=device)
    hier_soa = (build_hier_soa(geom_np, order, packed=packed, device=device)
                if num_prims >= HIER_BUILD_MIN else None)

    materials_t = MaterialTable(
        type=put(mtypes),
        albedo=put(malbedo, np.float32),
        params=put(mparams, np.float32),
        extra=put(mextra, np.float32),
        one_sided=put(mone),
        albedo_tex=put(mtex),
        present=tuple(
            sorted(
                {int(t) for t in np.unique(mtypes)}
                | ({mat_mod.INVISIBLE} if mone.any() else set())
            )
        ),
        tex_flags=tex_flags(mtex, mntex, mrtex),
    )

    # --- packed shading rows ---
    shade = np.zeros((num_prims, 24), np.float32)
    shade[:num_tris, 0:3] = geo_normal
    shade[:num_tris, 3:6] = geom_np["tri_n0"]
    shade[:num_tris, 6:9] = geom_np["tri_n1"]
    shade[:num_tris, 9:12] = geom_np["tri_n2"]
    shade[:num_tris, 12:14] = geom_np["tri_uv0"]
    shade[:num_tris, 14:16] = geom_np["tri_uv1"]
    shade[:num_tris, 16:18] = geom_np["tri_uv2"]
    shade[:num_tris, 18] = geom_np["tri_mat"]
    shade[:num_tris, 19] = 0.5 * tri_area2
    if num_prims > num_tris:
        shade[num_tris:, 0:3] = geom_np["sph_center"]
        shade[num_tris:, 3] = geom_np["sph_radius"]
        shade[num_tris:, 18] = geom_np["sph_mat"]
        r = geom_np["sph_radius"]
        shade[num_tris:, 19] = 4.0 * np.pi * r * r
        shade[num_tris:, 20] = 1.0

    mat_pack = fill_mat_pack(malbedo, mparams, mextra, mtypes, mone, mtex, mntex, mnint, mrtex)

    epack = np.zeros((len(emissive_prims), 20), np.float32)
    for i, (p, _) in enumerate(emissive_prims):
        if p < num_tris:
            epack[i, 0:3] = geom_np["tri_v0"][p]
            epack[i, 3:6] = geom_np["tri_e1"][p]
            epack[i, 6:9] = geom_np["tri_e2"][p]
            epack[i, 9:12] = geo_normal[p]
            epack[i, 15] = 0.5 * tri_area2[p]
        else:
            s = p - num_tris
            epack[i, 0:3] = geom_np["sph_center"][s]
            epack[i, 3] = geom_np["sph_radius"][s]
            epack[i, 15] = 4.0 * np.pi * float(geom_np["sph_radius"][s]) ** 2
            epack[i, 16] = 1.0
        mi = geom_np["tri_mat"][p] if p < num_tris else geom_np["sph_mat"][p - num_tris]
        epack[i, 12:15] = malbedo[mi]

    return PreparedScene(
        geometry=FlatGeometry(**{k: put(v) for k, v in geom_np.items()}),
        materials=materials_t,
        lights=lights,
        camera=camera,
        env_maps=tuple(env.maps),
        tex_atlas=put(tex_atlas),
        prim_soa=prim_soa,
        shade_pack=put(shade),
        mat_pack=put(mat_pack),
        emissive_pack=put(epack),
        hier_soa=hier_soa,
        bvh=on_device(bvh, device),
    )
