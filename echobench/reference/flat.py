"""A scene spec flattened into the reference's tables (numpy, host).

Works out again, from the arrays that `echobench.scenes` made, what the
port's `prepare_scene` derives: the triangle soup with its geometric and
shading normals and areas, the spheres, the material parameters, the
light records with their power CDF, and the camera's frame. The numpy
expressions are the port's own (echorenderer_tpu_torch/scene/prepare.py,
geometries.py, entities.py, cameras.py, materials.py), so both sides
start from the same float32 values. Supported (`_KEYS`, the kinds and
keyword arguments of the port's scene API that the reference covers):
planes, spheres and meshes under a translation, diffuse, conductor,
dielectric and emissive materials, one constant ambient light, a pinhole
perspective camera; anything else is refused. A scene that needs more
brings a reference module of its own, which its configuration names
(check.py, manifest.Cell.reference).
"""

from __future__ import annotations

import dataclasses

import numpy as np

_LUM = np.asarray([0.212671, 0.715160, 0.072169], np.float32)

DIFFUSE, DIELECTRIC, CONDUCTOR, EMISSIVE = 1, 2, 3, 4
LIGHT_AMBIENT, LIGHT_EMISSIVE = 2, 3


@dataclasses.dataclass
class Flat:
    """Prim ids: triangles [0, T), spheres [T, T + S). `bvh_tris` lists the
    triangles of meshes (the reference's BVH takes them); every other prim
    is tested by every ray."""

    tri_v0: np.ndarray
    tri_e1: np.ndarray
    tri_e2: np.ndarray
    tri_n: np.ndarray  # (T, 3, 3) shading normals at the three corners
    tri_geo_n: np.ndarray
    tri_area: np.ndarray  # (T,) float32, 0.5 |e1 x e2|
    tri_mat: np.ndarray
    bvh_tris: np.ndarray  # (B,) int64 triangle ids
    sph_center: np.ndarray
    sph_radius: np.ndarray
    sph_area: np.ndarray
    sph_mat: np.ndarray
    mat_type: np.ndarray
    mat_albedo: np.ndarray
    mat_params: np.ndarray
    mat_extra: np.ndarray
    light_kind: np.ndarray  # (L,) int32
    light_power: np.ndarray  # (L,) float32
    light_cdf: np.ndarray  # (L,) float32
    light_emitter: np.ndarray  # (L,) int32 emitter row or -1
    prim_light: np.ndarray  # (P,) int32 light record or -1
    emit_prim: np.ndarray  # (E,) int32
    emit_area: np.ndarray  # (E,) float32
    emit_radiance: np.ndarray  # (E, 3)
    ambient: np.ndarray  # (3,) float32
    cam_position: np.ndarray  # (3,) float32
    cam_rotation: np.ndarray  # (3, 3) float32, local -> world
    cam_forward: np.float32

    @property
    def num_tris(self) -> int:
        return self.tri_v0.shape[0]


def _rgb(value) -> np.ndarray:
    a = np.asarray(value, np.float32)
    if a.ndim == 0:
        a = np.full(3, float(a), np.float32)
    return a[:3].astype(np.float32)


_KEYS = {  # what the reference covers of each kind of the port's scene API
    "Diffuse": {"albedo", "roughness", "transmissive"},
    "Dielectric": {"albedo", "roughness", "refractive_index"},
    "Conductor": {"albedo", "roughness", "artistic", "edge"},
    "Emissive": {"albedo"},
    "PlaneEntity": {"material", "size", "position"},
    "SphereEntity": {"material", "radius", "position"},
    "MeshEntity": {"material", "vertices", "faces"},
    "AmbientLight": {"intensity"},
    "PerspectiveCamera": {"field_of_view", "position", "lens_radius", "target"},
}


def _covered(item: dict) -> dict:
    """The item, once the reference is known to cover its kind and keys."""
    kind = item["kind"]
    if kind not in _KEYS:
        raise ValueError(f"the reference has no {kind!r}")
    extra = set(item) - {"kind"} - _KEYS[kind]
    if extra:
        raise ValueError(f"the reference has no {sorted(extra)} of {kind!r}")
    return item


def _material_row(m: dict):
    kind = _covered(m)["kind"]
    albedo = _rgb(m["albedo"])
    extra = np.zeros(3, np.float32)
    if kind == "Diffuse":
        params = [float(m.get("roughness", 0.0)), 1.0 if m.get("transmissive") else 0.0, 0, 0]
        mtype = DIFFUSE
    elif kind == "Dielectric":
        params = [float(m.get("roughness", 0.0)), float(m.get("refractive_index", 1.5)), 0, 0]
        mtype = DIELECTRIC
    elif kind == "Conductor":
        params = [float(m.get("roughness", 0.05)), 1.0 if m.get("artistic", True) else 0.0, 0, 0]
        extra = _rgb(m.get("edge", (1.0, 1.0, 1.0)))
        mtype = CONDUCTOR
    else:
        params = [0, 0, 0, 0]
        mtype = EMISSIVE
    return mtype, albedo, np.asarray(params, np.float32), extra


def _emissive_power(m: dict) -> float:
    if m["kind"] != "Emissive":
        return 0.0
    c = _rgb(m["albedo"])
    return float(0.212671 * c[0] + 0.715160 * c[1] + 0.072169 * c[2])


def _plane_tris(p: dict):
    world = np.eye(4)
    world[:3, 3] = np.asarray(p.get("position", (0, 0, 0)), np.float64)
    hx, hz = np.asarray(p["size"], np.float64) / 2.0
    verts = np.asarray([[-hx, 0, -hz], [hx, 0, -hz], [hx, 0, hz], [-hx, 0, hz]], np.float64)
    verts = verts @ world[:3, :3].T + world[:3, 3]
    normals = np.tile([[0.0, 1.0, 0.0]], (4, 1)) @ np.linalg.inv(world[:3, :3])
    normals = normals / np.maximum(np.linalg.norm(normals, axis=-1, keepdims=True), 1e-20)
    return verts, np.asarray([[0, 2, 1], [0, 3, 2]], np.int32), normals


def _quat_matrix(q):
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def _look_at_quat(position, target):
    """The camera's rotation quaternion (x, y, z, w): local +z faces the
    target, as the scene entities' `look_at` computes it."""
    forward = np.asarray(target, np.float64) - position
    forward = forward / np.linalg.norm(forward)
    up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(forward, up)) > 0.999:
        up = np.array([0.0, 0.0, 1.0])
    right = np.cross(up, forward)
    right /= np.linalg.norm(right)
    up = np.cross(forward, right)
    m = np.stack([right, up, forward], axis=1)
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array(
            [(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s, s / 4]
        )
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[i] = s / 4
        q[j] = (m[j, i] + m[i, j]) / s
        q[k] = (m[k, i] + m[i, k]) / s
        q[3] = (m[k, j] - m[j, k]) / s
    return q / np.linalg.norm(q)


def flatten(spec) -> Flat:
    """The reference's tables of a `scenes.SceneSpec`."""
    tri_v, tri_f, tri_n, tri_m, bvh_ranges = [], [], [], [], []
    sph_c, sph_r, sph_m = [], [], []
    n_verts = n_tris = 0
    for e in spec.entities:
        kind = _covered(e)["kind"]
        if kind == "SphereEntity":
            s = e
            sph_c.append(np.asarray(np.asarray(s.get("position", (0, 0, 0)), np.float64), np.float32))
            sph_r.append(np.float32(float(s["radius"]) * 1.0))
            sph_m.append(s["material"])
            continue
        if kind == "PlaneEntity":
            verts, faces, normals = _plane_tris(e)
            mat = e["material"]
        else:
            m = e
            verts = np.asarray(m["vertices"], np.float64)
            faces, normals, mat = np.asarray(m["faces"], np.int32), None, m["material"]
            bvh_ranges.append((n_tris, n_tris + len(faces)))
        tri_v.append(np.asarray(verts, np.float32))
        tri_f.append(faces + n_verts)
        tri_n.append(np.zeros((len(verts), 3), np.float32) if normals is None
                     else np.asarray(normals, np.float32))
        tri_m.append(np.full(len(faces), mat, np.int64))
        n_verts += len(verts)
        n_tris += len(faces)

    verts = np.concatenate(tri_v, 0)
    faces = np.concatenate(tri_f, 0)
    vn = np.concatenate(tri_n, 0)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    e1, e2 = v1 - v0, v2 - v0
    gn = np.cross(e1, e2)
    gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    corners = [vn[faces[:, k]] for k in range(3)]
    for arr in corners:  # faces without shading normals take the geometric one
        missing = np.linalg.norm(arr, axis=-1) < 1e-6
        arr[missing] = gn[missing]
    geo_n = np.cross(e1, e2)
    area2 = np.linalg.norm(geo_n, axis=-1)
    geo_n /= np.maximum(area2[:, None], 1e-20)
    tri_mat = np.concatenate(tri_m, 0)

    sph_center = np.stack(sph_c, 0) if sph_c else np.zeros((0, 3), np.float32)
    sph_radius = np.asarray(sph_r, np.float32) if sph_r else np.zeros(0, np.float32)
    sph_mat = np.asarray(sph_m, np.int64)

    rows = [_material_row(m) for m in spec.materials]
    mat_power = np.asarray([_emissive_power(m) for m in spec.materials], np.float64)

    # light records: the constant ambient, then emitting triangles, then
    # emitting spheres, each in prim order
    if len(spec.lights) != 1 or _covered(spec.lights[0])["kind"] != "AmbientLight":
        raise ValueError("the reference has no light but one AmbientLight")
    ambient = np.zeros(3, np.float32) + _rgb(spec.lights[0]["intensity"])
    kinds, powers, emitters = [], [], []
    if float(ambient.sum()) > 0.0:
        kinds.append(LIGHT_AMBIENT)
        powers.append(max(float(4.0 * np.pi * (_LUM @ ambient)), 1e-6))
        emitters.append(-1)
    emissive = []  # (prim, power, area, material)
    tri_area = 0.5 * area2
    tri_power = mat_power[tri_mat]
    for p in np.nonzero(tri_power > 0.0)[0]:
        emissive.append((int(p), float(tri_power[p] * tri_area[p] * np.pi), tri_area[p],
                         tri_mat[p]))
    if len(sph_m):
        sph_power = mat_power[sph_mat]
        sph_area64 = 4.0 * np.pi * sph_radius.astype(np.float64) ** 2
        for s in np.nonzero(sph_power > 0.0)[0]:
            area = 4.0 * np.pi * float(sph_radius[s]) ** 2
            emissive.append((n_tris + int(s), float(sph_power[s] * sph_area64[s] * np.pi), area,
                             sph_mat[s]))
    prim_light = np.full(n_tris + len(sph_m), -1, np.int32)
    for e, (p, power, _, _) in enumerate(emissive):
        prim_light[p] = len(kinds)
        kinds.append(LIGHT_EMISSIVE)
        powers.append(max(power, 1e-6))
        emitters.append(e)
    powers = np.asarray(powers, np.float64)
    cdf = np.cumsum(powers / powers.sum()).astype(np.float32)
    cdf[-1] = 1.0

    c = _covered(spec.camera)
    if c["kind"] != "PerspectiveCamera":
        raise ValueError(f"the reference has no camera {c['kind']!r}")
    position = np.asarray(c["position"], np.float64)
    world = np.eye(4)
    world[:3, :3] = _quat_matrix(_look_at_quat(position, c["target"])) * 1.0
    world[:3, 3] = position
    rot = world[:3, :3].copy()
    rot /= max(np.linalg.norm(rot[:, 0]), 1e-20)
    if c.get("lens_radius", 0.0) > 0.0:
        raise ValueError("the reference has no thin-lens camera")

    return Flat(
        tri_v0=v0, tri_e1=e1, tri_e2=e2, tri_n=np.stack(corners, 1), tri_geo_n=geo_n,
        tri_area=tri_area.astype(np.float32), tri_mat=tri_mat,
        bvh_tris=np.concatenate([np.arange(a, b) for a, b in bvh_ranges]) if bvh_ranges
        else np.zeros(0, np.int64),
        sph_center=sph_center, sph_radius=sph_radius,
        sph_area=(4.0 * np.pi * sph_radius * sph_radius).astype(np.float32), sph_mat=sph_mat,
        mat_type=np.asarray([r[0] for r in rows], np.int32),
        mat_albedo=np.stack([r[1] for r in rows], 0),
        mat_params=np.stack([r[2] for r in rows], 0),
        mat_extra=np.stack([r[3] for r in rows], 0),
        light_kind=np.asarray(kinds, np.int32), light_power=powers.astype(np.float32),
        light_cdf=cdf, light_emitter=np.asarray(emitters, np.int32), prim_light=prim_light,
        emit_prim=np.asarray([e[0] for e in emissive], np.int32),
        emit_area=np.asarray([e[2] for e in emissive], np.float32),
        emit_radiance=np.stack([rows[e[3]][1] for e in emissive], 0) if emissive
        else np.zeros((0, 3), np.float32),
        ambient=ambient, cam_position=world[:3, 3].astype(np.float32),
        cam_rotation=rot.astype(np.float32),
        cam_forward=np.float32(0.5 / np.tan(np.radians(c["field_of_view"]) / 2.0)),
    )
