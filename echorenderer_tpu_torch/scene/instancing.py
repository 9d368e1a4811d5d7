"""TLAS instancing preparation (counterpart of
echorenderer_tpu/scene/instancing.py): shared packs traced through
per-instance transforms.

A pack placed by PackInstances keeps ONE copy of its geometry, in pack
space, in the storage arrays; each placement costs a 16-float instance row
(world rotation, translation, scale and emissive bookkeeping) and a
material-remap row (its swatch). The root scene's own geometry is block 0,
instance 0 (identity). Rays trace through the instanced chunk-tree walk or
the instanced binned traversal (ops/pallas_hier.py, ops/binned_trace.py):
a TLAS over the instances' world boxes whose leaves move the ray into the
pack's space.

A hit is a (prim, inst) pair: `Hit.prim` the storage prim (shared by the
instances), `Hit.inst` the placement. `scene_ops.interact` rotates the
pack-space shading rows into world space with the instance row and remaps
the material through the swatch table. Every table equals the JAX
package's (tests/test_torch_instancing.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..aggregation.bvh import build_bvh, geometry_bounds, join, on_device
from ..aggregation.light_tree import build_light_tree
from ..ops.intersect import FlatGeometry
from ..ops.pallas_hier import build_hier_soa_instanced
from . import materials as mat_mod
from .cameras import PerspectiveCamera
from .entities import Scene
from .prepare import (
    LIGHT_AMBIENT,
    LIGHT_DIRECTIONAL,
    LIGHT_EMISSIVE_TRI,
    LIGHT_POINT,
    LIGHT_TREE_THRESHOLD,
    Collector,
    EnvCensus,
    LightTable,
    MaterialTable,
    PackedCamera,
    PreparedScene,
    _LUM,
    _iter_world,
    assemble_triangles,
    build_material_arrays,
    fill_mat_pack,
    tex_flags,
)


class InstanceTable(NamedTuple):
    """Tables of instanced shading (see scene_ops.interact).

    `rows` per instance: [R row-major (9), translation (3), scale, scale^2,
    first emissive light record (or -1), emissive profile id].
    `mat_remap` (I * M,): material g of instance i resolves to
    mat_remap[i * M + g] (its swatch). `emi_ordinal` (n_profiles * P,): the
    rank of storage prim p in a profile's emissive list, or -1; the light
    record of (p, i) is rows[i].emi_base + rank."""

    rows: torch.Tensor  # (I, 16) float32
    mat_remap: torch.Tensor  # (I*M,) int32
    emi_ordinal: torch.Tensor  # (n_profiles*P,) int32
    num_materials: int
    num_storage: int

    @property
    def num_instances(self) -> int:
        return self.rows.shape[0]


def _decompose(m: np.ndarray):
    """4x4 uniform-scale TRS -> (R (3,3) pure rotation, t (3,), s float)."""
    s = float(np.linalg.norm(m[:3, 0]))
    if s < 1e-12:
        raise ValueError("instance transform has zero scale")
    r = m[:3, :3] / s
    if not np.allclose(r @ r.T, np.eye(3), atol=1e-4):
        raise ValueError("instanced packs require uniform-scale TRS transforms")
    return r, m[:3, 3].copy(), s


def _degenerate_part(intern):
    """A far-away invisible triangle: keeps every block non-empty, so that
    kernel instance ids equal scene instance ids."""
    mid = intern(mat_mod.Invisible())
    return dict(
        v0=np.asarray([[1e7, 1e7, 1e7]], np.float32),
        e1=np.asarray([[1e-3, 0, 0]], np.float32),
        e2=np.asarray([[0, 1e-3, 0]], np.float32),
        n0=np.asarray([[0, 0, 1]], np.float32),
        n1=np.asarray([[0, 0, 1]], np.float32),
        n2=np.asarray([[0, 0, 1]], np.float32),
        uv0=np.zeros((1, 2), np.float32),
        uv1=np.zeros((1, 2), np.float32),
        uv2=np.zeros((1, 2), np.float32),
        tmat=np.asarray([mid], np.int32),
    )


def prepare_scene_instanced(scene: Scene, camera_name: str | None, shared: set[int],
                            device) -> PreparedScene:
    """`prepare_scene` for a scene that keeps the packs `shared` (pack ids)
    in pack space, on `device`."""
    materials: list = []
    mat_index: dict[tuple, int] = {}

    def intern(mat) -> int:
        one_sided = 0
        if isinstance(mat, mat_mod.OneSided):
            one_sided, mat = 1, mat.base
        key = (id(mat), one_sided)
        if key not in mat_index:
            mat_index[key] = len(materials)
            materials.append((mat, one_sided))
        return mat_index[key]

    # --- the root scene, collecting instance specs at shared packs ---
    root = Collector()
    specs: list[tuple[object, np.ndarray, dict]] = []  # (pack, world, swatch)
    for entity, world, swatch in _iter_world(scene, np.eye(4), {}, stop_shared=shared,
                                             inst_specs=specs):
        root.add(entity, world, swatch, intern)

    # --- each shared pack flattened once, in pack space ---
    pack_list: list[object] = []
    pack_cols: dict[int, Collector] = {}
    pack_nested: dict[int, list] = {}
    queue = [p for p, _, _ in specs]
    while queue:
        pack = queue.pop(0)
        if id(pack) in pack_cols:
            continue
        col = Collector()
        nested: list = []
        for child in pack.children:
            for entity, world, swatch in _iter_world(child, np.eye(4), {}, stop_shared=shared,
                                                     inst_specs=nested):
                col.add(entity, world, swatch, intern)
        pack_list.append(pack)
        pack_cols[id(pack)] = col
        pack_nested[id(pack)] = nested
        queue.extend(p for p, _, _ in nested)

    # --- nested instances expanded (PackInstance forbids cycles) ---
    flat_specs: list[tuple[object, np.ndarray, dict]] = []
    work = list(specs)
    while work:
        pack, world, swatch = work.pop(0)
        flat_specs.append((pack, world, swatch))
        for q, local, q_swatch in pack_nested[id(pack)]:
            work.append((q, world @ local, {**swatch, **q_swatch}))

    # --- storage geometry: the root block, then the pack blocks ---
    blocks = [root] + [pack_cols[id(p)] for p in pack_list]
    block_tri, block_sph = [], []  # per block (start, count) in storage
    tri_parts: list[dict] = []
    tri_total = 0
    for col in blocks:
        if col.tri_v:
            v0, e1, e2, n0, n1, n2, uv0, uv1, uv2, tmat = assemble_triangles(
                col.tri_v, col.tri_f, col.tri_n, col.tri_uv, col.tri_m)
            part = dict(v0=v0, e1=e1, e2=e2, n0=n0, n1=n1, n2=n2,
                        uv0=uv0, uv1=uv1, uv2=uv2, tmat=tmat)
        elif not col.sph_c:
            part = _degenerate_part(intern)  # a geometry-less block
        else:
            z = np.zeros((0, 3), np.float32)
            z2 = np.zeros((0, 2), np.float32)
            part = dict(v0=z, e1=z, e2=z, n0=z, n1=z, n2=z,
                        uv0=z2, uv1=z2, uv2=z2, tmat=np.zeros(0, np.int32))
        tri_parts.append(part)
        block_tri.append((tri_total, len(part["v0"])))
        tri_total += len(part["v0"])
    if tri_total == 0:  # all spheres: the geometry keeps one triangle row
        tri_parts[0] = _degenerate_part(intern)
        block_tri = [(0, 1)] + [(1 + s, c) for s, c in block_tri[1:]]
        tri_total = 1

    sph_total = 0
    for col in blocks:
        block_sph.append((sph_total, len(col.sph_r)))
        sph_total += len(col.sph_r)

    catf = lambda key: np.concatenate([p[key] for p in tri_parts], 0)
    z3 = np.zeros((0, 3), np.float32)
    geom_np = dict(
        tri_v0=catf("v0"), tri_e1=catf("e1"), tri_e2=catf("e2"),
        tri_n0=catf("n0"), tri_n1=catf("n1"), tri_n2=catf("n2"),
        tri_uv0=catf("uv0"), tri_uv1=catf("uv1"), tri_uv2=catf("uv2"),
        tri_mat=catf("tmat"),
        sph_center=np.concatenate([np.stack(c.sph_c, 0) if c.sph_c else z3 for c in blocks], 0),
        sph_radius=np.concatenate([np.asarray(c.sph_r, np.float32) if c.sph_r
                                   else np.zeros(0, np.float32) for c in blocks], 0),
        sph_mat=np.concatenate([np.asarray(c.sph_m, np.int32) if c.sph_m
                                else np.zeros(0, np.int32) for c in blocks], 0),
    )
    num_tris = tri_total
    num_prims = num_tris + sph_total

    def block_prims(bi: int) -> np.ndarray:
        """Storage prim ids of block bi (triangles, then spheres)."""
        ts, tc = block_tri[bi]
        ss, sc = block_sph[bi]
        return np.concatenate([ts + np.arange(tc, dtype=np.int64),
                               num_tris + ss + np.arange(sc, dtype=np.int64)])

    # --- instances: 0 = the root block (identity), then the expanded specs ---
    pack_of_block = {id(p): 1 + k for k, p in enumerate(pack_list)}
    inst_block: list[int] = [0]
    inst_R: list[np.ndarray] = [np.eye(3)]
    inst_t: list[np.ndarray] = [np.zeros(3)]
    inst_s: list[float] = [1.0]
    inst_swatch: list[dict] = [{}]
    for pack, world, swatch in flat_specs:
        r, t, s = _decompose(world)
        inst_block.append(pack_of_block[id(pack)])
        inst_R.append(r)
        inst_t.append(t)
        inst_s.append(s)
        inst_swatch.append(swatch)
    n_inst = len(inst_block)

    # --- per-instance material remap (the swatches) ---
    pending_remaps: list[dict[int, object]] = []
    for i in range(n_inst):
        swatch = inst_swatch[i]
        row: dict[int, object] = {}
        if swatch:
            for obj, gid, claimed in blocks[inst_block[i]].mat_pairs:
                if not claimed and id(obj) in swatch:
                    row[gid] = swatch[id(obj)]
        pending_remaps.append(row)
    # interning the replacements may grow the material table
    resolved = [{g: intern(m) for g, m in row.items()} for row in pending_remaps]
    n_mat = len(materials)
    remap_rows = np.tile(np.arange(n_mat, dtype=np.int32), (n_inst, 1))
    for i, row in enumerate(resolved):
        for g, g2 in row.items():
            remap_rows[i, g] = g2

    (mtypes, malbedo, mparams, mextra, mone, mtex, mntex, mnint, mrtex,
     tex_atlas) = build_material_arrays(materials)
    mat_power = np.asarray(
        [m.power if isinstance(m, mat_mod.Emissive) else 0.0 for m, _ in materials], np.float64)

    # --- per-prim pack-space areas (emissive power, pdf scaling) ---
    tri_area2 = np.linalg.norm(np.cross(geom_np["tri_e1"], geom_np["tri_e2"]), axis=-1)
    gn_local = np.cross(geom_np["tri_e1"], geom_np["tri_e2"])
    gn_local = gn_local / np.maximum(tri_area2[:, None], 1e-20)

    # --- light census: the root block as is, pack lights per instance ---
    kinds, indices, powers = [], [], []
    point_rows, dir_rows = [], []
    env = EnvCensus(device)
    for i in range(n_inst):
        col = blocks[inst_block[i]]
        R, T, S = inst_R[i], inst_t[i], inst_s[i]
        for pos, inten, power in col.point_lights:
            p_w = (R * S) @ pos + T if i else pos
            kinds.append(LIGHT_POINT)
            indices.append(len(point_rows))
            powers.append(max(power, 1e-6))
            point_rows.append((p_w.astype(np.float32), np.asarray(inten, np.float32)))
        for d, inten, _ent in col.dir_lights:
            d_w = (R @ d).astype(np.float32) if i else d
            kinds.append(LIGHT_DIRECTIONAL)
            indices.append(len(dir_rows))
            powers.append(max(float(np.pi * _LUM @ inten), 1e-6))
            dir_rows.append((d_w, np.asarray(inten, np.float32)))
        for ent, rot in col.ambient_lights:
            env.add(ent, (R @ rot).astype(np.float32) if i else rot)
    # env maps' records after every explicit light, then the constant one
    for e, p_e in enumerate(env.powers):
        kinds.append(LIGHT_AMBIENT)
        indices.append(e)
        powers.append(p_e)
    if env.constant_power() is not None:
        kinds.append(LIGHT_AMBIENT)
        indices.append(len(env.maps))  # index E = the constant record
        powers.append(env.constant_power())

    # --- emissive census per instance (world-space records); a profile =
    # (block, remap row): instances sharing both share the ordinal table ---
    profile_ids: dict[tuple, int] = {}
    inst_profile = np.zeros(n_inst, np.int32)
    profile_tables: list[np.ndarray] = []
    profile_members: list[tuple[int, np.ndarray]] = []
    for i in range(n_inst):
        key = (inst_block[i], remap_rows[i].tobytes())
        if key not in profile_ids:
            ids = block_prims(inst_block[i])
            tri_ids = ids[ids < num_tris]
            sph_ids = ids[ids >= num_tris]
            g_tri = remap_rows[i][geom_np["tri_mat"][tri_ids]]
            g_sph = remap_rows[i][geom_np["sph_mat"][sph_ids - num_tris]]
            emi = np.concatenate([tri_ids[mat_power[g_tri] > 0.0], sph_ids[mat_power[g_sph] > 0.0]])
            table = np.full(num_prims, -1, np.int32)
            table[emi] = np.arange(len(emi), dtype=np.int32)
            profile_ids[key] = len(profile_tables)
            profile_tables.append(table)
            profile_members.append((inst_block[i], emi))
        inst_profile[i] = profile_ids[key]

    emissive_records = []  # (inst, prim, world record)
    inst_emi_base = np.full(n_inst, -1, np.int32)
    for i in range(n_inst):
        _blk, emi = profile_members[inst_profile[i]]
        if not len(emi):
            continue
        inst_emi_base[i] = len(kinds)
        R, T, S = inst_R[i], inst_t[i], inst_s[i]
        g_row = remap_rows[i]
        for p in emi:
            if p < num_tris:
                g = g_row[geom_np["tri_mat"][p]]
                area_w = 0.5 * tri_area2[p] * S * S
                rec = dict(is_sph=0.0, v0=(R * S) @ geom_np["tri_v0"][p] + T,
                           e1=(R * S) @ geom_np["tri_e1"][p], e2=(R * S) @ geom_np["tri_e2"][p],
                           n=R @ gn_local[p], area=area_w, albedo=malbedo[g])
            else:
                s_i = p - num_tris
                g = g_row[geom_np["sph_mat"][s_i]]
                r_w = float(geom_np["sph_radius"][s_i]) * S
                area_w = 4.0 * np.pi * r_w * r_w
                rec = dict(is_sph=1.0, v0=(R * S) @ geom_np["sph_center"][s_i] + T,
                           e1=np.asarray([r_w, 0, 0]), e2=np.zeros(3), n=np.zeros(3),
                           area=area_w, albedo=malbedo[g])
            power = float(mat_power[g] * area_w * np.pi)
            kinds.append(LIGHT_EMISSIVE_TRI)
            indices.append(len(emissive_records))
            powers.append(max(power, 1e-6))
            emissive_records.append((i, int(p), rec))

    if not kinds:  # degenerate: a black ambient record
        kinds, indices, powers = [LIGHT_AMBIENT], [0], [1e-6]

    powers_np = np.asarray(powers, np.float64)
    cdf = np.cumsum(powers_np / powers_np.sum()).astype(np.float32)
    cdf[-1] = 1.0
    # prim -> light serves only baked scenes: instanced lookups go through
    # the instance table (scene_ops.hit_light_record)
    prim_light = np.full(num_prims, -1, np.int32)

    # --- light tree over the finite (world-space) lights ---
    record_tree = np.full(len(kinds), -1, np.int32)
    tree_records = np.zeros(0, np.int32)
    tree_args = None
    finite = []
    for rec, (k, idx) in enumerate(zip(kinds, indices)):
        if k == LIGHT_POINT:
            pos = point_rows[idx][0]
            finite.append((rec, pos, 0.0, np.asarray([0.0, 0.0, 1.0]), np.pi, np.pi / 2,
                           powers_np[rec]))
        elif k == LIGHT_EMISSIVE_TRI:
            _i, _p, r = emissive_records[idx]
            if r["is_sph"] < 0.5:
                v0 = r["v0"]
                v1 = v0 + r["e1"]
                v2 = v0 + r["e2"]
                c = (v0 + v1 + v2) / 3.0
                rad = float(max(np.linalg.norm(v0 - c), np.linalg.norm(v1 - c),
                                np.linalg.norm(v2 - c)))
                finite.append((rec, c, rad, r["n"], 0.0, np.pi / 2, powers_np[rec]))
            else:
                finite.append((rec, r["v0"], float(r["e1"][0]), np.asarray([0.0, 0.0, 1.0]),
                               np.pi, np.pi / 2, powers_np[rec]))
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
        power=put(powers_np, np.float32),
        cdf=put(cdf),
        point_pos=put(stack3([p for p, _ in point_rows]), np.float32),
        point_intensity=put(stack3([i for _, i in point_rows]), np.float32),
        dir_dir=put(stack3([d for d, _ in dir_rows]), np.float32),
        dir_intensity=put(stack3([i for _, i in dir_rows]), np.float32),
        emissive_prim=put([p for _, p, _ in emissive_records], np.int32),
        emissive_inst=put([i for i, _, _ in emissive_records], np.int32),
        emissive_light=put([rec for rec, k in enumerate(kinds) if k == LIGHT_EMISSIVE_TRI]
                           if emissive_records else [], np.int32),
        prim_light=put(prim_light),
        **env.tables(put),
        tree=None if tree_args is None else build_light_tree(*tree_args, device=device),
        tree_records=put(tree_records),
        record_tree=put(record_tree),
    )

    # emissive_pack rows: world space, one per emissive record
    epack = np.zeros((len(emissive_records), 20), np.float32)
    for j, (_i, _p, r) in enumerate(emissive_records):
        epack[j, 0:3] = r["v0"]
        epack[j, 3:6] = r["e1"]
        epack[j, 6:9] = r["e2"]
        epack[j, 9:12] = r["n"]
        epack[j, 12:15] = r["albedo"]
        epack[j, 15] = r["area"]
        epack[j, 16] = r["is_sph"]

    # --- camera: the root's, then the pack cameras of each instance ---
    cameras = list(root.cameras)
    for i in range(1, n_inst):
        m = np.eye(4)
        m[:3, :3] = inst_R[i] * inst_s[i]
        m[:3, 3] = inst_t[i]
        for c, w_local in blocks[inst_block[i]].cameras:
            cameras.append((c, m @ w_local))
    cam_entity, cam_world = None, np.eye(4)
    for c, w in cameras:
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

    # --- per-pack BVH orders and the instanced tables ---
    bmin, bmax = geometry_bounds(geom_np)
    pack_orders, pack_aabb, pack_bvhs = [], [], []
    for bi in range(len(blocks)):
        ids = block_prims(bi)  # never empty: see _degenerate_part
        tree = build_bvh(bmin[ids], bmax[ids])
        pack_orders.append(ids[tree.prim_order])
        pack_aabb.append((bmin[ids].min(0), bmax[ids].max(0)))
        pack_bvhs.append(tree._replace(prim_order=pack_orders[-1]))
    inv_a = np.zeros((n_inst, 3, 3))
    inv_b = np.zeros((n_inst, 3))
    ilo = np.zeros((n_inst, 3), np.float32)
    ihi = np.zeros((n_inst, 3), np.float32)
    for i in range(n_inst):
        R, T, S = inst_R[i], inst_t[i], inst_s[i]
        a = R.T / S
        inv_a[i] = a
        inv_b[i] = -a @ T
        lo, hi = pack_aabb[inst_block[i]]
        corners = np.array([[lo[k] if b & (1 << k) else hi[k] for k in range(3)]
                            for b in range(8)])
        wc = corners @ (R * S).T + T
        ilo[i] = wc.min(0)
        ihi[i] = wc.max(0)
    hier = build_hier_soa_instanced(geom_np, pack_orders, np.asarray(inst_block, np.int64),
                                    inv_a, inv_b, ilo, ihi, device=device)

    materials_t = MaterialTable(
        type=put(mtypes),
        albedo=put(malbedo, np.float32),
        params=put(mparams, np.float32),
        extra=put(mextra, np.float32),
        one_sided=put(mone),
        albedo_tex=put(mtex),
        present=tuple(sorted({int(t) for t in np.unique(mtypes)}
                             | ({mat_mod.INVISIBLE} if mone.any() else set()))),
        tex_flags=tex_flags(mtex, mntex, mrtex),
    )

    # --- shading rows, in pack space (interact rotates them) ---
    shade = np.zeros((num_prims, 24), np.float32)
    shade[:num_tris, 0:3] = gn_local
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
        shade[num_tris:, 19] = 4.0 * np.pi * geom_np["sph_radius"] ** 2
        shade[num_tris:, 20] = 1.0

    mat_pack = fill_mat_pack(malbedo, mparams, mextra, mtypes, mone, mtex, mntex, mnint, mrtex)

    rows = np.zeros((n_inst, 16), np.float32)
    for i in range(n_inst):
        rows[i, 0:9] = inst_R[i].reshape(-1)
        rows[i, 9:12] = inst_t[i]
        rows[i, 12] = inst_s[i]
        rows[i, 13] = inst_s[i] * inst_s[i]
        rows[i, 14] = inst_emi_base[i]
        rows[i, 15] = inst_profile[i]
    instances = InstanceTable(
        rows=put(rows),
        mat_remap=put(remap_rows.reshape(-1)),
        emi_ordinal=put(np.concatenate(profile_tables) if profile_tables
                        else np.full(num_prims, -1, np.int32)),
        num_materials=n_mat,
        num_storage=num_prims,
    )

    return PreparedScene(
        geometry=FlatGeometry(**{k: put(v) for k, v in geom_np.items()}),
        materials=materials_t,
        lights=lights,
        camera=camera,
        env_maps=tuple(env.maps),
        tex_atlas=put(tex_atlas),
        prim_soa=None,
        shade_pack=put(shade),
        mat_pack=put(mat_pack),
        emissive_pack=put(epack),
        hier_soa=hier,
        instances=instances,
        # the storage tree, in pack space, joined from the packs' own trees
        bvh=on_device(join(pack_bvhs, pack_aabb), device),
    )
