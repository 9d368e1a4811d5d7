"""Carry prepared-scene tables between the JAX package and this port.

Tables travel as a flat dict of numpy arrays keyed by the JAX
`PreparedScene` field paths ("geometry.tri_v0", "prim_soa.ax",
"lights.cdf", "materials.present", "camera.kind", ...); a light tree
travels under "lights.tree.nodes", "lights.tree.light_path", ..., the
chunk-tree tables under "hier_soa.prim_chunks", "hier_soa.root_code", ...
(with the TLAS tables "hier_soa.inst_f32", "hier_soa.binned_g2c", ... of an
instanced scene), and an instanced scene's instance table under
"instances.rows", "instances.num_materials", ...; such a scene has no
"prim_soa.*". The texture atlas travels as "tex_atlas", env map e as
"env_maps.<e>.grid.texels", "env_maps.<e>.dist.marginal_cdf", ...,
"env_maps.<e>.mean_lum", and the BVH as "bvh.child_min", ...,
"bvh.root_code" (read by `from_jax_arrays`; `to_arrays` leaves it out,
since the JAX package's C++ builder may split where the port's numpy one
does not). `to_arrays`
writes a port scene in that form; `from_jax_arrays` builds a port scene
from it, so both packages can be fed identical tables and a difference in
preparation cannot hide a difference in the physics.
"""

from __future__ import annotations

import numpy as np
import torch

from ..aggregation.bvh import FlatBVH
from ..aggregation.light_tree import FlatLightTree
from ..ops.intersect import FlatGeometry
from ..ops.pallas_hier import HierSoA
from ..ops.pallas_intersect import PrimSoA
from ..textures.directional import PreparedDirectional
from ..textures.grids import PreparedGrid
from ..utils.distributions import Distribution2D
from .prepare import LightTable, MaterialTable, PackedCamera, PreparedScene

_ROWS = ("ax", "ay", "az", "bx", "by", "bz", "cx", "cy", "cz", "is_sphere")
_INT_FIELDS = {
    "geometry.tri_mat", "geometry.sph_mat", "materials.type", "materials.one_sided",
    "materials.albedo_tex", "lights.kind", "lights.index", "lights.emissive_prim",
    "lights.emissive_inst", "lights.emissive_light", "lights.prim_light",
    "lights.tree_records", "lights.record_tree", "lights.tree.light_depth",
    "instances.mat_remap", "instances.emi_ordinal",
    "prim_soa.order", "prim_soa.inv_order", "hier_soa.codes", "hier_soa.order",
    "hier_soa.inv_order", "hier_soa.inst_codes", "hier_soa.binned_g2c", "hier_soa.binned_g2i",
    "bvh.child_code", "bvh.prim_order",
}
# HierSoA and InstanceTable fields that are Python scalars, with their types
_HIER_STATICS = {"root_code": int, "stack_size": int, "num_tris": int, "num_prims": int,
                 "instanced": bool}
_INSTANCE_STATICS = {"num_materials": int, "num_storage": int}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x)


def to_arrays(scene: PreparedScene) -> dict[str, np.ndarray]:
    """The scene's tables under the JAX package's field paths."""
    out: dict[str, np.ndarray] = {}
    for group in ("geometry", "materials", "lights", "camera"):
        table = getattr(scene, group)
        for name, value in zip(table._fields, table):
            if isinstance(value, FlatLightTree):
                for sub, v in zip(value._fields, value):
                    out[f"{group}.{name}.{sub}"] = _np(v)
            elif value is not None:
                out[f"{group}.{name}"] = _np(value)
    soa = scene.prim_soa
    if soa is not None:
        rows = _np(soa.rows)
        for k, name in enumerate(_ROWS):
            out[f"prim_soa.{name}"] = rows[k: k + 1]
        for name in ("chunk_bounds", "super_bounds", "order", "inv_order", "num_tris",
                     "num_prims"):
            out[f"prim_soa.{name}"] = _np(getattr(soa, name))
    for name in ("shade_pack", "mat_pack", "emissive_pack", "tex_atlas"):
        out[name] = _np(getattr(scene, name))
    for e, env in enumerate(scene.env_maps):
        for part in ("grid", "dist"):
            table = getattr(env, part)
            for name, value in zip(table._fields, table):
                out[f"env_maps.{e}.{part}.{name}"] = _np(value)
        out[f"env_maps.{e}.mean_lum"] = _np(env.mean_lum)
    for prefix, table in (("hier_soa", scene.hier_soa), ("instances", scene.instances)):
        if table is not None:
            for name, value in zip(table._fields, table):
                out[f"{prefix}.{name}"] = _np(value)
    return out


def from_jax_arrays(tables: dict[str, np.ndarray], device="cuda") -> PreparedScene:
    """A port `PreparedScene` on `device` (the card unless the caller asks
    for another device) from the JAX scene's flattened tables, its BVH
    included when they hold one (extra keys are ignored)."""
    from .instancing import InstanceTable

    device = torch.device(device)

    def put(key):
        a = np.asarray(tables[key])
        a = a.astype(np.int32) if key in _INT_FIELDS else a.astype(np.float32)
        return torch.as_tensor(a.copy(), device=device)  # copy: C order, keeps 0-d

    def tree():
        if "lights.tree.nodes" not in tables:
            return None
        return FlatLightTree(
            nodes=put("lights.tree.nodes"),
            light_path=torch.as_tensor(
                np.asarray(tables["lights.tree.light_path"]).astype(np.int64), device=device),
            light_depth=put("lights.tree.light_depth"),
            max_depth=int(tables["lights.tree.max_depth"]),
        )

    def group(cls, prefix, statics=()):
        vals = {}
        for name in cls._fields:
            key = f"{prefix}.{name}"
            if name == "tree":
                vals[name] = tree()
            elif name in statics:
                vals[name] = statics[name](tables[key])
            else:
                vals[name] = put(key)
        return cls(**vals)

    soa = None
    if "prim_soa.ax" in tables:
        rows = np.concatenate([np.asarray(tables[f"prim_soa.{r}"], np.float32) for r in _ROWS], 0)
        soa = PrimSoA(
            rows=torch.as_tensor(np.ascontiguousarray(rows), device=device),
            chunk_bounds=put("prim_soa.chunk_bounds"),
            super_bounds=put("prim_soa.super_bounds"),
            order=put("prim_soa.order"),
            inv_order=put("prim_soa.inv_order"),
            num_tris=int(tables["prim_soa.num_tris"]),
            num_prims=int(tables["prim_soa.num_prims"]),
        )
    hier = None
    if "hier_soa.prim_chunks" in tables:
        hier = group(HierSoA, "hier_soa", _HIER_STATICS)
    instances = None
    if "instances.rows" in tables:
        instances = group(InstanceTable, "instances", _INSTANCE_STATICS)
    env_maps = []
    while f"env_maps.{len(env_maps)}.mean_lum" in tables:
        e = f"env_maps.{len(env_maps)}"
        env_maps.append(PreparedDirectional(
            grid=group(PreparedGrid, f"{e}.grid", {"wrap": int, "filter": int, "wrap_v": int}),
            dist=group(Distribution2D, f"{e}.dist"),
            mean_lum=put(f"{e}.mean_lum"),
        ))
    bvh = None
    if "bvh.child_min" in tables:
        bvh = group(FlatBVH, "bvh", {"root_code": int})
    return PreparedScene(
        geometry=group(FlatGeometry, "geometry"),
        materials=group(MaterialTable, "materials", {
            "present": lambda a: tuple(int(t) for t in np.asarray(a).reshape(-1)),
            "tex_flags": lambda a: tuple(bool(t) for t in np.asarray(a).reshape(-1)),
        }),
        lights=group(LightTable, "lights"),
        camera=group(PackedCamera, "camera", {"kind": lambda a: int(a)}),
        env_maps=tuple(env_maps),
        tex_atlas=put("tex_atlas"),
        prim_soa=soa,
        shade_pack=put("shade_pack"),
        mat_pack=put("mat_pack"),
        emissive_pack=put("emissive_pack"),
        hier_soa=hier,
        instances=instances,
        bvh=bvh,
    )
