"""Triangle mesh import (counterpart of echorenderer_tpu/io/models.py, in
numpy): Wavefront OBJ (+.mtl materials, .zip compressed), Stanford PLY
(ascii + binary little/big endian).

Rebuild of the reference model readers (InOut/Models/
WavefrontObjectFormatReader.cs:18 — .obj with zip support and parallel
line parsing; PolygonFileFormatReader.cs — .ply; MaterialLibrary.cs —
.mtl -> Materials). Parsing is numpy-vectorized instead of thread-pooled:
the whole file is split once and each attribute class is converted with
one `np.loadtxt`-style pass, which is the single-core-friendly analogue
of the reference's parallel line parser.
"""

from __future__ import annotations

import io as _io
import zipfile
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np


@dataclass
class Model:
    """A loaded indexed triangle mesh. `faces` index into `vertices`;
    normals/uvs are per-vertex (re-indexed during load when the source
    indexes them separately, as OBJ does)."""

    vertices: np.ndarray  # (V, 3) float32
    faces: np.ndarray  # (F, 3) int32
    normals: np.ndarray | None = None  # (V, 3)
    uvs: np.ndarray | None = None  # (V, 2)
    face_materials: np.ndarray | None = None  # (F,) int32 into materials
    materials: list = field(default_factory=list)  # scene.materials objects
    material_names: list = field(default_factory=list)


def load_model(path, *, load_materials: bool = True) -> Model:
    """Extension-dispatch model load (.obj, .obj inside .zip, .ply)."""
    p = Path(path)
    suffix = p.suffix.lower()
    if suffix == ".zip":
        with zipfile.ZipFile(p) as z:
            inner = [n for n in z.namelist() if n.lower().endswith((".obj", ".ply"))]
            if not inner:
                raise ValueError(f"no model file inside {path}")
            blob = z.read(inner[0])
            if inner[0].lower().endswith(".obj"):
                return _load_obj_bytes(blob, p.parent, load_materials)
            return _load_ply_bytes(blob)
    if suffix == ".obj":
        return _load_obj_bytes(p.read_bytes(), p.parent, load_materials)
    if suffix == ".ply":
        return _load_ply_bytes(p.read_bytes())
    raise ValueError(f"unsupported model extension {suffix!r}")


# ----------------------------------------------------------------------------
# OBJ
# ----------------------------------------------------------------------------


def _load_obj_bytes(blob: bytes, base_dir: Path, load_materials: bool) -> Model:
    text = blob.decode("utf-8", errors="replace")
    positions: list[str] = []
    texcoords: list[str] = []
    normals: list[str] = []
    face_lines: list[tuple[str, int]] = []  # (line, material index)
    mtl_names: list[str] = []
    mtl_files: list[str] = []
    current_mtl = -1

    for line in text.splitlines():
        if not line or line[0] == "#":
            continue
        if line.startswith("v "):
            positions.append(line[2:])
        elif line.startswith("vt "):
            texcoords.append(line[3:])
        elif line.startswith("vn "):
            normals.append(line[3:])
        elif line.startswith("f "):
            face_lines.append((line[2:], current_mtl))
        elif line.startswith("usemtl "):
            name = line[7:].strip()
            if name not in mtl_names:
                mtl_names.append(name)
            current_mtl = mtl_names.index(name)
        elif line.startswith("mtllib "):
            mtl_files.append(line[7:].strip())

    pos = np.loadtxt(_io.StringIO("\n".join(positions)), dtype=np.float32, ndmin=2)[:, :3]
    uv = (
        np.loadtxt(_io.StringIO("\n".join(texcoords)), dtype=np.float32, ndmin=2)[:, :2]
        if texcoords
        else None
    )
    nrm = (
        np.loadtxt(_io.StringIO("\n".join(normals)), dtype=np.float32, ndmin=2)[:, :3]
        if normals
        else None
    )

    # parse faces; fan-triangulate polygons; corners keyed by (v, vt, vn)
    corner_key: dict[tuple, int] = {}
    out_v: list[int] = []  # source position index per output vertex
    out_vt: list[int] = []
    out_vn: list[int] = []
    tri_faces: list[list[int]] = []
    tri_mats: list[int] = []

    def corner(token: str) -> int:
        parts = token.split("/")
        vi = int(parts[0])
        ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        vi = vi - 1 if vi > 0 else len(pos) + vi
        ti = ti - 1 if ti > 0 else (len(uv) + ti if uv is not None and ti else -1)
        ni = ni - 1 if ni > 0 else (len(nrm) + ni if nrm is not None and ni else -1)
        key = (vi, ti, ni)
        if key not in corner_key:
            corner_key[key] = len(out_v)
            out_v.append(vi)
            out_vt.append(ti)
            out_vn.append(ni)
        return corner_key[key]

    for line, mat in face_lines:
        ids = [corner(t) for t in line.split()]
        for k in range(1, len(ids) - 1):
            tri_faces.append([ids[0], ids[k], ids[k + 1]])
            tri_mats.append(mat)

    vi = np.asarray(out_v, np.int64)
    vertices = pos[vi]
    uvs = None
    if uv is not None:
        ti = np.asarray(out_vt, np.int64)
        uvs = np.where((ti >= 0)[:, None], uv[np.maximum(ti, 0)], 0.0).astype(np.float32)
    norms = None
    if nrm is not None:
        ni = np.asarray(out_vn, np.int64)
        norms = np.where((ni >= 0)[:, None], nrm[np.maximum(ni, 0)], 0.0).astype(np.float32)

    materials = []
    if load_materials and mtl_files and mtl_names:
        lib = {}
        for mf in mtl_files:
            mp = base_dir / mf
            if mp.exists():
                lib.update(parse_mtl(mp.read_text(errors="replace"), base_dir))
        from ..scene.materials import Diffuse

        materials = [lib.get(n) or Diffuse() for n in mtl_names]

    return Model(
        vertices=vertices.astype(np.float32),
        faces=np.asarray(tri_faces, np.int32).reshape(-1, 3),
        normals=norms,
        uvs=uvs,
        face_materials=np.asarray(tri_mats, np.int32) if mtl_names else None,
        materials=materials,
        material_names=mtl_names,
    )


def parse_mtl(text: str, base_dir: Path) -> dict:
    """.mtl material library -> {name: scene material} (reference
    MaterialLibrary.cs mapping of Kd/Ks/Ke/Ni/d to Echo materials)."""
    from ..scene.materials import Conductor, Dielectric, Diffuse, Emissive
    from ..textures import ImportGrid

    mats: dict[str, object] = {}
    cur: dict | None = None
    name = None

    def flush():
        if name is None or cur is None:
            return
        ke = cur.get("Ke", (0, 0, 0))
        kd = cur.get("Kd", (0.8, 0.8, 0.8))
        ks = cur.get("Ks", (0, 0, 0))
        ns = float(cur.get("Ns", 10.0))
        d = float(cur.get("d", 1.0))
        albedo = cur.get("map_Kd", kd)
        rough = float(np.clip(1.0 - np.sqrt(min(ns, 1000.0)) / 31.62, 0.0, 1.0))
        if max(ke) > 0.0:
            mats[name] = Emissive(albedo=ke)
        elif d < 1.0:  # transparent -> dielectric glass
            mats[name] = Dielectric(albedo=(1, 1, 1), roughness=rough,
                                    refractive_index=float(cur.get("Ni", 1.5)))
        elif max(ks) > 0.5 and max(kd) < 0.2:  # specular-dominant -> metal
            mats[name] = Conductor(albedo=ks, roughness=rough)
        else:
            mats[name] = Diffuse(albedo=albedo)

    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "newmtl":
            flush()
            name = " ".join(parts[1:])
            cur = {}
        elif cur is not None:
            if tag in ("Kd", "Ks", "Ke", "Ka"):
                cur[tag] = tuple(float(x) for x in parts[1:4])
            elif tag in ("Ns", "Ni", "d"):
                cur[tag] = float(parts[1])
            elif tag == "map_Kd":
                tex_path = base_dir / parts[-1]
                if tex_path.exists():
                    cur["map_Kd"] = ImportGrid(tex_path)
    flush()
    return mats


# ----------------------------------------------------------------------------
# PLY
# ----------------------------------------------------------------------------

_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _load_ply_bytes(blob: bytes) -> Model:
    header_end = blob.index(b"end_header\n") + len(b"end_header\n")
    header = blob[:header_end].decode("ascii", errors="replace")
    body = blob[header_end:]

    fmt = "ascii"
    elements: list[dict] = []
    for line in header.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append(dict(name=parts[1], count=int(parts[2]), props=[]))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                # ("list", count_type, index_type, name)
                elements[-1]["props"].append(("list", parts[2], parts[3], parts[4]))
            else:
                # ("scalar", name, type)
                elements[-1]["props"].append(("scalar", parts[2], parts[1]))

    endian = "<" if fmt == "binary_little_endian" else ">"
    verts = norms = uvs = None
    faces = []  # triangles of rows walked one at a time
    blocks = []  # (F, 3) arrays, in element order with `faces` between them

    if fmt == "ascii":
        tokens = body.decode("ascii", errors="replace").split("\n")
        row = 0
        for el in elements:
            rows = [tokens[row + i].split() for i in range(el["count"])]
            row += el["count"]
            if el["name"] == "vertex":
                names = [p[1] for p in el["props"] if p[0] == "scalar"]
                arr = np.asarray([[float(v) for v in r[: len(names)]] for r in rows], np.float32)
                verts, norms, uvs = _extract_vertex_props(arr, names)
            elif el["name"] == "face":
                for r in rows:
                    n = int(r[0])
                    ids = [int(v) for v in r[1 : 1 + n]]
                    for k in range(1, n - 1):
                        faces.append([ids[0], ids[k], ids[k + 1]])
    else:
        pos = 0
        for el in elements:
            if all(p[0] == "scalar" for p in el["props"]):
                dt = np.dtype([(p[1], endian + _PLY_TYPES[p[2]]) for p in el["props"]])
                arr = np.frombuffer(body, dt, el["count"], pos)
                pos += dt.itemsize * el["count"]
                if el["name"] == "vertex":
                    names = [p[1] for p in el["props"]]
                    flat = np.stack([arr[n].astype(np.float32) for n in names], -1)
                    verts, norms, uvs = _extract_vertex_props(flat, names)
            else:  # list property (faces) — variable length, walk rows
                count_t = np.dtype(endian + _PLY_TYPES[el["props"][0][1]])
                index_t = np.dtype(endian + _PLY_TYPES[el["props"][0][2]])
                rows = (_uniform_list_rows(body, pos, el["count"], count_t, index_t)
                        if len(el["props"]) == 1 else None)
                if rows is not None:  # every row of one length: one strided read
                    pos += rows.nbytes
                    if el["name"] == "face":
                        blocks += [np.asarray(faces, np.int64).reshape(-1, 3),
                                   _fan(rows["ids"].astype(np.int64))]
                        faces = []
                    continue
                for _ in range(el["count"]):
                    n = int(np.frombuffer(body, count_t, 1, pos)[0])
                    pos += count_t.itemsize
                    ids = np.frombuffer(body, index_t, n, pos).astype(np.int64)
                    pos += index_t.itemsize * n
                    if el["name"] == "face":
                        for k in range(1, n - 1):
                            faces.append([int(ids[0]), int(ids[k]), int(ids[k + 1])])

    if verts is None:
        raise ValueError("ply: no vertex element")
    blocks.append(np.asarray(faces, np.int64).reshape(-1, 3))
    return Model(
        vertices=verts,
        faces=np.concatenate(blocks).astype(np.int32),
        normals=norms,
        uvs=uvs,
    )


def _uniform_list_rows(body: bytes, pos: int, count: int, count_t, index_t):
    """The rows of a single-list element as one structured array when every
    row has the first row's length (a triangle or quad mesh), else None."""
    if count == 0 or pos + count_t.itemsize > len(body):
        return None
    n = int(np.frombuffer(body, count_t, 1, pos)[0])
    dt = np.dtype([("n", count_t), ("ids", index_t, (n,))], align=False)
    if n < 3 or pos + dt.itemsize * count > len(body):
        return None
    rows = np.frombuffer(body, dt, count, pos)
    return rows if bool((rows["n"] == n).all()) else None


def _fan(ids: np.ndarray) -> np.ndarray:
    """Fan triangulation of (F, n) polygons, in the row walk's order:
    polygon by polygon, (0, k, k + 1) for k = 1 .. n - 2."""
    n = ids.shape[1]
    tris = np.stack([np.stack([ids[:, 0], ids[:, k], ids[:, k + 1]], -1)
                     for k in range(1, n - 1)], 1)
    return tris.reshape(-1, 3)


def _extract_vertex_props(arr: np.ndarray, names: list[str]):
    def cols(*want):
        if all(w in names for w in want):
            return arr[:, [names.index(w) for w in want]].astype(np.float32)
        return None

    verts = cols("x", "y", "z")
    norms = cols("nx", "ny", "nz")
    uvs = cols("u", "v") if cols("u", "v") is not None else cols("s", "t")
    return verts, norms, uvs
