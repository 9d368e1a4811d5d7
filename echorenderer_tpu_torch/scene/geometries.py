"""Geometry entities: sources of prepared triangles and spheres.

Rebuild of the reference geometry layer (Scenic/Geometries/): each entity
"extracts" flat arrays under its world transform at preparation time —
the analogue of IGeometrySource<T>.Extract (IGeometrySource.cs).
"""

from __future__ import annotations

import numpy as np

from .entities import Entity
from .materials import Material


class GeometryEntity(Entity):
    def __init__(self, material: Material | None = None, **kw):
        super().__init__(**kw)
        self.material = material or Material()

    def extract_triangles(self, world: np.ndarray) -> dict | None:
        """Return dict(vertices (V,3), faces (F,3), normals (V,3)|None,
        uvs (V,2)|None) in world space, or None."""
        return None

    def extract_sphere(self, world: np.ndarray) -> tuple | None:
        """Return (center (3,), radius) in world space, or None."""
        return None


def _apply(world: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ world[:3, :3].T + world[:3, 3]


def _apply_normals(world: np.ndarray, nrm: np.ndarray) -> np.ndarray:
    inv_t = np.linalg.inv(world[:3, :3]).T
    out = nrm @ inv_t.T
    return out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-20)


class TriangleEntity(GeometryEntity):
    """A single triangle with optional shading normals and texcoords
    (reference Scenic/Geometries/TriangleEntity.cs)."""

    def __init__(self, vertex0, vertex1, vertex2, normals=None, uvs=None, **kw):
        super().__init__(**kw)
        self.vertices = np.asarray([vertex0, vertex1, vertex2], np.float64)
        self.normals = None if normals is None else np.asarray(normals, np.float64)
        self.uvs = None if uvs is None else np.asarray(uvs, np.float64)

    def extract_triangles(self, world):
        return dict(
            vertices=_apply(world, self.vertices),
            faces=np.asarray([[0, 1, 2]], np.int32),
            normals=None if self.normals is None else _apply_normals(world, self.normals),
            uvs=self.uvs,
        )


class MeshEntity(GeometryEntity):
    """An indexed triangle mesh (reference Scenic/Geometries/MeshEntity.cs
    streaming from an ITriangleSource)."""

    def __init__(self, vertices=None, faces=None, normals=None, uvs=None, source=None, **kw):
        super().__init__(**kw)
        self.face_materials = None
        self.materials = None
        if source is not None:  # a loaded model (io/models.py)
            vertices, faces, normals, uvs = (
                source.vertices,
                source.faces,
                source.normals,
                source.uvs,
            )
            if getattr(source, "face_materials", None) is not None and source.materials:
                self.face_materials = np.asarray(source.face_materials, np.int32)
                self.materials = list(source.materials)
        self.vertices = np.asarray(vertices, np.float64)
        self.faces = np.asarray(faces, np.int32)
        self.normals = None if normals is None else np.asarray(normals, np.float64)
        self.uvs = None if uvs is None else np.asarray(uvs, np.float64)

    def extract_triangles(self, world):
        out = dict(
            vertices=_apply(world, self.vertices),
            faces=self.faces,
            normals=None if self.normals is None else _apply_normals(world, self.normals),
            uvs=self.uvs,
        )
        if self.face_materials is not None:
            out["face_materials"] = self.face_materials
            out["materials"] = self.materials
        return out


class SphereEntity(GeometryEntity):
    """An analytic sphere (reference Scenic/Geometries/SphereEntity.cs).
    Requires uniform world scale, like the reference's PreparedSphere."""

    def __init__(self, radius=1.0, **kw):
        super().__init__(**kw)
        self.radius = float(radius)

    def extract_sphere(self, world):
        center = world[:3, 3].copy()
        scale = np.linalg.norm(world[:3, 0])
        return center, self.radius * scale


class PlaneEntity(GeometryEntity):
    """A rectangle in the local XZ plane, facing +Y, as two triangles
    (reference Scenic/Geometries/PlaneEntity.cs)."""

    def __init__(self, size=(1.0, 1.0), **kw):
        super().__init__(**kw)
        self.size = np.asarray(size, np.float64)

    def extract_triangles(self, world):
        hx, hz = self.size / 2.0
        verts = np.asarray(
            [[-hx, 0, -hz], [hx, 0, -hz], [hx, 0, hz], [-hx, 0, hz]], np.float64
        )
        faces = np.asarray([[0, 2, 1], [0, 3, 2]], np.int32)
        uvs = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float64)
        normals = np.tile([[0.0, 1.0, 0.0]], (4, 1))
        return dict(
            vertices=_apply(world, verts),
            faces=faces,
            normals=_apply_normals(world, normals),
            uvs=uvs,
        )


class BoxEntity(GeometryEntity):
    """An axis-aligned (local space) box as 12 triangles
    (reference Scenic/Geometries/BoxEntity.cs)."""

    def __init__(self, size=(1.0, 1.0, 1.0), **kw):
        super().__init__(**kw)
        self.size = np.asarray(size, np.float64)

    def extract_triangles(self, world):
        h = self.size / 2.0
        corners = np.asarray(
            [
                [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
            ],
            np.float64,
        ) * h
        quads = [
            (0, 3, 2, 1),  # -z
            (4, 5, 6, 7),  # +z
            (0, 1, 5, 4),  # -y
            (3, 7, 6, 2),  # +y
            (0, 4, 7, 3),  # -x
            (1, 2, 6, 5),  # +x
        ]
        faces = []
        for a, b, c, d in quads:
            faces.append([a, b, c])
            faces.append([a, c, d])
        return dict(
            vertices=_apply(world, corners),
            faces=np.asarray(faces, np.int32),
            normals=None,
            uvs=None,
        )
