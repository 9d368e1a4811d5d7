"""User-facing material definitions.

Rebuild of the reference material set (Evaluation/Materials/): each material
maps a surface hit to a BSDF composition. Here materials are host-side
descriptions interned into a flat parameter table at scene preparation
(the analogue of SwatchExtractor, Scenic/Preparation/SwatchExtractor.cs);
the device-side BSDF dispatch lives in evaluation/bsdf.py.

Albedo/roughness/emission accept either a constant (float or 3-tuple) or a
Texture (textures/grids.py).
"""

from __future__ import annotations

import numpy as np

# material type ids used in the device parameter table
INVISIBLE = 0
DIFFUSE = 1
DIELECTRIC = 2
CONDUCTOR = 3
EMISSIVE = 4
COATED_DIFFUSE = 5
NUM_MATERIAL_TYPES = 6


def _rgb(value) -> np.ndarray:
    a = np.asarray(value, np.float32)
    if a.ndim == 0:
        a = np.full(3, float(a), np.float32)
    return a[:3].astype(np.float32)


class Material:
    """Base material. `albedo` is the main color texture/constant and
    `normal` an optional tangent-space normal map (reference Material.cs:17)."""

    type_id = INVISIBLE

    def __init__(self, albedo=(1.0, 1.0, 1.0), normal=None, normal_intensity=1.0):
        self.albedo = albedo
        self.normal = normal
        self.normal_intensity = float(normal_intensity)

    def constant_albedo(self) -> np.ndarray:
        if hasattr(self.albedo, "average"):
            return _rgb(self.albedo.average()[:3])
        return _rgb(self.albedo)

    def albedo_texture(self):
        return self.albedo if hasattr(self.albedo, "sample_uv") else None

    def roughness_texture(self):
        r = getattr(self, "roughness", None)
        return r if hasattr(r, "sample_uv") else None

    @staticmethod
    def _rough_scalar(r) -> float:
        """Constant roughness, or the texture's mean as the packed fallback
        (the per-contact value comes from the atlas at interact time)."""
        if hasattr(r, "sample_uv"):
            if hasattr(r, "average"):
                a = np.asarray(r.average(), np.float32).reshape(-1)
                return float(a[:3].mean())
            return 0.5
        return float(r)

    # packed scalar parameters (roughness, ior, ...) — see prepare.py layout
    def params(self) -> np.ndarray:
        return np.zeros(4, np.float32)

    def extra_color(self) -> np.ndarray:
        return np.zeros(3, np.float32)


class Invisible(Material):
    """Pass-through material (reference Evaluation/Materials/Invisible.cs)."""

    type_id = INVISIBLE


class Diffuse(Material):
    """Lambertian, or Oren–Nayar when roughness > 0; `transmissive` flips it
    into a diffuse transmitter (reference Diffuse.cs:16-22)."""

    type_id = DIFFUSE

    def __init__(self, albedo=(0.8, 0.8, 0.8), roughness=0.0, transmissive=False, **kw):
        super().__init__(albedo, **kw)
        self.roughness = roughness
        self.transmissive = bool(transmissive)

    def params(self):
        return np.asarray(
            [self._rough_scalar(self.roughness), 1.0 if self.transmissive else 0.0, 0, 0],
            np.float32,
        )


class Dielectric(Material):
    """Glass-like: GGX glossy reflection+transmission, or perfect specular
    when roughness ~ 0 (reference Dielectric.cs:15-48)."""

    type_id = DIELECTRIC

    def __init__(self, albedo=(1.0, 1.0, 1.0), roughness=0.0, refractive_index=1.5, **kw):
        super().__init__(albedo, **kw)
        self.roughness = roughness
        self.refractive_index = float(refractive_index)

    def params(self):
        return np.asarray(
            [self._rough_scalar(self.roughness), self.refractive_index, 0, 0], np.float32
        )


class Conductor(Material):
    """Metal with complex IOR; `artistic` mode derives eta/k from a main and
    edge color (reference Conductor.cs:18-30, Fresnel.cs ComplexFresnel)."""

    type_id = CONDUCTOR

    def __init__(self, albedo=(0.9, 0.9, 0.9), edge=(1.0, 1.0, 1.0), roughness=0.05, artistic=True, **kw):
        super().__init__(albedo, **kw)
        self.edge = edge
        self.roughness = roughness
        self.artistic = bool(artistic)

    def params(self):
        return np.asarray(
            [self._rough_scalar(self.roughness), 1.0 if self.artistic else 0.0, 0, 0],
            np.float32,
        )

    def extra_color(self):
        return _rgb(self.edge)


class Emissive(Material):
    """Diffuse emitter; power is the averaged albedo luminance times area
    (reference Emissive.cs:20-26)."""

    type_id = EMISSIVE

    def __init__(self, albedo=(1.0, 1.0, 1.0), **kw):
        super().__init__(albedo, **kw)

    @property
    def power(self) -> float:
        # mean emitted radiance luminance (used in the light census)
        c = self.constant_albedo()
        return float(0.212671 * c[0] + 0.715160 * c[1] + 0.072169 * c[2])


class CoatedDiffuse(Diffuse):
    """Clearcoat over a Lambertian base
    (reference CoatedDiffuse.cs, CoatedLambertianReflection)."""

    type_id = COATED_DIFFUSE

    def __init__(self, albedo=(0.8, 0.8, 0.8), roughness=0.0, refractive_index=1.5, **kw):
        super().__init__(albedo, roughness=roughness, **kw)
        self.refractive_index = float(refractive_index)

    def params(self):
        return np.asarray(
            [self._rough_scalar(self.roughness), self.refractive_index, 0, 0], np.float32
        )


class OneSided(Material):
    """Wrapper that makes the base material invisible from the back face
    (reference OneSided.cs). Stored as a flag on the wrapped material."""

    type_id = None  # resolved at interning time

    def __init__(self, base: Material, **kw):
        super().__init__(base.albedo, **kw)
        self.base = base
