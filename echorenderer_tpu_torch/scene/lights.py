"""Explicit light entities.

Rebuild of the reference light layer (Scenic/Lights/): point lights (delta
finite), directional lights (delta infinite), and ambient lights (env-map
infinite). Emissive geometry participates via the light census during
preparation (Aggregation/Preparation/LightCollection.cs).
"""

from __future__ import annotations

import numpy as np

from .entities import Entity


def _rgb(value) -> np.ndarray:
    a = np.asarray(value, np.float32)
    if a.ndim == 0:
        a = np.full(3, float(a), np.float32)
    return a[:3].astype(np.float32)


class LightEntity(Entity):
    def __init__(self, intensity=(1.0, 1.0, 1.0), **kw):
        super().__init__(**kw)
        self.intensity = _rgb(intensity)


class PointLight(LightEntity):
    """Omnidirectional delta light (reference PointLight.cs:17-48).
    Power = 4 pi * intensity luminance."""

    @property
    def power(self) -> float:
        c = self.intensity
        return float(4.0 * np.pi * (0.212671 * c[0] + 0.715160 * c[1] + 0.072169 * c[2]))


class DirectionalLight(LightEntity):
    """Delta infinite light shining along local +z (reference DirectionalLight.cs).
    `directly_visible` controls camera-ray visibility."""

    def __init__(self, intensity=(1.0, 1.0, 1.0), directly_visible=False, **kw):
        super().__init__(intensity, **kw)
        self.directly_visible = bool(directly_visible)


class AmbientLight(LightEntity):
    """Environment light: a constant color or an IDirectionalTexture
    (reference AmbientLight.cs, InfiniteLight.cs:18). Rotating the entity
    rotates the environment."""

    def __init__(self, intensity=(1.0, 1.0, 1.0), texture=None, directly_visible=True, **kw):
        super().__init__(intensity, **kw)
        self.texture = texture  # textures/directional.py object or None
        self.directly_visible = bool(directly_visible)
