"""sphere_field: ~80 random spheres on a plane under an ambient light.

A frozen copy of `sphere_field` of echorenderer_tpu_torch/models/scenes.py,
as a `SceneSpec`: the same random draws, in the same order."""

import numpy as np

from echobench.scenes import SceneSpec


def make(count: int = 80, seed: int = 3) -> SceneSpec:
    rs = np.random.RandomState(seed)
    spec = SceneSpec()
    spec.entity("PlaneEntity", spec.material("Diffuse", albedo=(0.6, 0.6, 0.6)),
                size=(100, 100), position=(0, 0, 0))
    makers = [
        lambda c: dict(kind="Diffuse", albedo=tuple(c)),
        lambda c: dict(kind="Conductor", albedo=tuple(c), roughness=0.08),
        lambda c: dict(kind="Dielectric", albedo=(1, 1, 1), roughness=0.0,
                       refractive_index=1.5),
        lambda c: dict(kind="Emissive", albedo=tuple(np.asarray(c) * 4.0)),
    ]
    for _ in range(count):
        r = rs.uniform(0.3, 1.2)
        pos = np.array([rs.uniform(-16, 16), r, rs.uniform(-16, 16)])
        c = rs.uniform(0.2, 0.95, 3)
        spec.entity("SphereEntity", spec.material(**makers[rs.randint(len(makers))](c)),
                    radius=r, position=pos)
    spec.light("AmbientLight", intensity=(0.5, 0.6, 0.75))
    spec.camera = dict(kind="PerspectiveCamera", field_of_view=60.0, position=(0, 6, -24),
                       lens_radius=0.0, target=(0, 1, 0))
    return spec
