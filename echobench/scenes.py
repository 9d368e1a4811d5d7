"""Scenes as plain data, made by generators found by name.

A configuration file names a generator (`"generator"`) and its arguments
(`"args"`); the generator is `generators/<generator>.py`, whose
`make(**args)` returns a `SceneSpec`. `port.build_scene` turns a spec into
the port's scene objects and `reference.flat.flatten` into the reference's
tables, so both sides render what was made here. A new scene is a new
generator file: nothing here or in `port.py` names a scene or a kind.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class SceneSpec:
    """One scene, in the order the port's `Scene` takes it.

    Every item is a dict whose "kind" names a class of
    `echorenderer_tpu_torch.scene` and whose other keys are that class's
    keyword arguments: `materials` (Diffuse, Conductor, ...); `entities`
    (PlaneEntity, SphereEntity, MeshEntity, ...), added in order, each
    "material" an index into `materials`; `lights` (AmbientLight, ...),
    added after the entities; `camera` (PerspectiveCamera, ...), added
    last, whose "target" goes to its `look_at`."""

    materials: list = dataclasses.field(default_factory=list)
    entities: list = dataclasses.field(default_factory=list)
    lights: list = dataclasses.field(default_factory=list)
    camera: dict = dataclasses.field(default_factory=dict)

    def material(self, kind: str, **kw) -> int:
        """Adds a material; returns its index."""
        self.materials.append(dict(kind=kind, **kw))
        return len(self.materials) - 1

    def entity(self, kind: str, material: int, **kw):
        self.entities.append(dict(kind=kind, material=material, **kw))

    def light(self, kind: str, **kw):
        self.lights.append(dict(kind=kind, **kw))


def args_of(item: dict) -> dict:
    """An item's keyword arguments: every key but "kind"."""
    return {k: v for k, v in item.items() if k != "kind"}
