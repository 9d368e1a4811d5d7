"""The system under test: the PyTorch and CUDA port, driven through its
public API. Everything the benchmark takes from the program passes through
here; nothing else in echobench imports echorenderer_tpu_torch.

`build_scene` turns a `scenes.SceneSpec` into the port's scene objects,
`prepare` flattens it onto the device, and `Entry` renders one image of a
traffic mix: `render_layer` for an "entry": "render_layer" mix (one
evaluation profile), `render` with `standard_path_traced_profile` for an
"entry": "render" mix (the README's call). A `render` image's stack starts
with the port's own `TextureManage(copy_from="main", copy_to="path")`, so
the call also returns the path layer that the stack took in, as "path":
the check follows it (check.py). That costs one more layer's download an
image.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def build_scene(spec):
    """The port's `Scene` of a spec: each item's "kind" is the class of
    `echorenderer_tpu_torch.scene` it is made with, in the spec's order."""
    from echorenderer_tpu_torch import scene as api

    from .scenes import args_of

    make = lambda item: getattr(api, item["kind"])(**args_of(item))
    materials = [make(m) for m in spec.materials]
    scene = api.Scene()
    for e in spec.entities:
        scene.add(make(dict(e, material=materials[e["material"]])))
    for light in spec.lights:
        scene.add(make(light))
    cam = make({k: v for k, v in spec.camera.items() if k != "target"})
    cam.look_at(spec.camera["target"])
    scene.add(cam)
    return scene


def prepare(spec, device):
    """The port's `prepare_scene` of the spec's scene on `device`."""
    from echorenderer_tpu_torch.scene.prepare import prepare_scene

    return prepare_scene(build_scene(spec), device=device)


class Entry:
    """One image of a traffic mix through the port's public entry. A call
    returns (the images the entry returned, by layer name, as host arrays;
    its info, by layer name)."""

    def __init__(self, traffic: dict):
        from echorenderer_tpu_torch.processes import render as render_mod

        self.kind = traffic["entry"]
        self.resolution = tuple(traffic["resolution"])
        self._render = render_mod
        if self.kind == "render_layer":
            self.profile = render_mod.EvaluationProfile(**traffic["profile"])
        elif self.kind == "render":
            self.quality = float(traffic["quality"])
        else:
            raise ValueError(f"unknown entry {self.kind!r}")

    def __call__(self, scene, seed: int):
        r = self._render
        if self.kind == "render_layer":
            image, info = r.render_layer(scene, self.profile, self.resolution, seed=seed)
            return {self.profile.layer_name: image}, {self.profile.layer_name: info}
        from echorenderer_tpu_torch.processes.composition import TextureManage

        profile = r.standard_path_traced_profile(self.quality, self.resolution)
        profile = dataclasses.replace(profile, seed=seed, composition=(
            TextureManage(copy_from="main", copy_to="path"),) + profile.composition)
        layers = r.render(scene, profile)
        infos = layers.pop("__info__")
        if "composition_errors" in infos:
            raise RuntimeError(f"composition failed: {infos['composition_errors']}")
        return {k: np.asarray(v) for k, v in layers.items()}, infos
