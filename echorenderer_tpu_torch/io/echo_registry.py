"""Constructor registry for the Echo description language (counterpart of
echorenderer_tpu/io/echo_registry.py, over this package's classes).

Maps the reference's [EchoSourceUsable] surface (scene entities, materials,
textures, cameras, lights, render profiles, composition layers — see
bunny.echo/cornell.echo in the reference's ext/Scenes) onto this
framework's Python classes. Each builder gets (source, ctor_args, props,
invocations) and returns the constructed object; properties arrive already
coerced (colors as RGBA arrays, vectors as numpy, numbers as floats).
"""

from __future__ import annotations

import re

import numpy as np


def _rgb(v):
    """Coerced literal / Pure texture -> (3,) float color."""
    from ..textures.grids import Pure, Texture

    if isinstance(v, Pure):
        return np.asarray(v.color[:3], np.float32)
    if isinstance(v, Texture):
        return v  # real texture: pass through
    a = np.asarray(v, np.float32).reshape(-1)
    if a.shape[0] == 1:
        a = np.repeat(a, 3)
    return a[:3]


def _scalar(v, default=0.0):
    """Coerced literal / Pure texture -> float (first channel)."""
    from ..textures.grids import Pure

    if isinstance(v, Pure):
        return float(v.color[0])
    a = np.asarray(v, np.float64).reshape(-1)
    return float(a[0]) if a.size else default


def _apply_entity_props(entity, props, extra=None):
    """Common entity properties: Position / Rotation (euler degrees) /
    Scale / Name; anything in `extra` is handled by its callback."""
    leftovers = []
    for name, value in props:
        if name == "Position":
            entity.position = np.asarray(value, np.float64)
        elif name == "Rotation":
            entity.rotation = np.asarray(value, np.float64)
        elif name == "Scale":
            entity.scale = _scalar(value, 1.0)
        elif name == "Name":
            entity.name = str(value)
        elif extra is not None and name in extra:
            extra[name](value)
        else:
            leftovers.append((name, value))
    return leftovers


def _apply_adds(entity, invocations):
    for name, args in invocations:
        if name == "Add":
            for child in args:
                entity.add(child)
        else:
            raise KeyError(f"echo: unknown method .{name} on {type(entity).__name__}")


# ----------------------------------------------------------------------------
# builders
# ----------------------------------------------------------------------------


def _build_scene(source, args, props, calls):
    from ..scene import Scene

    s = Scene()
    _apply_entity_props(s, props)
    _apply_adds(s, calls)
    return s


def _build_entity_pack(source, args, props, calls):
    from ..scene import EntityPack

    s = EntityPack()
    _apply_entity_props(s, props)
    _apply_adds(s, calls)
    return s


class _MaterialSwatch(dict):
    """DSL-facing material swatch (reference Scenic/Hierarchies/
    MaterialSwatch.cs): a material -> material override map applied by a
    PackInstance. The reference's C# indexer has no .echo syntax, so this
    dialect exposes `.Map(original, replacement)` calls instead:

        :sw = new MaterialSwatch .Map(link red link green)
        :i  = new PackInstance { .Pack = link pack .Swatch = link sw }
    """


def _build_material_swatch(source, args, props, calls):
    sw = _MaterialSwatch()
    for name, cargs in calls:
        # .Set is the reference's [EchoSourceUsable] spelling
        # (MaterialSwatch.cs:73-74); .Map is this dialect's original alias
        if name not in ("Map", "Set"):
            raise KeyError(f"echo: unknown method .{name} on MaterialSwatch")
        if len(cargs) != 2:
            raise ValueError(f"echo: MaterialSwatch.{name} takes (original, replacement)")
        sw[cargs[0]] = cargs[1]
    return sw


def _build_pack_instance(source, args, props, calls):
    from ..scene import PackInstance

    pack = args[0] if args else None
    swatch = None
    rest = []
    for name, value in props:
        if name == "Pack":
            pack = value
        elif name == "Swatch":
            swatch = value
        else:
            rest.append((name, value))
    inst = PackInstance(pack, material_swatch=dict(swatch) if swatch else None)
    _apply_entity_props(inst, rest)
    return inst


def _geometry_builder(cls, size_prop=None):
    def build(source, args, props, calls):
        kwargs = {}
        rest = []
        for name, value in props:
            if name == "Material":
                kwargs["material"] = value
            elif name == "Size" and size_prop:
                v = np.asarray(value, np.float64).reshape(-1)
                kwargs["size"] = tuple(v) if v.size > 1 else (float(v[0]),) * size_prop
            elif name == "Radius":
                kwargs["radius"] = _scalar(value, 1.0)
            elif name == "Source":
                from .models import load_model

                kwargs["source"] = load_model(source.base_dir / str(value))
            else:
                rest.append((name, value))
        ent = cls(**kwargs)
        _apply_entity_props(ent, rest)
        return ent

    return build


def _material_builder(cls):
    def build(source, args, props, calls):
        mat = cls()
        for name, value in props:
            if name == "Albedo":
                mat.albedo = value if hasattr(value, "sample_uv") else tuple(_rgb(value))
            elif name == "Roughness":
                # texture-valued roughness passes through (sampled per
                # contact via the atlas, see scene_ops.interact); Pure and
                # literals collapse to the scalar
                from ..textures.grids import Pure

                if hasattr(value, "sample_uv") and not isinstance(value, Pure):
                    mat.roughness = value
                else:
                    mat.roughness = _scalar(value)
            elif name == "RefractiveIndex":
                # conductor physical mode gets per-channel eta via albedo
                from ..scene.materials import Conductor

                if isinstance(mat, Conductor):
                    mat.albedo = tuple(_rgb(value))
                    mat.artistic = False
                else:
                    mat.refractive_index = _scalar(value, 1.5)
            elif name == "Extinction":
                mat.edge = tuple(_rgb(value))
            elif name == "MainColor":
                if getattr(mat, "artistic", True):
                    mat.albedo = tuple(_rgb(value))
            elif name == "EdgeColor":
                if getattr(mat, "artistic", True):
                    mat.edge = tuple(_rgb(value))
            elif name == "Artistic":
                mat.artistic = bool(value)
            elif name == "Transmissive":
                mat.transmissive = bool(value)
            elif name == "Normal":
                mat.normal = value
            elif name == "NormalIntensity":
                mat.normal_intensity = _scalar(value, 1.0)
            else:
                raise KeyError(f"echo: unknown material property .{name}")
        return mat

    return build


def _build_one_sided(source, args, props, calls):
    from ..scene.materials import Material, OneSided

    base = args[0] if args else Material()
    for name, value in props:
        if name == "Base":
            base = value
    return OneSided(base)


def _build_pure(source, args, props, calls):
    from ..textures.grids import Pure

    color = _rgb(args[0]) if args else (1.0, 1.0, 1.0)
    return Pure(color)


def _build_cylindrical(source, args, props, calls):
    from ..textures.directional import CylindricalTexture
    from ..textures.grids import ImportGrid, Texture

    tex = None
    for name, value in props:
        if name == "Texture":
            if isinstance(value, Texture):
                tex = value
            else:  # a file path relative to the .echo file
                tex = ImportGrid(source.base_dir / str(value))
    return CylindricalTexture(tex.data() if tex else np.ones((2, 4, 3), np.float32))


def _build_import_grid(source, args, props, calls):
    from ..textures.grids import ImportGrid

    path = args[0] if args else None
    for name, value in props:
        if name == "Path":
            path = value
    return ImportGrid(source.base_dir / str(path))


def _build_cloud(source, args, props, calls):
    from ..textures.procedural import CloudTexture

    kw = {}
    for name, value in props:
        if name == "Scale":
            kw["scale"] = _scalar(value, 4.0)
        elif name == "Octaves":
            kw["octaves"] = int(_scalar(value, 6))
        elif name == "Seed":
            kw["seed"] = int(_scalar(value, 0))
        else:
            raise KeyError(f"echo: unknown CloudTexture property .{name}")
    return CloudTexture(**kw)


def _build_gradient_texture(source, args, props, calls):
    from ..textures.grids import GradientTexture

    kw = {}
    for name, value in props:
        if name == "Start":
            kw["start"] = tuple(_rgb(value))
        elif name == "End":
            kw["end"] = tuple(_rgb(value))
        elif name == "Axis":
            kw["axis"] = int(_scalar(value))
        else:
            raise KeyError(f"echo: unknown GradientTexture property .{name}")
    return GradientTexture(**kw)


def _light_builder(cls):
    def build(source, args, props, calls):
        light = cls()

        def set_tex(value):
            light.texture = value

        extra = {
            "Intensity": lambda v: setattr(light, "intensity", _rgb(v)),
            "Texture": set_tex,
            "DirectlyVisible": lambda v: setattr(light, "directly_visible", bool(v)),
        }
        rest = _apply_entity_props(light, props, extra)
        if rest:
            raise KeyError(f"echo: unknown light property .{rest[0][0]}")
        return light

    return build


def _camera_builder(cls):
    def build(source, args, props, calls):
        cam = cls()
        extra = {
            "FieldOfView": lambda v: setattr(cam, "field_of_view", _scalar(v, 65.0)),
            "LensRadius": lambda v: setattr(cam, "lens_radius", _scalar(v)),
            "FocalDistance": lambda v: setattr(cam, "focal_distance", _scalar(v)),
            "Width": lambda v: setattr(cam, "width", _scalar(v, 1.0)),
        }
        rest = _apply_entity_props(cam, props, extra)
        if rest:
            raise KeyError(f"echo: unknown camera property .{rest[0][0]}")
        return cam

    return build


# --- evaluators are markers that select the evaluator string ---


def _evaluator(name):
    def build(source, args, props, calls):
        return name

    return build


def _build_evaluation_profile(source, args, props, calls):
    from ..processes.render import EvaluationProfile

    kw = {}
    for name, value in props:
        if name == "Evaluator":
            kw["evaluator"] = value
        elif name == "LayerName":
            kw["layer_name"] = str(value)
        elif name == "NoiseThreshold":
            kw["noise_threshold"] = _scalar(value, 0.045)
        elif name == "MinEpoch":
            kw["min_epoch"] = int(_scalar(value, 1))
        elif name == "MaxEpoch":
            kw["max_epoch"] = int(_scalar(value, 20))
        elif name == "Distribution":
            pass  # sampling is counter-based; stratification is built in
        else:
            raise KeyError(f"echo: unknown EvaluationProfile property .{name}")
    return EvaluationProfile(**kw)


def _build_render_profile(source, args, props, calls):
    from ..processes.render import RenderProfile

    prof = RenderProfile()
    for name, value in props:
        if name == "Scene":
            prof.scene = value
        elif name == "CameraName":
            prof.camera_name = str(value)
        elif name == "Resolution":
            v = np.asarray(value, np.float64).reshape(-1)
            prof.resolution = (int(v[0]), int(v[1]))
        elif name == "EvaluationProfiles":
            prof.evaluations = tuple(value)
        elif name == "CompositionLayers":
            prof.composition = tuple(value)
        elif name == "TileSize":
            pass  # tiles only order the progressive display (tile_progress)
        else:
            raise KeyError(f"echo: unknown RenderProfile property .{name}")
    return prof


def _build_standard_profile(source, args, props, calls):
    from ..processes.render import standard_path_traced_profile

    scene = args[0] if args else None
    quality = _scalar(args[1], 1.0) / 40.0 if len(args) > 1 else 1.0
    watermark = True
    only_denoise = False
    resolution = None
    camera_name = None
    noise_threshold = None
    for name, value in props:
        if name == "OnlyDenoise":
            only_denoise = bool(value)
        elif name == "Quality":
            quality = _scalar(value, 40.0) / 40.0
        elif name == "NoiseThreshold":
            noise_threshold = _scalar(value, 0.045)
        elif name == "Resolution":
            v = np.asarray(value, np.float64).reshape(-1)
            resolution = (int(v[0]), int(v[1]))
        elif name == "CameraName":
            camera_name = str(value)
        elif name == "TileSize":
            pass  # tiles only order the progressive display (tile_progress)
        else:
            raise KeyError(f"echo: unknown StandardPathTracedProfile property .{name}")
    prof = standard_path_traced_profile(
        quality=quality,
        resolution=resolution or (960, 540),
        watermark=watermark and not only_denoise,
    )
    if only_denoise:
        from ..processes.composition import LearnedDenoise

        prof.composition = (LearnedDenoise(),)
    if noise_threshold is not None:
        for ep in prof.evaluations:
            if ep.evaluator == "path":
                ep.noise_threshold = noise_threshold
    prof.camera_name = camera_name
    prof.scene = scene
    return prof


def _composition_builder(cls, **fixed):
    def build(source, args, props, calls):
        kw = dict(fixed)
        for name, value in props:
            if cls.__name__ == "TextureManage" and name in ("CopySources", "CopyLayers"):
                items = value if isinstance(value, list) else [value]
                kw["copy_from" if name == "CopySources" else "copy_to"] = str(items[0])
            else:
                key = re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()
                if not hasattr(cls(), key):
                    raise KeyError(f"echo: unknown {cls.__name__} property .{name}")
                if isinstance(value, (np.ndarray, np.floating)):
                    value = float(np.asarray(value).reshape(-1)[0])
                kw[key] = value
        return cls(**kw)

    return build


def _make_registry():
    from ..processes import composition as comp
    from ..scene import cameras, geometries, lights
    from ..scene import materials as mats

    return {
        "Scene": _build_scene,
        "EntityPack": _build_entity_pack,
        "PackInstance": _build_pack_instance,
        "MaterialSwatch": _build_material_swatch,
        # geometry
        "PlaneEntity": _geometry_builder(geometries.PlaneEntity, size_prop=2),
        "BoxEntity": _geometry_builder(geometries.BoxEntity, size_prop=3),
        "SphereEntity": _geometry_builder(geometries.SphereEntity),
        "MeshEntity": _geometry_builder(geometries.MeshEntity),
        "TriangleEntity": _geometry_builder(geometries.TriangleEntity),
        # materials
        "Diffuse": _material_builder(mats.Diffuse),
        "Dielectric": _material_builder(mats.Dielectric),
        "Conductor": _material_builder(mats.Conductor),
        "Emissive": _material_builder(mats.Emissive),
        "CoatedDiffuse": _material_builder(mats.CoatedDiffuse),
        "Invisible": _material_builder(mats.Invisible),
        "OneSided": _build_one_sided,
        # textures
        "Pure": _build_pure,
        "CylindricalTexture": _build_cylindrical,
        "ImportGrid": _build_import_grid,
        "Texture": _build_import_grid,  # bare path syntax alias
        "CloudTexture": _build_cloud,
        "GradientTexture": _build_gradient_texture,
        # lights
        "PointLight": _light_builder(lights.PointLight),
        "DirectionalLight": _light_builder(lights.DirectionalLight),
        "AmbientLight": _light_builder(lights.AmbientLight),
        # cameras
        "PerspectiveCamera": _camera_builder(cameras.PerspectiveCamera),
        "OrthographicCamera": _camera_builder(cameras.OrthographicCamera),
        "CylindricalCamera": _camera_builder(cameras.CylindricalCamera),
        # evaluators
        "PathTracedEvaluator": _evaluator("path"),
        "StandardNaiveEvaluator": _evaluator("naive"),
        "NaiveEvaluator": _evaluator("naive"),
        "AlbedoEvaluator": _evaluator("albedo"),
        "NormalDepthEvaluator": _evaluator("normal_depth"),
        "AggregatorQualityEvaluator": _evaluator("aggregator_quality"),
        # profiles
        "EvaluationProfile": _build_evaluation_profile,
        "RenderProfile": _build_render_profile,
        "StandardPathTracedProfile": _build_standard_profile,
        # composition
        "TextureManage": _composition_builder(comp.TextureManage),
        "AutoExposure": _composition_builder(comp.AutoExposure),
        "Bloom": _composition_builder(comp.Bloom),
        "ToneMapper": _composition_builder(comp.ToneMapper),
        "Vignette": _composition_builder(comp.Vignette),
        "Watermark": _composition_builder(comp.Watermark),
        "OidnDenoise": _composition_builder(comp.LearnedDenoise),
        "BilateralDenoise": _composition_builder(comp.BilateralDenoise),
        "LearnedDenoise": _composition_builder(comp.LearnedDenoise),
    }


REGISTRY = _make_registry()
