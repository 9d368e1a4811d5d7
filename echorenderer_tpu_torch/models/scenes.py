"""Built-in benchmark scenes, the analogue of the reference's ext/Scenes
(.echo files): a Cornell box, a material ball, a many-lights stress scene,
the 80-sphere field from the reference performance log
(misc/performance.txt:4), objects under an importance-sampled sky
(hdr_environment), the grid of triangulated spheres that bench.py's
large-scene configuration renders at a million triangles, and four
placements of one such grid (the TLAS check of
benchmarks/instanced_tpu_check.py).

Copied from echorenderer_tpu/models/scenes.py and, for `sphere_grid` and
`instanced_sphere_grids`, from benchmarks/scene_throughput.py and
benchmarks/instanced_tpu_check.py. `hdr_environment(hdr_path=...)` reads
its sky through io/images.py and `load_mesh_scene` its mesh through
io/models.py."""

from __future__ import annotations

import numpy as np

from ..scene import (
    AmbientLight,
    BoxEntity,
    Conductor,
    CoatedDiffuse,
    Dielectric,
    Diffuse,
    Emissive,
    MeshEntity,
    PerspectiveCamera,
    PlaneEntity,
    PointLight,
    Scene,
    SphereEntity,
)
from ..scene.entities import euler_quaternion


def cornell_box(light_scale: float = 1.0) -> Scene:
    """The classic Cornell box: white floor/ceiling/back, red/green walls,
    two diffuse boxes, one emissive quad on the ceiling."""
    scene = Scene()
    white = Diffuse(albedo=(0.73, 0.73, 0.73))
    red = Diffuse(albedo=(0.65, 0.05, 0.05))
    green = Diffuse(albedo=(0.12, 0.45, 0.15))
    light = Emissive(albedo=tuple(np.asarray([18.4, 15.6, 8.0]) * light_scale))

    s = 5.0  # box half size-ish scale
    scene.add(PlaneEntity(size=(2 * s, 2 * s), material=white, position=(0, 0, 0)))  # floor
    scene.add(
        PlaneEntity(size=(2 * s, 2 * s), material=white, position=(0, 2 * s, 0), rotation=(180, 0, 0))
    )  # ceiling
    scene.add(
        PlaneEntity(size=(2 * s, 2 * s), material=white, position=(0, s, s), rotation=(-90, 0, 0))
    )  # back wall
    scene.add(
        PlaneEntity(size=(2 * s, 2 * s), material=red, position=(-s, s, 0), rotation=(0, 0, -90))
    )  # left wall
    scene.add(
        PlaneEntity(size=(2 * s, 2 * s), material=green, position=(s, s, 0), rotation=(0, 0, 90))
    )  # right wall
    scene.add(
        PlaneEntity(size=(0.5 * s, 0.5 * s), material=light, position=(0, 2 * s - 1e-3, 0), rotation=(180, 0, 0))
    )  # area light

    scene.add(
        BoxEntity(size=(3, 6, 3), material=white, position=(-1.9, 3.0, 1.6), rotation=(0, 20, 0))
    )
    scene.add(
        BoxEntity(size=(3, 3, 3), material=white, position=(2.0, 1.5, -1.3), rotation=(0, -18, 0))
    )

    cam = PerspectiveCamera(field_of_view=42.0, position=(0, s, -3.2 * s))
    cam.look_at((0, s, 0))
    scene.add(cam)
    return scene


def material_ball(material=None) -> Scene:
    """A single sphere on a plane under an area light and ambient sky —
    the material showcase (reference ext/Scenes material ball)."""
    scene = Scene()
    mat = material or Dielectric(albedo=(1.0, 1.0, 1.0), roughness=0.15, refractive_index=1.5)
    scene.add(PlaneEntity(size=(40, 40), material=Diffuse(albedo=(0.4, 0.4, 0.4))))
    scene.add(SphereEntity(radius=1.0, material=mat, position=(0, 1.0, 0)))
    scene.add(
        SphereEntity(
            radius=0.5,
            material=Conductor(albedo=(0.95, 0.64, 0.54), roughness=0.1),
            position=(2.0, 0.5, -1.0),
        )
    )
    scene.add(
        SphereEntity(
            radius=0.5,
            material=CoatedDiffuse(albedo=(0.2, 0.3, 0.8), refractive_index=1.5),
            position=(-2.0, 0.5, -1.0),
        )
    )
    scene.add(
        PlaneEntity(
            size=(4, 4),
            material=Emissive(albedo=(8.0, 7.6, 7.2)),
            position=(0, 8, 0),
            rotation=(180, 0, 0),
        )
    )
    scene.add(AmbientLight(intensity=(0.06, 0.07, 0.09)))
    cam = PerspectiveCamera(field_of_view=40.0, position=(0, 2.2, -7.0))
    cam.look_at((0, 0.9, 0))
    scene.add(cam)
    return scene


def many_lights(count: int = 128, seed: int = 5) -> Scene:
    """Hundreds of emissive spheres over a diffuse plane — exercises the
    light selection machinery (BASELINE.json config #3)."""
    rs = np.random.RandomState(seed)
    scene = Scene()
    scene.add(PlaneEntity(size=(60, 60), material=Diffuse(albedo=(0.5, 0.5, 0.5))))
    for _ in range(count):
        pos = np.array([rs.uniform(-20, 20), rs.uniform(0.3, 6.0), rs.uniform(-20, 20)])
        color = rs.uniform(0.2, 6.0, 3)
        scene.add(
            SphereEntity(radius=rs.uniform(0.05, 0.25), material=Emissive(albedo=tuple(color)), position=pos)
        )
    # a few matte objects to catch the light
    for _ in range(24):
        pos = np.array([rs.uniform(-12, 12), 0.6, rs.uniform(-12, 12)])
        scene.add(SphereEntity(radius=0.6, material=Diffuse(albedo=tuple(rs.uniform(0.2, 0.9, 3))), position=pos))
    cam = PerspectiveCamera(field_of_view=55.0, position=(0, 7, -22))
    cam.look_at((0, 0.5, 0))
    scene.add(cam)
    return scene


def sphere_field(count: int = 80, seed: int = 3) -> Scene:
    """~80 random spheres, the reference's original benchmark scene
    (misc/performance.txt:4 '80 spheres')."""
    rs = np.random.RandomState(seed)
    scene = Scene()
    scene.add(PlaneEntity(size=(100, 100), material=Diffuse(albedo=(0.6, 0.6, 0.6))))
    makers = [
        lambda c: Diffuse(albedo=tuple(c)),
        lambda c: Conductor(albedo=tuple(c), roughness=0.08),
        lambda c: Dielectric(albedo=(1, 1, 1), roughness=0.0, refractive_index=1.5),
        lambda c: Emissive(albedo=tuple(np.asarray(c) * 4.0)),
    ]
    for _ in range(count):
        r = rs.uniform(0.3, 1.2)
        pos = np.array([rs.uniform(-16, 16), r, rs.uniform(-16, 16)])
        c = rs.uniform(0.2, 0.95, 3)
        mat = makers[rs.randint(len(makers))](c)
        scene.add(SphereEntity(radius=r, material=mat, position=pos))
    scene.add(AmbientLight(intensity=(0.5, 0.6, 0.75)))
    cam = PerspectiveCamera(field_of_view=60.0, position=(0, 6, -24), lens_radius=0.0)
    cam.look_at((0, 1, 0))
    scene.add(cam)
    return scene


def hdr_environment(hdr_path=None, resolution=(256, 128), sun_elevation=35.0) -> Scene:
    """HDR-environment showcase (BASELINE config #4): glossy + diffuse +
    glass objects under an importance-sampled equirectangular sky. Uses a
    procedural sun+gradient sky unless an .hdr/.exr path is given."""
    from ..textures import CylindricalTexture

    if hdr_path is not None:
        from ..io.images import load

        sky = load(hdr_path)[..., :3]
    else:
        h, w = resolution[1], resolution[0]
        v = (np.arange(h, dtype=np.float32) + 0.5) / h  # 0 = down, 1 = up
        u = (np.arange(w, dtype=np.float32) + 0.5) / w
        uu, vv = np.meshgrid(u, v)
        horizon = np.clip((vv - 0.5) * 2.0, 0.0, 1.0)
        sky = np.stack(
            [0.25 + 0.25 * horizon, 0.35 + 0.35 * horizon, 0.55 + 0.45 * horizon], -1
        ).astype(np.float32)
        ground = vv < 0.5
        sky[ground] = [0.18, 0.15, 0.12]
        # sun disk
        el = np.radians(sun_elevation)
        sun_v = 0.5 + el / np.pi
        d2 = ((uu - 0.72) * 2.0) ** 2 + ((vv - sun_v) * 1.0) ** 2
        sky += np.where(d2[..., None] < 0.0006, np.asarray([900.0, 820.0, 700.0]), 0.0)

    scene = Scene()
    scene.add(PlaneEntity(size=(30, 30), material=Diffuse(albedo=(0.5, 0.5, 0.5))))
    scene.add(SphereEntity(radius=1.0, material=Conductor(albedo=(0.95, 0.75, 0.45), roughness=0.08), position=(-2.2, 1, 0)))
    scene.add(SphereEntity(radius=1.0, material=Dielectric(albedo=(1, 1, 1), roughness=0.0, refractive_index=1.5), position=(0, 1, 0)))
    scene.add(SphereEntity(radius=1.0, material=Diffuse(albedo=(0.8, 0.3, 0.25)), position=(2.2, 1, 0)))
    scene.add(AmbientLight(intensity=(1, 1, 1), texture=CylindricalTexture(sky)))
    cam = PerspectiveCamera(field_of_view=45.0, position=(0, 2.0, -8.0))
    cam.look_at((0, 1.0, 0))
    scene.add(cam)
    return scene


def load_mesh_scene(path, material=None, scale=1.0, env=(0.6, 0.7, 0.9)) -> Scene:
    """A loaded OBJ/PLY mesh on a ground plane under an ambient sky."""
    from ..io.models import load_model

    model = load_model(path)
    scene = Scene()
    mat = material or Diffuse(albedo=(0.7, 0.7, 0.7))
    lo = model.vertices.min(axis=0)
    hi = model.vertices.max(axis=0)
    center = (lo + hi) / 2
    size = float(np.max(hi - lo))
    norm = 2.0 * scale / max(size, 1e-9)
    mesh = MeshEntity(source=model, material=mat, scale=norm, position=tuple(-center * norm + np.array([0, (hi - lo)[1] / 2 * norm, 0])))
    scene.add(mesh)
    scene.add(PlaneEntity(size=(30, 30), material=Diffuse(albedo=(0.45, 0.45, 0.45))))
    scene.add(AmbientLight(intensity=env))
    cam = PerspectiveCamera(field_of_view=45.0, position=(0, scale * 1.2, -scale * 3.2))
    cam.look_at((0, scale * 0.6, 0))
    scene.add(cam)
    return scene


def instanced_grid(side: int = 3, seed: int = 11) -> Scene:
    """A TLAS showcase: ONE two-sphere pack instanced side*side times with
    per-instance transforms and material swatches (reference
    Scenic/Hierarchies/PackInstance.cs + SwatchExtractor) — exercises the
    instance-leaf traversal path end-to-end."""
    from ..scene import EntityPack, PackInstance

    rs = np.random.RandomState(seed)
    base = Diffuse(albedo=(0.8, 0.8, 0.8))
    pack = EntityPack()
    pack.add(SphereEntity(radius=0.5, material=base))
    pack.add(SphereEntity(radius=0.22, material=Conductor(
        albedo=(0.9, 0.7, 0.3), roughness=0.15), position=(0, 0.75, 0)))

    scene = Scene()
    scene.add(PlaneEntity(size=(40, 40), material=Diffuse(albedo=(0.5, 0.5, 0.5))))
    for i in range(side):
        for j in range(side):
            c = rs.uniform(0.2, 0.95, 3)
            scene.add(PackInstance(
                pack,
                material_swatch={base: Diffuse(albedo=tuple(c))},
                position=(2.2 * (i - (side - 1) / 2), 0.5,
                          2.2 * (j - (side - 1) / 2)),
                scale=float(rs.uniform(0.7, 1.2)),
            ))
    scene.add(AmbientLight(intensity=(0.55, 0.6, 0.7)))
    cam = PerspectiveCamera(field_of_view=55.0, position=(0, 4.5, -8.5))
    cam.look_at((0, 0.4, 0))
    scene.add(cam)
    return scene


def sphere_grid_mesh(k: int, subdiv: int):
    """Indexed UV-sphere grid: k*k spheres, 2*subdiv^2 triangles each,
    at random heights and scales (RandomState(0))."""
    nu = nv = subdiv
    u = np.linspace(0, 2 * np.pi, nu + 1)
    v = np.linspace(0, np.pi, nv + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    pts = np.stack(
        [np.cos(uu) * np.sin(vv), np.cos(vv), np.sin(uu) * np.sin(vv)], -1
    ).reshape(-1, 3).astype(np.float32)
    idx = lambda i, j: i * (nv + 1) + j
    faces = []
    for i in range(nu):
        for j in range(nv):
            faces.append((idx(i, j), idx(i, j + 1), idx(i + 1, j + 1)))
            faces.append((idx(i, j), idx(i + 1, j + 1), idx(i + 1, j)))
    faces = np.asarray(faces, np.int32)
    rs = np.random.RandomState(0)
    all_v, all_f = [], []
    for gi in range(k):
        for gj in range(k):
            c = np.asarray([gi * 2.5, rs.uniform(0, 0.5) + 1.0, gj * 2.5], np.float32)
            s = rs.uniform(0.7, 1.1)
            all_f.append(faces + len(all_v) * len(pts))
            all_v.append(pts * s + c)
    return np.concatenate(all_v, 0), np.concatenate(all_f, 0)


def sphere_grid(n_tris: int) -> Scene:
    """A k x k grid of UV spheres near `n_tris` triangles, on a plane under
    an ambient light (benchmarks/scene_throughput.build_scene):
    sphere_grid(1_000_000) is a 59 x 59 grid at subdiv 12, 1,002,528
    triangles, bench.py's large-scene configuration."""
    best = None
    for subdiv in range(8, 40):
        per = 2 * subdiv * subdiv
        k = max(1, int(round(np.sqrt(n_tris / per))))
        err = abs(k * k * per - n_tris)
        if best is None or err < best[0]:
            best = (err, k, subdiv)
    _, k, subdiv = best
    verts, faces = sphere_grid_mesh(k, subdiv)
    scene = Scene()
    scene.add(MeshEntity(vertices=verts, faces=faces, material=Diffuse(albedo=(0.7, 0.6, 0.5))))
    extent = k * 2.5
    scene.add(PlaneEntity(size=(extent * 4, extent * 4), material=Diffuse(albedo=(0.4, 0.4, 0.4))))
    scene.add(AmbientLight(intensity=(0.5, 0.6, 0.8)))
    cam = PerspectiveCamera(
        field_of_view=50.0,
        position=(extent * 0.5, extent * 0.8, -extent * 0.6),
    )
    cam.look_at((extent * 0.5, 0.0, extent * 0.5))
    scene.add(cam)
    return scene


def instanced_sphere_grids() -> Scene:
    """benchmarks/instanced_tpu_check.py's scene: one pack holding
    sphere_grid_mesh(8, 31) (64 UV spheres, 123,008 triangles) placed 4
    times, at (0,0,0) s1.0, (25,0,0) s0.8, (0,0,25) s1.2 and (25,0,25) s0.9,
    rotated 17*i degrees about y; for a render, the ground plane and ambient
    light of sphere_grid's scene (benchmarks/scene_throughput.build_scene at
    k = 8) and a camera at (10, 10, -30) looking at the centre of the
    instances' world box. About 492k triangles unrolled."""
    from ..scene import EntityPack, PackInstance

    verts, faces = sphere_grid_mesh(8, 31)
    pack = EntityPack()
    pack.add(MeshEntity(vertices=verts, faces=faces, material=Diffuse(albedo=(0.7, 0.6, 0.5))))
    scene = Scene()
    lo, hi = np.full(3, np.inf), np.full(3, -np.inf)
    for i, (dx, dz, s) in enumerate([(0, 0, 1.0), (25, 0, 0.8), (0, 25, 1.2), (25, 25, 0.9)]):
        inst = PackInstance(pack, position=(dx, 0, dz), scale=s, rotation=(0, 17 * i, 0))
        scene.add(inst)
        m = inst.transform.matrix()
        world = verts @ m[:3, :3].T + m[:3, 3]
        lo, hi = np.minimum(lo, world.min(0)), np.maximum(hi, world.max(0))
    extent = 8 * 2.5
    scene.add(PlaneEntity(size=(extent * 4, extent * 4), material=Diffuse(albedo=(0.4, 0.4, 0.4))))
    scene.add(AmbientLight(intensity=(0.5, 0.6, 0.8)))
    cam = PerspectiveCamera(position=(10, 10, -30))
    cam.look_at(tuple(0.5 * (lo + hi)))
    scene.add(cam)
    return scene
