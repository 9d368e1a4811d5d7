"""sphere_grid: a k x k grid of UV spheres on a plane under an ambient light.

A frozen copy of `sphere_grid` and `sphere_grid_mesh` of
echorenderer_tpu_torch/models/scenes.py, as a `SceneSpec`: the same random
draws, in the same order."""

import numpy as np

from echobench.scenes import SceneSpec


def mesh(k: int, subdiv: int):
    """Indexed UV-sphere grid: k*k spheres, 2*subdiv^2 triangles each, at
    random heights and scales (RandomState(0))."""
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


def make(n_tris: int) -> SceneSpec:
    """The grid nearest `n_tris` triangles: make(1_000_000) is 59 x 59
    spheres at subdiv 12, 1,002,528 triangles."""
    best = None
    for subdiv in range(8, 40):
        per = 2 * subdiv * subdiv
        k = max(1, int(round(np.sqrt(n_tris / per))))
        err = abs(k * k * per - n_tris)
        if best is None or err < best[0]:
            best = (err, k, subdiv)
    _, k, subdiv = best
    verts, faces = mesh(k, subdiv)
    extent = k * 2.5
    spec = SceneSpec()
    spec.entity("MeshEntity", spec.material("Diffuse", albedo=(0.7, 0.6, 0.5)),
                vertices=verts, faces=faces)
    spec.entity("PlaneEntity", spec.material("Diffuse", albedo=(0.4, 0.4, 0.4)),
                size=(extent * 4, extent * 4), position=(0, 0, 0))
    spec.light("AmbientLight", intensity=(0.5, 0.6, 0.8))
    spec.camera = dict(kind="PerspectiveCamera", field_of_view=50.0,
                       position=(extent * 0.5, extent * 0.8, -extent * 0.6), lens_radius=0.0,
                       target=(extent * 0.5, 0.0, extent * 0.5))
    return spec
