"""PyTorch port: the image and mesh frontends (io/images.py, io/exr.py,
io/models.py) against the JAX package's, in one process.

- Every codec: the port's writer gives the JAX writer's bytes, each
  package reads the other's files bitwise, and the round trip holds
  (exactly for the float formats, within the format's quantization for PNG
  and RGBE), on images made from a seed under tmp_path; EXR in FLOAT and
  HALF, NONE and ZIP.
- `ImportGrid` on a PNG and an HDR file, and `hdr_environment(hdr_path=...)`
  on an EXR sky: the prepared tables equal the JAX package's; a lossless EXR
  of the procedural sky gives env tables bitwise equal to the procedural
  scene's.
- OBJ (+ .mtl, negative indices, quads), OBJ inside a zip, PLY ascii and
  binary little-endian: the port's loaded models equal JAX's; the binary
  PLY's one-read face path equals the row walk.
- `load_mesh_scene`: prepared tables equal JAX's.
"""

import struct
import zipfile

import numpy as np
import pytest
import torch

from echorenderer_tpu.io import exr as jexr
from echorenderer_tpu.io import images as jimages
from echorenderer_tpu.io import models as jmodels
from echorenderer_tpu.models import scenes as jscenes
from echorenderer_tpu.scene.prepare import prepare_scene as jprepare
from echorenderer_tpu_torch.io import exr as texr
from echorenderer_tpu_torch.io import images as timages
from echorenderer_tpu_torch.io import models as tmodels
from echorenderer_tpu_torch.models import scenes as tscenes
from echorenderer_tpu_torch.scene.convert import to_arrays
from echorenderer_tpu_torch.scene.prepare import prepare_scene as tprepare
from test_torch_prepare import _assert_tables_equal, flatten_jax

torch.set_num_threads(1)


def jprepare_numpy_bvh(scene):
    """The JAX package's prepare_scene on its numpy BVH builder, the oracle
    of its C++ one: that build (-march=native, FMA-contracted SAH sums)
    picks other splits on near-equal costs, while the port's C++ builder
    gives the numpy splits (as tests/test_torch_hier.py's grid_pair does)."""
    import echorenderer_tpu.native as jnative

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "build_bvh_native", lambda *args: None)
        return jprepare(scene)


def _image(seed, shape=(7, 10, 3), lo=0.0, hi=4.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(np.float32)


def _bits_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


# (extension, save kwargs, round-trip check)
CODECS = {
    "png": (".png", {}, "srgb8"),
    "fpi": (".fpi", {}, "exact"),
    "hdr": (".hdr", {}, "rgbe"),
    "pfm": (".pfm", {}, "exact"),
    "npy": (".npy", {}, "exact"),
    "exr": (".exr", {}, "exact"),
    "exr_zip": (".exr", {"compression": "zip"}, "exact"),
}


@pytest.mark.parametrize("codec", list(CODECS))
def test_codec_matches_jax(tmp_path, codec):
    ext, kw, check = CODECS[codec]
    img = _image(list(CODECS).index(codec), lo=0.0, hi=1.0 if check == "srgb8" else 40.0)
    if codec == "exr_zip":  # smooth rows: the compressed blocks are kept
        y, x = np.mgrid[0:37, 0:23].astype(np.float32)
        img = np.stack([y * 0.1, x * 0.2, (x + y) * 0.05], -1)
    mine, theirs = tmp_path / f"t{ext}", tmp_path / f"j{ext}"
    timages.save(mine, img, **kw)
    jimages.save(theirs, img, **kw)
    assert mine.read_bytes() == theirs.read_bytes()
    got = timages.load(mine)
    assert _bits_equal(got, jimages.load(mine))
    assert _bits_equal(timages.load(theirs), jimages.load(theirs))
    if check == "exact":
        assert _bits_equal(got, img)
    elif check == "srgb8":  # half an 8-bit sRGB step: at most 0.0045 linear (near 1)
        np.testing.assert_allclose(got, img, atol=0.0051)
    else:  # RGBE: one shared exponent, half a mantissa step after the centered decode
        bound = img.max(axis=-1, keepdims=True) / 256.0 + 1e-3
        assert (np.abs(got - img) <= bound).all()


def test_encode_png_and_rgba_exr_match_jax():
    rgba = _image(5, (5, 7, 4), 0.0, 2.0)
    assert timages.encode_png(rgba) == jimages.encode_png(rgba)
    assert timages.encode_png(rgba[..., 0], srgb=False) == jimages.encode_png(rgba[..., 0],
                                                                              srgb=False)


def _half_exr(path, img):
    """A HALF scanline EXR, NONE compression (the writers only write FLOAT)."""
    h, w, c = img.shape
    names = ["R", "G", "B", "A"][:c]
    header = (texr._attr("channels", "chlist", texr._channel_list(names, 1))
              + texr._attr("compression", "compression", b"\x00")
              + texr._attr("dataWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
              + texr._attr("displayWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
              + texr._attr("lineOrder", "lineOrder", b"\x00") + b"\x00")
    pre = struct.pack("<II", texr._MAGIC, 2)
    rows = img[::-1].astype("<f2")
    order = np.argsort(names)
    blocks, offsets = b"", []
    off = len(pre) + len(header) + 8 * h
    for y in range(h):
        data = b"".join(rows[y, :, ci].tobytes() for ci in order)
        offsets.append(off)
        blocks += struct.pack("<ii", y, len(data)) + data
        off += 8 + len(data)
    path.write_bytes(pre + header + struct.pack(f"<{h}Q", *offsets) + blocks)


def test_exr_half_reads_like_jax(tmp_path):
    img = _image(6, (6, 5, 4), 0.0, 8.0)
    p = tmp_path / "h.exr"
    _half_exr(p, img)
    got = texr.load_exr(p)
    assert _bits_equal(got, jexr.load_exr(p))
    assert _bits_equal(got, img.astype(np.float16).astype(np.float32))


def _ball_tables(albedo_path):
    """The material ball in an ImportGrid albedo, prepared by both packages."""
    from echorenderer_tpu.scene.materials import Diffuse as JDiffuse
    from echorenderer_tpu.textures import ImportGrid as JImportGrid
    from echorenderer_tpu_torch.scene import Diffuse
    from echorenderer_tpu_torch.textures import ImportGrid

    jscene = jprepare_numpy_bvh(jscenes.material_ball(material=JDiffuse(albedo=JImportGrid(albedo_path))))
    tscene = tprepare(tscenes.material_ball(material=Diffuse(albedo=ImportGrid(albedo_path))),
                      device="cpu")
    return to_arrays(tscene), flatten_jax(jscene), tscene


@pytest.mark.parametrize("ext", [".png", ".hdr"])
def test_import_grid_matches_jax(tmp_path, ext):
    from echorenderer_tpu.textures import ImportGrid as JImportGrid
    from echorenderer_tpu_torch.textures import ImportGrid

    path = tmp_path / f"wood{ext}"
    timages.save(path, _image(7, (12, 16, 3), 0.0, 1.0))
    assert _bits_equal(ImportGrid(path).data(), np.asarray(JImportGrid(path).data()))
    got, ref, tscene = _ball_tables(path)
    assert tscene.tex_atlas.shape[0] == 1
    _assert_tables_equal(got, ref)
    assert _bits_equal(got["tex_atlas"], ref["tex_atlas"])


def test_hdr_environment_from_exr_matches_jax_and_procedural(tmp_path):
    # the procedural sky written losslessly: the same env tables bitwise
    sky = next(e for e in tscenes.hdr_environment().children
               if getattr(e, "texture", None) is not None).texture.data()
    path = tmp_path / "sky.exr"
    timages.save(path, sky)
    from_file = to_arrays(tprepare(tscenes.hdr_environment(hdr_path=path), device="cpu"))
    procedural = to_arrays(tprepare(tscenes.hdr_environment(), device="cpu"))
    assert from_file.keys() == procedural.keys() and "env_maps.0.dist.conditional_cdf" in from_file
    for key in from_file:
        assert _bits_equal(from_file[key], procedural[key]), key
    # another sky from a seed: the port's tables against the JAX package's
    other = tmp_path / "other.exr"
    timages.save(other, _image(8, (16, 32, 3), 0.05, 30.0), compression="zip")
    ref = flatten_jax(jprepare_numpy_bvh(jscenes.hdr_environment(hdr_path=other)))
    _assert_tables_equal(to_arrays(tprepare(tscenes.hdr_environment(hdr_path=other),
                                            device="cpu")), ref)


OBJ_TEXT = """
# simple quad + tri with separate vt/vn indexing
mtllib test.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 2 0 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl glow
f 2/2/1 5/1/1 3/3/1
usemtl tex
f -5/4/1 -4/3/1 -3/2/1
"""

MTL_TEXT = """
newmtl red
Kd 0.8 0.1 0.1
Ns 250
newmtl glow
Kd 1 1 1
Ke 5 4 3
newmtl tex
Kd 1 1 1
map_Kd wood.png
newmtl glass
Kd 1 1 1
d 0.2
Ni 1.45
newmtl steel
Kd 0.05 0.05 0.05
Ks 0.9 0.9 0.9
Ns 600
"""


def _write_obj(tmp_path):
    (tmp_path / "test.obj").write_text(OBJ_TEXT)
    (tmp_path / "test.mtl").write_text(MTL_TEXT)
    timages.save(tmp_path / "wood.png", _image(9, (8, 8, 3), 0.0, 1.0))
    return tmp_path / "test.obj"


def _material_state(mat):
    """A material as comparable data: its class name and attributes, a
    texture by its class and pixels."""
    out = {"type": type(mat).__name__}
    for k, v in sorted(vars(mat).items()):
        if hasattr(v, "data") and callable(v.data):
            out[k] = (type(v).__name__, np.asarray(v.data()).tobytes())
        else:
            out[k] = np.asarray(v).tobytes() if isinstance(v, (np.ndarray, tuple)) else v
    return out


def _assert_models_equal(t, j):
    for name in ("vertices", "faces", "normals", "uvs", "face_materials"):
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert _bits_equal(a, b), name
    assert t.material_names == j.material_names
    assert [_material_state(m) for m in t.materials] == [_material_state(m) for m in j.materials]


def _ply_ascii() -> str:
    return (
        "ply\nformat ascii 1.0\n"
        "element vertex 4\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "element face 2\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
        "0 0 0 0 0 1\n1 0 0 0 0 1\n1 1 0 0 0 1\n0 1 0 0 0 1\n"
        "3 0 1 2\n4 0 1 2 3\n"
    )


def _ply_binary(rows, verts) -> bytes:
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\nproperty float u\n"
        "property float v\n"
        f"element face {len(rows)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    ).encode()
    body = bytearray(np.asarray(verts, "<f4").tobytes())
    for ids in rows:
        body += bytes([len(ids)]) + np.asarray(ids, "<i4").tobytes()
    return header + bytes(body)


def _model_files(tmp_path):
    obj = _write_obj(tmp_path)
    zp = tmp_path / "model.zip"
    with zipfile.ZipFile(zp, "w") as z:
        z.write(obj, "test.obj")
    (tmp_path / "neg.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    (tmp_path / "a.ply").write_text(_ply_ascii())
    rs = np.random.RandomState(10)
    verts = rs.uniform(-1, 1, (40, 5))
    (tmp_path / "tri.ply").write_bytes(_ply_binary(rs.randint(0, 40, (30, 3)).tolist(), verts))
    (tmp_path / "quad.ply").write_bytes(_ply_binary(rs.randint(0, 40, (20, 4)).tolist(), verts))
    mixed = [list(r) for r in rs.randint(0, 40, (9, 3))] + [list(rs.randint(0, 40, 5))]
    (tmp_path / "mixed.ply").write_bytes(_ply_binary(mixed, verts))
    return dict(obj=obj, zip=zp, neg=tmp_path / "neg.obj", ascii=tmp_path / "a.ply",
                tri=tmp_path / "tri.ply", quad=tmp_path / "quad.ply",
                mixed=tmp_path / "mixed.ply")


@pytest.mark.parametrize("case", ["obj", "zip", "neg", "ascii", "tri", "quad", "mixed"])
def test_models_match_jax(tmp_path, case):
    path = _model_files(tmp_path)[case]
    kw = {"load_materials": False} if case == "zip" else {}
    t, j = tmodels.load_model(path, **kw), jmodels.load_model(path, **kw)
    _assert_models_equal(t, j)
    if case == "obj":
        from echorenderer_tpu_torch.scene.materials import Diffuse, Emissive
        from echorenderer_tpu_torch.textures import ImportGrid

        assert t.faces.shape == (4, 3) and t.vertices.shape[0] == 8
        assert t.material_names == ["red", "glow", "tex"]
        assert [type(m) for m in t.materials] == [Diffuse, Emissive, Diffuse]
        assert isinstance(t.materials[2].albedo, ImportGrid)
        np.testing.assert_array_equal(t.face_materials, [0, 0, 1, 2])
    if case == "quad":  # two triangles a quad, in the row walk's order
        assert t.faces.shape == (40, 3)


def test_mtl_transparent_and_metal(tmp_path):
    from echorenderer_tpu_torch.scene.materials import Conductor, Dielectric

    lib = tmodels.parse_mtl(MTL_TEXT, tmp_path)
    jlib = jmodels.parse_mtl(MTL_TEXT, tmp_path)
    assert isinstance(lib["glass"], Dielectric) and lib["glass"].refractive_index == 1.45
    assert isinstance(lib["steel"], Conductor)
    assert {k: _material_state(v) for k, v in lib.items() if k != "tex"} == {
        k: _material_state(v) for k, v in jlib.items() if k != "tex"}


def test_mesh_entity_per_face_materials(tmp_path):
    """A multi-material OBJ through prepare_scene: the emissive face
    registers as a light, and the tables equal the JAX package's."""
    from echorenderer_tpu.scene import MeshEntity as JMesh
    from echorenderer_tpu.scene import PerspectiveCamera as JCam
    from echorenderer_tpu.scene import Scene as JScene
    from echorenderer_tpu_torch.scene import MeshEntity, PerspectiveCamera, Scene

    obj = _write_obj(tmp_path)
    scene, jscene = Scene(), JScene()
    scene.add(MeshEntity(source=tmodels.load_model(obj)))
    scene.add(PerspectiveCamera(position=(0, 0, -3)))
    jscene.add(JMesh(source=jmodels.load_model(obj)))
    jscene.add(JCam(position=(0, 0, -3)))
    prepared = tprepare(scene, device="cpu")
    assert prepared.geometry.num_triangles == 4
    assert int(prepared.lights.emissive_prim.shape[0]) == 1
    _assert_tables_equal(to_arrays(prepared), flatten_jax(jprepare_numpy_bvh(jscene)))


def test_load_mesh_scene_matches_jax(tmp_path):
    """The random quads' PLY on the ground plane: equal tables, the JAX
    side's zero-area triangles (faces repeating a vertex) with their edges
    zeroed, as the port packs them (tests/test_torch_hier.py's
    _zero_area_edges_zeroed, on the prim rows alone: no chunk tree here)."""
    path = _model_files(tmp_path)["quad"]
    got = to_arrays(tprepare(tscenes.load_mesh_scene(path), device="cpu"))
    ref = flatten_jax(jprepare_numpy_bvh(jscenes.load_mesh_scene(path)))
    rows = np.concatenate([ref[f"prim_soa.{k}"] for k in
                           ("bx", "by", "bz", "cx", "cy", "cz", "is_sphere")], 0)
    flat = (rows[6] < 0.5) & (np.cross(rows[0:3].T, rows[3:6].T) == 0.0).all(-1)
    assert flat.any()  # the random faces repeat vertices
    for k in ("bx", "by", "bz", "cx", "cy", "cz"):
        ref[f"prim_soa.{k}"] = np.where(flat[None], np.float32(0.0), ref[f"prim_soa.{k}"])
    _assert_tables_equal(got, ref)
