"""The fused path-tracing megakernel (counterpart of
echorenderer_tpu/ops/megakernel.py).

`sample_frame_mega` has the contract of `evaluation.wavefront.
sample_frame_wavefront`: per-lane (sum, sum²) of `count` path samples. On
a CUDA scene it launches the hand-written kernel of csrc/megakernel.cu,
which runs the whole regenerating path loop (camera spawn, trace,
shading, NEE with a shadow ray, MIS, Russian roulette) over a block-
resident pool of paths, stage by stage; on a CPU scene it runs
`sample_frame_mega_plain`, which is the port's wavefront itself: the one
physics function `path_step` stays the reference the kernel is held to.

The kernel replaces the TPU's `_mega_kernel`
(echorenderer_tpu/ops/megakernel.py:1101), texture stage included. Its
envelope is the JAX package's: at most MEGA_PRIM_LIMIT padded prims, a
light tree no deeper than MEGA_TREE_DEPTH, no env map, at most
MEGA_TEX_LIMIT atlas textures, a perspective camera, at most
MEGA_LIGHT_LIMIT light records and emitters, and no TLAS instancing (an
instanced scene has no `prim_soa`). `_build_tables` packs the scene into
the JAX kernel's table layouts, value for value; the launch hands them to
the kernel transposed, one row per prim / material / light. A textured
scene adds the JAX kernel's uv rows and texture-id rows, and the atlas
itself as the texel table (the JAX kernel's channel-major (3R, A*R) bf16
layout exists for the TPU's one-hot matrix fetch; a gather reads
(A, R, R, 4)); the launch then takes the kernel's textured form.

`hier=True` runs the kernel's chunk-tree form, the TPU kernel's fat-chunk
variant (`_hier_walk`, echorenderer_tpu/ops/megakernel.py:909): every ray
walks the scene's chunk tree (`hier_soa`) instead of testing every prim,
so a scene of any size fits. Its envelope is the JAX package's
`supported_hier`: chunk-tree tables, no instancing, no textures, no env
map, the same light, tree and camera limits. The shading table is built
in the tree's sorted slots (the JAX kernel's fat-chunk rows 16-32, without
the chunks); hits, ignores and emitters' prim ids are those slots. Its
plain version is the wavefront with every wave on the chunk-tree walk
(`scene_ops.walk_only`). The render path takes it only behind the JAX
package's gate, `ECHO_MEGA_HIER` (`scene_ops._use_mega_hier`).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..scene.cameras import PERSPECTIVE
from ..scene.prepare import LIGHT_AMBIENT, LIGHT_DIRECTIONAL, LIGHT_POINT
from ..utils.rng import as_u32
from . import cuda_build
from .pallas_hier import check_tables
from .pallas_intersect import PRIM_BLOCK

MEGA_PRIM_LIMIT = 2048  # padded prims: 10 rows of them fit a block's shared memory
MEGA_LIGHT_LIMIT = 512
MEGA_TREE_DEPTH = 24  # the leaf-path bitmask stays exact in an f32 table
# atlas textures, as in the JAX package, whose kernel read the whole texel
# table per fetch through a one-hot matrix product; a gather's cost does not
# grow with the count, but the envelope is kept so both packages dispatch alike
MEGA_TEX_LIMIT = 4

# packed shade rows (sorted prim order): 0:3 geo normal / sphere center,
# 3:6 n0 (3 = radius), 6:9 n1, 9:12 n2, 12 material, 13 area, 14 is_sphere,
# 15 light record (-1), 16 light power; textured scenes add 17:23 uv0 uv1 uv2
SP_ROWS = 17
SP_TEX_ROWS = 6
# material rows: 0:3 albedo, 3:7 params, 7:10 extra, 10 type, 11 one_sided;
# textured scenes add 12 albedo texture, 13 normal map, 14 its intensity,
# 15 roughness texture (ids -1 where none)
MT_ROWS = 12
MT_TEX_ROWS = 4
# light records: 0 kind, 1 cdf, 2 power, 3:6 pos/dir, 6:9 intensity,
# 9 emissive index, 10 w_inf, 11 cdf over w_inf (pad 2.0), 12 tree light id
LT_ROWS = 13
# emitters: 0:3 v0/center, 3:6 e1 (3 = radius), 6:9 e2, 9:12 normal,
# 12:15 emitted, 15 area, 16 is_sphere, 17 sorted prim id
EP_ROWS = 18
TREE_ROWS = 24  # both packed children of a light-tree node
TL_ROWS = 3  # tree light: record, path bitmask, leaf depth

# camera/scalar row
C_POS, C_ROT, C_FL, C_LENS, C_FOCAL = 0, 3, 12, 13, 14
C_AMB_ALL, C_AMB_CAM, C_AMB_PMF, C_TOTAL_POWER = 16, 19, 22, 23
C_P_INF, C_SUM_INF = 24, 25
C_LEN = 26


def unsupported_reason(scene) -> str | None:
    """Why the megakernel does not take `scene` (None when it does)."""
    tree = scene.lights.tree
    if scene.prim_soa is None:  # pack-space geometry: only the instanced walks trace it
        return "TLAS instancing"
    if scene.prim_soa.padded > MEGA_PRIM_LIMIT:
        return f"prims > {MEGA_PRIM_LIMIT}"
    if tree is not None and tree.max_depth > MEGA_TREE_DEPTH:
        return f"light tree deeper than {MEGA_TREE_DEPTH}"
    if scene.env_maps:
        return "environment map (importance sampling is wavefront-only)"
    if scene.tex_atlas.shape[0] > MEGA_TEX_LIMIT:
        return f"more than {MEGA_TEX_LIMIT} textures (one-hot fetch cost)"
    if scene.camera.kind != PERSPECTIVE:
        return "non-perspective camera"
    if (scene.lights.num_lights > MEGA_LIGHT_LIMIT
            or scene.emissive_pack.shape[0] > MEGA_LIGHT_LIMIT):
        return f"more than {MEGA_LIGHT_LIMIT} lights"
    return None


def supported(scene) -> bool:
    """Whether the scene lies inside the megakernel's envelope."""
    return unsupported_reason(scene) is None


def unsupported_hier_reason(scene) -> str | None:
    """Why the chunk-tree form does not take `scene` (None when it does):
    the JAX package's `supported_hier`, a reason for each refusal."""
    tree = scene.lights.tree
    soa = scene.hier_soa
    if soa is None:
        return "no chunk-tree tables"
    if soa.instanced or scene.instances is not None:
        return "TLAS instancing"
    if tree is not None and tree.max_depth > MEGA_TREE_DEPTH:
        return f"light tree deeper than {MEGA_TREE_DEPTH}"
    if scene.env_maps:
        return "environment map (importance sampling is wavefront-only)"
    if scene.tex_atlas.shape[0]:
        return "textures (the chunk-tree form has no texture stage)"
    if scene.camera.kind != PERSPECTIVE:
        return "non-perspective camera"
    if (scene.lights.num_lights > MEGA_LIGHT_LIMIT
            or scene.emissive_pack.shape[0] > MEGA_LIGHT_LIMIT):
        return f"more than {MEGA_LIGHT_LIMIT} lights"
    return None


def supported_hier(scene) -> bool:
    """Whether the scene lies inside the chunk-tree form's envelope."""
    return unsupported_hier_reason(scene) is None


def _pad8(n: int) -> int:
    return -(-max(n, 1) // 8) * 8


def _pad_cols(t, width, fill=0.0):
    if t.shape[-1] == width:
        return t
    pad = torch.full(t.shape[:-1] + (width - t.shape[-1],), fill, dtype=t.dtype, device=t.device)
    return torch.cat([t, pad], dim=-1)


def _build_tables(scene, hier: bool = False):
    """The kernel's tables in the JAX kernel's (rows, columns) layouts:
    (spT, matT, lightT, epackT, treeT, tlT, texT, cam_row), tree tables
    None without a light tree; texT is the (A, R, R, 4) atlas of a textured
    scene, else None. `hier`: shading rows and emitters' prim ids in the
    chunk tree's sorted slots, spT padded to its chunks (the JAX kernel's
    fat-chunk rows 16-32, slot by slot)."""
    f32 = torch.float32
    soa = scene.hier_soa if hier else scene.prim_soa
    p_pad = soa.padded
    order = soa.order.long()

    def permpad(col, fill=0.0):
        return _pad_cols(col.to(f32)[order], p_pad, fill)

    sp = scene.shade_pack
    lt = scene.lights
    rows = [permpad(sp[:, i]) for i in list(range(12)) + [18, 19, 20]]
    rows.append(permpad(lt.prim_light, -1.0))
    prim_power = torch.where(lt.prim_light >= 0, lt.power[torch.clamp(lt.prim_light, min=0).long()],
                             0.0)
    rows.append(permpad(prim_power))
    tex_on = scene.tex_atlas.shape[0] > 0
    if tex_on:  # uv0, uv1, uv2 for the kernel's barycentric texture coordinates
        rows += [permpad(sp[:, i]) for i in range(12, 18)]
    spT = torch.stack(rows, 0)

    mp = scene.mat_pack
    cols = [mp[:, 0:11], mp[:, 12:13]]
    if tex_on:  # albedo texture, normal map, its intensity, roughness texture
        cols += [mp[:, 11:12], mp[:, 13:16]]
    matT = _pad_cols(torch.cat(cols, dim=1).T, _pad8(mp.shape[0]))
    texT = scene.tex_atlas.contiguous() if tex_on else None

    n_lights = lt.num_lights
    kind = lt.kind.to(f32)
    posdir = torch.zeros((n_lights, 3), dtype=f32, device=sp.device)
    inten = torch.zeros_like(posdir)
    idx = lt.index.long()
    for code, pos_t, int_t in ((LIGHT_POINT, lt.point_pos, lt.point_intensity),
                               (LIGHT_DIRECTIONAL, lt.dir_dir, lt.dir_intensity)):
        if pos_t.shape[0]:
            sel = (lt.kind == code)[:, None]
            ci = torch.clamp(idx, 0, pos_t.shape[0] - 1)
            posdir = torch.where(sel, pos_t[ci], posdir)
            inten = torch.where(sel, int_t[ci], inten)
    inf_mask = (lt.kind == LIGHT_DIRECTIONAL) | (lt.kind == LIGHT_AMBIENT)
    w_inf = torch.where(inf_mask, lt.power, 0.0)
    sum_inf = torch.clamp(torch.sum(w_inf), min=1e-20)
    cdf_inf = torch.cumsum(w_inf, 0) / sum_inf
    light_rows = torch.stack(
        [kind, lt.cdf, lt.power, posdir[:, 0], posdir[:, 1], posdir[:, 2],
         inten[:, 0], inten[:, 1], inten[:, 2], idx.to(f32), w_inf, cdf_inf,
         lt.record_tree.to(f32)], 0)
    pad_vals = torch.zeros((LT_ROWS, 1), dtype=f32, device=sp.device)
    pad_vals[1] = pad_vals[11] = 2.0  # padded records are never picked
    pad_vals[12] = -1.0
    l_pad = _pad8(n_lights)
    lightT = torch.cat([light_rows, pad_vals.expand(LT_ROWS, l_pad - n_lights)], dim=1)

    tree = lt.tree
    if tree is not None:
        treeT = _pad_cols(tree.nodes.to(f32).T, _pad8(tree.nodes.shape[0]))
        tlT = _pad_cols(torch.stack([lt.tree_records.to(f32), tree.light_path.to(f32),
                                     tree.light_depth.to(f32)], 0),
                        _pad8(lt.tree_records.shape[0]))
    else:
        treeT = tlT = None

    ep = scene.emissive_pack
    n_e = ep.shape[0]
    e_pad = _pad8(n_e)
    if n_e:
        eprim = lt.emissive_prim.long()
        sprim = soa.inv_order.long()[eprim] if hier or p_pad > PRIM_BLOCK else eprim
        epackT = _pad_cols(torch.cat([ep[:, 0:17].T, sprim.to(f32)[None, :]], 0), e_pad)
    else:
        epackT = torch.zeros((EP_ROWS, e_pad), dtype=f32, device=sp.device)
        epackT[15] = 1.0

    cam = scene.camera
    total = torch.sum(lt.power)
    total_c = torch.clamp(total, min=1e-20)
    amb_pmf = torch.sum(torch.where(lt.kind == LIGHT_AMBIENT, lt.power, 0.0)) / total_c
    cam_row = torch.zeros(C_LEN, dtype=f32, device=sp.device)
    cam_row[C_POS:C_POS + 3] = cam.position
    cam_row[C_ROT:C_ROT + 9] = cam.rotation.reshape(-1)
    cam_row[C_FL] = cam.forward_length
    cam_row[C_LENS] = cam.lens_radius
    cam_row[C_FOCAL] = cam.focal_distance
    cam_row[C_AMB_ALL:C_AMB_ALL + 3] = lt.ambient_all
    cam_row[C_AMB_CAM:C_AMB_CAM + 3] = lt.ambient_camera
    cam_row[C_AMB_PMF] = amb_pmf
    cam_row[C_TOTAL_POWER] = total_c
    cam_row[C_P_INF] = torch.sum(w_inf) / total_c
    cam_row[C_SUM_INF] = sum_inf
    return spT, matT, lightT, epackT, treeT, tlT, texT, cam_row


def sample_frame_mega_plain(scene, pixel_id, pixel_xy, resolution, seed, sample_start,
                            count: int, *, bounce_limit: int = 128,
                            survivability: float = 2.5, hier: bool = False,
                            k_slots: int | None = None):
    """The plain PyTorch version: the port's wavefront on the same lanes
    (NEE and MIS on, no stats); with `hier`, every wave of it on the
    chunk-tree walk. `k_slots` changes no sum and is ignored."""
    from ..evaluation.scene_ops import walk_only
    from ..evaluation.wavefront import run_wavefront

    with walk_only() if hier else contextlib.nullcontext():
        return run_wavefront(scene, pixel_id, pixel_xy, resolution, seed, sample_start, count,
                             bounce_limit=bounce_limit, survivability=survivability)


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load("megakernel")
        lib.megakernel.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                                   ctypes.c_void_p]
        lib.megakernel.restype = ctypes.c_int
        lib.megakernel_hier.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.megakernel_hier.restype = ctypes.c_int
        lib.megakernel_hier_occupancy.argtypes = [ctypes.c_void_p]
        lib.megakernel_hier_occupancy.restype = ctypes.c_int
        lib.megakernel_occupancy.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.megakernel_occupancy.restype = ctypes.c_int
        _lib = lib
    return _lib


def occupancy(textured: bool, padded: int) -> dict:
    """The untextured or textured form's resident blocks per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) at `padded` prims, its
    block size (the pool's paths a block), dynamic shared memory per block,
    the card's SMs, its resident warps per SM and the paths the card holds
    at once."""
    key = (_load(), bool(textured), int(padded))
    if key not in _OCCUPANCY:
        out = (ctypes.c_int * 4)()
        err = _load().megakernel_occupancy(int(textured), int(padded), out)
        if err:
            raise RuntimeError(f"megakernel_occupancy failed: cudaError {err}")
        _OCCUPANCY[key] = dict(blocks=out[0], block=out[1], smem=out[2], sms=out[3],
                               warps=out[0] * out[1] // 32, paths=out[0] * out[1] * out[3])
    return _OCCUPANCY[key]


_OCCUPANCY: dict = {}  # by (library, textured, padded)


def hier_occupancy() -> dict:
    """The chunk-tree form's resident blocks per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), its block size,
    dynamic shared memory per block and resident warps per SM."""
    out = (ctypes.c_int * 3)()
    err = _load().megakernel_hier_occupancy(out)
    if err:
        raise RuntimeError(f"megakernel_hier_occupancy failed: cudaError {err}")
    return dict(blocks=out[0], block=out[1], smem=out[2], warps=out[0] * out[1] // 32)


def _present_mask(present) -> int:
    return sum(1 << int(t) for t in present)


class KernelArgs(NamedTuple):
    tensors: list  # every tensor the pointers refer to (kept alive by the caller)
    ptrs: list  # prims sp mat light epack tree tl cam pid pxy s0 s_sum s_sq atlas
    ints: list  # n n_lanes k count bounce width height seed padded has_tri
    #             has_sph present n_lights n_emissive tree_depth n_tex tex_res
    #             has_ntex has_rtex
    s_sum: torch.Tensor
    s_sq: torch.Tensor
    hier_ptrs: list | None = None  # the chunk-tree form: chunks, node bounds, node codes


def _kernel_args(scene, pixel_id, pixel_xy, resolution, seed, sample_start, count,
                 bounce_limit, k_slots, hier: bool = False) -> KernelArgs:
    """Tables, lanes, outputs and integer settings of one launch, in the
    order of the C interface of csrc/megakernel.cu; `hier` for its
    chunk-tree form (no prim rows: ptrs[0] is 0)."""
    dev = scene.device
    n = int(pixel_id.shape[0])
    k = 1 if k_slots is None else int(k_slots)
    if k < 1:
        raise ValueError("k_slots must be >= 1")
    n_lanes = -(-n // k)
    if 3 * n >= 2 ** 31 or not 0 <= count < 2 ** 31:
        raise ValueError(f"{n} lanes of {count} samples: outside the kernel's int32 range")

    def i32(x):  # 32-bit words as int32 bit patterns
        w = as_u32(x, dev).to(dev)
        return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)

    pid = i32(pixel_id).expand(n).contiguous()
    pxy = pixel_xy.to(device=dev, dtype=torch.int32).contiguous()
    s0 = i32(sample_start).expand(n).contiguous()
    if pxy.shape != (n, 2):
        raise ValueError(f"pixel_xy must be ({n}, 2), got {tuple(pxy.shape)}")
    soa = scene.hier_soa if hier else scene.prim_soa
    if hier:
        check_tables(soa)
    spT, matT, lightT, epackT, treeT, tlT, texT, cam_row = _build_tables(scene, hier)
    tables = [None if hier else soa.rows.contiguous()] + [
        None if t is None else t.T.contiguous() for t in (spT, matT, lightT, epackT, treeT, tlT)
    ] + [cam_row]
    s_sum = torch.empty((n, 3), dtype=torch.float32, device=dev)
    s_sq = torch.empty_like(s_sum)
    lt = scene.lights
    tree = lt.tree
    if texT is not None and (texT.dtype != torch.float32 or texT.dim() != 4
                             or texT.shape[1] != texT.shape[2] or texT.shape[3] != 4):
        raise ValueError(f"the atlas must be (A, R, R, 4) float32, got {tuple(texT.shape)} "
                         f"{texT.dtype}")
    tensors = tables + [pid, pxy, s0, s_sum, s_sq, texT]
    ptrs = [0 if t is None else t.data_ptr() for t in tensors]
    flags = scene.materials.tex_flags
    width, height = resolution
    ints = [
        n, n_lanes, k, int(count), int(bounce_limit), int(width), int(height),
        int(np.uint32(int(seed) & 0xFFFFFFFF).view(np.int32)),
        soa.padded, int(soa.num_tris > 0), int(soa.num_prims > soa.num_tris),
        _present_mask(scene.materials.present), lt.num_lights,
        int(scene.emissive_pack.shape[0]), 0 if tree is None else int(tree.max_depth),
        0 if texT is None else int(texT.shape[0]), 0 if texT is None else int(texT.shape[1]),
        int(texT is not None and flags[1]), int(texT is not None and flags[2]),
    ]
    hier_ptrs = [soa.prim_chunks.data_ptr(), soa.bounds.data_ptr(),
                 soa.codes.data_ptr()] if hier else None
    return KernelArgs(tensors, ptrs, ints, s_sum, s_sq, hier_ptrs)


def sample_frame_mega(scene, pixel_id, pixel_xy, resolution, seed, sample_start, count: int,
                      *, bounce_limit: int = 128, survivability: float = 2.5,
                      hier: bool = False, k_slots: int | None = None):
    """Accumulate `count` path samples for each of the N lanes (pixel ids
    (N,), pixel coordinates (N, 2), first sample index scalar or (N,),
    wrapping as a 32-bit word). Returns (sum, sum_sq), each (N, 3).

    `k_slots`: pixels each lane serves one after the other (slot j of
    lane L is pixel j * ceil(N / K) + L); a pool entry takes a lane and
    keeps it until its slots are done (the chunk-tree form: a thread a
    lane). None means 1: the pool's work counter balances the tail that K
    slots averaged on the TPU. Per-pixel sums are bitwise the same for
    every K, and in the split form (fewer pixels than the card holds paths,
    count >= 2) K is not used.

    `hier`: the kernel's chunk-tree form (the JAX package's fat-chunk
    variant), for scenes inside `supported_hier`.

    A CPU scene runs the plain version; a CUDA scene launches the kernel
    or raises."""
    dev = scene.device
    if dev.type == "cpu":
        return sample_frame_mega_plain(scene, pixel_id, pixel_xy, resolution, seed,
                                       sample_start, count, bounce_limit=bounce_limit,
                                       survivability=survivability, hier=hier)
    if dev.type != "cuda":
        raise ValueError(f"sample_frame_mega runs on CUDA or CPU scenes, not {dev}")
    reason = unsupported_hier_reason(scene) if hier else unsupported_reason(scene)
    if reason is not None:
        form = "chunk-tree form's" if hier else "megakernel's"
        raise ValueError(f"scene outside the {form} envelope: {reason}")
    launch = _prepare_launch(scene, pixel_id, pixel_xy, resolution, seed, sample_start, count,
                             bounce_limit, k_slots, hier)
    s_sum, s_sq = launch.args.s_sum, launch.args.s_sq
    if s_sum.shape[0] == 0:
        return s_sum, s_sq
    err = _run_launch(scene, launch, survivability)
    if err:
        raise RuntimeError(f"megakernel launch failed: cudaError {err}")
    if hier:
        sample_frame_mega.launches_hier += 1
    elif launch.args.ints[15]:  # atlas textures: the textured form ran
        sample_frame_mega.launches_textured += 1
    else:
        sample_frame_mega.launches += 1
    return s_sum, s_sq


def split_form(scene, n: int, count: int, hier: bool = False) -> bool:
    """Whether a launch of `n` pixels at `count` samples takes the split
    form: (pixel, sample) paths into a per-sample buffer, then each pixel's
    samples summed in order. It does where the untextured or textured form
    has fewer pixels than the card holds paths at once (the occupancy
    query) and at least two samples a pixel."""
    if hier or count < 2 or n == 0:
        return False
    occ = occupancy(scene.tex_atlas.shape[0] > 0, scene.prim_soa.padded)
    return n < occ["paths"] and n * count + occ["paths"] < 2 ** 31


class _Launch(NamedTuple):
    args: KernelArgs
    keep: list  # the work counter and the split form's buffer, alive as long as the launch
    c_ptrs: object  # ptrs, then the work counter and the split form's buffer (or 0)
    c_ints: object
    hier: bool


def _prepare_launch(scene, pixel_id, pixel_xy, resolution, seed, sample_start, count,
                    bounce_limit, k_slots, hier: bool = False) -> _Launch:
    """Everything `sample_frame_mega` hands the C entry, on a CUDA scene
    (tools/hier_ab.py times the C entry alone through this and
    `_run_launch`)."""
    args = _kernel_args(scene, pixel_id, pixel_xy, resolution, seed, sample_start, count,
                        bounce_limit, k_slots, hier)
    dev, n, ints = scene.device, args.s_sum.shape[0], args.ints
    work = torch.empty(1, dtype=torch.int32, device=dev)  # the pool's work counter
    samples = (torch.empty((n, count, 3), dtype=torch.float32, device=dev)
               if split_form(scene, n, count, hier) else None)
    ptrs = args.ptrs + [work.data_ptr(), 0 if samples is None else samples.data_ptr()]
    return _Launch(args, [work, samples], (ctypes.c_void_p * len(ptrs))(*ptrs),
                   (ctypes.c_int * len(ints))(*ints), hier)


def _run_launch(scene, launch: _Launch, survivability: float) -> int:
    """Launch a prepared megakernel call on the current stream; returns the
    C entry's CUDA error."""
    stream = torch.cuda.current_stream(scene.device).cuda_stream
    if launch.hier:
        c_hier = (ctypes.c_void_p * 3)(*launch.args.hier_ptrs)
        return _load().megakernel_hier(launch.c_ptrs, launch.c_ints, c_hier,
                                       scene.hier_soa.root_code, float(survivability), stream)
    return _load().megakernel(launch.c_ptrs, launch.c_ints, float(survivability), stream)


# launches of the kernel: the untextured, the textured and the chunk-tree form
sample_frame_mega.launches = sample_frame_mega.launches_textured = 0
sample_frame_mega.launches_hier = 0
