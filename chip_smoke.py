#!/usr/bin/env python3
"""Smoke run of the PyTorch port (echorenderer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions. No CUDA device: exit 1.
  2. build: nvcc builds csrc/dense_intersect.cu for sm_90a.
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card, on the sphere_field(80) tables and on a ~42k-prim BVH-ordered
     scene of 329 chunks, 2^20 rays each: identical prim ids and blocked
     flags, t/u/v to rtol 1e-6; median times over 10 runs after a warm-up.
  4. golden: the cornell and spheres goldens rendered on the card through
     the kernels, held to tests/test_golden.py's tolerances.
  5. slice: the main path, counters zeroed first: entry() (Cornell box,
     128x128, 8 spp) and the bench scene sphere_field(80) at 960x540,
     8 spp, bounce limit 16, through render_layer; Mspps, wavefront
     iterations and peak memory.
  6. summary: a JSON line of the kernels, then the last line
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
N_RAYS = 2 ** 20
RTOL = 1e-6
TRACE_SITE = "echorenderer_tpu/ops/pallas_intersect.py:322"
OCCLUDE_SITE = "echorenderer_tpu/ops/pallas_intersect.py:400"
SOURCE = "echorenderer_tpu_torch/csrc/dense_intersect.cu"


def log(*args):
    print(*args, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def median_ms(fn, runs: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_rays(rs, n, lo, hi, num_prims):
    """Bounce-like rays: origins in the box [lo, hi], random directions; a
    quarter ignore a random prim, half stop at a finite t_max, 1/16 dead."""
    import numpy as np

    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ignore = np.where(rs.uniform(size=n) < 0.25, rs.randint(0, num_prims, n), -1)
    t_max = np.where(rs.uniform(size=n) < 0.5, np.inf, rs.uniform(0.5, 30.0, n))
    t_max[rs.uniform(size=n) < 1 / 16] = rs.choice([0.0, -1.0])
    return o, d, t_max.astype(np.float32), ignore.astype(np.int32)


def camera_rays(width, height, eye):
    """Tile-major pinhole rays (the main path's camera wave layout)."""
    import numpy as np

    from echorenderer_tpu_torch.processes.tiles import lane_order

    perm, _ = lane_order((width, height))
    px = (perm % width).astype(np.float32) + 0.5
    py = (perm // width).astype(np.float32) + 0.5
    d = np.stack([(px / width - 0.5) * 1.6, (py / height - 0.5) * 0.8,
                  np.ones_like(px)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.asarray(eye, np.float32), d.shape).copy()
    return o, d, np.full(len(d), np.inf, np.float32), np.full(len(d), -1, np.int32)


def synthetic_scene(rs):
    """~40k small triangles and 2k spheres scattered in a 40x10x40 box."""
    import numpy as np

    t, s = 40_000, 2_000
    z3 = np.zeros((t, 3), np.float32)
    z2 = np.zeros((t, 2), np.float32)
    return dict(
        tri_v0=(rs.uniform(-20, 20, (t, 3)) * [1, 0.25, 1] + [0, 5, 0]).astype(np.float32),
        tri_e1=rs.uniform(-0.6, 0.6, (t, 3)).astype(np.float32),
        tri_e2=rs.uniform(-0.6, 0.6, (t, 3)).astype(np.float32),
        tri_n0=z3, tri_n1=z3, tri_n2=z3, tri_uv0=z2, tri_uv1=z2, tri_uv2=z2,
        tri_mat=np.zeros(t, np.int32),
        sph_center=(rs.uniform(-20, 20, (s, 3)) * [1, 0.25, 1] + [0, 5, 0]).astype(np.float32),
        sph_radius=rs.uniform(0.1, 0.5, s).astype(np.float32),
        sph_mat=np.zeros(s, np.int32),
    )


def compare_kernels(label, soa, rays_np, dev):
    """Kernel against plain version on one scene: returns ({kernel:
    max_abs_err}, {timing: median ms})."""
    import numpy as np
    import torch

    from echorenderer_tpu_torch.ops import pallas_intersect as pi

    o, d, t_max, ignore = (torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in rays_np)
    rays = pi.ray_columns(o, d, t_max)
    ig = pi._sorted_ignore(soa, ignore)
    kt = pi.dense_trace(rays, ig, soa)
    pt = pi.dense_trace_plain(rays, ig, soa)
    kb = pi.dense_occlude(rays, ig, soa)
    pb = pi.dense_occlude_plain(rays, ig, soa)
    torch.cuda.synchronize()
    n_hit = int((pt[1] >= 0).sum())
    if not torch.equal(kt[1], pt[1]):
        bad = int((kt[1] != pt[1]).sum())
        raise AssertionError(f"{label}: dense_trace prim ids differ on {bad} of {len(pt[1])} rays")
    if not torch.equal(kb, pb):
        bad = int((kb != pb).sum())
        raise AssertionError(f"{label}: dense_occlude flags differ on {bad} rays")
    hit = pt[1] >= 0
    err = dict(trace=0.0, occlude=float((kb.int() - pb.int()).abs().max()))
    for name, k, p in (("t", kt[0][hit], pt[0][hit]), ("u", kt[2], pt[2]), ("v", kt[3], pt[3])):
        torch.testing.assert_close(k, p, rtol=RTOL, atol=0.0, msg=lambda m: f"{label} {name}: {m}")
        err["trace"] = max(err["trace"], float((k - p).abs().max()) if k.numel() else 0.0)
    ms = dict(
        trace=median_ms(lambda: pi.dense_trace(rays, ig, soa)),
        trace_plain=median_ms(lambda: pi.dense_trace_plain(rays, ig, soa)),
        occlude=median_ms(lambda: pi.dense_occlude(rays, ig, soa)),
        occlude_plain=median_ms(lambda: pi.dense_occlude_plain(rays, ig, soa)),
    )
    log(f"[kernels] {label}: {rays.shape[1]} rays, {soa.padded} padded prims, "
        f"{soa.n_chunks} chunks, {soa.n_super} superchunks; {n_hit} hits, "
        f"{int(pb.sum())} blocked; identical ids/flags, max |t,u,v err| {err['trace']:.3g} "
        f"(rtol {RTOL})")
    log(f"[kernels] {label}: median ms over 10 runs: "
        + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    return err, ms


def golden_phase(dev):
    import numpy as np

    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.ops import pallas_intersect as pi
    from echorenderer_tpu_torch.processes.render import _sample_frame
    from echorenderer_tpu_torch.scene.prepare import prepare_scene

    cfg = {  # as tests/test_golden.py configures them
        "cornell": (scenes.cornell_box, (32, 24), 8, 4),
        "spheres": (lambda: scenes.sphere_field(80), (32, 18), 4, 6),
    }
    for name, (maker, res, spp, bounce) in cfg.items():
        before = (pi.dense_trace.launches, pi.dense_occlude.launches)
        s_sum, _ = _sample_frame(prepare_scene(maker(), device=dev), "path", res, 0, 0, spp,
                                 bounce, 2.5)
        img = (s_sum.cpu().numpy() / spp).reshape(res[1], res[0], 3)
        ref = np.load(REPO / "tests" / "golden" / f"{name}.npy")
        diff = np.abs(img - ref).mean()
        mean_diff = abs(img.mean() - ref.mean())
        grew = (pi.dense_trace.launches - before[0], pi.dense_occlude.launches - before[1])
        log(f"[golden] {name}: mean |diff| {diff:.3g} (< 5e-3), |mean diff| {mean_diff:.3g} "
            f"(< 2e-3), kernel launches trace {grew[0]} occlude {grew[1]}")
        if not (diff < 5e-3 and mean_diff < 2e-3):
            raise AssertionError(f"golden {name} out of tolerance")
        if min(grew) <= 0:
            raise AssertionError(f"golden {name} did not go through both kernels")


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this smoke run needs an NVIDIA GPU")
    if not (REPO / "echorenderer_tpu_torch" / "__init__.py").exists():
        return fail(f"the echorenderer_tpu_torch package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    import numpy as np

    from echorenderer_tpu_torch.entry import entry
    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.aggregation.bvh import build_bvh, geometry_bounds
    from echorenderer_tpu_torch.ops import pallas_intersect as pi
    from echorenderer_tpu_torch.processes.render import EvaluationProfile, render_layer
    from echorenderer_tpu_torch.scene.prepare import prepare_scene
    from echorenderer_tpu_torch.utils.colors import luminance

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi} | torch.cuda: {kind} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")

    built = pi.build()
    log(f"[build] {built.path.name}: {built.seconds:.2f} s nvcc, "
        f"flags {' '.join(pi.NVCC_FLAGS)}")
    for line in built.ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")
    pi._load()

    # --- kernel phase ---
    rs = np.random.RandomState(2024)
    bench = prepare_scene(scenes.sphere_field(80), device=dev)
    err_a, ms_a = compare_kernels(
        "sphere_field(80)", bench.prim_soa,
        random_rays(rs, N_RAYS, [-20, 0.05, -20], [20, 4, 20], bench.prim_soa.num_prims), dev)
    geom = synthetic_scene(rs)
    bmin, bmax = geometry_bounds(geom)
    t_bvh = time.perf_counter()
    order = build_bvh(bmin, bmax).prim_order
    big = pi.build_prim_soa(geom, order=order,
                            packed=pi.pack_sorted_prims(geom, order, bounds=(bmin, bmax)),
                            device=dev)
    log(f"[kernels] synthetic scene: {big.num_prims} prims, BVH order in "
        f"{time.perf_counter() - t_bvh:.2f} s")
    cam = camera_rays(1024, 512, (0.0, 5.0, -40.0))
    rnd = random_rays(rs, N_RAYS - len(cam[0]), [-20, 2, -20], [20, 8, 20], big.num_prims)
    err_b, ms_b = compare_kernels(
        "synthetic 42k", big, [np.concatenate([a, b]) for a, b in zip(cam, rnd)], dev)

    # --- golden phase ---
    golden_phase(dev)

    # --- slice phase: the main path, counters from zero ---
    pi.dense_trace.launches = 0
    pi.dense_occlude.launches = 0
    torch.cuda.reset_peak_memory_stats()
    fn, args = entry("cuda")
    t_entry = time.perf_counter()
    s_sum, s_sq = fn(*args)
    torch.cuda.synchronize()
    t_entry = time.perf_counter() - t_entry
    if s_sum.shape != (128 * 128, 3) or not bool(torch.isfinite(s_sum).all()):
        return fail("entry(): non-finite or misshapen output")
    entry_lum = float(luminance(s_sum / 8.0).mean())
    log(f"[slice] entry(): cornell 128x128 8 spp in {t_entry:.3f} s, mean luminance "
        f"{entry_lum:.4f}")

    prof = EvaluationProfile(samples_per_epoch=8, max_epoch=1, bounce_limit=16,
                             survivability=2.5, adaptive=False)
    image, info = render_layer(bench, prof, (960, 540))
    launches = dict(trace=pi.dense_trace.launches, occlude=pi.dense_occlude.launches)
    lum = float(luminance(torch.as_tensor(image)).mean())
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    mspps = info["samples_per_second"] / 1e6
    log(f"[slice] sphere_field(80) 960x540 8 spp bounce 16: {info['samples']} samples in "
        f"{info['seconds']:.3f} s = {mspps:.3f} Mspps, {info['wavefront_iterations']} wavefront "
        f"iterations, peak memory {peak_gib:.2f} GiB, mean luminance {lum:.4f} | {smi}")
    log(f"[slice] kernel launches on the main path: {launches}")
    if image.shape != (540, 960, 3) or not np.isfinite(image).all():
        return fail("bench render: non-finite or misshapen image")
    if not (0.01 < lum < 10.0 and 0.01 < entry_lum < 10.0):
        return fail(f"mean luminance out of (0.01, 10): bench {lum}, entry {entry_lum}")
    if min(launches.values()) <= 0:
        return fail(f"the main path did not launch every kernel: {launches}")

    kernels = [
        dict(name="dense_trace", route="cuda", source=SOURCE, replaces=TRACE_SITE,
             launches=launches["trace"], max_abs_err=max(err_a["trace"], err_b["trace"]),
             ms=ms_a["trace"], plain_ms=ms_a["trace_plain"]),
        dict(name="dense_occlude", route="cuda", source=SOURCE, replaces=OCCLUDE_SITE,
             launches=launches["occlude"],
             max_abs_err=max(err_a["occlude"], err_b["occlude"]),
             ms=ms_a["occlude"], plain_ms=ms_a["occlude_plain"]),
    ]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
