#!/usr/bin/env python3
"""Smoke run of the PyTorch port (echorenderer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a non-zero exit:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions. No CUDA device: exit 1.
  2. build: nvcc builds every csrc/*.cu for sm_90a, all at once; ptxas
     registers, spills and shared memory per kernel, the megakernel's
     three forms (untextured, textured, chunk-tree) by name with their
     registers, spills and stack frame (the chunk-tree form's holds the
     walk's stack), and hier_kernel's forms with their static shared memory.
     Every phase that measures a form of the chunk-tree walk (hier_kernel's
     trace and occlude, flat and instanced; the megakernel's chunk-tree
     form on each frame) also reports its ptxas registers, stack frame and
     static shared memory, its dynamic shared memory a block, its resident
     warps/SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and its share
     of its bound; these lines are printed again, "[walk]", before the
     kernels line. The seg kernel's forms (seg_kernel<has_tri, has_sph,
     instanced, keyed>) with their ptxas registers, stack frame and spills;
     before the kernels line, one "[seg]" line a form (flat and instanced,
     keyed and exact, triangle-only and mixed, and any other form checked):
     its ptxas report, dynamic shared memory a block, resident warps/SM and
     what caps them, and over every checked launch of it the mean ms, the
     mean bound and its share. Setup's and select's forms (setup_kernel,
     setup_group<lanes, threads>, select_group<lanes, keys a lane,
     threads>, select_kernel) with their ptxas reports; before the kernels
     line, one "[setup]" or "[select]" line a shape the checks launched
     (setup: supers and s_out; select: w and k): the form the C entry takes
     for it, its ptxas report, dynamic shared memory a block, resident
     warps/SM and what caps them (binned_trace.setup_occupancy /
     select_occupancy), and over its checked launches their rays, mean ms,
     mean bound, % of bound and launches x (ms - bound).
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card, on the same inputs:
     - dense_trace / dense_occlude on every call the wavefront path makes
       (sphere_field(2400) 320x180 8 spp through render_layer, recorded),
       on every call a mid-size triangle mesh makes on it (sphere_grid(
       50_000): 51,200 triangles, 401 chunks, 320x180 8 spp bounce 6,
       recorded), and on 2^20 rays each against the sphere_field(80) table
       and a ~42k-prim BVH-ordered scene of 329 chunks: identical prim ids
       and blocked flags, t/u/v to rtol 1e-6; each set's C entry alone (its
       launches back to back, the card kept busy while the host makes the
       first call) and a call of the wrapper, in ms a launch, beside the
       bound and the % of bound; one "[dense]" line a kernel form and set,
       printed again before the kernels line: ptxas registers, dynamic
       shared memory a block, resident warps/SM and what caps them, ms,
       bound and launches x (ms - bound);
     - the megakernel on sphere_field(80) 960x540, the Cornell box 128x128,
       material_ball, many_lights(96) and sphere_grid(1900) (1,924
       triangles, 2048 padded prims: the top of the envelope) at 320x180,
       8 spp, bounce 16, and
       on the main path's bench launch (sphere_field(80) 960x540, 64 spp),
       against the wavefront: every pixel's sums bitwise equal (the path
       pool runs the plain version's ops in its order), and, as before,
       per-pixel sums to atol/rtol 2e-3 and sums of squares to atol 4e-2 /
       rtol 2e-3 on at least 99.99% of pixels, mean image to 1e-4 per
       channel; k_slots 1 and 4 bitwise equal; each launch's report of its
       form (ptxas registers, stack frame, spills and static smem, dynamic
       smem a block, resident warps/SM and what caps them, the lanes or the
       split form, ms, bound, % of bound), printed again, "[mega]", before
       the kernels line;
     - the megakernel's textured form the same way on the showcase
       (scenes/showcase.echo through the port's loader, `showcase_scene`), on
       tests/test_megakernel.py's cloud-and-gradient scene and sphere-texture
       scene and on a normal-map and roughness-ramp scene at 320x180, 8 spp,
       bounce 16, and on the main path's showcase launch (960x540, 64 spp);
       the showcase with a fifth texture must stay outside the envelope
       ("more than 4 textures") and render through the wavefront;
     - hier_trace / hier_occlude (the chunk-tree walk) on 2^20 random rays
       against sphere_grid(1_000_000) (bench.py's large scene) and on every
       coherent call (the first wave) of the slice's first timed program
       below, recorded; the plain versions on a strided subset of 65,536
       rays of each call: ids, flags and t/u/v bitwise equal;
     - the binned traversal's kernels setup_rank / refill / select / seg_keys on one
       trace_binned and one occlude_binned call of the same 2^20 random
       rays and on every binned call of that program: every launch against
       its plain version on the same inputs, bitwise; then each call against
       the hier kernels: the same rays hit, equal prims give bitwise equal
       t/u/v, differing prims (counted) have t in one band (bits & ~0xFF),
       occlude flags identical; per kernel the mean ms per launch (the sum
       over the launches over their count, as the bound, which counts only
       the bytes each launch needs: the records of live pairs, the new keys
       of refilling rays, the order keys and super boxes a refill reads) and
       the median per call, the plain version's,
       launches, rounds and host reads per call, and torch.sort of setup's
       key matrix as its yardstick (the ranking step only) and torch.topk of
       select's purged and merged buffer as select's (the pop step alone,
       without the distinct rule); setup's, refill's (ksup, capped or not)
       and select's launches also by shape (launches, rays, mean ms and
       bound, launches x (ms - bound));
       the seg
       launches bucketed by live pairs (< 2^14, < 2^18, the rest), each
       bucket's launches, share of the seg time, mean ms and share of its
       bound; every seg
       launch also runs the seg kernel's exact form (seg_hits: t, prim, u, v
       per pair, the JAX package's `_seg_kernel(keyed=False)`, which no
       render path calls) on the same pairs, bitwise against its plain
       version and against the keyed result (the same hit or miss, the
       key's band on every found pair, prim ties within one band counted);
     - sphere_grid(250_000) at 320x180, 8 spp, bounce 6 rendered through
       the hier kernels alone (`scene_ops.walk_only`), through the main
       dispatch (first wave on the walk, the rest binned) and through the
       dense kernels: hier = dense bitwise; binned vs dense: pixels not
       bitwise equal counted, sums within the megakernel's tolerance; and
       through the megakernel's chunk-tree form against its plain version
       (the wavefront on the walk alone, the same lanes): bitwise;
     - the chunk-tree form on many_lights(256) (emitters, the light tree,
       MIS on emissive hits; chunk-tree tables built directly) at 320x180,
       8 spp, bounce 16 against its plain version: pixels not bitwise equal
       counted, MEGA_TOL; its ms, plain ms and bound;
     - under ECHO_MEGA_HIER, render_layer at 320x180, 8 spp: sphere_grid(
       20_000) under a textured plane and instanced_grid(side=3) (TLAS)
       take the wavefront, sphere_grid(20_000) the chunk-tree form;
     - median ms of each kernel (10 runs after a warm-up) and of its plain
       version (the megakernel's: the compared wavefront run itself, its
       least work counted after it; sphere_grid(50_000)'s dense calls: not
       timed), and the bound: the larger of the float work over 67 TFLOP/s
       and the bytes over 3.35 TB/s. The float work is that of the prim
       tests the rays of this run cannot do without (`least_flops`,
       `least_flops_hier`): chunks a ray does not enter before its final
       hit are skipped where the kernel culls, a blocked shadow ray stops at
       its first blocker; shading is not counted.
  4. golden: the cornell and spheres goldens rendered on the card through
     the megakernel and through the wavefront (dense kernels), held to
     tests/test_golden.py's tolerances.
  5. slice: the main path, counters zeroed first: entry() (Cornell box,
     128x128, 8 spp) and the bench scene sphere_field(80) at 960x540,
     64 spp, bounce 16, through render_layer (the megakernel path: Mspps,
     peak memory); the showcase, counters zeroed again, at the same traffic
     through the textured megakernel (Mspps beside the bench's, epoch wall,
     peak memory); then the wavefront path, counters zeroed again:
     sphere_field(2400) (outside the megakernel's envelope) at 320x180,
     8 spp through render_layer; hdr_environment() (an env map, 5 prims: the
     plain linear intersector, as in the JAX package) at 960x540, 16 spp,
     and its sky over sphere_field(80) at 320x180, 8 spp (the dense
     kernels), both through the wavefront: Mspps, mean luminance, launches;
     then the large-scene path, counters zeroed
     again: bench.py's large configuration, sphere_grid(1_000_000) at
     1920x1080, 1 spp, bounce 6, survivability 2.5, through _sample_frame:
     a warm-up program, then 8 timed programs (sample_start 1..8): Mspps,
     program seconds, prepare seconds, peak memory, dispatch ("binned"), the
     liveness cascade's widths, launches (binned kernels and hier > 0, dense
     and megakernel 0), rounds and host reads, mean luminance; then the same
     8 programs with the binned traversal off (`scene_ops.walk_only`: every
     wave on the walk, the dispatch before the binned port) for comparison;
     then the same 8 programs under ECHO_MEGA_HIER through the megakernel's
     chunk-tree form (dispatch "megakernel-hier"): Mspps, program seconds,
     peak memory, mean luminance, launches (9 chunk-tree launches and no
     other), the first timed program's sums against the walk-only first
     program's (pixels not bitwise equal, MEGA_TOL), and its launch against
     its plain version: median ms of 10 launches, the plain ms, the bound
     (the least prim-test work of the plain run's walk calls). The kernels
     line reports the dense kernels' ms and bound per launch of the
     wavefront path, the megakernel's for the bench launch, the hier
     kernels' per call of the large-scene program, and the binned kernels'
     per launch of its binned calls, megakernel_textured the textured
     form's for the showcase launch, and megakernel_hier the chunk-tree
     form's for the large scene's launch.
  6. adaptive: adaptive per-pixel epochs and the AOV evaluators, each
     render with every launch count zeroed first and its host reads counted
     (torch.cuda's sync debug mode: one warning a synchronizing call):
     - the bench scene (sphere_field(80), 960x540) and the showcase
       (320x180) under EvaluationProfile()'s defaults (16 spp an epoch,
       epochs 1..20, threshold 0.045, bounce 128; the showcase's max_epoch
       cut to 8: its later epochs hold a few hundred pixels or fewer, and
       each costs the wavefront ~5 s) through render_layer on the
       megakernel: seconds, epochs, samples, mean spp, effective Mspps,
       peak memory; per epoch its active pixels, seconds, Mspps, form (the
       pool or the split form, megakernel.split_form), launches and host
       reads; then the same render on the wavefront with one sample chain
       (megakernel.supported and render.MAX_LANES patched off): every pixel
       bitwise equal and the same epochs and samples; at least one checked
       epoch must take the split form;
     - bench.py's adaptive configuration (ADAPTIVE_LARGE:
       sphere_grid(1_000_000) at 1920x1080, 8 spp an epoch, min_epoch 1,
       threshold 0.045, bounce 6, survivability 2.5) with max_epoch cut
       from 32 to 4 to keep the phase near a minute: the same numbers per
       run and per epoch; then its first adaptive epoch again from the same
       state (`_adaptive_step`), its calls recorded: the walk's launches
       against their plain versions (compare_hier), every binned launch
       against its plain version (BinnedCheck) and each binned call against
       the walk (compare_binned); `tools/torch_profile.py --adaptive` runs
       the full 32 epochs;
     - albedo and normal_depth at 320x180 of sphere_field(2400) (the dense
       kernels), timed, bitwise against the same layers on the kernels'
       plain versions (a miss's depth is INF, and 16 samples of it sum to
       inf, as in the JAX package), and of sphere_grid(250_000) (the binned traversal):
       every binned launch against its plain version, each call against
       the walk, and the image against the walk's, every differing pixel
       owning a band-tie ray;
     - path_lockstep against the wavefront on sphere_field(2400), 320x180,
       3 spp (one sample chain), bounce 16: sums bitwise, squares to rtol
       1e-6.
     The kernels line's hier and binned rows take the largest error of the
     first adaptive epoch's checks too.
  6b. bvh-oracle: the stack BVH walk (aggregation/bvh.intersect_bvh /
     occlude_bvh, plain PyTorch on the card, which no render dispatches
     to) against the dense kernels on 2^16 random rays of
     sphere_field(80): hits and blocked flags identical, another prim
     only on an exact t tie, t to rtol 1e-6.
  7. instanced: TLAS instancing, counters zeroed again:
     instanced_sphere_grids() (4 placements of a 123,008-triangle pack,
     ~2,000 global chunks, a ground plane, an ambient light) prepared with
     instancing="tlas"; the instanced walk (hier_trace / hier_occlude on
     instanced tables) against its plain version and the instanced binned
     traversal (every setup / refill / select / seg launch against its plain
     version, bitwise) on 2^20 random rays with per-instance ignores, then
     binned against the walk (same hits, instances and flags, band ties
     counted, 0 recovery misses); bench.py's large-scene traffic
     (1920x1080, 1 spp, bounce 6, a warm-up and 8 timed programs: the
     first wave on the instanced walk, the rest binned): Mspps, prepare
     seconds, peak memory, launches (instanced kernels only), rounds, host
     reads, mean luminance; the baked twin (instancing="bake", ~492k
     triangles, the flat dispatch) timed the same way; the first program
     again with every kernel call checked as above (ms per launch, mean
     and median, and the bound: the least float work, with 18 flops a ray
     transform, over 67 TFLOP/s or the bytes over 3.35 TB/s); then the
     TLAS render against the baked one (mean |tlas - bake| / mean(bake) <
     0.02, tests/test_instancing.py's bound) of 1,001 instances of a
     two-sphere pack (binned) and of instanced_grid(side=3) (the walk),
     320x180, 8 spp, bounce 6. The instanced seg launches are held to the
     exact form as in the kernel phase. The kernels line adds
     hier_trace[instanced], hier_occlude[instanced], binned_seg[instanced]
     (the instanced forms of hier_kernel and seg_kernel) and
     binned_seg_exact_instanced from this program.
  8. plucker: the Plücker micro-benchmark's kernels
     (echorenderer_tpu_torch.benchmarks.plucker_micro, csrc/plucker.cu) at
     2^20 rays against its 256-triangle soup, counters zeroed: its numerics
     as its main() drives them (1 MT launch, 2 each of the Plücker form at
     HIGHEST and DEFAULT), the MT and HIGHEST key arrays bitwise against
     their plain versions, the DEFAULT ones (the wgmma form) within
     plucker_micro.default_within_contract, its counts printed (prim and
     hit/miss flips, differing keys, keys off by other than one band, the
     largest |key difference| of the rays without a flip), the agreement
     of each Plücker form with MT
     (key agreement, prim flips, hit/miss flips, largest relative t gap) in
     the scene frame and the chunk-local frame; each kernel's form (rays a
     thread or prims a wgmma product, ptxas registers and spills, which
     must be none, dynamic shared memory, resident warps/SM) and the HGMMA
     instructions in the DEFAULT kernel's SASS (cuobjdump -sass; none
     fails); per kernel the median ms on the chunk-local
     inputs, the plain ms, the bound (MT: 45 flops a (ray, triangle);
     Plücker: the edge volumes' 33 flops a pair, at 67 TFLOP/s or at
     DEFAULT at the bf16 tensor-core rate, and 12 more only on the pairs
     that pass the sign test, counted from this run's data) and, for
     the Plücker form, torch.matmul of its two products alone as a
     yardstick. The kernels line adds plucker_mt, plucker_plk_highest and
     plucker_plk_default (its max_abs_err the largest |key difference|
     without a flip, its contract counts per frame under "contract");
     binned_seg_exact counts the exact launches of
     the large-scene program's check above.
  9. compose: the README's call on the card, render(prepare_scene(
     scenes.material_ball()), standard_path_traced_profile(1.0, (1280,
     720))), launch counts zeroed first: seconds a layer, epochs, samples,
     dispatch (the path layer on the megakernel; material_ball's 7 prims
     put the AOV layers on the linear intersector, so no dense launch),
     wall, peak memory; it fails on a recorded composition error or a
     `main` that is not finite, not (720, 1280, 3) or outside [0, 1].
     Then, on the layers the stack received: each operator's ms (CUDA
     events, median of 5) of the profile's stack and of
     composition.STANDARD_STACK (BilateralDenoise first), the card's
     compose again (bitwise equal to
     render's) against the CPU's compose (main atol 1e-4), the denoiser
     alone against the CPU's (rtol 1e-4 / atol 1e-5: its convolutions in
     float32, torch.backends.cudnn.allow_tf32 unchanged after it), and, for
     comparison, the same convolutions in TF32 (error and ms), and
     load_params(device=cuda) alone; two threads denoising at once, each
     output within the same tolerance and the flag unchanged after; each
     operator of composition.STANDARD_STACK and LearnedDenoise called 20
     more times on the same layers, a matmul between calls: every call
     bitwise equal to the first (torch.cumsum of the layer, which
     AutoExposure does not use, counted beside them); a resumed
     resume_render_layer (1 epoch, then to 3) against 3 epochs straight,
     bitwise, on sphere_field(80) 320x180 (the megakernel) and
     hdr_environment() 320x180 (the wavefront); under ECHO_DEBUG_DEVICE=1
     the first epoch of sphere_field(2400) (the wavefront, dense kernels)
     runs path_step's checks in one host read and equals the unchecked
     render bitwise, sphere_field(80) stays on the megakernel (no check
     there, equal bitwise), and run_checked over a non-finite card tensor
     raises; a Device().schedule_render of the standard profile at 320x180
     on material_ball gives render's layers bitwise.
 10. frontend: the CLI as a user runs it, `python -m
     echorenderer_tpu_torch.terminal -p scenes/showcase.echo --profile-name
     standard` in a subprocess writing main as EXR and PNG and albedo as
     PFM: exit 0, the main layer's line naming the textured megakernel at a
     Mspps above 0, every SAH build on the C++ builder; its EXR and PFM
     bitwise equal to an in-process render of the same profile (960x540)
     and its PNG the u8 encoding of it; wall seconds and each layer's.
     scenes/cornell.echo's :fast profile through terminal.main in-process
     (its Pure albedos are atlas textures: the textured megakernel alone),
     its EXR bitwise equal to render's; the same profile rendered with
     preview_progress into a PreviewServer on 127.0.0.1 with
     tile_progress=16, bitwise equal to the untiled render, /status.json
     (tile_batch [16, 16]) and the last frame PNG fetched and decoded.
     sphere_grid(1_000_000)'s mesh written as a binary PLY beside a .echo
     of sphere_grid's plane, light and camera: load_profile's seconds,
     prepare_scene's seconds and its SAH builds, the prim, chunk-tree and
     geometry tables bitwise equal to those of the 1M scene above; then
     rendered through terminal.main at 960x540 (one path epoch of 16 spp)
     on the walk and the binned kernels alone, the EXR read back finite
     with mean luminance in (0.01, 10). The C++ builder against the numpy
     builder on sphere_grid(250_000)'s prim and chunk boxes and on the 1M
     prim boxes, every array and the root bitwise (seconds of both), and
     every prepare_scene of the run on the C++ builder.
 11. multigpu: parallel/ on the card, counters zeroed before each render.
     The bench frame (sphere_field(80), 960x540, 64 spp, bounce 16: the
     megakernel) through render_epoch_sharded over meshes of 1 (make_mesh(1)),
     2 and 4 shards on cuda:0: sums and squares bitwise equal to one
     unsharded sample_frame_wavefront call over every lane in tile order,
     Mspps (best of 3), the counter (padded lanes x spp) and one megakernel
     launch a shard. instanced_sphere_grids() (TLAS) at 1920x1080, 1 spp,
     bounce 6, over 1 and 2 shards: the instanced kernels alone, bitwise
     equal. Three spawned processes at once on cuda:0: two gloo ranks over
     a file store, each rendering its half of the bench frame at 16 spp
     through render_frame_multihost, and one NCCL world of one (its gather
     all_gather_into_tensor on the card); each renders the frame twice and
     reports the all-gather's ms; every image bitwise equal to the
     in-process render_frame_sharded frame over 2 shards; a process that
     fails or outlives its 150 s join timeout fails the phase. Then
     entry.dryrun_multichip(4) (the mesh repeats cuda:0).
 12. train: echorenderer_tpu_torch/tools/ on the card. The denoiser's
     trainer at full width (WIDTH 32, 5 layers, batch 16, 64x64 crops) on
     a dataset cut to 3 of its 10 scene variants (TRAIN_VARIANTS) and 1 of
     its 4 noisy views each, at 192x128 with 1024 clean spp: the dataset's
     seconds; the first 3 steps against the CPU on the same crops (each
     step's loss and whole gradient against a float64 CPU step from the
     card's own params, the CPU's Adam on the card's gradients against the
     card's step, and a CPU float32 run of its own, within TRAIN_TOL),
     beside the gap of the backward pass under torch's defaults (TF32),
     which the bound refuses; 200 steps twice from one seed, loss
     traces and params bitwise equal, steps/s, the mean loss of the last
     20 steps below the first 20's; the cuDNN flags as they were. Then
     gen_reference_stats' naive oracle for material_ball at 960x540 and
     64 spp, and the worst and mean tile z of the port's 2-spp path render
     against those stats and against the committed fixture, beside
     TestTileStats's bounds (6.0, 1.5): a finding, gating nothing.
 13. summary: a JSON line of the kernels, then the last line
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
N_RAYS = 2 ** 20
RTOL = 1e-6
PEAK_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (data sheet)
# float ops of one ray-prim test, counted from csrc/intersect.cuh: a
# Moller-Trumbore triangle and a sphere (compares and selects not counted)
FLOPS_TRI = 45
FLOPS_SPH = 21
LEAST_SLICE = 2 ** 16  # rays per pass of the least-work count
# sphere_grid(MESH_GRID): a mid-size triangle mesh on the dense kernels'
# path (51,200 triangles, 401 chunks, under scene_ops.HIER_TRACE_MIN)
MESH_GRID = 50_000
# cycles the card spins (torch.cuda._sleep) before a timed run of C entries,
# so that the host's first ctypes call ends before the start event: ~60 us
SLEEP_CYCLES = 100_000
HIER_LEAST_SLICE = 2 ** 13  # rays per pass of the chunk-tree least-work count
HIER_SUBSET = 2 ** 16  # rays of each call the hier kernels' plain versions check
MEGA_TOL = dict(sum_atol=2e-3, sum_rtol=2e-3, sq_atol=4e-2, sq_rtol=2e-3, share=0.9999,
                mean=1e-4)
DENSE_SOURCE = "echorenderer_tpu_torch/csrc/dense_intersect.cu"
MEGA_SOURCE = "echorenderer_tpu_torch/csrc/megakernel.cu"
TRACE_SITE = "echorenderer_tpu/ops/pallas_intersect.py:322"
OCCLUDE_SITE = "echorenderer_tpu/ops/pallas_intersect.py:400"
MEGA_SITE = "echorenderer_tpu/ops/megakernel.py:1101"
MEGA_TEX_SITE = "echorenderer_tpu/ops/megakernel.py:1295"  # _mega_kernel's texture stage
MEGA_HIER_SITE = "echorenderer_tpu/ops/megakernel.py:909"  # _hier_walk: the fat-chunk variant
# the megakernel's three compiled forms: mega_kernel<TEX, HIER>
MEGA_FORMS = {"ILb0ELb0E": "untextured", "ILb1ELb0E": "textured", "ILb0ELb1E": "chunk-tree"}
HIER_SOURCE = "echorenderer_tpu_torch/csrc/hier_walk.cu"
HIER_SITE = "echorenderer_tpu/ops/pallas_hier.py:498"
BINNED_SOURCE = "echorenderer_tpu_torch/csrc/binned.cu"
BINNED_SITES = dict(setup="echorenderer_tpu/ops/binned_trace.py:552",
                    select="echorenderer_tpu/ops/binned_trace.py:402",
                    seg="echorenderer_tpu/ops/binned_trace.py:117",
                    refill="echorenderer_tpu/ops/binned_trace.py:1143")
# what BinnedCheck records: the four kernels, the seg kernel's instanced
# form, and its exact form (seg_hits) flat and instanced
BINNED_KINDS = ("setup", "refill", "select", "seg", "seg_instanced", "seg_exact",
                "seg_exact_instanced")
# float ops of one ray-box slab test (6 subtractions, 6 products, 10 mins
# and maxes; compares not counted), counted from csrc/intersect.cuh
FLOPS_SLAB = 22
# float ops of moving a ray into an instance's space (csrc/hier_walk.cu:
# 9 + 9 products, 6 + 6 sums, 3 offsets; counted as 18 here, the products
# of the origin and the direction), and of the instanced sphere test's
# extra quadratic terms (not counted)
FLOPS_XFORM = 18
PEAK_BF16 = 989e12  # H100 SXM bf16 on the tensor cores, dense (data sheet)
PLUCKER_SOURCE = "echorenderer_tpu_torch/csrc/plucker.cu"
PLUCKER_SITES = dict(mt="benchmarks/plucker_micro.py:79", plk="benchmarks/plucker_micro.py:142")
# the Plücker form's least float work, counted from csrc/plucker.cu without
# its products by structural zeros: a (ray, triangle) pair's three edge
# volumes of 6 products and 5 sums; on a pair that passes the sign test
# only, n.d of 3 and 2, nv0 - n.o of 3 and 3 and the division; per ray
# m = o x d, 9
PLUCKER_EDGE_FLOPS = 33
PLUCKER_INSIDE_FLOPS = 12
PLUCKER_RAY_FLOPS = 9
INSTANCED_RES = (1920, 1080)  # bench.py's large-scene frame, for the TLAS slice
# live-pair bounds of the seg launches' buckets (< 2^14, < 2^18, the rest)
SEG_BUCKETS = (2 ** 14, 2 ** 18)
# the seg kernel's forms by BinnedCheck kind: (instanced, keyed)
SEG_KINDS = {"seg": (False, True), "seg_instanced": (True, True), "seg_exact": (False, False),
             "seg_exact_instanced": (True, False)}
H100_SMEM_SM = 233_472  # shared memory of an SM (228 KiB), 1 KiB of it reserved a block
TLAS_BAKE_RES = (320, 180)  # the TLAS-against-bake renders


def log(*args):
    print(*args, flush=True)


def count_of(name: str) -> int:
    """A host counter of the port (`utils.diagnostics`), 0 where it never
    moved."""
    from echorenderer_tpu_torch.utils import diagnostics

    return diagnostics.counts()[name]


def binned_reads() -> int:
    """The binned traversal's host reads, its `reads.binned_*` counters."""
    from echorenderer_tpu_torch.utils import diagnostics

    return sum(v for k, v in diagnostics.counts().items() if k.startswith("reads.binned_"))


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def showcase_scene(fifth_texture: bool = False):
    """scenes/showcase.echo's Scene through the port's .echo loader. Its
    Pure(...) albedos stay textures, so the atlas holds 4 slices: the
    cloud, the gradient and the two Pure colors. `fifth_texture` adds a
    cloud-textured fifth sphere: 5 slices, outside the megakernel's
    envelope."""
    from echorenderer_tpu_torch.io.echo_dsl import EchoSource
    from echorenderer_tpu_torch.scene import Diffuse, Scene, SphereEntity
    from echorenderer_tpu_torch.textures import CloudTexture

    scene = EchoSource(REPO / "scenes" / "showcase.echo").construct_first(Scene)
    if fifth_texture:
        scene.add(SphereEntity(material=Diffuse(albedo=CloudTexture(scale=3.0, seed=9)),
                               radius=0.5, position=(-1.2, 0.5, -1.5)))
    return scene


def texture_scene(name: str):
    """A textured scene of tests/test_torch_textures.py, built with the port's
    classes: "textured" (tests/test_megakernel.py's cloud plane and gradient
    box), "sphere_texture" (its gradient-textured sphere), "rough_normal"
    (a normal map and tests/test_rough_texture.py's roughness ramp)."""
    sys.path.insert(0, str(REPO / "tests"))
    import test_torch_textures

    return test_torch_textures.SCENES[name]("torch")


def hdr_sky_over_spheres():
    """sphere_field(80) under hdr_environment()'s sky as a second ambient
    light: an env map (the mixture branch) on the dense kernels' path."""
    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.scene import AmbientLight

    sky = next(e for e in scenes.hdr_environment().children
               if getattr(e, "texture", None) is not None)
    scene = scenes.sphere_field(80)
    scene.add(AmbientLight(intensity=(0.5, 0.5, 0.5), texture=sky.texture))
    return scene


def ptxas_forms(ptxas: str, kernel: str) -> dict:
    """{entry name: "N registers, F bytes stack frame, S bytes spill stores,
    L bytes spill loads, M bytes static smem"} for every compiled form of
    `kernel` in an -Xptxas -v report."""
    forms, entry, spill = {}, None, ""
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry = name if kernel in name else None
        elif entry and "spill stores" in line:
            spill = line.strip()
        elif entry and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
            smem = re.search(r"(\d+) bytes smem", line)
            smem = smem.group(1) if smem else "0"
            forms[entry] = f"{regs} registers, {spill}, {smem} bytes static smem"
    return forms


# ptxas reports of the chunk-tree walk's forms, filled by main(): hier_kernel's
# by (has_tri, has_sph, any_hit, instanced), the megakernel's chunk-tree form
# by "mega"; and the report line of every form measured, printed again before
# the kernels line
WALK_PTXAS: dict = {}
WALK_REPORTS: list = []
# the seg kernel's ptxas reports by (has_tri, has_sph, instanced, keyed),
# filled by main(); and every checked seg launch: (kind, (has_tri,
# has_sph), row), for the "[seg]" lines before the kernels line
SEG_PTXAS: dict = {}
SEG_LAUNCHES: list = []
# ptxas reports of the megakernel's untextured and textured forms (the path
# pool) by form, filled by main(); and the report line of every launch of
# them measured, printed again, "[mega]", before the kernels line
MEGA_PTXAS: dict = {}
MEGA_REPORTS: list = []
# the dense kernels' ptxas reports by (any_hit, has_tri, has_sph), filled by
# main(); and the report line of every checked set of calls, "[dense]",
# printed again before the kernels line
DENSE_PTXAS: dict = {}
DENSE_REPORTS: list = []
# the binned library's ptxas report, filled by main(); and every checked setup
# and select launch: (kind, shape, row), shape (supers, s_out) or (w, k), for
# the "[setup]" and "[select]" lines before the kernels line
BINNED_PTXAS: list = [""]
SHAPE_LAUNCHES: list = []


def occupancy_cap(occ, ptxas) -> str:
    """What caps a form's resident blocks a SM: its shared memory, its
    registers (256 a warp at a time, from each of the SM's four 16,384-
    register quarters), or the 64 warps of an SM."""
    regs = int(ptxas.split(" registers")[0])
    static = re.search(r"(\d+) bytes static smem", ptxas)
    smem = occ["smem"] + (int(static.group(1)) if static else 0)
    wpb = occ["block"] // 32
    caps = {"shared memory": H100_SMEM_SM // (smem + 1024),
            "registers": 4 * (16384 // (-(-regs * 32 // 256) * 256)) // wpb,
            "the 64 warps of an SM": 64 // wpb}
    held = [name for name, blocks in caps.items() if blocks == occ["blocks"]]
    return " and ".join(held) if held else "the occupancy query's other limits"


def seg_form_reports(smi) -> list:
    """One "[seg]" line a seg form (flat and instanced, keyed and exact,
    triangle-only and mixed, and any other form the checks launched): ptxas
    registers / stack frame / spills, dynamic shared memory a block,
    resident warps/SM and what caps them; over every checked launch of the
    form, the launches, the mean ms, the mean bound and its share."""
    from echorenderer_tpu_torch.ops import binned_trace as bt

    keys = {(t, s, i, k) for t, s in ((True, False), (True, True))
            for i in (False, True) for k in (True, False)}
    keys |= {(*form, *SEG_KINDS[kind]) for kind, form, _ in SEG_LAUNCHES}
    lines = []
    for tri, sph, inst, keyed in sorted(keys, reverse=True):
        ptxas = SEG_PTXAS[(tri, sph, inst, keyed)]
        occ = bt.seg_occupancy(keyed, inst, tri, sph)
        rows = [r for kind, form, r in SEG_LAUNCHES
                if form == (tri, sph) and SEG_KINDS[kind] == (inst, keyed)]
        name = (f"seg_kernel {'instanced' if inst else 'flat'} {'keyed' if keyed else 'exact'} "
                f"{'mixed' if sph and tri else 'triangle-only' if tri else 'sphere-only'}")
        timing = "not launched by this run's checks"
        if rows:
            ms, bound = sum(r["ms"] for r in rows), sum(r["bound"][0] for r in rows)
            timing = (f"{len(rows)} checked launches: mean {ms / len(rows):.4f} ms against a "
                      f"mean bound of {bound / len(rows):.6f} ms, {100.0 * bound / ms:.2f}% of "
                      f"bound")
        lines.append(f"{name}: {ptxas}; {occ['smem']} bytes dynamic smem a {occ['block']}-thread "
                     f"block, {occ['blocks']} blocks = {occ['warps']} resident warps/SM, capped "
                     f"by {occupancy_cap(occ, ptxas)}; {timing} | {smi}")
    return lines


def shape_form_reports(smi) -> list:
    """One "[setup]" or "[select]" line a shape the checks launched (setup:
    supers and s_out; select: w and k): the form the C entry takes for it
    (csrc/binned.cu kSetupForms / kSelectForms), its ptxas registers / stack
    frame / spills, dynamic shared memory a block, resident warps/SM and
    what caps them; over the checked launches of the shape, their count,
    rays, mean ms and bound, % of bound and launches x (ms - bound)."""
    from echorenderer_tpu_torch.ops import binned_trace as bt

    lines = []
    for kind, shape in sorted({(k, s) for k, s, _ in SHAPE_LAUNCHES}):
        occ = (bt.setup_occupancy if kind == "setup" else bt.select_occupancy)(*shape)
        g, t = occ["group"], occ["block"]
        if kind == "setup":
            what = f"setup, {shape[0]} supers, s_out {shape[1]}"
            tag, form = (("setup_kernel", "setup_kernel (a thread a ray)") if g == 1 else
                         (f"setup_groupILi{g}ELi{t}E", f"setup_group ({g} lanes a ray)"))
        else:
            what = f"select, w {shape[0]}, k {shape[1]}"
            tag, form = (("select_kernel", "select_kernel (a thread a ray, shared-memory column)")
                         if g == 0 else (f"select_groupILi{g}ELi{occ['keys']}ELi{t}E",
                                         f"select_group ({g} lanes a ray, {occ['keys']} keys a "
                                         f"lane)"))
        ptxas = next(iter(ptxas_forms(BINNED_PTXAS[0], tag).values()))
        rows = [r for k, s, r in SHAPE_LAUNCHES if (k, s) == (kind, shape)]
        ms, bound = sum(r["ms"] for r in rows), sum(r["bound"][0] for r in rows)
        n = [r["n"] for r in rows]
        lines.append(f"{what}: {form}: {ptxas}; {occ['smem']} bytes dynamic smem a {t}-thread "
                     f"block, {occ['blocks']} blocks = {occ['warps']} resident warps/SM, capped by "
                     f"{occupancy_cap(occ, ptxas)}; {len(rows)} checked launches on "
                     f"{min(n)}-{max(n)} rays: mean {ms / len(rows):.4f} ms against a mean bound "
                     f"of {bound / len(rows):.6f} ms, {100.0 * bound / ms:.2f}% of bound, launches "
                     f"x (ms - bound) {ms - bound:.4f} ms | {smi}")
    return lines


def walk_form_report(label, ms, bound, occ, ptxas) -> str:
    """One form of the chunk-tree walk: ptxas registers / stack frame /
    static smem, dynamic smem a block, resident warps/SM, % of its bound."""
    line = (f"{label}: {ptxas}; {occ['smem']} bytes dynamic smem a {occ['block']}-thread block, "
            f"{occ['blocks']} blocks = {occ['warps']} resident warps/SM; {ms:.4f} ms against a "
            f"bound of {bound:.6f} ms: {100.0 * bound / ms:.3f}% of bound")
    WALK_REPORTS.append(line)
    return line


def mega_form_report(label, scene, n, spp, ms, bound) -> str:
    """One launch of the megakernel's untextured or textured form: ptxas
    registers / stack frame / spills / static smem (the pool), dynamic smem
    a block (the prim records), resident warps/SM and what caps them, the
    form the launch took (ops/megakernel.split_form), ms, bound and % of
    bound."""
    from echorenderer_tpu_torch.ops import megakernel as mk

    textured = scene.tex_atlas.shape[0] > 0
    form = "textured" if textured else "untextured"
    ptxas = MEGA_PTXAS[form]
    occ = mk.occupancy(textured, scene.prim_soa.padded)
    split = mk.split_form(scene, n, spp)
    line = (f"mega_kernel<{str(textured).lower()}, false> ({form}), {label}: {ptxas}; "
            f"{occ['smem']} bytes dynamic smem a {occ['block']}-thread block, {occ['blocks']} "
            f"blocks = {occ['warps']} resident warps/SM, capped by {occupancy_cap(occ, ptxas)}; "
            f"{n} pixels against {occ['paths']} resident paths: the "
            f"{'split form, (pixel, sample) paths' if split else 'lanes form'}; {ms:.4f} ms "
            f"against a bound of {bound:.6f} ms: {100.0 * bound / ms:.3f}% of bound")
    MEGA_REPORTS.append(line)
    return line


def run_ms(fn, runs: int = 10, warm: bool = True) -> list[float]:
    """fn's ms on the card (CUDA events) in each of `runs` runs."""
    import torch

    if warm:
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
    return times


def median_ms(fn, runs: int = 10, warm: bool = True) -> float:
    """The median of `runs` runs' ms; nan for no run (not timed)."""
    times = run_ms(fn, runs, warm)
    return statistics.median(times) if times else float("nan")


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def setup_work(n: int, s_count: int, s_out: int) -> tuple[float, int]:
    """(least float ops, bytes) of a setup launch: every ray's slab test of
    every super; each ray's 7 columns read, its s_out keys written, the super
    table read."""
    return float(n) * s_count * FLOPS_SLAB, n * 28 + s_out * n * 4 + s_count * 24


def refill_work(sup_ord, cursor, best_t, do_refill, base, ksup: int,
                sbits: int) -> tuple[float, int]:
    """(least float ops, bytes) of a refill launch: the slab test of each
    chunk of every super a refilling ray examines; per ray the flag and the
    cursor read, its ksup * SUP keys, cursor and next super written; per
    refilling ray its 6 ray columns and best_t, per other ray its next super
    read; the order keys the refilling rays read; each examined super's
    boxes once."""
    import torch

    from echorenderer_tpu_torch.ops import binned_trace as bt

    w_ord, n = sup_ord.shape
    capped = w_ord < base.shape[0]
    reads, examined, supers = 0, 0, []
    for j in range(ksup + 1):
        p = cursor + j
        inside = do_refill & (p < w_ord)
        reads += int(inside.sum()) + (int((do_refill & ~inside).sum()) if capped and j == ksup
                                      else 0)
        if j == ksup:
            break
        key = sup_ord.gather(0, torch.clamp(p, max=w_ord - 1).long()[None])[0]
        ok = inside & (key != bt._INT_INF) & (bt._dec_t(key, sbits) < best_t)
        examined += int(ok.sum())
        supers.append((key & ((1 << sbits) - 1))[ok])
    distinct = int(torch.unique(torch.cat(supers)).numel()) if supers else 0
    refills = int(do_refill.sum())
    return (float(examined) * bt.SUP * FLOPS_SLAB,
            n * (1 + 8 + 4 + ksup * bt.SUP * 4) + refills * 28 + (n - refills) * 4 + reads * 4
            + distinct * 6 * bt.SUP * 4)


def select_work(w: int, n: int, k: int, refills: int) -> tuple[float, int]:
    """(least float ops, bytes) of a select launch: no float work; the buffer
    read and written, the new keys of refilling rays only, the pops, and per
    ray best_t, the flag, live and mink."""
    return 0.0, 2 * w * n * 4 + (w - k + 1) * refills * 4 + k * n * 4 + n * (4 + 1 + 8)


def slot_flops(soa):
    """Float ops of one ray-prim test per sorted slot (0 for padding)."""
    import torch

    f = torch.where(soa.rows[9] > 0.5, float(FLOPS_SPH), float(FLOPS_TRI)).double()
    f[soa.num_prims:] = 0.0
    return f


def least_flops(soa, rays, ignore, t_end=None, cull=True) -> float:
    """Float ops of the prim tests these rays (7, N) cannot do without,
    with sorted-slot ignores. Closest hit (t_end: each ray's final t):
    every real prim of each 128-slot chunk whose box the ray enters before
    t_end. Any hit (t_end None): the same before t_max, but a blocked ray
    stops at its first blocking slot, in the kernels' order. Without
    `cull` (or in a one-chunk table) every chunk counts. Rays with t_max
    <= 0 do nothing. Box tests are left out, so this is a lower bound."""
    import torch

    from echorenderer_tpu_torch.ops import pallas_intersect as pi

    flops = slot_flops(soa)
    cs = pi.PRIM_BLOCK
    cull = cull and soa.n_chunks > 1
    kinds = soa.num_tris > 0, soa.num_prims > soa.num_tris
    total = 0.0
    for s in range(0, rays.shape[1], LEAST_SLICE):
        r, ig = rays[:, s: s + LEAST_SLICE], ignore[s: s + LEAST_SLICE]
        todo = r[6] > 0.0
        limit = r[6] if t_end is None else t_end[s: s + LEAST_SLICE]
        inv = [pi._safe_inv(r[k]) for k in (3, 4, 5)]
        for j in range(0, soa.padded, cs):
            f = flops[j: j + cs]
            reach = todo & pi._box_reach(soa.chunk_bounds, j // cs, r, inv, limit) if cull else todo
            idx = torch.nonzero(reach).squeeze(1)
            if idx.numel() == 0:
                continue
            if t_end is not None:
                total += float(f.sum()) * idx.numel()
                continue
            t, _, _, ok = pi._chunk_hits(soa.rows[:, j: j + cs], j, r[:, idx], ig[idx], *kinds)
            hit = ok & (t < r[6][idx][:, None])
            blocked = hit.any(dim=1)
            cum = torch.cumsum(f, 0)
            first = torch.argmax(hit.to(torch.int8), dim=1)
            total += float(torch.where(blocked, cum[first], cum[-1]).sum())
            todo[idx[blocked]] = False
    return total


def least_flops_hier(soa, rays, t_end) -> float:
    """Float ops of the prim tests these rays (7, N) cannot do without on
    the chunk tree: for each ray with t_max > 0, every real prim of each
    HCHUNK-prim chunk whose box it enters at or before t_end (its final
    hit, its nearest blocker, else t_max). Box tests are left out, so this
    is a lower bound."""
    import torch

    from echorenderer_tpu_torch.ops import pallas_intersect as pi

    per_chunk = chunk_flops(soa)
    cb = soa.chunk_bounds
    total = 0.0
    for s in range(0, rays.shape[1], HIER_LEAST_SLICE):
        r, te = rays[:, s: s + HIER_LEAST_SLICE], t_end[s: s + HIER_LEAST_SLICE]
        tn = tf = None
        for a in range(3):
            inv = pi._safe_inv(r[3 + a])[:, None]
            t0 = (cb[None, :, a] - r[a][:, None]) * inv
            t1 = (cb[None, :, 3 + a] - r[a][:, None]) * inv
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            tn = lo if tn is None else torch.maximum(tn, lo)
            tf = hi if tf is None else torch.minimum(tf, hi)
        reach = (tn <= tf) & (tf > 0.0) & (tn <= te[:, None]) & (r[6] > 0.0)[:, None]
        total += float((reach.double() @ per_chunk).sum())
    return total


def least_flops_instanced(soa, rays, t_end) -> float:
    """least_flops_hier on instanced tables: for each ray with t_max > 0
    and each instance, every real prim of each pack chunk whose box the ray,
    moved into the instance's space, enters at or before t_end, plus one
    ray transform (FLOPS_XFORM) per instance in which it enters any chunk.
    Box tests are left out, so this is a lower bound."""
    import torch

    from echorenderer_tpu_torch.ops import pallas_hier as ph
    from echorenderer_tpu_torch.ops import pallas_intersect as pi

    per_chunk = chunk_flops(soa)
    real = soa.binned_wcb[:, 0] <= soa.binned_wcb[:, 3]  # not an instance's padding
    total = 0.0
    for i in range(soa.inst_codes.numel()):
        lc = soa.binned_g2c[real & (soa.binned_g2i == i)].long()
        cb = soa.chunk_bounds[lc]
        for s in range(0, rays.shape[1], HIER_LEAST_SLICE):
            r, te = rays[:, s: s + HIER_LEAST_SLICE], t_end[s: s + HIER_LEAST_SLICE]
            inst = torch.full((r.shape[1],), i, dtype=torch.int32, device=r.device)
            o, d = ph.to_instance(soa.inst_f32, inst, r[0:3], r[3:6])
            tn = tf = None
            for a in range(3):
                inv = pi._safe_inv(d[a])[:, None]
                t0 = (cb[None, :, a] - o[a][:, None]) * inv
                t1 = (cb[None, :, 3 + a] - o[a][:, None]) * inv
                lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
                tn = lo if tn is None else torch.maximum(tn, lo)
                tf = hi if tf is None else torch.minimum(tf, hi)
            reach = (tn <= tf) & (tf > 0.0) & (tn <= te[:, None]) & (r[6] > 0.0)[:, None]
            total += float((reach.double() @ per_chunk[lc]).sum())
            total += FLOPS_XFORM * float(reach.any(dim=1).sum())
    return total


class RayWork:
    """While open, wraps the wavefront's scene_ops.trace / occlude: counts
    each call's rays (t_max > 0) and, on the dense kernels' scenes, the
    least float work of their prim tests (`least_flops`), and with `record`
    keeps each call's kernel inputs (rays (7, N), sorted ignores, and on an
    instanced scene the ignores' instances): in `calls` those of the dense
    kernels or the walk (a large scene's coherent first wave), in `binned`
    those of the binned traversal, with each binned call's launches, rounds
    and host reads in `per_call`. With `defer`, the least work is counted
    by `finish()` after the run, from the calls kept until then, so the
    run itself can be timed."""

    def __init__(self, cull: bool, record: bool = False, defer: bool = False):
        self.cull, self.record, self.defer = cull, record, defer
        self.pending = []
        self.rays = dict(trace=0, occlude=0)
        self.flops = dict(trace=0.0, occlude=0.0)
        self.calls = dict(trace=[], occlude=[])
        self.binned = dict(trace=[], occlude=[])
        self.per_call = []

    def __enter__(self):
        import torch

        from echorenderer_tpu_torch.evaluation import scene_ops
        from echorenderer_tpu_torch.ops import pallas_hier as ph
        from echorenderer_tpu_torch.ops import pallas_intersect as pi

        self._saved = trace, occlude = scene_ops.trace, scene_ops.occlude

        def counts():
            return (count_of("launches.binned_setup"), count_of("launches.binned_select"),
                    count_of("launches.binned_seg") + count_of("launches.binned_seg_instanced"),
                    count_of("binned.rounds"), binned_reads())

        def add(kind, scene, o, d, t_max, ignore, ignore_inst, coherent, before, t_end=None):
            rays = pi.ray_columns(o, d, t_max)
            self.rays[kind] += int((rays[6] > 0).sum())
            inst = scene.instances is not None
            binned = (scene_ops._use_binned_instanced(scene) if inst
                      else scene_ops._use_binned(scene)) and not coherent
            extra = ()
            if inst:  # instanced calls carry the ignore's instance
                ig = ph._sorted_ignore(scene.hier_soa, ignore)
                extra = (ph._ignore_inst(scene.hier_soa, ignore, ignore_inst,
                                         missing=0 if binned else -1),)
            elif scene_ops._use_hier(scene):  # compare_hier / compare_binned count their work
                ig = ph._sorted_ignore(scene.hier_soa, ignore)
            else:
                soa = scene.prim_soa
                ig = pi._sorted_ignore(soa, ignore)
                if t_end is not None:
                    t_end = torch.where(t_end[1] >= 0, t_end[0], rays[6])
                if self.defer:
                    self.pending.append((kind, soa, rays, ig, t_end))
                else:
                    self.flops[kind] += least_flops(soa, rays, ig, t_end, self.cull)
            if binned:
                grew = [a - b for a, b in zip(counts(), before)]
                self.per_call.append(dict(kind=kind, rays=rays.shape[1], setup=grew[0],
                                          select=grew[1], seg=grew[2], rounds=grew[3],
                                          syncs=grew[4]))
            if self.record:
                (self.binned if binned else self.calls)[kind].append((rays, ig) + extra)

        def traced(scene, o, d, t_max, ignore, ignore_inst=None, coherent=False):
            before = counts()
            hit = trace(scene, o, d, t_max, ignore, ignore_inst, coherent=coherent)
            add("trace", scene, o, d, t_max, ignore, ignore_inst, coherent, before,
                (hit.t, hit.prim))
            return hit

        def occluded(scene, o, d, t_max, ignore, ignore_inst=None, coherent=False):
            before = counts()
            blocked = occlude(scene, o, d, t_max, ignore, ignore_inst, coherent=coherent)
            add("occlude", scene, o, d, t_max, ignore, ignore_inst, coherent, before)
            return blocked

        scene_ops.trace, scene_ops.occlude = traced, occluded
        return self

    def __exit__(self, *exc):
        from echorenderer_tpu_torch.evaluation import scene_ops

        scene_ops.trace, scene_ops.occlude = self._saved

    def finish(self):
        """Count the least work of the calls a deferred run kept."""
        for kind, soa, rays, ig, t_end in self.pending:
            self.flops[kind] += least_flops(soa, rays, ig, t_end, self.cull)
        self.pending = []
        return self


def timed(fn):
    """(fn's result, its ms on the card by CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def chunk_flops(soa):
    """Float ops of one ray's tests of every real prim, per HCHUNK chunk."""
    import torch

    from echorenderer_tpu_torch.ops import pallas_hier as ph

    real = torch.arange(soa.padded, device=soa.prim_chunks.device) < soa.num_prims
    per_slot = torch.where(soa.prim_chunks[:, 9, :].reshape(-1) > 0.5, float(FLOPS_SPH),
                           float(FLOPS_TRI)).double() * real
    return per_slot.view(-1, ph.HCHUNK).sum(1)


# the one PyTorch call timed beside setup and select: what it computes
LIBRARY_CALLS = dict(setup="torch.sort of the same key matrix (the ranking step alone)",
                     select="torch.topk(merged, k, dim=0, largest=False) over the purged and "
                            "merged buffer (the pop step alone)")


def shape_groups(kind, rows) -> list:
    """[(name, rows, summed ms, summed bound)] of setup, refill or select
    rows by their shape; [] for another kind."""
    groups = {}
    for r in rows:
        if kind in ("setup", "refill", "select"):
            groups.setdefault(r["shape"], []).append(r)
    names = dict(setup="{} supers s_out {}", refill="ksup {} order {}", select="w {} k {}")
    return [(names[kind].format(a, b), rs, sum(r["ms"] for r in rs),
             sum(r["bound"][0] for r in rs))
            for (a, b), rs in sorted(groups.items())]


class BinnedCheck:
    """While open, every launch of the binned traversal's four kernels
    (ops/binned_trace.setup_rank / refill / select / seg_keys) first runs the
    plain version on the same inputs (on a copy of select's in-place buffer), then
    the kernel, and the integer outputs must be identical; `max_err` keeps
    the largest |kernel - plain| seen per kernel. Every seg_keys launch also
    runs the seg kernel's exact form (`seg_hits`, kind "seg_exact") on the
    same pairs, after its plain version: (t, prim, u, v) bitwise equal to
    it, and held to the keyed result: the same hit or miss on every pair,
    bits(t) & ~0xFF equal to the key's band on every found pair, the prim
    equal but for ties within one band (counted). Records per launch: the
    traversal call it belongs to, kernel and plain ms (CUDA events), the
    least float work and the bytes the launch must move, the bound; with
    `library`, for setup also the ms of torch.sort over the same (N, S) key
    matrix. The kernels count their launches in the port's host counters
    (`launches.binned_*`), as on the main path."""

    def __init__(self, soa, library: bool = False):
        self.library = library
        self.rows = {kind: [] for kind in BINNED_KINDS}
        self.max_err = dict.fromkeys(BINNED_KINDS, 0)
        self.chunk_flops = chunk_flops(soa)

    def __enter__(self):
        import torch

        from echorenderer_tpu_torch.ops import binned_trace as bt
        from echorenderer_tpu_torch.ops import pallas_hier as ph

        self._saved = setup_k, refill_k, select_k, seg_k = (bt.setup_rank, bt.refill, bt.select,
                                                            bt.seg_keys)

        def record(kind, k_ms, p_ms, flops, nbytes, **extra):
            self.rows[kind].append(dict(call=count_of("binned.calls"), ms=k_ms, plain_ms=p_ms,
                                        flops=flops, bound=bound_ms(flops, nbytes), **extra))

        def differ(kind, got, want):
            for g, w in zip(got, want):
                err = int((g.long() - w.long()).abs().max()) if w.numel() else 0
                self.max_err[kind] = max(self.max_err[kind], err)
                if err:
                    raise AssertionError(f"binned {kind} kernel differs from its plain version on "
                                         f"{int((g != w).sum())} of {w.numel()} values")

        def setup(rays, sup_cb, sbits, cap=None):
            want, p_ms = timed(lambda: bt.setup_rank_plain(rays, sup_cb, sbits, cap))
            got, k_ms = timed(lambda: setup_k(rays, sup_cb, sbits, cap))
            differ("setup", (got,), (want,))
            n, s = rays.shape[1], sup_cb.shape[0]
            lib = None
            if self.library:  # the ranking step alone: one row sort of the same keys
                ids = torch.arange(s, dtype=torch.int32, device=rays.device)[None]
                keys = torch.cat([bt._enc(bt._slab_all(r[0:3].T, r[3:6].T, sup_cb, r[6]), ids,
                                          sbits) for r in rays.split(bt.PLAIN_SLICE, dim=1)])
                torch.sort(keys, dim=1)
                lib = timed(lambda: torch.sort(keys, dim=1))[1]
                del keys
            record("setup", k_ms, p_ms, *setup_work(n, s, got.shape[0]), library_ms=lib,
                   shape=(s, got.shape[0]), n=n)
            SHAPE_LAUNCHES.append(("setup", (s, got.shape[0]), self.rows["setup"][-1]))
            return got

        def refill(rays, sup_ord, cursor, best_t, do_refill, next_sup, base, ksup, sbits, cbits):
            args = (rays, sup_ord, cursor, best_t, do_refill, next_sup, base, ksup, sbits, cbits)
            want, p_ms = timed(lambda: bt.refill_plain(*args))
            got, k_ms = timed(lambda: refill_k(*args))
            differ("refill", got, want)
            n = rays.shape[1]
            capped = sup_ord.shape[0] < base.shape[0]
            record("refill", k_ms, p_ms,
                   *refill_work(sup_ord, cursor, best_t, do_refill, base, ksup, sbits), rays=n,
                   refills=int(do_refill.sum()), shape=(ksup, "capped" if capped else "uncapped"),
                   n=n)
            return got

        def select(cand, new_keys, best_t, do_refill, k, cbits):
            copy = cand.clone()
            lib = None
            if self.library and cand.shape[1]:  # the pop step alone, without the distinct rule
                merged = bt._select_merge(copy, new_keys, best_t, do_refill, k, cbits)
                torch.topk(merged, k, dim=0, largest=False)
                lib = timed(lambda: torch.topk(merged, k, dim=0, largest=False))[1]
                del merged
            want, p_ms = timed(lambda: bt.select_plain(copy, new_keys, best_t, do_refill, k,
                                                       cbits))
            got, k_ms = timed(lambda: select_k(cand, new_keys, best_t, do_refill, k, cbits))
            differ("select", (cand,) + tuple(got), (copy,) + tuple(want))
            w, n = cand.shape
            refills = int(do_refill.sum())
            record("select", k_ms, p_ms, *select_work(w, n, k, refills), rays=n, refills=refills,
                   library_ms=lib, shape=(w, k), n=n)
            SHAPE_LAUNCHES.append(("select", (w, k), self.rows["select"][-1]))
            return got

        def seg(rec, chunk, prim_chunks, has_tri, has_sph, inst=None):
            kind = "seg" if inst is None else "seg_instanced"
            want, p_ms = timed(lambda: bt.seg_keys_plain(rec, chunk, prim_chunks, has_tri,
                                                         has_sph, inst))
            got, k_ms = timed(lambda: seg_k(rec, chunk, prim_chunks, has_tri, has_sph,
                                            inst=inst))
            differ(kind, (got,), (want,))
            n_valid = prim_chunks.shape[0] if inst is None else inst[0].shape[0]
            live = (rec[:, 6] > 0.0) & (chunk >= 0) & (chunk < n_valid)
            used = chunk[live].long()
            n_live = int(live.sum())
            extra_flops = extra_bytes = 0
            if inst is not None:  # per live pair a ray transform; per chunk its map
                distinct_g = int(torch.unique(used).numel())
                used = inst[0][used].long()
                extra_flops = FLOPS_XFORM * n_live
                extra_bytes = distinct_g * 8 + inst[2].numel() * 4
            distinct = int(torch.unique(used).numel())
            flops = float(self.chunk_flops[used].sum()) + extra_flops
            rows_bytes = distinct * 10 * prim_chunks.shape[2] * 4 + extra_bytes
            # a live pair reads its record and chunk id (4 B a column, 4 B)
            # and writes its key; a dead one needs only its chunk id and its
            # key (8 B); each distinct pack chunk's 10 used rows once
            record(kind, k_ms, p_ms, flops,
                   n_live * (4 * rec.shape[1] + 4 + 4) + (rec.shape[0] - n_live) * 8 + rows_bytes,
                   pairs=rec.shape[0], live=n_live)
            SEG_LAUNCHES.append((kind, (bool(has_tri), bool(has_sph)), self.rows[kind][-1]))
            # the exact form on the same pairs: bitwise to its plain version,
            # and to the keyed result's hits and bands
            ekind = "seg_exact" if inst is None else "seg_exact_instanced"
            want_e, pe_ms = timed(lambda: bt.seg_hits_plain(rec, chunk, prim_chunks, has_tri,
                                                            has_sph, inst))
            got_e, ke_ms = timed(lambda: bt.seg_hits(rec, chunk, prim_chunks, has_tri, has_sph,
                                                     inst=inst))
            differ(ekind, tuple(x.view(torch.int32) for x in got_e),
                   tuple(x.view(torch.int32) for x in want_e))
            found = got != bt._INT_INF
            if not torch.equal(got_e[1] >= 0, found):
                raise AssertionError(f"binned {ekind}: hit or miss differs from the keyed "
                                     f"kernel on {int(((got_e[1] >= 0) != found).sum())} pairs")
            if not torch.equal(bt._bits(got_e[0])[found] & -256, got[found] & -256):
                raise AssertionError(f"binned {ekind}: a found pair's t is outside its key's band")
            ties = int(((got_e[1][found].long() % ph.HCHUNK) != (got[found] & 0xFF).long()).sum())
            # a live pair reads its record and chunk id and writes 4 floats; a
            # dead one reads its t_max and chunk id and writes 4 floats
            record(ekind, ke_ms, pe_ms, flops,
                   n_live * (4 * rec.shape[1] + 4 + 16) + (rec.shape[0] - n_live) * 24
                   + rows_bytes, pairs=rec.shape[0], live=n_live, ties=ties,
                   found=int(found.sum()))
            SEG_LAUNCHES.append((ekind, (bool(has_tri), bool(has_sph)), self.rows[ekind][-1]))
            return got

        bt.setup_rank, bt.refill, bt.select, bt.seg_keys = setup, refill, select, seg
        return self

    def __exit__(self, *exc):
        from echorenderer_tpu_torch.ops import binned_trace as bt

        bt.setup_rank, bt.refill, bt.select, bt.seg_keys = self._saved

    def summary(self, label, kinds=("setup", "refill", "select", "seg", "seg_exact")):
        """Log per kernel of `kinds`: launches checked, the mean kernel,
        plain and bound ms per launch (each a sum over the launches over
        their count, so the bound share is sum(bound) / sum(ms)), the median
        ms per launch and per call, the largest |kernel - plain|. Returns
        {kernel: dict}."""
        out = {}
        for kind in kinds:
            rows = self.rows[kind]
            if not rows:
                raise AssertionError(f"{label}: no {kind} launch was checked")
            per_call = {}
            for r in rows:
                c = per_call.setdefault(r["call"], [0.0, 0.0])
                c[0] += r["ms"]
                c[1] += r["plain_ms"]
            lib = [r["library_ms"] for r in rows if r.get("library_ms") is not None]
            total = sum(r["ms"] for r in rows)
            total_bound = sum(r["bound"][0] for r in rows)
            by = {}  # the summed bound split by what bounds each launch
            for r in rows:
                by[r["bound"][1]] = by.get(r["bound"][1], 0.0) + r["bound"][0]
            bound_by = max(by, key=by.get)
            out[kind] = dict(
                launches=len(rows), ms=total / len(rows),
                plain_ms=statistics.fmean(r["plain_ms"] for r in rows),
                median_ms=statistics.median(r["ms"] for r in rows),
                median_plain_ms=statistics.median(r["plain_ms"] for r in rows),
                call_ms=statistics.median(c[0] for c in per_call.values()),
                call_plain_ms=statistics.median(c[1] for c in per_call.values()),
                bound_ms=total_bound / len(rows), share=total_bound / total,
                bound_by=bound_by, bound_by_share=by[bound_by] / total_bound,
                flops=statistics.fmean(r["flops"] for r in rows),
                library_ms=statistics.fmean(lib) if lib else None,
                max_abs_err=self.max_err[kind])
            o = out[kind]
            shares = {name: (sum(r[part] for r in rows), sum(r[whole] for r in rows))
                      for name, part, whole in (("live pairs", "live", "pairs"),
                                                ("refilling rays", "refills", "rays"),
                                                ("found pairs whose prim differs from the keyed "
                                                 "kernel's within one band", "ties", "found"))
                      if part in rows[0]}
            if kind in SEG_KINDS:  # where the seg time sits, by live pairs a launch
                edges = (0,) + SEG_BUCKETS + (None,)
                o["buckets"] = []
                for lo, hi in zip(edges, edges[1:]):
                    inb = [r for r in rows if r["live"] >= lo and (hi is None or r["live"] < hi)]
                    b_ms = sum(r["ms"] for r in inb)
                    o["buckets"].append(dict(
                        live=f"{lo}-{hi - 1}" if hi else f">= {lo}", launches=len(inb),
                        share=b_ms / total, ms=b_ms / len(inb) if inb else 0.0,
                        bound_share=sum(r["bound"][0] for r in inb) / b_ms if b_ms else 0.0))
            log(f"[kernels] {label}: binned {kind}: {o['launches']} launches over "
                f"{len(per_call)} calls, each bitwise equal to its plain version (max |diff| "
                f"{o['max_abs_err']}); mean ms per launch {o['ms']:.4f} (plain "
                f"{o['plain_ms']:.4f}), median per launch {o['median_ms']:.4f} (plain "
                f"{o['median_plain_ms']:.4f}), median per call {o['call_ms']:.4f} (plain "
                f"{o['call_plain_ms']:.4f}); mean least float work per launch {o['flops']:.6g}; "
                f"mean bound per launch {o['bound_ms']:.6f} ms ({100 * o['bound_by_share']:.1f}% "
                f"of it from launches bound by {o['bound_by']}), "
                f"{100 * o['share']:.2f}% of the kernel's time"
                + "".join(f"; {name} {a} of {b}" for name, (a, b) in shares.items())
                + (f"; {LIBRARY_CALLS[kind]} {o['library_ms']:.4f} ms per launch" if lib else "")
                + "".join(f"; {name}: {len(rs)} launches on {min(r['n'] for r in rs)}-"
                          f"{max(r['n'] for r in rs)} rays, mean {st_ms / len(rs):.4f} ms, mean "
                          f"bound {st_b / len(rs):.6f} ms, launches x (ms - bound) "
                          f"{st_ms - st_b:.4f} ms"
                          for name, rs, st_ms, st_b in shape_groups(kind, rows))
                + "".join(f"; live pairs {b['live']}: {b['launches']} launches, "
                          f"{100 * b['share']:.1f}% of the time, mean {b['ms']:.4f} ms, "
                          f"{100 * b['bound_share']:.2f}% of bound"
                          for b in o.get("buckets", ())))
        return out


def compare_binned(label, soa, calls):
    """The binned traversal against the hier kernels on every call of
    `calls` ({"trace": [(rays, ignore)], "occlude": [...]}, sorted-slot
    ignores): the same rays hit; equal prims give bitwise equal t, u, v;
    differing prims have t in one band. Occlude flags identical. Returns the
    count of rays whose prims differ."""
    import torch

    from echorenderer_tpu_torch.ops import binned_trace as bt
    from echorenderer_tpu_torch.ops import pallas_hier as ph

    ties = n_hit = n_blocked = 0
    for rays, ig, *extra in calls["trace"]:  # extra: an instanced call's ignore instances
        out = bt._Walk(rays, ig, soa, False, *extra).traverse()
        hout = ph.hier_trace(rays, ig, soa, *extra)
        (t, p, u, v), (ht, hp, hu, hv) = out[:4], hout[:4]
        if not torch.equal(p >= 0, hp >= 0):
            raise AssertionError(f"{label}: binned and hier disagree on hit or miss for "
                                 f"{int(((p >= 0) != (hp >= 0)).sum())} rays")
        same = (p == hp) & (p >= 0)
        if extra:  # the same prim of another instance is another hit
            same &= out[4] == hout[4]
        for name, a, b in (("t", t, ht), ("u", u, hu), ("v", v, hv)):
            if not torch.equal(a[same], b[same]):
                raise AssertionError(f"{label}: binned {name} differs from hier on "
                                     f"{int((a[same] != b[same]).sum())} rays with equal prims")
        diff = ~same & (p >= 0)
        band = lambda x: x.contiguous().view(torch.int32) & -256
        if not torch.equal(band(t[diff]), band(ht[diff])):
            raise AssertionError(f"{label}: binned and hier prims differ beyond one band")
        ties += int(diff.sum())
        n_hit += int((p >= 0).sum())
    for rays, ig, *extra in calls["occlude"]:
        blocked = bt._Walk(rays, ig, soa, True, *extra).traverse()
        want = ph.hier_occlude(rays, ig, soa, *extra)
        if not torch.equal(blocked, want):
            raise AssertionError(f"{label}: binned and hier occlude flags differ on "
                                 f"{int((blocked != want).sum())} rays")
        n_blocked += int(want.sum())
    rays_n = {k: sum(c[0].shape[1] for c in v) for k, v in calls.items()}
    log(f"[kernels] {label}: binned vs hier on {len(calls['trace'])} trace calls "
        f"({rays_n['trace']} rays, {n_hit} hits) and {len(calls['occlude'])} occlude calls "
        f"({rays_n['occlude']} rays, {n_blocked} blocked): same hits and flags, equal prims "
        f"{'and instances ' if soa.instanced else ''}bitwise equal; {ties} rays with another "
        f"prim{' or instance' if soa.instanced else ''} in the same band; "
        f"recovery misses so far {int(bt.STATS['misses'])}")
    return ties


def table_bytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors if x is not None)


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


def dense_calls(soa, rays_np, dev):
    """One trace and one occlude call on the same numpy rays."""
    import numpy as np
    import torch

    from echorenderer_tpu_torch.ops import pallas_intersect as pi

    o, d, t_max, ignore = (torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in rays_np)
    call = (pi.ray_columns(o, d, t_max), pi._sorted_ignore(soa, ignore))
    return dict(trace=[call], occlude=[call])


def soup_42k(rs, dev):
    """The ~42k-prim soup (`synthetic_scene`) in BVH order on `dev`, and its
    2^20 numpy rays: a 1024x512 camera tile-major, then random rays."""
    import numpy as np

    from echorenderer_tpu_torch.aggregation.bvh import build_bvh, geometry_bounds
    from echorenderer_tpu_torch.ops import pallas_intersect as pi

    geom = synthetic_scene(rs)
    bmin, bmax = geometry_bounds(geom)
    order = build_bvh(bmin, bmax).prim_order
    soa = pi.build_prim_soa(geom, order=order,
                            packed=pi.pack_sorted_prims(geom, order, bounds=(bmin, bmax)),
                            device=dev)
    cam = camera_rays(1024, 512, (0.0, 5.0, -40.0))
    rnd = random_rays(rs, N_RAYS - len(cam[0]), [-20, 2, -20], [20, 8, 20], soa.num_prims)
    return soa, [np.concatenate([a, b]) for a, b in zip(cam, rnd)]


def recorded_calls(scene, res, spp, bounce) -> dict:
    """The dense (or walk) calls of one render_layer epoch of `scene` at
    `res`, `spp` samples, bounce limit `bounce`, recorded as RayWork
    records them."""
    from echorenderer_tpu_torch.processes.render import EvaluationProfile, render_layer

    prof = EvaluationProfile(samples_per_epoch=spp, max_epoch=1, bounce_limit=bounce,
                             survivability=2.5, adaptive=False)
    with RayWork(cull=True, record=True) as rec:
        render_layer(scene, prof, res)
    return rec.calls


def dense_entry(lib, kind, soa, calls):
    """fn() running the C entry dense_trace or dense_occlude (`kind`) of
    `lib` (a csrc/dense_intersect.cu library) on every call of `calls`,
    back to back, into outputs allocated once; it returns the outputs
    [(t, prim, u, v)] or [blocked]."""
    import torch

    from echorenderer_tpu_torch.ops import pallas_intersect as pi

    stream = torch.cuda.current_stream().cuda_stream
    prepared = []
    for rays, ig in calls:
        n = rays.shape[1]
        if kind == "trace":
            outs = (torch.empty(n, device=rays.device), torch.empty(n, dtype=torch.int32,
                                                                    device=rays.device),
                    torch.empty(n, device=rays.device), torch.empty(n, device=rays.device))
        else:
            outs = (torch.empty(n, dtype=torch.bool, device=rays.device),)
        prepared.append((pi._kernel_args(rays, ig, soa), outs))
    entry = lib.dense_trace if kind == "trace" else lib.dense_occlude

    def run():
        for args, outs in prepared:
            err = entry(*args, *(x.data_ptr() for x in outs), stream)
            if err:
                raise RuntimeError(f"the dense {kind} C entry failed: cudaError {err}")
        return [outs if kind == "trace" else outs[0] for _, outs in prepared]
    return run


def entry_ms(fn, runs: int = 10) -> float:
    """Median ms of `runs` runs of fn (a run of C entries), each after a
    warm-up run and with the card spinning SLEEP_CYCLES first, so that
    the events time the launches and not the host's first call."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def dense_form_report(label, kind, soa, launches, ms, entry, bound, smi) -> str:
    """One "[dense]" line: a dense kernel form on a set of calls: ptxas
    registers / stack frame / spills, dynamic smem a block, resident
    warps/SM and what caps them; the wrapper's and the C entry's ms a
    launch, the bound, % of bound and launches x (ms - bound)."""
    from echorenderer_tpu_torch.ops import pallas_intersect as pi

    kinds = (soa.num_tris > 0, soa.num_prims > soa.num_tris)
    occ = pi.occupancy(kind == "occlude", *kinds)
    ptxas = DENSE_PTXAS[(kind == "occlude", *kinds)]
    name = (f"{kind}_kernel<{', '.join(str(b).lower() for b in kinds)}>")
    line = (f"{name}, {label}: {ptxas}; {occ['smem']} bytes dynamic smem a {occ['block']}-thread "
            f"block, {occ['blocks']} blocks = {occ['warps']} resident warps/SM, capped by "
            f"{occupancy_cap(occ, ptxas)}; {launches} launches: the wrapper {ms:.4f} ms a call "
            f"= {100.0 * bound / ms:.3f}% of bound, the C entry {entry:.4f} ms a launch = "
            f"{100.0 * bound / entry:.3f}% of bound, bound {bound:.6f} ms; launches x (ms - "
            f"bound): wrapper {launches * (ms - bound):.4f} ms, C entry "
            f"{launches * (entry - bound):.4f} ms | {smi}")
    DENSE_REPORTS.append(line)
    return line


def compare_dense(label, soa, calls, plain_runs, smi=""):
    """Dense kernels against their plain versions on every call of
    `calls` ({"trace": [(rays, ignore)], "occlude": [...]}): identical ids
    and flags, t/u/v to RTOL; then the C entry alone on the same calls, its
    outputs bitwise equal to the wrapper's. Returns ({kernel: max_abs_err},
    {timing: median ms per call or launch}, {kernel: (mean bound ms per
    call, by)})."""
    import torch

    from echorenderer_tpu_torch.ops import pallas_intersect as pi

    err = dict(trace=0.0, occlude=0.0)
    n_hit = n_blocked = 0
    tables = table_bytes(soa.rows, soa.chunk_bounds, soa.super_bounds)
    least = dict(trace=[], occlude=[])  # per call: float ops, bound
    for rays, ig in calls["trace"]:
        kt = pi.dense_trace(rays, ig, soa)
        pt = pi.dense_trace_plain(rays, ig, soa)
        if not torch.equal(kt[1], pt[1]):
            bad = int((kt[1] != pt[1]).sum())
            raise AssertionError(f"{label}: dense_trace prim ids differ on {bad} of "
                                 f"{len(pt[1])} rays")
        hit = pt[1] >= 0
        for name, k, p in (("t", kt[0][hit], pt[0][hit]), ("u", kt[2], pt[2]),
                           ("v", kt[3], pt[3])):
            torch.testing.assert_close(k, p, rtol=RTOL, atol=0.0,
                                       msg=lambda m: f"{label} {name}: {m}")
            err["trace"] = max(err["trace"], float((k - p).abs().max()) if k.numel() else 0.0)
        n_hit += int(hit.sum())
        flops = least_flops(soa, rays, ig, t_end=kt[0])
        least["trace"].append((flops, bound_ms(flops, rays.shape[1] * (32 + 16) + tables)))
    for rays, ig in calls["occlude"]:
        kb = pi.dense_occlude(rays, ig, soa)
        pb = pi.dense_occlude_plain(rays, ig, soa)
        if not torch.equal(kb, pb):
            bad = int((kb != pb).sum())
            raise AssertionError(f"{label}: dense_occlude flags differ on {bad} rays")
        err["occlude"] = max(err["occlude"], float((kb.int() - pb.int()).abs().max()))
        n_blocked += int(pb.sum())
        flops = least_flops(soa, rays, ig)
        least["occlude"].append((flops, bound_ms(flops, rays.shape[1] * (32 + 1) + tables)))

    def each(fn, kind):
        return lambda: [fn(rays, ig, soa) for rays, ig in calls[kind]]

    per = {k: len(v) for k, v in calls.items()}
    ms = dict(
        trace=median_ms(each(pi.dense_trace, "trace")) / per["trace"],
        trace_plain=median_ms(each(pi.dense_trace_plain, "trace"), plain_runs,
                              False) / per["trace"],
        occlude=median_ms(each(pi.dense_occlude, "occlude")) / per["occlude"],
        occlude_plain=median_ms(each(pi.dense_occlude_plain, "occlude"), plain_runs,
                                False) / per["occlude"],
    )
    for kind in ("trace", "occlude"):
        run = dense_entry(pi._load(), kind, soa, calls[kind])
        got, want = run(), each(getattr(pi, f"dense_{kind}"), kind)()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for g, w in zip(got, want)
                   for a, b in zip(g if kind == "trace" else (g,), w if kind == "trace" else (w,))):
            raise AssertionError(f"{label}: the dense {kind} C entry differs from the wrapper")
        ms[f"{kind}_entry"] = entry_ms(run) / per[kind]
    bounds = {k: (statistics.fmean(b[0] for _, b in v), statistics.mode(b[1] for _, b in v))
              for k, v in least.items()}
    flops = {k: statistics.fmean(f for f, _ in v) for k, v in least.items()}
    rays = {k: sum(r.shape[1] for r, _ in v) for k, v in calls.items()}
    log(f"[kernels] {label}: {per['trace']} trace calls on {rays['trace']} rays, "
        f"{per['occlude']} occlude calls on {rays['occlude']} rays; {soa.padded} padded "
        f"prims, {soa.n_chunks} chunks, {soa.n_super} superchunks; {n_hit} hits, {n_blocked} "
        f"blocked; identical ids/flags, max |t,u,v err| {err['trace']:.3g} (rtol {RTOL})")
    log(f"[kernels] {label}: median ms per call (kernels over 10 runs, plain over "
        f"{plain_runs}; _entry: the C entry alone, a launch): "
        + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
        + f"; least prim-test work per call: trace {flops['trace']:.6g}, occlude "
          f"{flops['occlude']:.6g} flops; bound per call: trace {bounds['trace'][0]:.6f} "
          f"({bounds['trace'][1]}), occlude {bounds['occlude'][0]:.6f} "
          f"({bounds['occlude'][1]})")
    for kind in ("trace", "occlude"):
        log("[kernels]   " + dense_form_report(label, kind, soa, per[kind], ms[kind],
                                               ms[f"{kind}_entry"], bounds[kind][0], smi))
    return err, ms, bounds


def compare_hier(label, soa, calls):
    """Hier kernels against their plain versions on every call of `calls`
    ({"trace": [(rays, ignore)], "occlude": [...]}), the plain version on a
    strided subset of HIER_SUBSET rays of each call: identical ids, flags
    and t/u/v bit for bit. Returns ({kernel: max_abs_err}, {timing: ms per
    call; the plain version's per subset}, {kernel: (mean bound ms per
    call, by)})."""
    import torch

    from echorenderer_tpu_torch.ops import pallas_hier as ph

    err = dict(trace=0.0, occlude=0.0)
    n_hit = n_blocked = n_checked = 0
    plain_ms = dict(trace=0.0, occlude=0.0)
    inst = soa.instanced  # calls then carry the ignores' instances; hits report theirs
    tables = soa.padded * 10 * 4 + table_bytes(soa.bounds, soa.codes)  # 10 used rows, nodes
    if inst:
        tables += table_bytes(soa.inst_f32, soa.inst_codes)
    least = dict(trace=[], occlude=[])
    for kind in ("trace", "occlude"):
        kernel = ph.hier_trace if kind == "trace" else ph.hier_occlude
        plain = ph.hier_trace_plain if kind == "trace" else ph.hier_occlude_plain
        for rays, ig, *extra in calls[kind]:
            stride = -(-rays.shape[1] // HIER_SUBSET)
            sub = [rays[:, ::stride].contiguous()] + [x[::stride].contiguous()
                                                     for x in (ig, *extra)]
            got = kernel(rays, ig, soa, *extra)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = plain(sub[0], sub[1], soa, *sub[2:])
            torch.cuda.synchronize()
            plain_ms[kind] += (time.perf_counter() - t0) * 1e3
            n_checked += sub[0].shape[1]
            if kind == "trace":
                for name, k, p in zip("tpuvi", got, want):
                    k = k[::stride]
                    if not torch.equal(k, p):
                        bad = int((k != p).sum())
                        raise AssertionError(f"{label}: hier_trace {name} differs on {bad} of "
                                             f"{p.numel()} rays")
                    if k.dtype == torch.float32 and k.numel():
                        err[kind] = max(err[kind], float((k - p).abs().max()))
                n_hit += int((want[1] >= 0).sum())
                t, prim = got[0], got[1]
            else:
                if not torch.equal(got[::stride], want):
                    bad = int((got[::stride] != want).sum())
                    raise AssertionError(f"{label}: hier_occlude flags differ on {bad} rays")
                n_blocked += int(want.sum())
                t, prim = ph.hier_trace(rays, ig, soa, *extra)[:2]  # the nearest blocker
            t_end = torch.where(prim >= 0, t, rays[6])
            flops = (least_flops_instanced if inst else least_flops_hier)(soa, rays, t_end)
            out_bytes = (20 if inst else 16) if kind == "trace" else 1
            in_bytes = 36 if inst else 32
            least[kind].append((flops, bound_ms(flops, rays.shape[1] * (in_bytes + out_bytes)
                                                + tables)))

    def each(fn, kind):
        return lambda: [fn(c[0], c[1], soa, *c[2:]) for c in calls[kind]]

    per = {k: len(v) for k, v in calls.items()}
    runs = {k: run_ms(each(fn, k)) for k, fn in (("trace", ph.hier_trace),
                                                 ("occlude", ph.hier_occlude))}
    ms = dict(trace=statistics.median(runs["trace"]) / per["trace"],
              trace_mean=statistics.fmean(runs["trace"]) / per["trace"],
              trace_plain=plain_ms["trace"] / per["trace"],
              occlude=statistics.median(runs["occlude"]) / per["occlude"],
              occlude_mean=statistics.fmean(runs["occlude"]) / per["occlude"],
              occlude_plain=plain_ms["occlude"] / per["occlude"])
    bounds = {k: (statistics.fmean(b[0] for _, b in v), statistics.mode(b[1] for _, b in v))
              for k, v in least.items()}
    flops = {k: statistics.fmean(f for f, _ in v) for k, v in least.items()}
    rays = {k: sum(c[0].shape[1] for c in v) for k, v in calls.items()}
    log(f"[kernels] {label}: {per['trace']} trace calls on {rays['trace']} rays, "
        f"{per['occlude']} occlude calls on {rays['occlude']} rays; {soa.padded} padded prims, "
        f"{soa.num_chunks} chunks, {soa.codes.numel() // 2} nodes, stack {soa.stack_size} of "
        f"{ph.MAX_STACK}; plain version on {n_checked} rays (a {HIER_SUBSET}-ray strided subset "
        f"of each call): {n_hit} hits, {n_blocked} blocked, ids/flags/t/u/v bitwise equal "
        f"(max |t,u,v err| {err['trace']:.3g})")
    log(f"[kernels] {label}: ms per full call (one launch), median / mean of 10 runs: trace "
        f"{ms['trace']:.4f} / {ms['trace_mean']:.4f}, occlude {ms['occlude']:.4f} / "
        f"{ms['occlude_mean']:.4f}; plain ms per subset call (1 run): trace "
        f"{ms['trace_plain']:.4f}, occlude {ms['occlude_plain']:.4f}; least prim-test work per "
        f"call: trace {flops['trace']:.6g}, occlude {flops['occlude']:.6g} flops; bound per "
        f"call: trace {bounds['trace'][0]:.6f} ({bounds['trace'][1]}), occlude "
        f"{bounds['occlude'][0]:.6f} ({bounds['occlude'][1]})")
    kinds = soa.num_tris > 0, soa.num_prims > soa.num_tris
    for kind, any_hit in (("trace", False), ("occlude", True)):
        log(f"[kernels] {label}: " + walk_form_report(
            f"hier_kernel {kind}{'[instanced]' if inst else ''}", ms[kind], bounds[kind][0],
            ph.occupancy(any_hit, inst, *kinds), WALK_PTXAS[(*kinds, any_hit, inst)]))
    return err, ms, bounds


def renders_against_dense(scene, res, spp, bounce):
    """One frame through the main dispatch (the first wave on the walk, the
    rest binned), through the hier kernels alone (`scene_ops.walk_only`) and
    through the dense kernels: hier = dense bitwise. Binned vs dense: the
    mean image within MEGA_TOL, and every pixel outside MEGA_TOL's per-pixel
    tolerance must own a ray on which binned kept another prim than the
    walk in the same band (its path diverges from there). The frame must
    stay under the liveness cascade's threshold, so that a call's ray i is
    lane i. Fourth, the same frame through the megakernel's chunk-tree form
    against its plain version, the wavefront on the walk alone, on the same
    lanes: bitwise. Returns compare_mega_hier's result."""
    import torch

    from echorenderer_tpu_torch.evaluation import scene_ops
    from echorenderer_tpu_torch.evaluation.wavefront import cascade_widths
    from echorenderer_tpu_torch.ops import binned_trace as bt
    from echorenderer_tpu_torch.ops import pallas_hier as ph
    from echorenderer_tpu_torch.processes.render import _sample_frame
    from echorenderer_tpu_torch.processes.tiles import lane_order

    counts = lambda: (count_of("launches.binned_seg"),
                      count_of("launches.walk_trace") + count_of("launches.walk_occlude"),
                      count_of("launches.dense_trace") + count_of("launches.dense_occlude"))
    sums, grew = [], []
    saved = scene_ops.HIER_TRACE_MIN
    try:
        for dispatch in ("binned", "walk", "dense"):
            scene_ops.HIER_TRACE_MIN = 2 ** 31 if dispatch == "dense" else saved
            before = counts()
            t0 = time.perf_counter()
            # only the binned render's calls are recorded (RayWork would also
            # count the dense render's least work, which nothing reads here)
            with (RayWork(cull=True, record=True) if dispatch == "binned"
                  else contextlib.nullcontext()) as rec, (
                    scene_ops.walk_only() if dispatch == "walk" else contextlib.nullcontext()):
                sums.append(_sample_frame(scene, "path", res, 0, 0, spp, bounce, 2.5))
            torch.cuda.synchronize()
            grew.append([a - b for a, b in zip(counts(), before)] + [time.perf_counter() - t0])
            if dispatch == "binned":
                calls = rec.binned
    finally:
        scene_ops.HIER_TRACE_MIN = saved
    (bs, bq), (hs, hq), (ds, dq) = sums
    n = bs.shape[0]
    differ = int(((hs != ds) | (hq != dq)).any(dim=-1).sum())
    # the pixels of the rays on which binned keeps another prim in the band
    perm = torch.as_tensor(lane_order(res)[0].astype("int64"), device=bs.device)
    tie_px = torch.zeros(n, dtype=torch.bool, device=bs.device)
    ties = 0
    for rays, ig in calls["trace"]:
        if cascade_widths(rays.shape[1]):
            raise AssertionError("the render check's frame must stay under the cascade")
        p = bt._Walk(rays, ig, scene.hier_soa, False).traverse()[1]
        other = (p != ph.hier_trace(rays, ig, scene.hier_soa)[1]).nonzero().squeeze(1)
        tie_px[perm[other % n]] = True
        ties += other.numel()
    compare_binned("sphere_grid(250k) render's binned calls", scene.hier_soa, calls)
    t = MEGA_TOL
    close = ((bs - ds).abs() <= t["sum_atol"] + t["sum_rtol"] * ds.abs()) & (
        (bq - dq).abs() <= t["sq_atol"] + t["sq_rtol"] * dq.abs())
    outside = ~close.all(dim=-1)
    unexplained = int((outside & ~tie_px).sum())
    mean_diff = float(((bs - ds) / spp).mean(dim=0).abs().max())
    b_differ = int(((bs != ds) | (bq != dq)).any(dim=-1).sum())
    log(f"[kernels] renders: {scene.geometry.num_primitives} prims {res[0]}x{res[1]} {spp} spp "
        f"bounce {bounce}: hier vs dense {differ} of {n} pixels not bitwise equal; binned "
        f"dispatch vs dense {b_differ} pixels not bitwise equal, {int(outside.sum())} outside "
        f"the per-pixel tolerance (share within {1 - float(outside.float().mean()):.6f}), "
        f"{ties} band-tie rays on {int(tie_px.sum())} pixels, {unexplained} pixels outside "
        f"tolerance without a band tie (need 0), mean image |diff| {mean_diff:.3g} "
        f"(< {t['mean']})")
    for label, g in zip(("binned dispatch", "hier", "dense"), grew):
        log(f"[kernels]   {label} render {g[3]:.3f} s: {g[0]} seg, {g[1]} hier, {g[2]} dense "
            f"launches")
    if differ or grew[1][1] == 0 or grew[1][2] or grew[2][1] or grew[2][2] == 0:
        raise AssertionError("hier and dense renders differ or took the wrong kernels")
    if unexplained or not mean_diff < t["mean"]:
        raise AssertionError("the binned render disagrees with the dense render")
    if grew[0][0] == 0 or grew[0][1] == 0 or grew[0][2]:
        raise AssertionError("the main dispatch's render did not take the binned and hier kernels")
    return compare_mega_hier(f"sphere_grid(250k) {res[0]}x{res[1]}", scene, res, spp, bounce,
                             bitwise=True)


def hier_path_work(soa, calls) -> float:
    """The least float work of the prim tests of recorded walk calls
    ({"trace": [(rays, ignore)], "occlude": [...]}): `least_flops_hier` up
    to each ray's hit, nearest blocker or t_max (found with the hier trace
    kernel, whose launches here are not the main path's)."""
    import torch

    from echorenderer_tpu_torch.ops import pallas_hier as ph

    total = 0.0
    for kind in ("trace", "occlude"):
        for rays, ig in calls[kind]:
            t, prim = ph.hier_trace(rays, ig, soa)[:2]
            total += least_flops_hier(soa, rays, torch.where(prim >= 0, t, rays[6]))
    return total


def compare_mega_hier(label, scene, res, spp, bounce, bitwise, start=0, kernel_runs=10):
    """The megakernel's chunk-tree form against its plain version (the
    wavefront with every wave on the walk) on the same tile-major lanes,
    seed 0, first sample `start`: pixels not bitwise equal (with `bitwise`
    they must be 0) and MEGA_TOL; the kernel's median ms over
    `kernel_runs` launches, the plain version's ms (1 run), and the bound:
    the least prim-test work of the plain run's recorded walk calls
    (`hier_path_work`: the kernel traces the same rays) over 67 TFLOP/s, or
    the bytes (lanes in, sums out, the tables once) over 3.35 TB/s. Returns
    (max_abs_err, {ms, plain_ms}, bound, (kernel sums, sums of squares))."""
    import torch

    from echorenderer_tpu_torch.evaluation import scene_ops
    from echorenderer_tpu_torch.evaluation.wavefront import run_wavefront
    from echorenderer_tpu_torch.ops import megakernel as mk

    dev = scene.device
    pid, pxy = tile_lanes(res, dev)
    n = pid.shape[0]
    kw = dict(bounce_limit=bounce, survivability=2.5)
    soa = scene.hier_soa
    kernel = lambda: mk.sample_frame_mega(scene, pid, pxy, res, 0, start, spp, hier=True, **kw)
    t0 = time.perf_counter()
    ks, kq = kernel()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    (ps, pq), plain_ms = timed(lambda: mk.sample_frame_mega_plain(scene, pid, pxy, res, 0, start,
                                                                  spp, hier=True, **kw))
    with scene_ops.walk_only(), RayWork(cull=True, record=True) as rec:
        _, _, stats = run_wavefront(scene, pid, pxy, res, 0, start, spp, return_stats=True, **kw)
    if rec.binned["trace"] or rec.binned["occlude"]:
        raise AssertionError(f"{label}: the plain version took the binned traversal")
    flops = hier_path_work(soa, rec.calls)
    n_calls = len(rec.calls["trace"]) + len(rec.calls["occlude"])
    del rec
    if not bool(torch.isfinite(ks).all()) or float(ks.sum()) <= 0.0:
        raise AssertionError(f"{label}: chunk-tree megakernel sums non-finite or black")
    t = MEGA_TOL
    close = ((ks - ps).abs() <= t["sum_atol"] + t["sum_rtol"] * ps.abs()) & (
        (kq - pq).abs() <= t["sq_atol"] + t["sq_rtol"] * pq.abs())
    ok_px = close.all(dim=-1)
    differ = int((~((ks == ps) & (kq == pq)).all(dim=-1)).sum())
    share = float(ok_px.float().mean())
    mean_diff = float(((ks - ps) / spp).mean(dim=0).abs().max())
    err = float((ks - ps).abs().max())
    ms = median_ms(kernel, kernel_runs)
    tables = [x for x in mk._build_tables(scene, hier=True) if isinstance(x, torch.Tensor)]
    bound = bound_ms(flops, n * (16 + 24) + soa.padded * 10 * 4
                     + table_bytes(soa.bounds, soa.codes, *tables))
    log(f"[kernels] megakernel chunk-tree form, {label}: {n} pixels {spp} spp bounce {bounce}: "
        f"{differ} pixels not bitwise equal to its plain version (the wavefront on the walk, "
        f"{n_calls} walk calls, {stats['Ray/Traced']:.0f} traced + {stats['Ray/Shadow']:.0f} "
        f"shadow rays), {n - int(ok_px.sum())} outside tolerance (share within {share:.6f}, "
        f"need >= {t['share']}), mean image |diff| {mean_diff:.3g} (< {t['mean']}), max |sum "
        f"diff| {err:.3g}; first launch {first_s:.3f} s incl. table build")
    log(f"[kernels] megakernel chunk-tree form, {label}: median ms over {kernel_runs} launches "
        f"{ms:.4f}, plain {plain_ms:.4f} (1 run, {plain_ms / ms:.2f}x); least prim-test work "
        f"{flops:.6g} flops; bound {bound[0]:.6f} ms ({bound[1]}); "
        f"{n * spp / ms / 1e3:.4f} Mspps in the kernel alone")
    log(f"[kernels] megakernel chunk-tree form, {label}: " + walk_form_report(
        "mega_kernel<false, true>", ms, bound[0], mk.hier_occupancy(), WALK_PTXAS["mega"]))
    if (bitwise and differ) or share < t["share"] or not mean_diff < t["mean"]:
        raise AssertionError(f"the chunk-tree megakernel disagrees with its plain version on "
                             f"{label}")
    return err, dict(ms=ms, plain_ms=plain_ms), bound, (ks, kq)


def with_hier_tables(scene):
    """`scene` with its chunk-tree tables built directly, as
    tests/test_megakernel.py builds them (prepare builds them from 16,384
    prims on; a chunk tree needs more than one 256-prim chunk)."""
    from echorenderer_tpu_torch.aggregation.bvh import build_bvh, geometry_bounds
    from echorenderer_tpu_torch.ops import pallas_hier as ph

    geom = {k: v.cpu().numpy() for k, v in scene.geometry._asdict().items()}
    order = build_bvh(*geometry_bounds(geom)).prim_order
    return scene._replace(hier_soa=ph.build_hier_soa(geom, order, device=scene.device))


def gate_keeps_wavefront(dev, prof):
    """Under ECHO_MEGA_HIER, scenes outside the chunk-tree form's envelope
    take the wavefront: sphere_grid(20_000) (chunk-tree tables, outside the
    dense envelope) under a cloud-textured plane, and the TLAS scene
    instanced_grid(side=3), each rendered at 320x180, 8 spp; then the same
    sphere_grid(20_000) untextured must take the chunk-tree form."""
    import os

    import numpy as np

    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.ops import megakernel as mk
    from echorenderer_tpu_torch.processes.render import render_layer
    from echorenderer_tpu_torch.scene import Diffuse, PlaneEntity
    from echorenderer_tpu_torch.scene.prepare import prepare_scene
    from echorenderer_tpu_torch.textures import CloudTexture

    textured = scenes.sphere_grid(20_000)
    textured.add(PlaneEntity(size=(4, 4), position=(0, 6, 0),
                             material=Diffuse(albedo=CloudTexture(scale=4.0, seed=5))))
    cases = [("sphere_grid(20_000) + a textured plane", prepare_scene(textured, device=dev),
              "wavefront"),
             ("instanced_grid(side=3), TLAS",
              prepare_scene(scenes.instanced_grid(side=3), instancing="tlas", device=dev),
              "wavefront"),
             ("sphere_grid(20_000)", prepare_scene(scenes.sphere_grid(20_000), device=dev),
              "megakernel-hier")]
    os.environ["ECHO_MEGA_HIER"] = "1"
    try:
        for label, scene, want in cases:
            zero_launch_counts()
            image, info = render_layer(scene, prof, (320, 180))
            hier = count_of("launches.mega_hier")
            d = info["dispatch"]
            log(f"[kernels] under ECHO_MEGA_HIER: {label} ({scene.tex_atlas.shape[0]} atlas "
                f"textures) 320x180 8 spp via {d['integrator']} ({d['integrator_reason']}), "
                f"chunk-tree form's reason {mk.unsupported_hier_reason(scene)!r}; launches "
                f"{launch_counts()}")
            if (d["integrator"] != want or (hier > 0) != (want == "megakernel-hier")
                    or not np.isfinite(image).all()):
                raise AssertionError(f"{label} under ECHO_MEGA_HIER did not take the {want}")
    finally:
        del os.environ["ECHO_MEGA_HIER"]


def tile_lanes(res, dev):
    """The main path's lanes: tile-major pixel ids and their coordinates."""
    import numpy as np
    import torch

    from echorenderer_tpu_torch.processes.tiles import lane_order

    perm, _ = lane_order(res)
    pid = torch.as_tensor(perm.astype(np.int64), device=dev)
    pxy = torch.stack([pid % res[0], pid // res[0]], dim=-1).to(torch.int32)
    return pid, pxy


def compare_mega(label, scene, res, spp, bounce, dev, seed=0):
    """The megakernel against its plain version (the wavefront) on one
    frame; returns (max_abs_err, timings, bound). The plain version's ms is
    that of the compared run (CUDA events; its counters on, its calls
    kept for the least-work count, which follows the run)."""
    import torch

    from echorenderer_tpu_torch.evaluation.wavefront import run_wavefront
    from echorenderer_tpu_torch.ops import megakernel as mk

    pid, pxy = tile_lanes(res, dev)
    n = pid.shape[0]
    kw = dict(bounce_limit=bounce, survivability=2.5)
    t0 = time.perf_counter()
    ks, kq = mk.sample_frame_mega(scene, pid, pxy, res, seed, 0, spp, **kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    # the megakernel tests every prim for a traced ray, and the prims up to
    # the first blocker for a shadow ray: count that on the plain run's rays
    with RayWork(cull=False, defer=True) as work:
        (ps, pq, stats), plain_ms = timed(lambda: run_wavefront(
            scene, pid, pxy, res, seed, 0, spp, return_stats=True, **kw))
    work.finish()
    if not bool(torch.isfinite(ks).all()) or float(ks.sum()) <= 0.0:
        raise AssertionError(f"{label}: megakernel sums non-finite or black")
    t = MEGA_TOL
    close_s = (ks - ps).abs() <= t["sum_atol"] + t["sum_rtol"] * ps.abs()
    close_q = (kq - pq).abs() <= t["sq_atol"] + t["sq_rtol"] * pq.abs()
    ok_px = (close_s & close_q).all(dim=-1)
    exact_px = ((ks == ps) & (kq == pq)).all(dim=-1)
    share = float(ok_px.float().mean())
    mean_diff = float(((ks - ps) / spp).mean(dim=0).abs().max())
    err = float((ks - ps).abs().max())
    log(f"[kernels] megakernel {label}: {n} pixels {spp} spp bounce {bounce}: "
        f"{n - int(exact_px.sum())} pixels not bitwise equal, {n - int(ok_px.sum())} outside "
        f"tolerance (share within {share:.6f}, need >= {t['share']}), mean image |diff| "
        f"{mean_diff:.3g} (< {t['mean']}), max |sum diff| {err:.3g}; first launch "
        f"{first_s:.3f} s incl. load")
    if share < t["share"] or not mean_diff < t["mean"]:
        raise AssertionError(f"megakernel {label} disagrees with the wavefront")
    if not bool(exact_px.all()):  # the path pool runs the plain version's ops in its order
        raise AssertionError(f"megakernel {label}: {n - int(exact_px.sum())} pixels not "
                             f"bitwise equal to the wavefront")
    ms = median_ms(lambda: mk.sample_frame_mega(scene, pid, pxy, res, seed, 0, spp, **kw))
    flops = work.flops["trace"] + work.flops["occlude"]
    tables = [x for x in mk._build_tables(scene) if isinstance(x, torch.Tensor)]
    bound = bound_ms(flops, n * (16 + 24) + table_bytes(scene.prim_soa.rows, *tables))
    log(f"[kernels] megakernel {label}: median ms (kernel over 10 runs, plain: the compared "
        f"run): kernel {ms:.4f}, plain {plain_ms:.4f} ({plain_ms / ms:.1f}x); "
        f"{work.rays['trace']} traced + {work.rays['occlude']} shadow rays (wavefront "
        f"counters {stats['Ray/Traced']:.0f} + {stats['Ray/Shadow']:.0f}); least prim-test "
        f"work {work.flops['trace']:.6g} + {work.flops['occlude']:.6g} flops; bound "
        f"{bound[0]:.6f} ms ({bound[1]}); {n * spp / ms / 1e3:.3f} Mspps in the kernel alone")
    log(f"[kernels] megakernel {label}: " + mega_form_report(label, scene, n, spp, ms,
                                                              bound[0]))
    return err, dict(ms=ms, plain_ms=plain_ms), bound


def golden_phase(dev):
    import numpy as np

    from echorenderer_tpu_torch.evaluation.wavefront import run_wavefront
    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.processes.render import _sample_frame
    from echorenderer_tpu_torch.scene.prepare import prepare_scene

    cfg = {  # as tests/test_golden.py configures them
        "cornell": (scenes.cornell_box, (32, 24), 8, 4),
        "spheres": (lambda: scenes.sphere_field(80), (32, 18), 4, 6),
    }
    counts = lambda: (count_of("launches.mega"), count_of("launches.dense_trace"),
                      count_of("launches.dense_occlude"))
    for name, (maker, res, spp, bounce) in cfg.items():
        scene = prepare_scene(maker(), device=dev)
        ref = np.load(REPO / "tests" / "golden" / f"{name}.npy")
        pid, pxy = tile_lanes(res, dev)
        inv = pid.argsort()
        for path in ("megakernel", "wavefront"):
            before = counts()
            if path == "megakernel":
                s_sum, _ = _sample_frame(scene, "path", res, 0, 0, spp, bounce, 2.5)
            else:
                s_sum, _ = run_wavefront(scene, pid, pxy, res, 0, 0, spp, bounce_limit=bounce)
                s_sum = s_sum[inv]
            grew = [a - b for a, b in zip(counts(), before)]
            img = (s_sum.cpu().numpy() / spp).reshape(res[1], res[0], 3)
            diff = np.abs(img - ref).mean()
            mean_diff = abs(img.mean() - ref.mean())
            log(f"[golden] {name} via {path}: mean |diff| {diff:.3g} (< 5e-3), |mean diff| "
                f"{mean_diff:.3g} (< 2e-3), launches megakernel {grew[0]} trace {grew[1]} "
                f"occlude {grew[2]}")
            if not (diff < 5e-3 and mean_diff < 2e-3):
                raise AssertionError(f"golden {name} via {path} out of tolerance")
            want = grew[0] > 0 and grew[1] == 0 if path == "megakernel" else (
                grew[0] == 0 and min(grew[1:]) > 0)
            if not want:
                raise AssertionError(f"golden {name} did not go through the {path} kernels")


def timed_programs(program, count: int = 8):
    """A warm-up and `count` timed programs (sample_start 1..count):
    (seconds, warm-up seconds, first sums, last sums)."""
    import torch

    t0 = time.perf_counter()
    program(0)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    secs, first_sum = [], None
    for i in range(count):
        t0 = time.perf_counter()
        out, _ = program(i + 1)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        first_sum = out if first_sum is None else first_sum
    return secs, warm, first_sum, out


def zero_launch_counts():
    """Every host counter of the port (launches, binned rounds and calls,
    host reads) and the binned traversal's recovery misses to 0."""
    from echorenderer_tpu_torch.ops import binned_trace as bt
    from echorenderer_tpu_torch.utils import diagnostics

    diagnostics.reset_counts()
    bt.STATS["misses"] = 0


# launch_counts()' keys and the counters they read
LAUNCH_COUNTERS = dict(
    hier_trace="walk_trace", hier_occlude="walk_occlude", hier_trace_inst="walk_trace_instanced",
    hier_occlude_inst="walk_occlude_instanced", setup="binned_setup", select="binned_select",
    seg="binned_seg", seg_inst="binned_seg_instanced", seg_exact="binned_seg_exact",
    seg_exact_inst="binned_seg_exact_instanced", dense_trace="dense_trace",
    dense_occlude="dense_occlude", mega="mega", mega_textured="mega_textured",
    mega_hier="mega_hier")


def launch_counts() -> dict:
    return {k: count_of(f"launches.{c}") for k, c in LAUNCH_COUNTERS.items()}


INSTANCED_PATH = ("hier_trace_inst", "hier_occlude_inst", "setup", "select", "seg_inst")


def thousand_instances():
    """tests/test_instancing.py's 1,000 placements of a two-sphere pack
    (RandomState(7)) under an ambient light."""
    import numpy as np

    from echorenderer_tpu_torch import scene as sc

    pack = sc.EntityPack()
    pack.add(sc.SphereEntity(radius=0.5, material=sc.Diffuse(albedo=(0.9, 0.2, 0.2))))
    pack.add(sc.SphereEntity(radius=0.25, material=sc.Diffuse(albedo=(0.2, 0.2, 0.9)),
                             position=(0, 0.9, 0)))
    scene = sc.Scene()
    rs = np.random.RandomState(7)
    for _ in range(1000):
        scene.add(sc.PackInstance(pack, position=tuple(rs.uniform(-50, 50, 3)),
                                  scale=float(rs.uniform(0.5, 1.5))))
    scene.add(sc.AmbientLight(intensity=(1, 1, 1)))
    scene.add(sc.PerspectiveCamera(position=(0, 0, -120)))
    return scene


def tie_pixels(soa, calls, res):
    """Pixels whose rays in `calls` (the binned calls of one frame under the
    liveness cascade: call ray i is lane i, whose pixel is lane i modulo
    the pixel count, one sample chain after another) keep another prim, or
    another instance, than the walk in the same band; and the count of such
    rays."""
    import torch

    from echorenderer_tpu_torch.evaluation.wavefront import cascade_widths
    from echorenderer_tpu_torch.ops import binned_trace as bt
    from echorenderer_tpu_torch.ops import pallas_hier as ph
    from echorenderer_tpu_torch.processes.tiles import lane_order

    n = res[0] * res[1]
    perm = torch.as_tensor(lane_order(res)[0].astype("int64"))
    tie_px = torch.zeros(n, dtype=torch.bool)
    ties = 0
    for rays, ig, *extra in calls["trace"]:
        if cascade_widths(rays.shape[1]) or rays.shape[1] % n:
            raise AssertionError("the render check's frame must stay under the cascade")
        out = bt._Walk(rays, ig, soa, False, *extra).traverse()
        walk = ph.hier_trace(rays, ig, soa, *extra)
        if not torch.equal(out[1] >= 0, walk[1] >= 0):
            raise AssertionError("binned and the walk disagree on hit or miss")
        other = out[1] != walk[1]
        if extra:
            other |= (out[4] != walk[4]) & (out[1] >= 0)
        other = other.nonzero().squeeze(1).cpu()
        tie_px[perm[other % n]] = True
        ties += other.numel()
    return tie_px, ties


def tlas_against_bake(label, make, res, spp, bounce, dev, accelerator):
    """One frame of the scene `make()` prepared with instancing="tlas" (its
    dispatch must be `accelerator`, on the instanced kernels) and with
    "bake": mean |tlas - bake| / mean(bake) < 0.02
    (tests/test_instancing.py's bound); pixels outside MEGA_TOL's per-pixel
    tolerance counted. A binned TLAS frame is also held to the same frame
    through the instanced walk alone by the binned render criterion: every
    pixel outside MEGA_TOL's per-pixel tolerance owns a band-tie ray, the
    mean image within MEGA_TOL's 1e-4."""
    import torch

    from echorenderer_tpu_torch.evaluation import scene_ops
    from echorenderer_tpu_torch.evaluation.scene_ops import dispatch_summary
    from echorenderer_tpu_torch.processes.render import _sample_frame
    from echorenderer_tpu_torch.scene.prepare import prepare_scene

    t = MEGA_TOL

    def outside(a, b):
        (as_, aq), (bs, bq) = a, b
        close = ((as_ - bs).abs() <= t["sum_atol"] + t["sum_rtol"] * bs.abs()) & (
            (aq - bq).abs() <= t["sq_atol"] + t["sq_rtol"] * bq.abs())
        return ~close.all(dim=-1)

    sums, info = {}, {}
    for mode in ("tlas", "bake"):
        scene = prepare_scene(make(), instancing=mode, device=dev)
        summary = dispatch_summary(scene)
        zero_launch_counts()
        t0 = time.perf_counter()
        with RayWork(cull=True, record=True) if mode == "tlas" else contextlib.nullcontext() as rec:
            sums[mode] = _sample_frame(scene, "path", res, 0, 0, spp, bounce, 2.5)
        torch.cuda.synchronize()
        grew = launch_counts()
        info[mode] = (summary, time.perf_counter() - t0, grew)
        if mode == "tlas":
            n_inst = scene.instances.num_instances
            if summary["accelerator"] != accelerator:
                raise AssertionError(f"{label}: TLAS dispatch {summary['accelerator']}, want "
                                     f"{accelerator}")
            used = ["hier_trace_inst", "hier_occlude_inst"] + (
                ["seg_inst"] if accelerator == "binned" else [])
            if min(grew[k] for k in used) <= 0 or grew["seg"] or grew["hier_trace"]:
                raise AssertionError(f"{label}: the TLAS render did not take the instanced "
                                     f"kernels: {grew}")
            if accelerator == "binned":  # the band-tie criterion against the walk alone
                saved = scene_ops._use_binned_instanced
                scene_ops._use_binned_instanced = lambda scene: False
                try:
                    walk_sums = _sample_frame(scene, "path", res, 0, 0, spp, bounce, 2.5)
                finally:
                    scene_ops._use_binned_instanced = saved
                tie_px, ties = tie_pixels(scene.hier_soa, rec.binned, res)
                off = outside(sums["tlas"], walk_sums).cpu()
                unexplained = int((off & ~tie_px).sum())
                mean_diff = float(((sums["tlas"][0] - walk_sums[0]) / spp).mean(dim=0).abs().max())
                log(f"[instanced] {label}: binned dispatch vs the walk alone: "
                    f"{int(off.sum())} pixels outside the per-pixel tolerance, {ties} band-tie "
                    f"rays on {int(tie_px.sum())} pixels, {unexplained} pixels outside tolerance "
                    f"without a band tie (need 0), mean image |diff| {mean_diff:.3g} "
                    f"(< {t['mean']})")
                if unexplained or not mean_diff < t["mean"]:
                    raise AssertionError(f"{label}: the binned TLAS render disagrees with the walk")
            del rec
        del scene
    ts, bs = sums["tlas"][0], sums["bake"][0]
    rel = float((ts - bs).abs().mean() / bs.abs().mean().clamp(min=1e-6))
    n_out = int(outside(sums["tlas"], sums["bake"]).sum())
    log(f"[instanced] TLAS vs bake, {label} ({n_inst} instances) {res[0]}x{res[1]} {spp} spp "
        f"bounce {bounce}: mean |tlas - bake| / mean(bake) {rel:.6f} (< 0.02); {n_out} of "
        f"{ts.shape[0]} pixels outside MEGA_TOL's per-pixel tolerance; tlas "
        f"{info['tlas'][0]['accelerator']} {info['tlas'][1]:.3f} s, bake "
        f"{info['bake'][0]['accelerator']} / {info['bake'][0]['integrator']} "
        f"{info['bake'][1]:.3f} s; tlas launches "
        + ", ".join(f"{k} {v}" for k, v in info["tlas"][2].items() if v))
    if not (rel < 0.02) or not bool(torch.isfinite(ts).all()):
        raise AssertionError(f"{label}: the TLAS render differs from the baked one")


def instanced_phase(dev, rs, smi):
    """The TLAS slice (instanced_sphere_grids: 4 x 123,008 triangles)
    and its kernels: the instanced walk and the instanced binned
    traversal on 2^20 random rays and on every call of one program,
    against their plain versions and each other; bench.py's large-scene
    traffic timed against the baked twin; two TLAS-against-bake renders.
    Returns the kernels-line rows of the instanced kernels."""
    import numpy as np
    import torch

    from echorenderer_tpu_torch.evaluation.scene_ops import dispatch_summary
    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.ops import binned_trace as bt
    from echorenderer_tpu_torch.ops import pallas_hier as ph
    from echorenderer_tpu_torch.ops import pallas_intersect as pi
    from echorenderer_tpu_torch.processes.render import _sample_frame
    from echorenderer_tpu_torch.scene.prepare import prepare_scene
    from echorenderer_tpu_torch.utils.colors import luminance

    res = INSTANCED_RES
    n_px = res[0] * res[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tlas = prepare_scene(scenes.instanced_sphere_grids(), instancing="tlas", device=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    prep_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    soa = tlas.hier_soa
    summary = dispatch_summary(tlas)
    log(f"[instanced] instanced_sphere_grids: {tlas.instances.num_instances} instances, "
        f"{tlas.geometry.num_triangles} stored triangles, {soa.num_chunks} pack chunks, "
        f"{soa.binned_g2c.shape[0]} global chunks, {soa.codes.numel() // 2} nodes, stack "
        f"{soa.stack_size} of {ph.MAX_STACK}; prepared (tlas) in {prep_s:.2f} s, peak "
        f"{prep_gib:.3f} GiB; dispatch {summary}")
    if summary["accelerator"] != "binned" or summary["integrator"] != "wavefront":
        raise AssertionError("the instanced slice does not dispatch to the binned traversal")

    # --- the kernels on 2^20 random rays ---
    real = (soa.binned_wcb[:, 0] <= soa.binned_wcb[:, 3]) & (soa.binned_wcb[:, 3] < 1e6)
    lo = soa.binned_wcb[real, 0:3].amin(0).tolist()
    hi = soa.binned_wcb[real, 3:6].amax(0).tolist()
    o, d, t_max, ignore = random_rays(rs, N_RAYS, lo, hi, soa.num_prims)
    inst_np = rs.randint(0, tlas.instances.num_instances, N_RAYS).astype(np.int32)
    o, d, t_max, ignore, inst = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
                                 for a in (o, d, t_max, ignore, inst_np))
    call = (pi.ray_columns(o, d, t_max), ph._sorted_ignore(soa, ignore),
            ph._ignore_inst(soa, ignore, inst))
    calls = dict(trace=[call], occlude=[call])
    err_rnd, _, _ = compare_hier("instanced random rays", soa, calls)
    zero_launch_counts()
    with BinnedCheck(soa) as check_rnd:
        bt._Walk(*call[:2], soa, False, call[2]).traverse()
        bt._Walk(*call[:2], soa, True, call[2]).traverse()
    log(f"[instanced] random rays, binned: {count_of('binned.rounds')} rounds, {binned_reads()} "
        f"host reads over 2 calls")
    b_rnd = check_rnd.summary("instanced random rays",
                              kinds=("setup", "refill", "select", "seg_instanced",
                                     "seg_exact_instanced"))
    compare_binned("instanced random rays", soa, calls)
    misses = int(bt.STATS["misses"])
    del call, calls, o, d, t_max, ignore, inst, check_rnd

    # --- the slice: bench.py's large-scene traffic, counters from zero ---
    program = lambda start: _sample_frame(tlas, "path", res, 0, start, 1, 6, 2.5)
    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    seconds, warm_s, first, s_sum = timed_programs(program)
    grew = launch_counts()
    slice_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    rounds, syncs, b_calls = count_of("binned.rounds"), binned_reads(), count_of("binned.calls")
    misses += int(bt.STATS["misses"])
    mspps = n_px * 8 / sum(seconds) / 1e6
    lum = float(luminance(s_sum.reshape(res[1], res[0], 3)).mean())
    log(f"[instanced] TLAS slice {res[0]}x{res[1]} 1 spp bounce 6: {mspps:.4f} Mspps over 8 "
        f"programs ({n_px} x 8 samples / {sum(seconds):.4f} s); program seconds "
        + ", ".join(f"{t:.4f}" for t in seconds)
        + f"; warm-up {warm_s:.3f} s; prepare {prep_s:.2f} s; peak memory {slice_gib:.3f} GiB; "
          f"mean luminance {lum:.4f} | {smi}")
    log(f"[instanced] TLAS slice launches over 9 programs: "
        + ", ".join(f"{k} {v}" for k, v in grew.items())
        + f"; per program: " + ", ".join(f"{k} {grew[k] / 9:.2f}" for k in INSTANCED_PATH)
        + f"; {b_calls} binned calls, {rounds} rounds, {syncs} host reads")
    if not bool(torch.isfinite(s_sum).all()) or not 0.01 < lum < 10.0:
        raise AssertionError(f"instanced slice non-finite or mean luminance {lum} out of (0.01, 10)")
    others = [k for k, v in grew.items() if v and k not in INSTANCED_PATH]
    if min(grew[k] for k in INSTANCED_PATH) <= 0 or others:
        raise AssertionError(f"the instanced slice did not run on the instanced kernels alone: "
                             f"{grew}")
    path_launches = dict(grew)

    # --- the baked twin: the same traffic through the flat dispatch ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bake = prepare_scene(scenes.instanced_sphere_grids(), instancing="bake", device=dev)
    torch.cuda.synchronize()
    bake_prep_s = time.perf_counter() - t0
    bake_prep_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    bsum = dispatch_summary(bake)
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    b_seconds, b_warm, _, b_sum = timed_programs(
        lambda start: _sample_frame(bake, "path", res, 0, start, 1, 6, 2.5))
    bake_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    b_lum = float(luminance(b_sum.reshape(res[1], res[0], 3)).mean())
    log(f"[instanced] baked twin ({bake.geometry.num_triangles} triangles, dispatch "
        f"{bsum['accelerator']}): {n_px * 8 / sum(b_seconds) / 1e6:.4f} Mspps over 8 programs; "
        f"program seconds " + ", ".join(f"{t:.4f}" for t in b_seconds)
        + f"; warm-up {b_warm:.3f} s; prepare {bake_prep_s:.2f} s (peak {bake_prep_gib:.3f} "
          f"GiB); peak memory {bake_gib:.3f} GiB (TLAS {slice_gib:.3f}); {count_of('binned.calls')} "
          f"binned calls, {count_of('binned.rounds')} rounds, {binned_reads()} host reads; mean "
          f"luminance {b_lum:.4f} (TLAS {lum:.4f}) | {smi}")
    if not bool(torch.isfinite(b_sum).all()):
        raise AssertionError("the baked twin's frame is not finite")
    del bake, b_sum

    # --- the first timed program once more, every kernel call checked ---
    zero_launch_counts()
    with RayWork(cull=True, record=True) as rec, BinnedCheck(soa) as check:
        again, _, stats = _sample_frame(tlas, "path", res, 0, 1, 1, 6, 2.5, return_stats=True)
    # no render path launches it
    exact_launches = count_of("launches.binned_seg_exact_instanced")
    log(f"[instanced] the first program again, recorded: {stats['Loop/Iterations']} wavefront "
        f"iterations, {stats['Ray/Traced']} traced and {stats['Ray/Shadow']} shadow rays, sums "
        f"{'bitwise equal' if torch.equal(again, first) else 'DIFFERENT'}")
    if not torch.equal(again, first):
        raise AssertionError("the recorded instanced program's sums differ from the timed one's")
    del again, first
    label = "instanced slice 1920x1080 1 spp, the first timed program's calls"
    err_p, ms_h, bound_h = compare_hier(label, soa, rec.calls)
    b_out = check.summary(label, kinds=("setup", "refill", "select", "seg_instanced",
                                        "seg_exact_instanced"))
    compare_binned(label, soa, rec.binned)
    misses += int(bt.STATS["misses"])
    log(f"[instanced] recovery misses over the random rays and the programs: {misses} (need 0)")
    if misses:
        raise AssertionError("a binned winner missed on its exact re-test")
    del rec, check, tlas, soa

    # --- TLAS against bake ---
    tlas_against_bake("1,001 instances of a two-sphere pack", thousand_instances, TLAS_BAKE_RES,
                      8, 6, dev, "binned")
    tlas_against_bake("instanced_grid(side=3)", lambda: scenes.instanced_grid(side=3),
                      TLAS_BAKE_RES, 8, 6, dev, "hier-packet")

    rows = [dict(name=f"hier_{k}[instanced]", route="cuda", source=HIER_SOURCE,
                 replaces=HIER_SITE, launches=path_launches[f"hier_{k}_inst"],
                 max_abs_err=max(err_rnd[k], err_p[k]), ms=ms_h[k],
                 plain_ms=ms_h[f"{k}_plain"], bound_ms=bound_h[k][0], bound_by=bound_h[k][1],
                 library_ms=None) for k in ("trace", "occlude")]
    for name, kind, launches in (("binned_seg[instanced]", "seg_instanced",
                                  path_launches["seg_inst"]),
                                 ("binned_seg_exact_instanced", "seg_exact_instanced",
                                  exact_launches)):
        seg = b_out[kind]
        rows.append(dict(name=name, route="cuda", source=BINNED_SOURCE,
                         replaces=BINNED_SITES["seg"], launches=launches,
                         max_abs_err=float(max(b_rnd[kind]["max_abs_err"], seg["max_abs_err"])),
                         ms=seg["ms"], plain_ms=seg["plain_ms"], bound_ms=seg["bound_ms"],
                         bound_by=seg["bound_by"], library_ms=None))
    return rows


def mega_hier_slice(grid, res, program, walk_first, walk_mspps, main_mspps, smi) -> dict:
    """bench.py's large configuration through the megakernel's chunk-tree
    form: ECHO_MEGA_HIER set, counters zeroed, a warm-up and 8 timed
    `program`s through _sample_frame (one launch each, nothing else). The
    first timed program's sums against the walk-only first program's
    (`walk_first`): pixels not bitwise equal, MEGA_TOL. Then the launch
    against its plain version (compare_mega_hier, 10 timed launches). Returns
    the kernels line's megakernel_hier entry."""
    import os

    import torch

    from echorenderer_tpu_torch.evaluation.scene_ops import dispatch_summary
    from echorenderer_tpu_torch.ops import megakernel as mk
    from echorenderer_tpu_torch.utils.colors import luminance

    n_px = res[0] * res[1]
    os.environ["ECHO_MEGA_HIER"] = "1"
    try:
        summary = dispatch_summary(grid)
        log(f"[slice] under ECHO_MEGA_HIER: dispatch {summary}")
        if summary["integrator"] != "megakernel-hier":
            raise AssertionError("the large scene does not dispatch to the chunk-tree form")
        zero_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        seconds, warm_s, first, s_sum = timed_programs(program)
        counts = launch_counts()
        gib = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        del os.environ["ECHO_MEGA_HIER"]
    mspps = n_px * 8 / sum(seconds) / 1e6
    lum = float(luminance((s_sum / 1.0).reshape(res[1], res[0], 3)).mean())
    t = MEGA_TOL
    close = (first - walk_first).abs() <= t["sum_atol"] + t["sum_rtol"] * walk_first.abs()
    differ = int((first != walk_first).any(dim=-1).sum())
    outside = int((~close.all(dim=-1)).sum())
    mean_diff = float((first - walk_first).mean(dim=0).abs().max())
    log(f"[slice] chunk-tree megakernel: {mspps:.4f} Mspps over 8 programs ({n_px:,} x 8 "
        f"samples / {sum(seconds):.4f} s; in this call the main dispatch {main_mspps:.4f}, the "
        f"walk alone {walk_mspps:.4f}); program seconds "
        + ", ".join(f"{x:.4f}" for x in seconds)
        + f"; warm-up {warm_s:.3f} s; peak memory {gib:.2f} GiB; mean luminance {lum:.4f}; "
          f"launches {counts} | {smi}")
    log(f"[slice] chunk-tree megakernel, first timed program against the walk-only first "
        f"program: {differ} of {n_px} pixels not bitwise equal, {outside} outside tolerance, "
        f"mean image |diff| {mean_diff:.3g} (< {t['mean']})")
    others = {k: v for k, v in counts.items() if k != "mega_hier"}
    if counts["mega_hier"] != 9 or any(others.values()):
        raise AssertionError("the chunk-tree megakernel's programs did not take its launch alone")
    if not bool(torch.isfinite(s_sum).all()) or not 0.01 < lum < 10.0:
        raise AssertionError(f"chunk-tree megakernel frame non-finite or mean luminance {lum}")
    if outside > (1 - t["share"]) * n_px or not mean_diff < t["mean"]:
        raise AssertionError("the chunk-tree megakernel disagrees with the walk-only program")
    label = f"sphere_grid(1M) {res[0]}x{res[1]} 1 spp, the first timed program's launch"
    err, ms, bound, _ = compare_mega_hier(label, grid, res, 1, 6, bitwise=True, start=1)
    return dict(name="megakernel_hier", route="cuda", source=MEGA_SOURCE,
                replaces=MEGA_HIER_SITE, launches=counts["mega_hier"],
                max_abs_err=max(err, float((first - walk_first).abs().max())), ms=ms["ms"],
                plain_ms=ms["plain_ms"], bound_ms=bound[0], bound_by=bound[1], library_ms=None)


def plucker_bounds(n: int, inside: dict) -> dict:
    """{kernel: (bound ms, "operations" or "bytes", reckoning)} of the
    Plücker micro-benchmark's kernels at n rays against its 256 triangles:
    the larger of the least float work and the bytes (the 8 columns read,
    the keys written, the table's rows read once). The float work: MT, 45
    flops a (ray, triangle) (its test runs whole on every pair); Plücker,
    the edge volumes' 33 flops a pair (at 67 TFLOP/s, or at DEFAULT at the
    bf16 tensor-core 989 TFLOP/s) and, at 67 TFLOP/s, 9 a ray for m = o x d
    and 12 (the plane and the division) on each of the inside[kernel] pairs
    that pass the sign test in this run's data
    (`plucker_micro.inside_pairs`)."""
    H = 256
    pairs = n * H
    io_bytes = 8 * n * 4 + n * 4
    plk_bytes = io_bytes + (6 * 3 + 3 + 4) * H * 4  # the rows the kernels read

    def plk_work(kernel, peak, rate):
        rest = PLUCKER_RAY_FLOPS * n + PLUCKER_INSIDE_FLOPS * inside[kernel]
        return (PLUCKER_EDGE_FLOPS * pairs / peak * 1e3 + rest / PEAK_FLOPS * 1e3, plk_bytes,
                f"{PLUCKER_EDGE_FLOPS} edge flops a pair at {rate}, {PLUCKER_RAY_FLOPS} a ray and "
                f"{PLUCKER_INSIDE_FLOPS} on each of the {inside[kernel]} pairs inside the sign "
                f"test at 67 TFLOP/s")

    work = dict(
        mt=(FLOPS_TRI * pairs / PEAK_FLOPS * 1e3, io_bytes + 10 * H * 4,
            f"{FLOPS_TRI} flops a (ray, triangle) at 67 TFLOP/s"),
        plk_highest=plk_work("plk_highest", PEAK_FLOPS, "67 TFLOP/s"),
        plk_default=plk_work("plk_default", PEAK_BF16, "the bf16 tensor-core 989 TFLOP/s"))
    out = {}
    for name, (ops_ms, nbytes, reckoning) in work.items():
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        bound, by = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
        out[name] = (bound, by, f"{reckoning}: {ops_ms:.6f} ms; {nbytes} bytes at 3.35 TB/s: "
                                f"{bytes_ms:.6f} ms")
    return out


def plucker_products(pm, plk, cols, dtype):
    """Kernel 9's products as one library call each, the yardstick: lhs
    (8, 3H) and (8, 2H) laid out as the JAX kernel's lhsA and lhsBC, against
    the per-ray [d, m, 0, 0] and [d, o, 1, 0] columns of cols, in `dtype`
    (the products alone, not the keys)."""
    import torch

    H = pm.H
    ox, oy, oz, dx, dy, dz = cols[0:6]
    zero, one = torch.zeros_like(ox), torch.ones_like(ox)
    rhs_a = torch.stack([dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx,
                         zero, zero])
    rhs_b = torch.stack([dx, dy, dz, ox, oy, oz, one, zero])
    lhs_a = plk[0:8, 0:3 * H]
    lhs_bc = torch.zeros((8, 2 * H), device=plk.device)
    lhs_bc[0:3, 0:H] = plk[0:3, 3 * H:4 * H]
    lhs_bc[3:7, H:2 * H] = plk[6:10, 4 * H:5 * H]
    a, b, c, d = (x.to(dtype) for x in (lhs_a.T, rhs_a, lhs_bc.T, rhs_b))
    return lambda: (torch.matmul(a, b), torch.matmul(c, d))


# the Plücker kernels' entry names in csrc/plucker.cu
PLUCKER_ENTRIES = dict(mt="mt_kernel", plk_highest="highest_kernel", plk_default="default_kernel")


def sass_functions(lib) -> dict:
    """{function name: [SASS instructions]} of a built library (cuobjdump
    -sass from nvcc's directory)."""
    from echorenderer_tpu_torch.ops import cuda_build

    text = subprocess.run([str(Path(cuda_build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        got = re.search(r"Function : (\S+)", line)
        if got:
            name = got.group(1)
            out[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            out[name].append(re.sub(r"/\*.*?\*/", "", line).split(";")[0].strip())
    return out


def plucker_form_reports(pm, smi) -> dict:
    """One "[plucker]" line a kernel: the form it launches (rays a thread or
    prims a wgmma product), ptxas registers / stack frame / spills, dynamic
    shared memory a block and resident warps/SM; and the DEFAULT kernel's
    HGMMA instructions in its SASS (it fails without one, or on a spill).
    Returns {kernel: line}."""
    from echorenderer_tpu_torch.ops import cuda_build

    built = cuda_build.build()["plucker"]
    forms = pm.forms()
    sass = sass_functions(built.path)
    lines = {}
    for kernel, entry in PLUCKER_ENTRIES.items():
        reports = ptxas_forms(built.ptxas, entry)
        if len(reports) != 1:
            raise AssertionError(f"plucker: expected one {entry} in ptxas's report: {reports}")
        (report,) = reports.values()
        if not re.search(r"\b0 bytes spill stores, 0 bytes spill loads", report):
            raise AssertionError(f"plucker: {entry} spills: {report}")
        f = forms[kernel]
        what = (f"{f['prims']} prims a wgmma product" if "prims" in f else
                f"{f['rays']} rays a thread")
        code = next(v for k, v in sass.items() if entry in k)
        hgmma = sum(1 for ins in code if "HGMMA" in ins)
        lines[kernel] = (f"{entry} ({what}): {report}; {f['smem']} bytes dynamic smem a "
                         f"{f['threads']}-thread block, {f['blocks']} blocks = {f['warps']} "
                         f"resident warps/SM on {f['sms']} SMs (persistent grid); "
                         f"{len(code)} SASS instructions, {hgmma} HGMMA | {smi}")
        if kernel == "plk_default" and not hgmma:
            raise AssertionError(f"plucker: {entry} holds no HGMMA instruction")
    return lines


def plucker_phase(dev, smi) -> list:
    """The Plücker micro-benchmark (echorenderer_tpu_torch.benchmarks.
    plucker_micro) at 2^20 rays against its 256-triangle soup: its numerics
    as its main() drives them (counts from zero: one MT launch, two of each
    Plücker precision), the MT and HIGHEST key arrays bitwise against their
    plain versions, the DEFAULT ones (the tensor-core form) within
    `default_within_contract` with its counts, the MT/Plücker agreement
    statistics, each kernel's form (ptxas, residency, HGMMA), then each
    kernel's ms on the chunk-local inputs (as the script times them), plain
    ms, bound and the library yardstick (kernel 9: torch.matmul of its two
    products alone). Returns the kernels-line rows."""
    import torch

    from echorenderer_tpu_torch.benchmarks import plucker_micro as pm

    n = N_RAYS
    prims, cols = pm.micro_scene(n, device=dev)
    zero_launch_counts()
    keys, inputs = pm.run_keys(prims, cols)
    torch.cuda.synchronize()
    launches = {k: count_of(f"launches.plucker_{k}") for k in ("mt", "plk_highest", "plk_default")}
    log(f"[plucker] {n} rays against {pm.H} triangles through run_keys: launches {launches}")
    if launches != dict(mt=1, plk_highest=2, plk_default=2):
        raise AssertionError(f"the micro-benchmark did not run on its kernels: {launches}")
    plain = {"mt": lambda: pm.keys_mt_plain(prims, cols)}
    for frame, (plk, cc) in inputs.items():
        for prec in pm.PRECISIONS:
            plain[f"{frame} {prec}"] = lambda plk=plk, cc=cc, prec=prec: pm.keys_plk_plain(
                plk, cc, prec)
    # the largest |kernel key - plain key| per kernel; DEFAULT's over the rays
    # without a prim or hit/miss flip (a flip's difference is no t gap), its
    # contract counts per frame beside it
    err, contract = {}, {}
    for name, fn in plain.items():
        want = fn()
        kernel = "mt" if name == "mt" else f"plk_{name.split()[1]}"
        if kernel == "plk_default":
            ok, counts = pm.default_within_contract(keys[name], want)
            contract[name.split()[0]] = counts
            err[kernel] = max(err.get(kernel, 0), counts["max_abs"])
            log(f"[plucker] {name} against its plain version (the contract: prim + hit/miss "
                f"flips <= {pm.DEFAULT_FLIPS_MAX:g} of rays, differing keys <= "
                f"{pm.DEFAULT_DIFFER_MAX:g}, the rest one band of the same prim): "
                f"{'within' if ok else 'OUTSIDE'}; {counts}")
            if not ok:
                raise AssertionError(f"plucker {name}: the kernel breaks its contract: {counts}")
        elif not torch.equal(keys[name], want):
            raise AssertionError(f"plucker {name}: the kernel differs from its plain version on "
                                 f"{int((keys[name] != want).sum())} of {n} rays")
        else:
            err[kernel] = 0
    log("[plucker] MT and HIGHEST key arrays (mt, " + ", ".join(
        f"{f} highest" for f in pm.FRAMES) + ") bitwise equal to their plain versions")
    for frame in pm.FRAMES:
        for prec in pm.PRECISIONS:
            a = pm.agreement(keys["mt"].cpu(), keys[f"{frame} {prec}"].cpu())
            log(f"[plucker] {frame} {prec.upper()} against MT: key agree {a['key_agree']:.7f}, "
                f"prim flips {a['prim_flips']:.3e}, hit/miss flips {a['hit_flips']:.3e}, t rel max "
                f"{a['t_rel_max']:.3e} ({a['hits']} of {n} rays hit)")
    for line in plucker_form_reports(pm, smi).values():
        log(f"[plucker] {line}")

    plk, local = inputs["chunk-local"]
    pairs = n * pm.H
    bounds = plucker_bounds(n, {f"plk_{prec}": pm.inside_pairs(plk, local, prec)
                                for prec in pm.PRECISIONS})
    cases = [
        ("plucker_mt", PLUCKER_SITES["mt"], lambda: pm.keys_mt(prims, local),
         lambda: pm.keys_mt_plain(prims, local), None),
        ("plucker_plk_highest", PLUCKER_SITES["plk"],
         lambda: pm.keys_plk(plk, local, "highest"),
         lambda: pm.keys_plk_plain(plk, local, "highest"),
         plucker_products(pm, plk, local, torch.float32)),
        ("plucker_plk_default", PLUCKER_SITES["plk"],
         lambda: pm.keys_plk(plk, local, "default"),
         lambda: pm.keys_plk_plain(plk, local, "default"),
         plucker_products(pm, plk, local, torch.bfloat16)),
    ]
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products for the HIGHEST yardstick
    rows = []
    try:
        for name, site, kernel_fn, plain_fn, library in cases:
            kernel = name.split("plucker_")[1]
            bound, by, reckoning = bounds[kernel]
            ms = median_ms(kernel_fn)
            plain_ms = median_ms(plain_fn, runs=3)
            lib_ms = median_ms(library, runs=5) if library else None
            torch.cuda.empty_cache()
            log(f"[plucker] {name}: {ms:.4f} ms ({ms * 1e6 / n:.3f} ns a ray, "
                f"{ms * 1e6 / pairs:.5f} ns a (ray, triangle)), plain {plain_ms:.4f} ms; bound "
                f"{bound:.6f} ms by {by} ({reckoning}), {100 * bound / ms:.2f}% of the kernel's "
                f"time" + (f"; torch.matmul of its two products alone (not the keys) "
                           f"{lib_ms:.4f} ms" if library else "") + f" | {smi}")
            rows.append(dict(name=name, route="cuda", source=PLUCKER_SOURCE, replaces=site,
                             launches=launches[kernel], max_abs_err=float(err[kernel]),
                             ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                             library_ms=lib_ms,
                             **({"contract": contract} if kernel == "plk_default" else {})))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    return rows


ORACLE_RAYS = 2 ** 16
ORACLE_RTOL = 1e-6  # tests/test_torch_bvh_walk.py's rule against the dense kernels


def bvh_oracle(label, geom, tree, soa, rays_np, smi):
    """`intersect_bvh` / `occlude_bvh` (plain PyTorch on the card) against
    the dense kernels on the same rays: hit or miss and blocked flags
    identical; a prim differs only on an exact t tie; t to ORACLE_RTOL."""
    import numpy as np
    import torch

    from echorenderer_tpu_torch.aggregation.bvh import intersect_bvh, occlude_bvh
    from echorenderer_tpu_torch.ops import pallas_intersect as pi

    dev = soa.rows.device
    o, d, t_max, ignore = (torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in rays_np)
    t0 = time.perf_counter()
    hit = intersect_bvh(geom, tree, o, d, t_max, ignore)
    blocked = occlude_bvh(geom, tree, o, d, t_max, ignore)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    rays, ig = pi.ray_columns(o, d, t_max), pi._sorted_ignore(soa, ignore)
    before = (count_of("launches.dense_trace"), count_of("launches.dense_occlude"))
    t, slot, _, _ = pi.dense_trace(rays, ig, soa)
    want_blocked = pi.dense_occlude(rays, ig, soa)
    after = (count_of("launches.dense_trace"), count_of("launches.dense_occlude"))
    if after != (before[0] + 1, before[1] + 1):
        raise AssertionError(f"{label}: the dense kernels did not launch once each")
    prim = torch.where(slot >= 0, soa.order[torch.clamp(slot, min=0).long()], -1)
    found = hit.prim >= 0
    differ = hit.prim != prim
    ties = int(differ.sum())
    off = int((hit.t[found] != t[found]).sum())
    close = torch.allclose(hit.t[found], t[found], rtol=ORACLE_RTOL, atol=0.0)
    same_found, same_blocked = torch.equal(found, prim >= 0), torch.equal(blocked, want_blocked)
    log(f"[bvh-oracle] {label}: {len(o)} rays, {int(found.sum())} hits, {int(blocked.sum())} "
        f"blocked; the stack walk {walk_s * 1e3:.1f} ms (trace + occlude) against the dense "
        f"kernels: hit or miss {'identical' if same_found else 'DIFFERENT'}, {ties} rays with "
        f"another prim (exact t ties), {off} hits with t not bitwise equal "
        f"({'within' if close else 'OUTSIDE'} rtol {ORACLE_RTOL}), blocked flags "
        f"{'identical' if same_blocked else 'DIFFERENT'} | {smi}")
    if (not same_found or not torch.equal(hit.t[differ], t[differ]) or not close
            or not same_blocked):
        raise AssertionError(f"{label}: the BVH oracle disagrees with the dense kernels")
    if not 0 < int(found.sum()) < len(o):
        raise AssertionError(f"{label}: the oracle's rays hit nothing or everything")


ADAPTIVE_LARGE = dict(samples_per_epoch=8, min_epoch=1, max_epoch=4, noise_threshold=0.045,
                      bounce_limit=6, survivability=2.5)  # bench.py's, max_epoch cut from 32


def counted_render(scene, prof, res, seed=0):
    """render_layer with every launch count zeroed first and the card's
    host reads counted (torch.cuda's sync debug mode, one warning a
    synchronizing call): (image, info, per-epoch rows, peak GiB). A row is
    info["epoch_log"]'s entry (epoch, active pixels, seconds between host
    reads) with the launches and host reads of that epoch and its Mspps;
    the final image download's read is counted in info["final_reads"]."""
    import warnings

    import torch

    from echorenderer_tpu_torch.processes.render import render_layer

    zero_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        reads = lambda: sum("synchroniz" in str(w.message) for w in caught)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            image, info = render_layer(scene, prof, res, seed=seed,
                                       progress=lambda *a: marks.append((reads(),
                                                                         launch_counts())))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        total_reads = reads()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rows, before = [], (0, dict.fromkeys(launch_counts(), 0))
    for entry, mark in zip(info["epoch_log"], marks):
        launched = {k: v - before[1][k] for k, v in mark[1].items() if v - before[1][k]}
        rows.append(dict(entry, reads=mark[0] - before[0], launches=launched,
                         mspps=entry["active"] * prof.samples_per_epoch / entry["seconds"] / 1e6))
        before = mark
    info["final_reads"] = total_reads - before[0]
    return image, info, rows, peak


def log_epochs(tag, scene, prof, rows, mega: bool) -> None:
    from echorenderer_tpu_torch.ops import megakernel as mk

    for r in rows:
        form = ""
        if mega:
            form = ", " + ("split form" if mk.split_form(scene, r["active"],
                                                          prof.samples_per_epoch) else "pool")
        log(f"[adaptive]   {tag} epoch {r['epoch']}: {r['active']} pixels active, "
            f"{r['seconds']:.4f} s = {r['mspps']:.3f} Mspps{form}, {r['reads']} host reads, "
            f"launches {r['launches']}")


def adaptive_against_wavefront(label, scene, res, smi, max_epoch=None):
    """The default EvaluationProfile (adaptive epochs; `max_epoch` cuts its
    20) through the megakernel, then the same render on the wavefront with
    one sample chain (the kernel's summation order): every pixel bitwise,
    the same epochs and samples. Returns the megakernel run's launches by
    form and the epochs that took the split form."""
    from unittest import mock

    import numpy as np

    from echorenderer_tpu_torch.evaluation.scene_ops import dispatch_summary
    from echorenderer_tpu_torch.ops import megakernel as mk
    from echorenderer_tpu_torch.processes import render as rd

    prof = rd.EvaluationProfile()
    prof.max_epoch = max_epoch or prof.max_epoch
    image, info, rows, peak = counted_render(scene, prof, res)
    launches = dict(mega=count_of("launches.mega"),
                    textured=count_of("launches.mega_textured"))
    n = res[0] * res[1]
    log(f"[adaptive] {label} {res[0]}x{res[1]} EvaluationProfile() (spe "
        f"{prof.samples_per_epoch}, epochs {prof.min_epoch}..{prof.max_epoch}, threshold "
        f"{prof.noise_threshold}, bounce {prof.bounce_limit}) via "
        f"{info['dispatch']['integrator']}: "
        f"{info['epochs']} epochs, {info['samples']} samples ({info['samples'] / n:.2f} spp "
        f"mean) in {info['seconds']:.3f} s = {info['samples_per_second'] / 1e6:.3f} Mspps "
        f"effective; megakernel launches {launches}, host reads {sum(r['reads'] for r in rows)} "
        f"+ {info['final_reads']} (image); peak {peak:.2f} GiB | {smi}")
    log_epochs(label, scene, prof, rows, mega=True)
    with mock.patch.object(rd, "MAX_LANES", 0), mock.patch.object(mk, "supported",
                                                                    lambda s: False):
        if dispatch_summary(scene)["integrator"] != "wavefront":
            raise AssertionError(f"{label}: the wavefront comparison did not take the wavefront")
        wimage, winfo, wrows, wpeak = counted_render(scene, prof, res)
    differ = int((image != wimage).any(axis=-1).sum())
    same = (info["epochs"], info["samples"]) == (winfo["epochs"], winfo["samples"])
    log(f"[adaptive] {label}: the same render on the wavefront (one sample chain): "
        f"{winfo['epochs']} epochs, {winfo['samples']} samples in {winfo['seconds']:.3f} s, "
        f"{sum(r['reads'] for r in wrows)} host reads, peak {wpeak:.2f} GiB; "
        f"{differ} of {n} pixels not bitwise equal, schedule {'equal' if same else 'DIFFERENT'}")
    log_epochs(f"{label} on the wavefront", scene, prof, wrows, mega=False)
    if not np.isfinite(image).all() or differ or not same:
        raise AssertionError(f"{label}: the adaptive megakernel render differs from the wavefront")
    if sum(launches.values()) != info["epochs"] or info["epochs"] < 2:
        raise AssertionError(f"{label}: expected one megakernel launch an epoch, adaptive "
                             f"epochs included")
    split = [r["epoch"] for r in rows if mk.split_form(scene, r["active"],
                                                        prof.samples_per_epoch)]
    return launches, split


def aov_checks(label, scene, res, binned: bool, smi):
    """albedo and normal_depth of `scene` at `res`: timed through
    render_layer with their kernels' launches counted, then against their
    plain versions: the dense kernels' plain versions on the same device
    (bitwise), or, on a binned scene, each binned launch against its plain
    version (BinnedCheck) and the image against the walk's (every pixel
    that differs must own a ray on which binned kept another prim in the
    same band). Returns the launches by kernel."""
    from unittest import mock

    import numpy as np
    import torch

    from echorenderer_tpu_torch.evaluation import scene_ops
    from echorenderer_tpu_torch.ops import binned_trace as bt
    from echorenderer_tpu_torch.ops import pallas_hier as ph
    from echorenderer_tpu_torch.ops import pallas_intersect as pi
    from echorenderer_tpu_torch.processes.render import EvaluationProfile, render_layer

    total = {}
    for evaluator in ("albedo", "normal_depth"):
        prof = EvaluationProfile(evaluator=evaluator, layer_name=evaluator)
        render_layer(scene, prof, res)  # warm-up
        zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        image, info = render_layer(scene, prof, res)
        ms = (time.perf_counter() - t0) * 1e3
        launched = {k: v for k, v in launch_counts().items() if v}
        for k, v in launched.items():
            total[k] = total.get(k, 0) + v
        if binned:
            with BinnedCheck(scene.hier_soa) as check, RayWork(cull=True, record=True) as rec:
                again, _ = render_layer(scene, prof, res)
            check.summary(f"{label} {evaluator}", kinds=("setup", "refill", "select", "seg"))
            ties = compare_binned(f"{label} {evaluator}", scene.hier_soa, rec.binned)
            tie_px = np.zeros(res[0] * res[1], bool)
            for rays, ig in rec.binned["trace"]:
                p = bt._Walk(rays, ig, scene.hier_soa, False).traverse()[1]
                other = (p != ph.hier_trace(rays, ig, scene.hier_soa)[1]).nonzero().squeeze(1)
                tie_px[other.cpu().numpy()] = True
            with scene_ops.walk_only():
                plain, _ = render_layer(scene, prof, res)
            differ = (again != plain).any(axis=-1).reshape(-1)
            how = (f"against the walk alone: {int(differ.sum())} pixels differ, {ties} band-tie "
                   f"rays on {int(tie_px.sum())} pixels, {int((differ & ~tie_px).sum())} "
                   f"differing pixels without a band tie (need 0)")
            bad = bool((differ & ~tie_px).any()) or not np.array_equal(again, image)
            want = launched.get("seg", 0) > 0
        else:
            with mock.patch.object(pi, "dense_trace", pi.dense_trace_plain):
                plain, _ = render_layer(scene, prof, res)
            differ = (image != plain).any(axis=-1)
            how = f"against the plain versions: {int(differ.sum())} pixels not bitwise equal"
            bad = bool(differ.any())
            want = launched.get("dense_trace", 0) > 0
        # a miss's depth is INF, and a sum of 16 INFs is inf in the JAX package too
        finite = bool(np.isfinite(image[..., :3]).all() and not np.isnan(image).any())
        log(f"[adaptive] {label} {evaluator} {res[0]}x{res[1]}: {ms:.3f} ms through render_layer "
            f"(accelerator {info['dispatch']['accelerator']}), launches {launched}; {how}; "
            f"finite (depth: finite or +inf) {finite} | {smi}")
        if bad or not want or not finite:
            raise AssertionError(f"{label} {evaluator} disagrees with its plain version or did "
                                 f"not launch its kernels")
    return total


def lockstep_against_wavefront(scene, res, spp, bounce):
    """path_lockstep against the wavefront on the card: per-sample sums
    bitwise, sums of squares to rtol 1e-6 (one sample chain: odd spp)."""
    import torch

    from echorenderer_tpu_torch.processes.render import _sample_frame

    zero_launch_counts()
    t0 = time.perf_counter()
    a, asq = _sample_frame(scene, "path", res, 0, 0, spp, bounce, 2.5)
    torch.cuda.synchronize()
    t_wave = time.perf_counter() - t0
    t0 = time.perf_counter()
    b, bsq = _sample_frame(scene, "path_lockstep", res, 0, 0, spp, bounce, 2.5)
    torch.cuda.synchronize()
    t_lock = time.perf_counter() - t0
    differ = int((a != b).any(dim=-1).sum())
    sq_ok = bool(torch.allclose(bsq, asq, rtol=1e-6, atol=0.0))
    log(f"[adaptive] path_lockstep vs the wavefront, {res[0]}x{res[1]} {spp} spp bounce {bounce}: "
        f"{differ} pixels with sums not bitwise equal, squares within rtol 1e-6 {sq_ok}; "
        f"wavefront {t_wave:.3f} s, lockstep {t_lock:.3f} s; launches {launch_counts()}")
    if differ or not sq_ok or float(a.sum()) <= 0.0:
        raise AssertionError("path_lockstep differs from the wavefront")


def adaptive_large(grid, smi):
    """bench.py's adaptive configuration (ADAPTIVE_LARGE: max_epoch cut
    from 32 to 4) on sphere_grid(1_000_000) at 1920x1080, then its first
    adaptive epoch again from the same state with every walk and binned
    launch checked against its plain version. Returns (launches,
    check rows for the kernels line)."""
    import numpy as np
    import torch

    from echorenderer_tpu_torch.processes import render as rd
    from echorenderer_tpu_torch.processes.tiles import lane_order
    from echorenderer_tpu_torch.utils import accumulator as acc_mod

    res = (1920, 1080)
    n = res[0] * res[1]
    prof = rd.EvaluationProfile(**ADAPTIVE_LARGE)
    image, info, rows, peak = counted_render(grid, prof, res)
    launches = launch_counts()
    lum = float(np.mean(image))
    log(f"[adaptive] bench.py's adaptive configuration, sphere_grid(1_000_000) {res[0]}x"
        f"{res[1]} ({ADAPTIVE_LARGE}) via {info['dispatch']['integrator']} "
        f"({info['dispatch']['accelerator']}): {info['seconds']:.3f} s, {info['epochs']} epochs, "
        f"{info['samples']} samples, {info['samples'] / n:.3f} spp mean, "
        f"{info['samples_per_second'] / 1e6:.4f} Mspps effective, "
        f"{info['wavefront_iterations']} wavefront iterations, peak {peak:.2f} GiB, mean "
        f"{lum:.4f} | {smi}")
    log_epochs("sphere_grid(1M)", grid, prof, rows, mega=False)
    if (not np.isfinite(image).all() or info["epochs"] < 2
            or min(launches[k] for k in ("hier_trace", "setup", "select", "seg")) <= 0):
        raise AssertionError("the large adaptive render is not finite, ran no adaptive epoch "
                             "or did not take the hier and binned kernels")
    # the first adaptive epoch again, its calls recorded and every launch checked
    spe = prof.samples_per_epoch
    s, q = rd._sample_frame(grid, "path", res, 0, 0, spe, prof.bounce_limit, 2.5)
    acc = acc_mod.add_many(acc_mod.create((n,), device=s.device), s, q, float(spe))
    thr = torch.tensor(prof.noise_threshold, dtype=torch.float32, device=s.device)
    m = int(rd._active_stats(acc, thr)[0])
    if m != rows[1]["active"]:
        raise AssertionError(f"the first adaptive epoch's active count {m} differs from the "
                             f"render's {rows[1]['active']}")
    perm = torch.as_tensor(lane_order(res)[0].astype(np.int64), device=s.device)
    drawn = torch.full((n,), spe, dtype=torch.int64, device=s.device)
    zero_launch_counts()
    label = f"sphere_grid(1M) first adaptive epoch ({m} pixels)"
    with RayWork(cull=True, record=True) as rec, BinnedCheck(grid.hier_soa) as check:
        rd._adaptive_step(grid, acc, drawn, perm, thr, res, spe, prof.bounce_limit, 2.5, 0, m)
    log(f"[adaptive] {label}: launches {launch_counts()}")
    err, ms, bound = compare_hier(label, grid.hier_soa, rec.calls)
    out = check.summary(label, kinds=("setup", "refill", "select", "seg"))
    compare_binned(label, grid.hier_soa, rec.binned)
    return launches, dict(err=err, binned=out)


def adaptive_phase(dev, smi, bench, showcase, large, mid, grid) -> dict:
    """Phase 6 (see the module docstring). Returns the adaptive programs'
    launches by kernel and the largest checked errors."""
    import torch

    t0 = time.perf_counter()
    mega, split_bench = adaptive_against_wavefront("sphere_field(80)", bench, (960, 540), smi)
    # the showcase's epochs past the 8th hold a few hundred pixels or fewer
    # and cost the wavefront ~5 s each (bounce 128 tails)
    tex, split_show = adaptive_against_wavefront("showcase", showcase, (320, 180), smi,
                                                 max_epoch=8)
    log(f"[adaptive] split-form epochs: bench {split_bench}, showcase {split_show}")
    if not split_bench + split_show:
        raise AssertionError("no checked adaptive launch took the split form")
    large_launches, checked = adaptive_large(grid, smi)
    dense = aov_checks("sphere_field(2400)", large, (320, 180), binned=False, smi=smi)
    binned = aov_checks("sphere_grid(250_000)", mid, (320, 180), binned=True, smi=smi)
    lockstep_against_wavefront(large, (320, 180), 3, 16)
    torch.cuda.synchronize()
    log(f"[adaptive] phase {time.perf_counter() - t0:.1f} s")
    return dict(mega=mega["mega"], textured=tex["textured"], large=large_launches, dense=dense,
                binned=binned, checked=checked)


COMPOSE_RES = (1280, 720)  # the README's standard_path_traced_profile call
COMPOSE_MAIN_ATOL = 1e-4  # the card's compose against the CPU's, tone-mapped main
DENOISE_TOL = dict(rtol=1e-4, atol=1e-5)  # the denoiser alone, card against CPU


def stack_ms(layers, operators, runs: int = 5) -> dict:
    """The stack op by op on the card: each operator's median CUDA-event
    ms over `runs` passes, after an untimed pass."""
    import torch

    times = {type(op).__name__: [] for op in operators}
    for r in range(runs + 1):
        ls = dict(layers)
        for op in operators:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            ls = op.apply(dict(ls))
            end.record()
            torch.cuda.synchronize()
            if r:
                times[type(op).__name__].append(start.elapsed_time(end))
    return {k: statistics.median(v) for k, v in times.items()}


@contextlib.contextmanager
def debug_checks(counts: list):
    """ECHO_DEBUG_DEVICE=1 for the block; each run_checked call appends
    the number of device flags its function raised."""
    from echorenderer_tpu_torch.utils import diagnostics as dg

    real = dg.run_checked

    def spy(fn, *args, **kwargs):
        def counted(*a, **kw):
            out = fn(*a, **kw)
            counts.append(len(dg._checks.flags))
            return out
        return real(counted, *args, **kwargs)

    os.environ["ECHO_DEBUG_DEVICE"] = "1"
    dg.run_checked = spy
    try:
        yield
    finally:
        dg.run_checked = real
        os.environ.pop("ECHO_DEBUG_DEVICE", None)


def repeat_differs(fn, calls: int = 20) -> int:
    """Of `calls` more calls of `fn`, the number whose output is not
    bitwise equal to the first call's; a 4096^2 matmul runs between calls
    so that the card's timing varies."""
    import torch

    first = fn()
    busy = torch.randn(4096, 4096, device=first.device)
    count = 0
    for _ in range(calls):
        busy @ busy
        count += not torch.equal(fn(), first)
    return count


def concurrent_denoises(params, args, threads: int = 2, calls: int = 10) -> list:
    """`denoise.apply` from `threads` threads at once, `calls` times each:
    every output, on the host."""
    import threading

    from echorenderer_tpu_torch.processes import denoise as dn

    outs, errors = [], []

    def work():
        try:
            for _ in range(calls):
                outs.append(dn.apply(params, *args).cpu().numpy())
        except Exception as exc:  # noqa: BLE001 — raised below
            errors.append(exc)

    workers = [threading.Thread(target=work) for _ in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    if errors:
        raise errors[0]
    return outs


def denoise_ms(params, args, allow_tf32: bool, runs: int = 10) -> tuple:
    """`denoise.apply` on the card: (output, median ms). With `allow_tf32`
    its convolutions run as torch's default would run them (TF32), for
    comparison; the port runs them in float32."""
    import torch

    from echorenderer_tpu_torch.processes import denoise as dn

    real = torch.backends.cudnn.flags
    if allow_tf32:
        torch.backends.cudnn.flags = lambda **kw: real(**dict(kw, allow_tf32=True))
    try:
        out = dn.apply(params, *args)
        ms = median_ms(lambda: dn.apply(params, *args), runs=runs)
    finally:
        torch.backends.cudnn.flags = real
    return out, ms


def compose_phase(dev, smi, bench, large) -> None:
    """Phase 9 (see the module docstring): the README's standard profile
    on the card, its composition against the CPU's, checkpoints, the
    device checks and the scheduler. Raises on the first failed check."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from echorenderer_tpu_torch.evaluation.scene_ops import dispatch_summary
    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.processes import composition as comp
    from echorenderer_tpu_torch.processes import denoise as dn
    from echorenderer_tpu_torch.processes import render as trender
    from echorenderer_tpu_torch.processes.checkpoint import resume_render_layer
    from echorenderer_tpu_torch.processes.composition import STANDARD_STACK
    from echorenderer_tpu_torch.processes.scheduler import Device, OperationState
    from echorenderer_tpu_torch.scene.prepare import prepare_scene
    from echorenderer_tpu_torch.utils import diagnostics as dg

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    # --- the README's call, its layers kept on their way into the stack ---
    t = time.perf_counter()
    ball = prepare_scene(scenes.material_ball())  # the card: the entry point's default
    prep_s = time.perf_counter() - t
    prof = trender.standard_path_traced_profile(1.0, COMPOSE_RES)
    captured = {}
    real_compose = trender.compose_on

    def keep_inputs(device, layers, operators):
        captured.update(layers)
        return real_compose(device, layers, operators)

    tf32 = torch.backends.cudnn.allow_tf32
    zero_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trender.compose_on = keep_inputs
    t = time.perf_counter()
    try:
        out = trender.render(ball, prof)
    finally:
        trender.compose_on = real_compose
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launched = {k: v for k, v in launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    infos = out["__info__"]
    for ep in prof.evaluations:
        info = infos[ep.layer_name]
        d = info["dispatch"]
        log(f"[compose] material_ball {COMPOSE_RES[0]}x{COMPOSE_RES[1]} layer {ep.layer_name} "
            f"({ep.evaluator}): {info['seconds']:.4f} s, {info['epochs']} epochs, "
            f"{info['samples']} samples, {info['samples_per_second'] / 1e6:.3f} Mspps; dispatch "
            f"{d['integrator']} / {d['accelerator']} ({d['accelerator_reason']}) | {smi}")
    log(f"[compose] README call render(prepare_scene(scenes.material_ball()), "
        f"standard_path_traced_profile(1.0, {COMPOSE_RES})): {wall:.4f} s wall (prepare "
        f"{prep_s:.3f} s), peak {peak:.3f} GiB, launches {launched} | {smi}")
    if "composition_errors" in infos:
        raise AssertionError(f"composition errors on the card: {infos['composition_errors']}")
    main = out["main"]
    if main.shape != (prof.resolution[1], prof.resolution[0], 3) or not np.isfinite(main).all():
        raise AssertionError(f"main {main.shape} not finite or not the frame's shape")
    if main.min() < 0.0 or main.max() > 1.0:
        raise AssertionError(f"main leaves [0, 1]: {main.min()} .. {main.max()}")
    if infos["main"]["dispatch"]["integrator"] != "megakernel" or not launched.get("mega"):
        raise AssertionError("the path layer did not run on the megakernel")
    aov = dispatch_summary(ball)["accelerator"]
    if (aov == "dense-stream") != bool(launched.get("dense_trace")):
        raise AssertionError(f"AOV accelerator {aov} but dense trace launches "
                             f"{launched.get('dense_trace', 0)}")

    # --- the stack by operator, and the card's compose against the CPU's ---
    layers_dev = {k: torch.as_tensor(v, device=dev) for k, v in captured.items()}
    for label, stack in (("the standard profile's stack", prof.composition),
                         ("composition.STANDARD_STACK", STANDARD_STACK)):
        ms = stack_ms(layers_dev, stack)
        log(f"[compose] {label}, ms by operator at {prof.resolution[0]}x{prof.resolution[1]} "
            f"(median of 5, CUDA events): " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
            + f"; total {sum(ms.values()):.4f} | {smi}")
    card, errors = trender.compose_on(dev, captured, prof.composition)
    host, host_errors = trender.compose_on(cpu, captured, prof.composition)
    if errors or host_errors:
        raise AssertionError(f"composition errors: card {errors}, CPU {host_errors}")
    if not np.array_equal(card["main"], main):
        raise AssertionError(f"the card's compose of the same layers differs from render's: max "
                             f"|diff| {float(np.abs(card['main'] - main).max())}")
    err_main = float(np.abs(card["main"] - host["main"]).max())
    args = lambda d: tuple(torch.as_tensor(captured[k], device=d)[None][..., :3]
                           for k in ("main", "albedo", "normal_depth"))
    load_s = []
    for _ in range(10):
        t = time.perf_counter()
        params = dn.load_params(device=dev)
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t)
    load_ms = statistics.median(load_s) * 1e3
    den_card, den_ms = denoise_ms(params, args(dev), allow_tf32=False)
    den_tf32, tf32_ms = denoise_ms(params, args(dev), allow_tf32=True)
    den_cpu = dn.apply(dn.load_params(device=cpu), *args(cpu)).numpy()
    den_card, den_tf32 = den_card.cpu().numpy(), den_tf32.cpu().numpy()
    err_den = float(np.abs(den_card - den_cpu).max())
    err_tf32 = float(np.abs(den_tf32 - den_cpu).max())
    rel = lambda x: float((np.abs(x - den_cpu) / (np.abs(den_cpu) + 1e-6)).max())
    log(f"[compose] card against CPU compose: main max |diff| {err_main:.3e} (atol "
        f"{COMPOSE_MAIN_ATOL}); denoiser alone max |diff| {err_den:.3e}, max rel "
        f"{rel(den_card):.3e} (rtol {DENOISE_TOL['rtol']}, atol {DENOISE_TOL['atol']}), "
        f"{den_ms:.4f} ms; with TF32 convolutions (torch's default) max |diff| "
        f"{err_tf32:.3e}, max rel {rel(den_tf32):.3e}, {tf32_ms:.4f} ms; "
        f"load_params(device=cuda) alone {load_ms:.4f} ms (median of 10, host clock, "
        f"synchronized) | {smi}")
    if err_main > COMPOSE_MAIN_ATOL:
        raise AssertionError(f"card compose off the CPU's by {err_main}")
    np.testing.assert_allclose(den_card, den_cpu, **DENOISE_TOL)
    # two threads denoising at once (the scheduler's and the caller's): each
    # output float32, and the process's cuDNN flags as they were
    outs = concurrent_denoises(params, args(dev))
    for o in outs:
        np.testing.assert_allclose(o, den_cpu, **DENOISE_TOL)
    same = sum(np.array_equal(o, den_card) for o in outs)
    log(f"[compose] 2 threads x 10 denoises at once: all within rtol {DENOISE_TOL['rtol']} / "
        f"atol {DENOISE_TOL['atol']} of the CPU's, {same} of {len(outs)} bitwise equal to the "
        f"single-threaded output; cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32} after "
        f"(was {tf32})")
    if torch.backends.cudnn.allow_tf32 != tf32:
        raise AssertionError("the denoiser changed torch.backends.cudnn.allow_tf32")
    # each operator called again and again on the same layers: the port's
    # must give the same bits every call (torch.cumsum, which AutoExposure
    # does not use, as the yardstick)
    vector = layers_dev["main"].reshape(-1)
    repeats = {"torch.cumsum": repeat_differs(lambda: torch.cumsum(vector, 0)),
               "composition._inclusive_sum": repeat_differs(lambda: comp._inclusive_sum(vector))}
    for op in list(STANDARD_STACK) + [comp.LearnedDenoise()]:
        repeats[type(op).__name__] = repeat_differs(lambda op=op: op.apply(dict(layers_dev))["main"])
    log("[compose] calls of 20 not bitwise equal to the first (a matmul between calls): "
        + ", ".join(f"{k} {v}" for k, v in repeats.items()))
    nondeterministic = [k for k, v in repeats.items() if v and k != "torch.cumsum"]
    if nondeterministic:
        raise AssertionError(f"operators whose bits differ from call to call: {nondeterministic}")
    del layers_dev

    # --- checkpoints: resumed against uninterrupted, on the megakernel and
    # on the wavefront ---
    hdr = prepare_scene(scenes.hdr_environment())
    with tempfile.TemporaryDirectory() as tmp:
        for label, scene, res, spp, integrator in (
                ("sphere_field(80)", bench, (320, 180), 8, "megakernel"),
                ("hdr_environment", hdr, (320, 180), 4, "wavefront")):
            one = trender.EvaluationProfile(samples_per_epoch=spp, min_epoch=1, max_epoch=1,
                                            noise_threshold=0.0, bounce_limit=16)
            three = dataclasses.replace(one, min_epoch=3, max_epoch=3)
            path = Path(tmp) / f"{integrator}.npz"
            zero_launch_counts()
            resume_render_layer(scene, one, res, path)
            resumed, info = resume_render_layer(scene, three, res, path)
            mega = launch_counts()["mega"]
            straight, _ = resume_render_layer(scene, three, res, Path(tmp) / "straight.npz")
            same = np.array_equal(resumed, straight)
            log(f"[compose] checkpoint {label} {res[0]}x{res[1]} {spp} spp: 1 epoch, resumed to "
                f"{info['epochs']}, against 3 straight: "
                f"{'bitwise equal' if same else 'DIFFERENT'}; dispatch "
                f"{dispatch_summary(scene)['integrator']}, megakernel launches {mega}")
            if not same or info["epochs"] != 3 or np.abs(straight).sum() == 0:
                raise AssertionError(f"{label}: the resumed render differs from the uninterrupted")
            if dispatch_summary(scene)["integrator"] != integrator or (
                    (mega > 0) != (integrator == "megakernel")):
                raise AssertionError(f"{label}: expected the {integrator}")
            (Path(tmp) / "straight.npz").unlink()
    del hdr

    # --- device checks: the first epoch under run_checked ---
    checked_prof = trender.EvaluationProfile(samples_per_epoch=4, max_epoch=1, bounce_limit=16,
                                             adaptive=False)
    for label, scene, integrator in (("sphere_field(2400)", large, "wavefront"),
                                     ("sphere_field(80)", bench, "megakernel")):
        counts = []
        zero_launch_counts()
        with debug_checks(counts):
            checked, _ = trender.render_layer(scene, checked_prof, (320, 180))
        launched = launch_counts()
        plain, _ = trender.render_layer(scene, checked_prof, (320, 180))
        same = np.array_equal(checked, plain)
        log(f"[compose] ECHO_DEBUG_DEVICE=1 {label} 320x180 4 spp: {len(counts)} checked epoch, "
            f"{counts} flags read in one transfer, image "
            f"{'bitwise equal' if same else 'DIFFERENT'} to the unchecked render; launches "
            f"megakernel {launched['mega']}, dense {launched['dense_trace']}/"
            f"{launched['dense_occlude']}")
        if not same or len(counts) != 1:
            raise AssertionError(f"{label}: the checked render differs or did not run checked")
        if integrator == "wavefront" and (not counts[0] or counts[0] % 3 or launched["mega"]):
            raise AssertionError(f"{label}: path_step's checks did not run on the wavefront")
        if integrator == "megakernel" and (counts[0] or not launched["mega"]):
            raise AssertionError(f"{label}: the checks rerouted the megakernel's frame")
    bad = torch.tensor([1.0, float("inf")], device=dev)
    os.environ["ECHO_DEBUG_DEVICE"] = "1"
    try:
        dg.run_checked(lambda: dg.dcheck(torch.isfinite(bad), "non-finite on the card"))
        raised = ""
    except AssertionError as exc:
        raised = str(exc)
    finally:
        os.environ.pop("ECHO_DEBUG_DEVICE", None)
    log(f"[compose] run_checked over a non-finite card tensor raised: {raised!r}")
    if raised != "non-finite on the card":
        raise AssertionError("run_checked passed a non-finite tensor")

    # --- the scheduler: evaluations then composition on its thread ---
    small = trender.standard_path_traced_profile(1.0, (320, 180))
    device = Device()
    try:
        t = time.perf_counter()
        ops = device.schedule_render(ball, small)
        if not device.await_idle(timeout=300):
            raise AssertionError("the scheduled render did not finish")
        sched_s = time.perf_counter() - t
    finally:
        device.dispose()
    states = [(o.name, o.state.value, o.error) for o in ops]
    if any(o.state != OperationState.COMPLETED for o in ops) or ops[-1].result:
        raise AssertionError(f"scheduled render: {states}, composition errors {ops[-1].result}")
    want = trender.render(ball, small)
    got = device._render_layers
    differ = [k for k in got if not np.array_equal(got[k], want[k])]
    log(f"[compose] Device().schedule_render(material_ball, standard profile "
        f"{small.resolution[0]}x{small.resolution[1]}): "
        f"{[o.name for o in ops]} completed in {sched_s:.3f} s; layers {sorted(got)} "
        f"{'bitwise equal to render' if not differ else f'DIFFERENT: {differ}'}")
    if differ or sorted(got) != sorted(k for k in want if k != "__info__"):
        raise AssertionError("the scheduled render's layers differ from render's")
    torch.cuda.synchronize()
    log(f"[compose] phase {time.perf_counter() - t0:.1f} s")



# tables of a prepared scene the frontend phase compares: the prim rows, the
# chunk tree and the geometry they were packed from
FRONTEND_TABLES = ("prim_soa.", "hier_soa.", "geometry.")
GRID_ECHO = """# sphere_grid(1_000_000)'s scene, its mesh read from a binary PLY
:scene = new Scene
{{
    .Add(new MeshEntity {{ .Source = "grid.ply" .Material = new Diffuse {{ .Albedo = "0.7 0.6 0.5" }} }})
    .Add(new PlaneEntity {{ .Size = "{plane} {plane}" .Material = new Diffuse {{ .Albedo = "0.4 0.4 0.4" }} }})
    .Add(new AmbientLight {{ .Intensity = "0.5 0.6 0.8" }})
    .Add(new PerspectiveCamera {{ .FieldOfView = "50" .Position = "{eye}" .Rotation = "{pitch!r} 0 0" }})
}}
:prof = new RenderProfile
{{
    .Scene = link scene
    .Resolution = "960 540"
    .EvaluationProfiles = [ new EvaluationProfile {{ .Evaluator = new PathTracedEvaluator .LayerName = "main" .MinEpoch = "1" .MaxEpoch = "1" }} ]
}}
"""


def tables_of(prepared) -> dict:
    """A prepared scene's prim, chunk-tree and geometry tables on the host."""
    from echorenderer_tpu_torch.scene.convert import to_arrays

    return {k: v for k, v in to_arrays(prepared).items() if k.startswith(FRONTEND_TABLES)}


def tables_differ(got: dict, want: dict) -> list:
    """The keys whose arrays are not bitwise equal (shape, dtype, bytes)."""
    import numpy as np

    bad = sorted(set(got) ^ set(want))
    for k in set(got) & set(want):
        a, b = np.ascontiguousarray(got[k]), np.ascontiguousarray(want[k])
        if a.shape != b.shape or a.dtype != b.dtype or a.tobytes() != b.tobytes():
            bad.append(k)
    return bad


def write_grid_ply(path, verts, faces) -> None:
    """A binary little-endian PLY of an indexed triangle mesh: the header,
    the float32 vertices, then a (count, 3 int32) row a face."""
    import numpy as np

    rows = np.empty(len(faces), dtype=[("n", "u1"), ("ids", "<i4", (3,))])
    rows["n"] = 3
    rows["ids"] = faces
    header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(verts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {len(faces)}\nproperty list uchar int vertex_indices\n"
              "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(np.ascontiguousarray(verts, "<f4").tobytes())
        f.write(rows.tobytes())


class BuildRecorder:
    """Records every SAH build prepare_scene makes while active: its boxes,
    leaf_max and seconds, and which builder took it."""

    def __init__(self):
        self.builds = []

    def __enter__(self):
        from echorenderer_tpu_torch.aggregation import bvh
        from echorenderer_tpu_torch.ops import pallas_hier
        from echorenderer_tpu_torch.scene import prepare

        real = bvh.build_bvh

        def record(lo, hi, leaf_max=bvh.LEAF_MAX):
            native = bvh.build_bvh.native_calls
            t = time.perf_counter()
            out = real(lo, hi, leaf_max)
            self.builds.append(dict(lo=lo, hi=hi, leaf_max=leaf_max,
                                    seconds=time.perf_counter() - t,
                                    native=bvh.build_bvh.native_calls > native))
            return out

        self._patched = [(prepare, "build_bvh", prepare.build_bvh),
                         (pallas_hier, "build_bvh", pallas_hier.build_bvh)]
        for mod, name, _ in self._patched:
            setattr(mod, name, record)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._patched:
            setattr(mod, name, fn)


def same_tree(a, b) -> bool:
    return a.root_code == b.root_code and all(
        getattr(a, f).tobytes() == getattr(b, f).tobytes()
        for f in ("child_min", "child_max", "child_code", "prim_order"))


def frontend_phase(dev, smi, grid_tables: dict) -> None:
    """Phase 10 (see the module docstring): the CLI as a user runs it, the
    showcase from its file, cornell.echo through terminal.main and the live
    preview, the 1M-triangle mesh from a PLY file, and the C++ BVH builder.
    Raises on the first failed check."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from echorenderer_tpu_torch import terminal
    from echorenderer_tpu_torch.aggregation import bvh
    from echorenderer_tpu_torch.io import exr, images
    from echorenderer_tpu_torch.io.echo_dsl import EchoSource
    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.processes.render import render
    from echorenderer_tpu_torch.scene.prepare import prepare_scene
    from echorenderer_tpu_torch.ui.preview import PreviewServer, PreviewState, preview_progress
    from echorenderer_tpu_torch.utils.colors import luminance

    t0 = time.perf_counter()
    tmp_dir = tempfile.TemporaryDirectory(prefix="echo_frontend_")
    tmp = Path(tmp_dir.name)
    # --- 1. the CLI as a user runs it, in a subprocess ---
    outs = dict(exr=tmp / "s.exr", png=tmp / "s.png", pfm=tmp / "a.pfm")
    cmd = [sys.executable, "-m", "echorenderer_tpu_torch.terminal", "-p", "scenes/showcase.echo",
           "--profile-name", "standard", "-o", f"main={outs['exr']}", "-o", f"main={outs['png']}",
           "-o", f"albedo={outs['pfm']}"]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t
    layer_lines = [ln for ln in proc.stderr.splitlines() if re.match(r"\[\w+\] [\d,]+ samples", ln)]
    for line in proc.stderr.splitlines():
        if line.startswith(("prepared", "[", "saved")) and "epoch" not in line:
            log(f"[frontend]   cli: {line}")
    log(f"[frontend] CLI `python -m echorenderer_tpu_torch.terminal -p scenes/showcase.echo "
        f"--profile-name standard` exit {proc.returncode} in {cli_s:.2f} s wall | {smi}")
    if proc.returncode != 0:
        raise AssertionError(f"the CLI failed:\n{proc.stdout}\n{proc.stderr}")
    main_line = next(ln for ln in layer_lines if ln.startswith("[main]"))
    cli_mspps = float(re.search(r"\(([\d.]+) Mspps\)", main_line).group(1))
    if "megakernel (fully fused trace+shade, textured form)" not in main_line or cli_mspps <= 0:
        raise AssertionError(f"the CLI's main layer is not on the textured megakernel: {main_line}")
    if ", 0 numpy" not in proc.stderr:
        raise AssertionError("the CLI's prepare_scene did not take the C++ BVH builder")
    prof = EchoSource(REPO / "scenes" / "showcase.echo").construct("standard")
    t = time.perf_counter()
    out = render(prepare_scene(prof.scene, prof.camera_name, device=dev), prof)
    torch.cuda.synchronize()
    inproc_s = time.perf_counter() - t
    for name, info in out["__info__"].items():
        if isinstance(info, dict) and "epochs" in info:  # a layer's, not the stack's
            log(f"[frontend]   in-process {name}: {info['seconds']:.4f} s, {info['epochs']} "
                f"epochs, {info['samples']} samples, "
                f"{info['samples_per_second'] / 1e6:.3f} Mspps")
    same_exr = exr.load_exr(outs["exr"]).tobytes() == out["main"].tobytes()
    same_png = outs["png"].read_bytes() == images.encode_png(out["main"])
    same_pfm = images.load(outs["pfm"]).tobytes() == out["albedo"].tobytes()
    log(f"[frontend] in-process render of the same profile {prof.resolution[0]}x"
        f"{prof.resolution[1]}: {inproc_s:.2f} s; the CLI's EXR "
        f"{'bitwise equal' if same_exr else 'DIFFERENT'}, PNG "
        f"{'equal to its u8 encoding' if same_png else 'DIFFERENT'}, albedo PFM "
        f"{'bitwise equal' if same_pfm else 'DIFFERENT'}")
    if not (same_exr and same_png and same_pfm) or prof.resolution != (960, 540):
        raise AssertionError("the CLI's images differ from the in-process render")

    # --- 3. cornell.echo's :fast profile through terminal.main, then the preview ---
    cornell = REPO / "scenes" / "cornell.echo"
    zero_launch_counts()
    t = time.perf_counter()
    terminal.main(["-p", str(cornell), "--profile-name", "fast", "-o", f"main={tmp / 'c.exr'}"])
    main_s = time.perf_counter() - t
    counts = {k: v for k, v in launch_counts().items() if v}
    prof = EchoSource(cornell).construct("fast")
    scene = prepare_scene(prof.scene, prof.camera_name, device=dev)
    plain = render(scene, prof)
    state = PreviewState()
    server = PreviewServer(state, host="127.0.0.1", port=0).start()
    try:
        tiled = render(scene, prof, progress=preview_progress(state, scene, prof), tile_progress=16)
        base = f"http://127.0.0.1:{server.port}"
        import urllib.request

        with urllib.request.urlopen(f"{base}/status.json", timeout=10) as r:
            status = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/frame.png", timeout=10) as r:
            frame = r.read()
    finally:
        server.stop()
    (tmp / "frame.png").write_bytes(frame)
    decoded = images.load(tmp / "frame.png")
    same_tiled = tiled["main"].tobytes() == plain["main"].tobytes()
    same_cli = exr.load_exr(tmp / "c.exr").tobytes() == plain["main"].tobytes()
    log(f"[frontend] cornell.echo :fast {prof.resolution[0]}x{prof.resolution[1]} through "
        f"terminal.main in {main_s:.2f} s: launches {counts}; its EXR "
        f"{'bitwise equal' if same_cli else 'DIFFERENT'} to render's; preview render "
        f"(tile_progress=16) {'bitwise equal' if same_tiled else 'DIFFERENT'} to the untiled "
        f"one; /status.json {status}; last frame {len(frame)} bytes, decoded "
        f"{decoded.shape}")
    if not (counts.get("mega", 0) + counts.get("mega_textured", 0)) or set(counts) - {
            "mega", "mega_textured"}:
        raise AssertionError(f"cornell.echo did not run on the megakernel alone: {counts}")
    if not (same_tiled and same_cli) or decoded.shape != (180, 320, 3) or status.get(
            "tile_batch") != [16, 16]:
        raise AssertionError("the preview's tiled render or its frames are wrong")

    # --- 4. the 1M-triangle mesh from a PLY file, at full size ---
    k, subdiv = 59, 12  # sphere_grid(1_000_000)
    verts, faces = scenes.sphere_grid_mesh(k, subdiv)
    t = time.perf_counter()
    write_grid_ply(tmp / "grid.ply", verts, faces)
    write_s = time.perf_counter() - t
    extent = k * 2.5
    eye = (extent * 0.5, extent * 0.8, -extent * 0.6)
    # sphere_grid's camera looks at (extent / 2, 0, extent / 2): a pitch down
    pitch = float(np.degrees(np.arctan2(eye[1], extent * 0.5 - eye[2])))
    (tmp / "grid.echo").write_text(GRID_ECHO.format(
        plane=extent * 4, eye=" ".join(repr(float(v)) for v in eye), pitch=pitch))
    args = terminal.build_argparser().parse_args(["-p", str(tmp / "grid.echo")])
    t = time.perf_counter()
    prof = terminal.load_profile(args)
    load_s = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    with BuildRecorder() as rec:
        big = prepare_scene(prof.scene, prof.camera_name, device=dev)
        torch.cuda.synchronize()
    prep_s = time.perf_counter() - t
    differ = tables_differ(tables_of(big), grid_tables)
    log(f"[frontend] sphere_grid_mesh(59, 12) as a binary PLY: {len(faces):,} triangles, "
        f"{(tmp / 'grid.ply').stat().st_size / 2 ** 20:.1f} MiB written in {write_s:.2f} s; "
        f"load_profile (.echo + PLY) {load_s:.2f} s, prepare_scene {prep_s:.2f} s (SAH builds "
        + ", ".join(f"{len(b['lo'])} boxes leaf_max {b['leaf_max']} "
                    f"{'C++' if b['native'] else 'numpy'} {b['seconds']:.3f} s"
                    for b in rec.builds)
        + f"); prim, chunk-tree and geometry tables against prepare_scene(sphere_grid(1_000_000)): "
        f"{'bitwise equal' if not differ else f'DIFFERENT: {differ}'} | {smi}")
    if differ or not all(b["native"] for b in rec.builds):
        raise AssertionError("the PLY scene's tables differ from sphere_grid(1_000_000)'s")
    prim_build = next(b for b in rec.builds if b["leaf_max"] == bvh.LEAF_MAX)
    del big
    zero_launch_counts()
    err = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stderr(err):
        terminal.main(["-p", str(tmp / "grid.echo"), "-r", "960x540", "-o",
                       f"main={tmp / 'g.exr'}"])
    grid_main_s = time.perf_counter() - t
    counts = {k: v for k, v in launch_counts().items() if v}
    for line in err.getvalue().splitlines():
        if "epoch" not in line:
            log(f"[frontend]   grid cli: {line}")
    image = exr.load_exr(tmp / "g.exr")
    lum = float(luminance(torch.as_tensor(np.ascontiguousarray(image))).mean())
    log(f"[frontend] the PLY scene 960x540 through terminal.main: {grid_main_s:.2f} s (load, "
        f"prepare, render, write); launches {counts}; EXR {image.shape}, mean luminance "
        f"{lum:.4f} | {smi}")
    if image.shape != (540, 960, 3) or not np.isfinite(image).all() or not 0.01 < lum < 10:
        raise AssertionError(f"the PLY scene's image is not finite or its luminance {lum} is out "
                             f"of (0.01, 10)")
    if min(counts.get(k, 0) for k in ("hier_trace", "setup", "select", "seg")) <= 0 or (
            set(counts) - {"hier_trace", "hier_occlude", "setup", "select", "seg"}):
        raise AssertionError(f"the PLY scene did not run on the hier and binned kernels: {counts}")

    # --- 5. the C++ builder against the numpy builder ---
    with BuildRecorder() as rec250:
        prepare_scene(scenes.sphere_grid(250_000), device=dev)
    for b in rec250.builds + [prim_build]:
        t = time.perf_counter()
        want = bvh.build_bvh_numpy(b["lo"], b["hi"], b["leaf_max"])
        numpy_s = time.perf_counter() - t
        got = bvh.build_bvh(b["lo"], b["hi"], b["leaf_max"])
        same = same_tree(got, want)
        log(f"[frontend] SAH build of {len(b['lo']):,} boxes leaf_max {b['leaf_max']}: C++ "
            f"{b['seconds']:.3f} s (in prepare_scene), numpy {numpy_s:.3f} s; child_min, "
            f"child_max, child_code, prim_order, root {'bitwise equal' if same else 'DIFFERENT'}"
            f" | {smi}")
        if not same:
            raise AssertionError("the C++ BVH builder disagrees with the numpy builder")
    log(f"[frontend] sphere_grid(1_000_000) from its PLY: prepare_scene {prep_s:.2f} s with the "
        f"C++ build {prim_build['seconds']:.3f} s | {smi}")
    log(f"[frontend] SAH builds of the run: {bvh.build_bvh.native_calls} C++, "
        f"{bvh.build_bvh.numpy_calls} numpy")
    if bvh.build_bvh.numpy_calls or not bvh.build_bvh.native_calls:
        raise AssertionError("a prepare_scene of the run did not take the C++ BVH builder")
    tmp_dir.cleanup()
    log(f"[frontend] phase {time.perf_counter() - t0:.1f} s")


MULTIGPU_RES = (960, 540)  # the bench frame
MULTIGPU_SPP = 64  # the bench render's epoch
MULTIGPU_PROCESS_SPP = 16  # the multi-process frame
MULTIGPU_SHARDS = (1, 2, 4)
MULTIGPU_JOIN_S = 150  # a rank's join timeout


def multigpu_rank(rank: int, world: int, backend: str, store_path: str, out_path: str) -> None:
    """One process of the [multigpu] phase's multi-process frame (spawned):
    join the group over a file store, render this rank's shards of the
    bench frame through render_frame_multihost on cuda:0, save the image
    and a JSON of its times beside it."""
    from datetime import timedelta

    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch
    import torch.distributed as dist

    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.parallel import multihost
    from echorenderer_tpu_torch.scene.prepare import prepare_scene

    t0 = time.perf_counter()
    store = dist.FileStore(store_path, world)
    if world > 1:
        if not multihost.initialize(store, world_size=world, rank=rank, backend=backend,
                                    timeout_s=MULTIGPU_JOIN_S):
            raise AssertionError("initialize() did not join the process group")
    else:  # initialize() does nothing for a world of one: join it directly
        dist.init_process_group(backend, store=store, world_size=1, rank=0,
                                timeout=timedelta(seconds=MULTIGPU_JOIN_S))
    mesh = multihost.make_global_mesh(devices=["cuda:0"])
    info = multihost.process_shard_info(mesh)
    if info != (rank, world, 1) or dist.get_backend() != backend:
        raise AssertionError(f"shard info {info}, backend {dist.get_backend()}")
    scene = prepare_scene(scenes.sphere_field(80), device="cuda:0")
    torch.cuda.synchronize()
    times = dict(set_up_s=time.perf_counter() - t0, frame_s=[], gather_ms=[])
    for run in range(2):  # the first gather also sets up the backend's communicator
        t1 = time.perf_counter()
        img = multihost.render_frame_multihost(mesh, scene, MULTIGPU_RES,
                                               spp=MULTIGPU_PROCESS_SPP, bounce_limit=16)
        times["frame_s"].append(time.perf_counter() - t1)
        times["gather_ms"].append(multihost.render_frame_multihost.gather_ms)
        if run == 0:
            first = img
    if not np.array_equal(first, img):
        raise AssertionError("the second frame differs from the first")
    np.save(out_path, img)
    with open(out_path + ".json", "w") as f:
        json.dump(times, f)
    dist.destroy_process_group()


def multigpu_processes(tmp: str) -> list:
    """The [multigpu] phase's processes, all at once on cuda:0: two gloo
    ranks and one NCCL world of one. Returns (label, rank, image path) of
    each; raises when a process fails or outlives its join timeout."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    runs = [("gloo", 2, r, f"{tmp}/gloo.store") for r in range(2)]
    runs.append(("nccl", 1, 0, f"{tmp}/nccl.store"))
    procs = []
    for backend, world, rank, store in runs:
        out = f"{tmp}/{backend}{rank}.npy"
        p = ctx.Process(target=multigpu_rank, args=(rank, world, backend, store, out))
        p.start()
        procs.append((p, (f"{backend} world {world}", rank, out)))
    deadline = time.monotonic() + MULTIGPU_JOIN_S
    failed = []
    for p, (label, rank, _) in procs:
        p.join(max(1.0, deadline - time.monotonic()))
        if p.is_alive():
            failed.append(f"{label} rank {rank} still running after {MULTIGPU_JOIN_S} s")
        elif p.exitcode != 0:
            failed.append(f"{label} rank {rank} exit code {p.exitcode}")
    for p, _ in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if failed:
        raise AssertionError("; ".join(failed))
    return [meta for _, meta in procs]


def multigpu_phase(dev, smi, bench) -> None:
    """Phase 11 (see the module docstring): the pixel shards of parallel/ on
    the card. Raises on the first failed check."""
    import tempfile

    import numpy as np
    import torch

    from echorenderer_tpu_torch.entry import dryrun_multichip
    from echorenderer_tpu_torch.evaluation.wavefront import sample_frame_wavefront
    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.parallel import (make_mesh, render_epoch_sharded,
                                                 render_frame_sharded)
    from echorenderer_tpu_torch.processes.tiles import lane_order
    from echorenderer_tpu_torch.scene.prepare import prepare_scene

    t_phase = time.perf_counter()
    # --- 1. the bench frame over 1, 2 and 4 shards and unsharded
    res, spp = MULTIGPU_RES, MULTIGPU_SPP
    n_px = res[0] * res[1]
    perm, inv = lane_order(res)
    pid = torch.as_tensor(perm.astype(np.int64), device=dev)
    pxy = torch.stack([pid % res[0], pid // res[0]], dim=-1).to(torch.int32)
    inv = torch.as_tensor(inv.astype(np.int64), device=dev)
    zero_launch_counts()
    ref_sum, ref_sq = sample_frame_wavefront(bench, pid, pxy, res, 0, 0, spp, bounce_limit=16)
    ref_launches = count_of("launches.mega")
    ref_sum, ref_sq = ref_sum[inv], ref_sq[inv]
    for k in MULTIGPU_SHARDS:
        mesh = make_mesh(1) if k == 1 else make_mesh(devices=[dev] * k)
        secs = []
        for run in range(3):
            if run == 0:
                zero_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s_sum, s_sq, counter = render_epoch_sharded(mesh, bench, res, 0, 0, spp,
                                                        bounce_limit=16)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if run == 0:
                grew = launch_counts()
            if not (torch.equal(s_sum, ref_sum) and torch.equal(s_sq, ref_sq)):
                differ = int((s_sum != ref_sum).any(-1).sum())
                raise AssertionError(f"bench over {k} shard(s): {differ} pixels not bitwise the "
                                     f"unsharded call's")
        padded = -(-n_px // k) * k
        others = {key: v for key, v in grew.items() if v and key != "mega"}
        log(f"[multigpu] sphere_field(80) {res[0]}x{res[1]} {spp} spp bounce 16 over {k} "
            f"shard(s) on {[str(d) for d in mesh.devices]}: {n_px * spp / min(secs) / 1e6:.3f} "
            f"Mspps (best of 3; seconds " + ", ".join(f"{t:.4f}" for t in secs) + f"), counter "
            f"{float(counter[0]):.0f} = {padded} x {spp}, megakernel launches {grew['mega']} "
            f"(unsharded call: {ref_launches}), bitwise the unsharded call | {smi}")
        if grew["mega"] != k or others or float(counter[0]) != padded * spp:
            raise AssertionError(f"bench over {k} shards: launches {grew}, counter "
                                 f"{float(counter[0])}")
    del ref_sum, ref_sq, s_sum, s_sq, pid, pxy, inv

    # --- 2. the TLAS slice at its full width over 1 and 2 shards
    t0 = time.perf_counter()
    tlas = prepare_scene(scenes.instanced_sphere_grids(), instancing="tlas", device=dev)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    res = INSTANCED_RES
    sums = {}
    for k in (1, 2):
        mesh = make_mesh(devices=[dev] * k)
        zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_sum, s_sq, _ = render_epoch_sharded(mesh, tlas, res, 0, 0, 1, bounce_limit=6)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        grew = launch_counts()
        sums[k] = (s_sum, s_sq)
        log(f"[multigpu] instanced_sphere_grids() (TLAS) {res[0]}x{res[1]} 1 spp bounce 6 over "
            f"{k} shard(s): {res[0] * res[1] / secs / 1e6:.4f} Mspps ({secs:.3f} s; prepare "
            f"{prep_s:.2f} s); launches " + ", ".join(f"{key} {v}" for key, v in grew.items() if v)
            + f" | {smi}")
        others = [key for key, v in grew.items() if v and key not in INSTANCED_PATH]
        if min(grew[key] for key in INSTANCED_PATH) <= 0 or others:
            raise AssertionError(f"TLAS over {k} shards not on the instanced kernels alone: {grew}")
    (a, a2), (b, b2) = sums[1], sums[2]
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("TLAS frame not finite")
    if not (torch.equal(a, b) and torch.equal(a2, b2)):
        differ = (a != b).any(-1)
        raise AssertionError(f"TLAS over 2 shards: {int(differ.sum())} pixels not bitwise the "
                             f"1-shard frame's (largest difference "
                             f"{float((a - b).abs().max()):.3e})")
    log(f"[multigpu] TLAS 1 and 2 shards bitwise equal")
    del tlas, sums, a, a2, b, b2, s_sum, s_sq

    # --- 3. two gloo processes and one NCCL world of one, all on cuda:0
    res = MULTIGPU_RES
    want = render_frame_sharded(make_mesh(devices=[dev] * 2), bench, res,
                                spp=MULTIGPU_PROCESS_SPP, bounce_limit=16)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        runs = multigpu_processes(tmp)
        wall = time.perf_counter() - t0
        for label, rank, out in runs:
            img = np.load(out)
            with open(out + ".json") as f:
                times = json.load(f)
            same = img.shape == want.shape and np.array_equal(img, want)
            log(f"[multigpu] {label} rank {rank}: set-up {times['set_up_s']:.2f} s; two frames "
                f"(the first gather sets up the communicator): "
                + ", ".join(f"{f:.3f} s with an all-gather of {g:.3f} ms"
                            for f, g in zip(times["frame_s"], times["gather_ms"]))
                + f"; image {'bitwise' if same else 'NOT bitwise'} the in-process 2-shard frame "
                  f"({res[0]}x{res[1]}, {MULTIGPU_PROCESS_SPP} spp) | {smi}")
            if not same:
                raise AssertionError(f"{label} rank {rank}: image differs from the in-process "
                                     f"frame")
    log(f"[multigpu] processes: {len(runs)} in {wall:.1f} s wall, spawn to join")

    # --- 4. the dry run over 4 shards
    t0 = time.perf_counter()
    dryrun_multichip(4)
    log(f"[multigpu] dryrun_multichip(4) passed in {time.perf_counter() - t0:.2f} s; the phase "
        f"{time.perf_counter() - t_phase:.1f} s")


# the [train] phase: the denoiser's trainer at full width (WIDTH 32, 5
# layers, batch 16, 64x64 crops) on a dataset cut to TRAIN_VARIANTS of the
# tool's 10 variants and 1 of its 4 noisy views each (192x128, 1024 clean spp)
TRAIN_VARIANTS = ("cornell", "ball-diffuse", "spheres-80")
TRAIN_VIEWS = 1
TRAIN_STEPS = 200
TRAIN_CHECK_STEPS = 3
TRAIN_WINDOW = 20  # the first and last steps whose mean loss must fall
# the card against the CPU. Each of the first steps from the card's own
# params on the same crops against the CPU's float64 step: the loss (rtol),
# the whole gradient's L2 gap over its L2 length (an H100 at 700 W, float32:
# 7.4e-7, 1.47e-4 and 9.6e-7 on the 3 steps, the second's in b1; its backward
# under torch's defaults, TF32: 7.2e-4 to 8.0e-4, which the bound refuses);
# the CPU's Adam on the card's gradients against the card's step. And a
# CPU float32 run of its own: loss rtol, and each tensor's L2 gap over the
# L2 length of the CPU params' move (Adam parts float32 trajectories at
# ~1e-2, tests/test_torch_train.py)
TRAIN_TOL = dict(loss=1e-5, grad=3e-4, adam_rtol=1e-6, adam_atol=2e-7, free_loss=1e-4,
                 free_move=2e-2)
TRAIN_STATS_SCENE = "material_ball"
TRAIN_STATS_SPP = 64  # the JAX tool's 256, cut to keep the phase short
TILE_BOUNDS = (6.0, 1.5)  # TestTileStats: worst and mean tile z


def train_phase(dev, smi) -> None:
    """Phase 12 (see the module docstring): the learned denoiser's trainer
    and the tile-stats oracle of echorenderer_tpu_torch/tools/ on the card.
    Raises on the first failed check."""
    import numpy as np
    import torch

    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.processes import denoise as dn
    from echorenderer_tpu_torch.processes.render import _sample_frame
    from echorenderer_tpu_torch.scene.prepare import prepare_scene
    from echorenderer_tpu_torch.tools import gen_reference_stats as gs
    from echorenderer_tpu_torch.tools import train_denoiser as tr

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    t = time.perf_counter()
    arrays = tr.build_dataset(None, device=dev, variants=TRAIN_VARIANTS, views=TRAIN_VIEWS,
                              log=lambda m: None)
    data_s = time.perf_counter() - t
    want = (len(TRAIN_VARIANTS) * TRAIN_VIEWS, tr.RES[1], tr.RES[0], 3)
    if any(a.shape != want or not np.isfinite(a).all() for a in arrays):
        raise RuntimeError(f"[train] dataset shapes {[a.shape for a in arrays]}, want {want}, "
                           "or non-finite values")
    log(f"[train] dataset {', '.join(TRAIN_VARIANTS)} at {tr.RES[0]}x{tr.RES[1]}, "
        f"{tr.CLEAN_SPP} clean spp, {TRAIN_VIEWS} noisy view each at {tr.NOISY_SPP} spp "
        f"(cut: {len(TRAIN_VARIANTS)} of the tool's 10 variants, {TRAIN_VIEWS} of its "
        f"{tr.NOISY_VIEWS} views): {want[0]} frames in {data_s:.2f} s | {smi}")
    data = [torch.as_tensor(a, device=dev) for a in arrays]
    data_cpu = [torch.as_tensor(a) for a in arrays]
    size, n_frames = (tr.RES[0], tr.RES[1]), want[0]
    batch, lr = 16, 2e-3

    # --- 1. the card's first steps against the CPU on the same crops
    params = tr.init_params(0, dev)
    opt = tr.make_optimizer(params, lr)
    mirror = tr.init_params(0, cpu)  # the CPU's Adam, fed the card's gradients
    mirror_opt = tr.make_optimizer(mirror, lr)
    free = tr.init_params(0, cpu)  # a CPU run of its own
    free_opt = tr.make_optimizer(free, lr)
    start = {k: v.detach().clone() for k, v in free.items()}
    gen = torch.Generator().manual_seed(42)
    worst = dict(loss=0.0, loss_cpu=0.0, adam=0.0, free_loss=0.0)
    # each step's gap of the whole gradient over its L2 length, and the worst
    # tensor's
    gaps = {who: [] for who in ("card", "cpu", "tf32")}
    for step in range(TRAIN_CHECK_STEPS):
        f, y, x = tr.sample_crops(gen, n_frames, batch, size)
        crops, crops_cpu = tr.crop(data, f, y, x), tr.crop(data_cpu, f, y, x)
        # the same step's loss and gradients on the CPU from the card's
        # params, in float32 and in float64 (the reference)
        ref = {}
        for dtype in (torch.float32, torch.float64):
            here = {k: v.detach().cpu().to(dtype).requires_grad_() for k, v in params.items()}
            with dn.float32_convs():
                loss_here = tr.loss_fn(here, *(c.to(dtype) for c in crops_cpu))
                loss_here.backward()
            ref[dtype] = (float(loss_here.detach()), {k: v.grad.double() for k, v in here.items()})
        # the backward pass as it ran before float32_convs: under torch's
        # defaults (TF32 allowed), the forward in float32 inside apply
        tf32 = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        tr.loss_fn(tf32, *crops).backward()
        loss = float(tr.train_step(params, opt, crops))
        grads = {k: v.grad.detach().cpu().clone() for k, v in params.items()}
        loss64, g64 = ref[torch.float64]
        worst["loss"] = max(worst["loss"], abs(loss - loss64) / loss64)
        worst["loss_cpu"] = max(worst["loss_cpu"], abs(ref[torch.float32][0] - loss64) / loss64)
        for who, g in (("card", grads), ("cpu", ref[torch.float32][1]),
                       ("tf32", {k: v.grad.cpu() for k, v in tf32.items()})):
            d2 = {k: float((g[k].double() - g64[k]).norm() ** 2) for k in g64}
            n2 = {k: float(g64[k].norm() ** 2) for k in g64}
            worst_k = max(g64, key=lambda k: d2[k] / n2[k])
            gaps[who].append((np.sqrt(sum(d2.values()) / sum(n2.values())),
                              np.sqrt(d2[worst_k] / n2[worst_k]), worst_k))
        for k, v in mirror.items():
            v.grad = grads[k].clone()
        mirror_opt.step()
        for k, v in mirror.items():
            got, want = params[k].detach().cpu(), v.detach()
            worst["adam"] = max(worst["adam"], float((got - want).abs().max()))
            if not torch.allclose(got, want, rtol=TRAIN_TOL["adam_rtol"],
                                  atol=TRAIN_TOL["adam_atol"]):
                raise RuntimeError(f"[train] step {step} {k}: the card's Adam step is "
                                   f"{float((got - want).abs().max()):.3e} from the CPU's on "
                                   "the same gradients")
        free_loss = float(tr.train_step(free, free_opt, crops_cpu))
        worst["free_loss"] = max(worst["free_loss"], abs(loss - free_loss) / free_loss)
    move = max(float((params[k].detach().cpu() - free[k].detach()).norm()
                     / (free[k].detach() - start[k]).norm()) for k in free)
    gap = lambda who: ", ".join(f"{a:.3e} ({b:.2e} {k})" for a, b, k in gaps[who])
    grad_gap = max(a for a, _, _ in gaps["card"])
    log(f"[train] the card's first {TRAIN_CHECK_STEPS} steps (batch {batch} of "
        f"{tr.CROP}x{tr.CROP} crops, WIDTH {dn.WIDTH}, {len(dn.DILATIONS)} layers) against the "
        f"CPU's float64 step from the same params on the same crops: loss {worst['loss']:.3e} "
        f"(rtol {TRAIN_TOL['loss']}; the CPU's float32 {worst['loss_cpu']:.3e}); gradients, "
        f"by step the whole gradient's gap over its L2 length (the worst tensor's): "
        f"{gap('card')} (tol {TRAIN_TOL['grad']}; the CPU's float32 {gap('cpu')}; the "
        f"card's backward under torch's defaults, TF32: {gap('tf32')}); the CPU's Adam on the "
        f"card's gradients {worst['adam']:.3e} from the card's step (rtol "
        f"{TRAIN_TOL['adam_rtol']}, atol {TRAIN_TOL['adam_atol']}); a CPU float32 run of its "
        f"own: loss {worst['free_loss']:.3e} (rtol {TRAIN_TOL['free_loss']}), params "
        f"{move:.3e} of their move (tol {TRAIN_TOL['free_move']}) | {smi}")
    if worst["loss"] > TRAIN_TOL["loss"] or grad_gap > TRAIN_TOL["grad"]:
        raise RuntimeError(f"[train] the card's loss or gradients outside tolerance: {worst}, "
                           f"{gaps}")
    if worst["free_loss"] > TRAIN_TOL["free_loss"] or move > TRAIN_TOL["free_move"]:
        raise RuntimeError(f"[train] the free CPU run parted from the card's: {worst}, {move}")

    # --- 2. two runs from one seed, bitwise; the loss falls
    runs = []
    for _ in range(2):
        params = tr.init_params(0, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses = tr.train(params, data, TRAIN_STEPS, batch, lr, seed=42, log_every=0)
        torch.cuda.synchronize()
        runs.append((losses.cpu(), {k: v.detach().cpu() for k, v in params.items()},
                     time.perf_counter() - t))
    (la, pa, sa), (lb, pb, sb) = runs
    if not torch.equal(la, lb) or any(not torch.equal(pa[k], pb[k]) for k in pa):
        raise RuntimeError("[train] two runs from one seed differ")
    first, last = float(la[:TRAIN_WINDOW].mean()), float(la[-TRAIN_WINDOW:].mean())
    log(f"[train] {TRAIN_STEPS} steps twice from one seed: loss traces and params bitwise "
        f"equal; {TRAIN_STEPS / sa:.2f} and {TRAIN_STEPS / sb:.2f} steps/s ({sa:.2f} s, "
        f"{sb:.2f} s); mean loss of the first {TRAIN_WINDOW} steps {first:.6f}, of the last "
        f"{last:.6f} | {smi}")
    if not last < first:
        raise RuntimeError(f"[train] the loss did not fall: {first} -> {last}")
    if (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic) != flags:
        raise RuntimeError("[train] the cuDNN flags changed")

    # --- 3. the tile-stats oracle at 960x540 against the port's 2-spp path
    # render (a finding: gates nothing)
    scene = prepare_scene(getattr(scenes, TRAIN_STATS_SCENE)(), device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    s_sum, s_sq = gs.naive_sums(scene, TRAIN_STATS_SPP, gs.RES)
    stats_s = time.perf_counter() - t
    stats = gs.stats_arrays(s_sum, s_sq, TRAIN_STATS_SPP, gs.RES)
    if not all(np.isfinite(stats[k]).all() for k in ("mean", "var")):
        raise RuntimeError("[train] non-finite tile statistics")
    path_sum, _ = _sample_frame(scene, "path", gs.RES, 0, 0, 2, gs.BOUNCE_LIMIT, gs.SURVIVABILITY)
    path_sum = path_sum.cpu().numpy()
    z = gs.tile_z(path_sum, 2, stats)
    with np.load(REPO / "tests" / "fixtures" / "tile_stats" / f"{TRAIN_STATS_SCENE}.npz") as ref:
        z_fix = gs.tile_z(path_sum, 2, dict(ref))
    log(f"[train] gen_reference_stats {TRAIN_STATS_SCENE} {gs.RES[0]}x{gs.RES[1]} naive "
        f"{TRAIN_STATS_SPP} spp (the JAX tool's 256 cut) in {stats_s:.2f} s; the port's 2-spp "
        f"path render against these card-made stats: worst tile z {float(z.max()):.4f}, mean "
        f"{float(z.mean()):.4f} (TestTileStats's bounds {TILE_BOUNDS[0]} and {TILE_BOUNDS[1]}); "
        f"against the committed TPU-made fixture: worst {float(z_fix.max()):.4f}, mean "
        f"{float(z_fix.mean()):.4f} | {smi}")
    log(f"[train] phase {time.perf_counter() - t_phase:.1f} s")


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

    from echorenderer_tpu_torch.benchmarks import plucker_micro as pm
    from echorenderer_tpu_torch.entry import entry
    from echorenderer_tpu_torch.evaluation.scene_ops import dispatch_summary
    from echorenderer_tpu_torch.evaluation.wavefront import cascade_widths
    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.evaluation import scene_ops
    from echorenderer_tpu_torch.ops import binned_trace as bt
    from echorenderer_tpu_torch.ops import cuda_build
    from echorenderer_tpu_torch.ops import megakernel as mk
    from echorenderer_tpu_torch.ops import pallas_hier as ph
    from echorenderer_tpu_torch.ops import pallas_intersect as pi
    from echorenderer_tpu_torch.processes.render import (EvaluationProfile, _sample_frame,
                                                         render_layer)
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

    # --- build: one nvcc per source, all started together ---
    t_build = time.perf_counter()
    builds = cuda_build.build()
    log(f"[build] {len(builds)} libraries in {time.perf_counter() - t_build:.2f} s wall, "
        f"flags {' '.join(cuda_build.NVCC_FLAGS)}")
    for stem, built in builds.items():
        log(f"[build] {built.path.name}: {built.seconds:.2f} s nvcc")
        for line in built.ptxas.splitlines():
            if any(w in line for w in ("registers", "Compiling entry", "spill", "warning")):
                log(f"[build]   {line.strip()}")
    forms = ptxas_forms(builds["megakernel"].ptxas, "mega_kernel")
    named = {}
    for name, report in forms.items():
        form = next((f for key, f in MEGA_FORMS.items() if key in name), None)
        named[form] = report
        log(f"[build] megakernel {form} form ({name}): {report}")
    if set(named) != set(MEGA_FORMS.values()):
        return fail(f"expected the megakernel's three forms in the ptxas report, got {forms}")
    MEGA_PTXAS.update(untextured=named["untextured"], textured=named["textured"])
    for kernel in ("trace_kernel", "occlude_kernel"):
        for name, report in ptxas_forms(builds["dense_intersect"].ptxas, kernel).items():
            log(f"[build] dense form ({name}): {report}")
            for tri, sph in ((True, True), (True, False), (False, True)):
                if f"ILb{int(tri)}ELb{int(sph)}E" in name:
                    DENSE_PTXAS[(kernel == "occlude_kernel", tri, sph)] = report
    hier_forms = ptxas_forms(builds["hier_walk"].ptxas, "hier_kernel")
    for name, report in hier_forms.items():
        log(f"[build] hier_kernel form ({name}): {report}")
    for key in [(t, s, a, i) for t in (True, False) for s in (True, False) if t or s
                for a in (False, True) for i in (False, True)]:
        tag = "I" + "".join(f"Lb{int(b)}E" for b in key) + "E"  # its template arguments
        WALK_PTXAS[key] = next(r for n, r in hier_forms.items() if tag in n)
    WALK_PTXAS["mega"] = named["chunk-tree"]
    seg_forms = ptxas_forms(builds["binned"].ptxas, "seg_kernel")
    BINNED_PTXAS[0] = builds["binned"].ptxas
    for kernel in ("setup_", "select_"):
        for name, report in ptxas_forms(builds["binned"].ptxas, kernel).items():
            log(f"[build] binned form ({name}): {report}")
    for key in [(t, s, i, k) for t in (True, False) for s in (True, False) if t or s
                for i in (True, False) for k in (True, False)]:
        tag = "I" + "".join(f"Lb{int(b)}E" for b in key) + "E"  # its template arguments
        SEG_PTXAS[key] = next(r for n, r in seg_forms.items() if tag in n)
    for key, report in sorted(SEG_PTXAS.items(), reverse=True):
        log(f"[build] seg_kernel<{', '.join(str(int(b)) for b in key)}> (has_tri, has_sph, "
            f"instanced, keyed): {report}")
    pi._load()
    mk._load()
    ph._load()
    bt._load()
    pm._load()
    t_run = time.perf_counter()

    # --- kernel phase: dense kernels ---
    rs = np.random.RandomState(2024)
    bench = prepare_scene(scenes.sphere_field(80), device=dev)
    rays_a = random_rays(rs, N_RAYS, [-20, 0.05, -20], [20, 4, 20], bench.prim_soa.num_prims)
    err_a, _, _ = compare_dense("sphere_field(80) random rays", bench.prim_soa,
                                dense_calls(bench.prim_soa, rays_a, dev), plain_runs=5, smi=smi)
    t_bvh = time.perf_counter()
    big, rays_b = soup_42k(rs, dev)
    log(f"[kernels] synthetic scene: {big.num_prims} prims, BVH order and rays in "
        f"{time.perf_counter() - t_bvh:.2f} s")
    err_b, _, _ = compare_dense("synthetic 42k", big, dense_calls(big, rays_b, dev),
                                plain_runs=1, smi=smi)
    del big, rays_b
    # the calls the wavefront path makes: the slice's render, recorded
    large = prepare_scene(scenes.sphere_field(2400), device=dev)
    prof8 = EvaluationProfile(samples_per_epoch=8, max_epoch=1, bounce_limit=16,
                              survivability=2.5, adaptive=False)
    err_c, ms_c, bound_c = compare_dense(
        "sphere_field(2400) 320x180 8 spp, the wavefront path's calls", large.prim_soa,
        recorded_calls(large, (320, 180), 8, 16), plain_runs=5, smi=smi)
    # the calls a mid-size triangle mesh makes on the wavefront path: every
    # call, the plain version on each (about 0.1 s a call on the card)
    mesh = prepare_scene(scenes.sphere_grid(MESH_GRID), device=dev)
    if scene_ops._use_hier(mesh) or mk.supported(mesh):
        return fail(f"sphere_grid({MESH_GRID}) is not on the dense kernels' path")
    err_d, _, _ = compare_dense(
        f"sphere_grid({MESH_GRID}) 320x180 8 spp bounce 6, the wavefront path's calls",
        mesh.prim_soa, recorded_calls(mesh, (320, 180), 8, 6), plain_runs=0, smi=smi)
    del mesh

    # --- kernel phase: the megakernel against the wavefront ---
    mega_cases = [
        ("sphere_field(80) 960x540", bench, (960, 540)),
        ("cornell 128x128", prepare_scene(scenes.cornell_box(), device=dev), (128, 128)),
        ("material_ball 320x180", prepare_scene(scenes.material_ball(), device=dev), (320, 180)),
        ("many_lights(96) 320x180", prepare_scene(scenes.many_lights(96), device=dev),
         (320, 180)),
        # the top of the envelope: 1,924 triangles, 2048 padded prims
        ("sphere_grid(1900) 320x180", prepare_scene(scenes.sphere_grid(1900), device=dev),
         (320, 180)),
    ]
    mega_err = 0.0
    for label, scene, res in mega_cases:
        if not mk.supported(scene):
            return fail(f"{label} lies outside the megakernel's envelope")
        err, _, _ = compare_mega(label, scene, res, 8, 16, dev)
        mega_err = max(mega_err, err)
    # the launch of the main path's bench render stands for the kernel
    err, mega_ms, mega_bound = compare_mega("sphere_field(80) 960x540", bench, (960, 540), 64,
                                            16, dev)
    mega_err = max(mega_err, err)
    many = mega_cases[3][1]
    if many.lights.tree is None:
        return fail("many_lights(96) prepared without its light tree")
    pid, pxy = tile_lanes((960, 540), dev)
    k1 = mk.sample_frame_mega(bench, pid, pxy, (960, 540), 5, 0, 8, bounce_limit=16, k_slots=1)
    k4 = mk.sample_frame_mega(bench, pid, pxy, (960, 540), 5, 0, 8, bounce_limit=16, k_slots=4)
    same = torch.equal(k1[0], k4[0]) and torch.equal(k1[1], k4[1])
    log(f"[kernels] megakernel k_slots 1 vs 4 on sphere_field(80) 960x540 8 spp: "
        f"{'bitwise equal' if same else 'DIFFERENT'}")
    if not same:
        return fail("megakernel sums depend on k_slots")

    # --- kernel phase: the megakernel's textured form against the wavefront ---
    showcase = prepare_scene(showcase_scene(), device=dev)
    tex_cases = [
        ("showcase 320x180", showcase, (320, 180)),
        ("textured (cloud, gradient) 320x180",
         prepare_scene(texture_scene("textured"), device=dev), (320, 180)),
        ("sphere texture 320x180", prepare_scene(texture_scene("sphere_texture"), device=dev),
         (320, 180)),
        ("normal map + roughness ramp 320x180",
         prepare_scene(texture_scene("rough_normal"), device=dev), (320, 180)),
    ]
    tex_err = 0.0
    for label, scene, res in tex_cases:
        flags = scene.materials.tex_flags
        log(f"[kernels] {label}: {scene.tex_atlas.shape[0]} atlas textures, flags (albedo, "
            f"normal map, roughness) {flags}, {scene.prim_soa.padded} padded prims")
        if not mk.supported(scene) or scene.tex_atlas.shape[0] == 0:
            return fail(f"{label} is not a textured scene inside the megakernel's envelope")
        err, _, _ = compare_mega(label, scene, res, 8, 16, dev)
        tex_err = max(tex_err, err)
    if not tex_cases[3][1].materials.tex_flags[1:] == (True, True):
        return fail("the normal-map scene does not run the normal-map and roughness stages")
    # the launch of the main path's showcase render stands for the textured form
    err, tex_ms, tex_bound = compare_mega("showcase 960x540", showcase, (960, 540), 64, 16, dev)
    tex_err = max(tex_err, err)
    five = prepare_scene(showcase_scene(fifth_texture=True), device=dev)
    reason = mk.unsupported_reason(five)
    zero_launch_counts()
    five_img, five_info = render_layer(five, prof8, (320, 180))
    five_mega = count_of("launches.mega") + count_of("launches.mega_textured")
    log(f"[kernels] showcase + a fifth texture: {five.tex_atlas.shape[0]} atlas textures, "
        f"unsupported_reason {reason!r}; render_layer 320x180 8 spp via "
        f"{five_info['dispatch']['integrator']} ({five_info['dispatch']['integrator_reason']}), "
        f"megakernel launches {five_mega}")
    if (reason != f"more than {mk.MEGA_TEX_LIMIT} textures (one-hot fetch cost)"
            or five_info["dispatch"]["integrator"] != "wavefront"
            or five_mega or not np.isfinite(five_img).all()):
        return fail("the 5-texture scene did not stay outside the megakernel")
    del five, five_img

    # --- golden phase ---
    golden_phase(dev)
    log(f"[time] {time.perf_counter() - t_run:.1f} s after the build")

    # --- kernel phase: the chunk-tree walk of large scenes ---
    torch.cuda.reset_peak_memory_stats()
    t_prep = time.perf_counter()
    grid = prepare_scene(scenes.sphere_grid(1_000_000), device=dev)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t_prep
    prep_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    hsoa = grid.hier_soa
    grid_tables = tables_of(grid)  # for the frontend phase's PLY scene
    log(f"[kernels] sphere_grid(1_000_000): {grid.geometry.num_triangles} triangles, "
        f"{grid.geometry.num_primitives} prims, {hsoa.num_chunks} chunks, "
        f"{hsoa.codes.numel() // 2} nodes, tree depth {hsoa.stack_size - 8} (stack "
        f"{hsoa.stack_size} of {ph.MAX_STACK}); prepared in {t_prep:.2f} s, peak "
        f"{prep_gib:.2f} GiB")
    lo = hsoa.chunk_bounds[:, 0:3].amin(0).tolist()
    hi = hsoa.chunk_bounds[:, 3:6].amax(0).tolist()
    rays_h = random_rays(rs, N_RAYS, [lo[0], 0.05, lo[2]], [hi[0], hi[1] + 1.0, hi[2]],
                         grid.geometry.num_primitives)
    o, d, t_max, ignore = (torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in rays_h)
    call = (pi.ray_columns(o, d, t_max), ph._sorted_ignore(hsoa, ignore))
    err_h, _, _ = compare_hier("sphere_grid(1M) random rays", hsoa,
                               dict(trace=[call], occlude=[call]))
    # the binned traversal on the same rays: every launch checked, then
    # each call against the hier kernels
    zero_launch_counts()
    with BinnedCheck(hsoa) as check_rnd:
        bt._Walk(*call, hsoa, False).traverse()
        bt._Walk(*call, hsoa, True).traverse()
    log(f"[kernels] sphere_grid(1M) random rays, binned: {count_of('binned.rounds')} rounds, "
        f"{binned_reads()} host reads over 2 calls")
    b_rnd = check_rnd.summary("sphere_grid(1M) random rays")
    compare_binned("sphere_grid(1M) random rays", hsoa, dict(trace=[call], occlude=[call]))
    del call, o, d, t_max, ignore
    mid = prepare_scene(scenes.sphere_grid(250_000), device=dev)
    err_m, _, _, _ = renders_against_dense(mid, (320, 180), 8, 6)  # its AOVs: phase 6
    # the chunk-tree form with emitters, the light tree and MIS on emissive
    # hits: many_lights(256) (many_lights(96) has 122 prims, one chunk, and
    # a chunk tree needs two) with its tables built directly
    lights = with_hier_tables(prepare_scene(scenes.many_lights(256), device=dev))
    if lights.lights.tree is None or not mk.supported_hier(lights):
        return fail("many_lights(256) has no light tree or lies outside the chunk-tree form")
    err_l, _, _, _ = compare_mega_hier("many_lights(256) 320x180", lights, (320, 180), 8, 16,
                                       bitwise=False)
    del lights
    gate_keeps_wavefront(dev, prof8)
    log(f"[time] {time.perf_counter() - t_run:.1f} s after the build")

    # --- slice phase: the megakernel path, counters from zero ---
    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    fn, args = entry()
    t_entry = time.perf_counter()
    s_sum, _ = fn(*args)
    torch.cuda.synchronize()
    t_entry = time.perf_counter() - t_entry
    if s_sum.shape != (128 * 128, 3) or not bool(torch.isfinite(s_sum).all()):
        return fail("entry(): non-finite or misshapen output")
    entry_lum = float(luminance(s_sum / 8.0).mean())
    log(f"[slice] entry(): cornell 128x128 8 spp in {t_entry:.3f} s "
        f"({128 * 128 * 8 / t_entry / 1e6:.3f} Mspps), mean luminance {entry_lum:.4f}")
    prof = EvaluationProfile(samples_per_epoch=64, max_epoch=1, bounce_limit=16,
                             survivability=2.5, adaptive=False)
    image, info = render_layer(bench, prof, (960, 540))
    mega_launches = count_of("launches.mega")
    dense_on_mega = (count_of("launches.dense_trace"), count_of("launches.dense_occlude"))
    lum = float(luminance(torch.as_tensor(image)).mean())
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    mspps = info["samples_per_second"] / 1e6
    # the wavefront on the same frame, as the render loop runs it when the
    # megakernel does not take a frame (a stats render: sample chains)
    t_wave = time.perf_counter()
    _sample_frame(bench, "path", (960, 540), 0, 0, 8, 16, 2.5, return_stats=True)
    torch.cuda.synchronize()
    wave_mspps = 960 * 540 * 8 / (time.perf_counter() - t_wave) / 1e6
    log(f"[slice] sphere_field(80) 960x540 64 spp bounce 16 via render_layer "
        f"({info['dispatch']['integrator']}: {info['dispatch']['integrator_reason']}): "
        f"{info['samples']} samples in {info['seconds']:.3f} s = {mspps:.3f} Mspps, peak memory "
        f"{peak_gib:.2f} GiB, mean luminance {lum:.4f} | {smi}")
    log(f"[slice] for comparison, the wavefront on the same scene at 8 spp through "
        f"_sample_frame (4 sample chains, stats on): {wave_mspps:.3f} Mspps")
    log(f"[slice] launches on the megakernel path: megakernel {mega_launches}, dense trace "
        f"{dense_on_mega[0]}, dense occlude {dense_on_mega[1]}")
    if image.shape != (540, 960, 3) or not np.isfinite(image).all():
        return fail("bench render: non-finite or misshapen image")
    if not (0.01 < lum < 10.0 and 0.01 < entry_lum < 10.0):
        return fail(f"mean luminance out of (0.01, 10): bench {lum}, entry {entry_lum}")
    if mega_launches < 1 or max(dense_on_mega) != 0:
        return fail("the bench render did not run on the megakernel alone")

    # --- slice phase: the showcase through the textured megakernel ---
    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    image, info = render_layer(showcase, prof, (960, 540))
    tex_launches = count_of("launches.mega_textured")
    dense_on_tex = (count_of("launches.dense_trace"), count_of("launches.dense_occlude"),
                    count_of("launches.mega"))
    show_lum = float(luminance(torch.as_tensor(image)).mean())
    show_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    show_mspps = info["samples_per_second"] / 1e6
    log(f"[slice] showcase (scenes/showcase.echo, 4 atlas textures) 960x540 64 spp bounce 16 via "
        f"render_layer ({info['dispatch']['integrator']}: "
        f"{info['dispatch']['integrator_reason']}): {info['samples']} samples, epoch wall "
        f"{info['seconds']:.3f} s = {show_mspps:.3f} Mspps (sphere_field(80), the same traffic, "
        f"in this call: {mspps:.3f} Mspps), peak memory {show_gib:.2f} GiB, mean luminance "
        f"{show_lum:.4f}; launches megakernel textured {tex_launches}, untextured "
        f"{dense_on_tex[2]}, dense trace/occlude {dense_on_tex[0]}/{dense_on_tex[1]} | {smi}")
    if info["dispatch"]["integrator"] != "megakernel" or tex_launches < 1 or max(dense_on_tex):
        return fail("the showcase did not run on the megakernel's textured form alone")
    if image.shape != (540, 960, 3) or not np.isfinite(image).all() or not 0.01 < show_lum < 10:
        return fail(f"showcase render non-finite or mean luminance {show_lum} out of (0.01, 10)")

    # --- slice phase: the wavefront path (outside the envelope) ---
    zero_launch_counts()
    image, info = render_layer(large, prof8, (320, 180))
    dense = dict(trace=count_of("launches.dense_trace"), occlude=count_of("launches.dense_occlude"))
    log(f"[slice] sphere_field(2400) ({large.prim_soa.padded} padded prims) 320x180 8 spp via "
        f"render_layer ({info['dispatch']['integrator']}: "
        f"{info['dispatch']['integrator_reason']}): {info['samples_per_second'] / 1e6:.3f} "
        f"Mspps, {info['wavefront_iterations']} wavefront iterations; launches dense {dense}, "
        f"megakernel {count_of('launches.mega')}")
    if not np.isfinite(image).all() or min(dense.values()) <= 0 or count_of("launches.mega"):
        return fail("the wavefront path did not run on the dense kernels")

    # --- slice phase: an env map, through the wavefront ---
    hdr = prepare_scene(scenes.hdr_environment(), device=dev)
    prof16 = EvaluationProfile(samples_per_epoch=16, max_epoch=1, bounce_limit=16,
                               survivability=2.5, adaptive=False)
    zero_launch_counts()
    image, info = render_layer(hdr, prof16, (960, 540))
    hdr_mega = count_of("launches.mega") + count_of("launches.mega_textured")
    hdr_lum = float(luminance(torch.as_tensor(image)).mean())
    log(f"[slice] hdr_environment (256x128 procedural sky, {hdr.geometry.num_primitives} prims) "
        f"960x540 16 spp bounce 16 via render_layer ({info['dispatch']['integrator']}: "
        f"{info['dispatch']['integrator_reason']}; rays: {info['dispatch']['accelerator']}, "
        f"{info['dispatch']['accelerator_reason']}): {info['samples_per_second'] / 1e6:.3f} "
        f"Mspps, epoch wall {info['seconds']:.3f} s, {info['wavefront_iterations']} wavefront "
        f"iterations, mean luminance {hdr_lum:.4f}; launches {launch_counts()} | {smi}")
    if info["dispatch"]["integrator"] != "wavefront" or hdr_mega:
        return fail("hdr_environment did not take the wavefront")
    if image.shape != (540, 960, 3) or not np.isfinite(image).all() or not 0.01 < hdr_lum < 10:
        return fail(f"hdr_environment render non-finite or mean luminance {hdr_lum} out of "
                    f"(0.01, 10)")
    # the same sky over sphere_field(80): an env map on the dense kernels' path
    sky = prepare_scene(hdr_sky_over_spheres(), device=dev)
    zero_launch_counts()
    image, info = render_layer(sky, prof8, (320, 180))
    sky_lum = float(luminance(torch.as_tensor(image)).mean())
    dense_sky = (count_of("launches.dense_trace"), count_of("launches.dense_occlude"))
    sky_mega = count_of("launches.mega") + count_of("launches.mega_textured")
    log(f"[slice] sphere_field(80) under the same sky ({len(sky.env_maps)} env map, "
        f"{int((sky.lights.kind == 2).sum())} ambient records) 320x180 8 spp via "
        f"{info['dispatch']['integrator']} ({info['dispatch']['integrator_reason']}): "
        f"{info['samples_per_second'] / 1e6:.3f} Mspps, mean luminance {sky_lum:.4f}; launches "
        f"dense trace/occlude {dense_sky[0]}/{dense_sky[1]}, megakernel {sky_mega}")
    if (min(dense_sky) <= 0 or sky_mega or not np.isfinite(image).all()
            or not 0.01 < sky_lum < 10):
        return fail("the env map over sphere_field(80) did not render on the dense kernels")
    del hdr, sky

    # --- slice phase: bench.py's large scene, the first wave on the walk and
    # every later wave through the binned traversal ---
    res = (1920, 1080)
    n_px = res[0] * res[1]
    summary = dispatch_summary(grid)
    log(f"[slice] sphere_grid(1_000_000) {res[0]}x{res[1]} 1 spp bounce 6: dispatch {summary}")
    if summary["accelerator"] != "binned" or summary["integrator"] != "wavefront":
        return fail("the large scene does not dispatch to the binned traversal")
    program = lambda start: _sample_frame(grid, "path", res, 0, start, 1, 6, 2.5)
    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    seconds, warm_s, first, s_sum = timed_programs(program)
    hier = dict(trace=count_of("launches.walk_trace"), occlude=count_of("launches.walk_occlude"))
    binned = {k: count_of(f"launches.binned_{k}") for k in ("setup", "refill", "select", "seg")}
    # the exact form: no render path launches it
    exact_on_path = count_of("launches.binned_seg_exact")
    others = (count_of("launches.dense_trace"), count_of("launches.dense_occlude"),
              count_of("launches.mega") + count_of("launches.mega_textured")
              + count_of("launches.mega_hier"))
    slice_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    rounds, syncs, calls = count_of("binned.rounds"), binned_reads(), count_of("binned.calls")
    misses = int(bt.STATS["misses"])
    big_mspps = n_px * 8 / sum(seconds) / 1e6
    img = (s_sum / 1.0).reshape(res[1], res[0], 3)
    big_lum = float(luminance(img).mean())
    log(f"[slice] {big_mspps:.4f} Mspps over 8 programs (2,073,600 x 8 samples / "
        f"{sum(seconds):.4f} s); program seconds "
        + ", ".join(f"{t:.4f}" for t in seconds)
        + f"; warm-up {warm_s:.3f} s; prepare {t_prep:.2f} s; peak memory {slice_gib:.2f} GiB "
          f"(prepare {prep_gib:.2f} GiB); mean luminance {big_lum:.4f} | {smi}")
    log(f"[slice] launches: binned {binned} (exact seg form {exact_on_path}), hier {hier}, "
        f"dense trace/occlude "
        f"{others[0]}/{others[1]}, megakernel {others[2]}; {calls} binned calls, {rounds} "
        f"rounds, {syncs} host reads, {misses} recovery misses over 9 programs; cascade widths "
        f"{cascade_widths(n_px)}")
    if not bool(torch.isfinite(s_sum).all()) or not 0.01 < big_lum < 10.0:
        return fail(f"large-scene frame non-finite or mean luminance {big_lum} out of (0.01, 10)")
    if min(binned.values()) <= 0 or min(hier.values()) <= 0 or max(others) or exact_on_path:
        return fail("the large scene did not run on the binned and hier kernels alone")
    # the same programs through the walk alone (the dispatch before the
    # binned traversal), for comparison
    with scene_ops.walk_only():
        walk_seconds, _, walk_first, _ = timed_programs(program)
    walk_mspps = n_px * 8 / sum(walk_seconds) / 1e6
    log(f"[slice] for comparison, the same programs through the walk alone: "
        f"{walk_mspps:.4f} Mspps; program seconds "
        + ", ".join(f"{t:.4f}" for t in walk_seconds) + f" | {smi}")
    # the same programs through the megakernel's chunk-tree form, under the
    # JAX package's gate
    hier_row = mega_hier_slice(grid, res, program, walk_first, walk_mspps, big_mspps, smi)
    hier_row["max_abs_err"] = max(hier_row["max_abs_err"], err_m, err_l)
    del walk_first
    # the first timed program once more, its kernel calls recorded and every
    # binned launch checked against its plain version
    zero_launch_counts()
    with RayWork(cull=True, record=True) as rec, BinnedCheck(hsoa, library=True) as check:
        again, _, stats = _sample_frame(grid, "path", res, 0, 1, 1, 6, 2.5, return_stats=True)
    exact_launches = count_of("launches.binned_seg_exact")  # no render path launches it
    log(f"[slice] the first program again, recorded: {stats['Loop/Iterations']} wavefront "
        f"iterations, {stats['Ray/Traced']} traced and {stats['Ray/Shadow']} shadow rays, "
        f"sums {'bitwise equal' if torch.equal(again, first) else 'DIFFERENT'}")
    if not torch.equal(again, first):
        return fail("the recorded program's sums differ from the timed one's")
    del again, first
    for c in rec.per_call:
        log(f"[slice]   binned {c['kind']} call on {c['rays']} rays: launches setup "
            f"{c['setup']}, select {c['select']}, seg {c['seg']}; {c['rounds']} rounds, "
            f"{c['syncs']} host reads")
    label = "sphere_grid(1M) 1920x1080 1 spp, the slice's first timed program's calls"
    err_r, ms_h, bound_h = compare_hier(label, hsoa, rec.calls)
    b_out = check.summary(label)
    compare_binned(label, hsoa, rec.binned)
    del rec, check
    log(f"[time] {time.perf_counter() - t_run:.1f} s after the build")

    # --- adaptive phase: adaptive epochs and the AOV evaluators ---
    adaptive = adaptive_phase(dev, smi, bench, showcase, large, mid, grid)
    del grid, hsoa, mid
    log(f"[time] {time.perf_counter() - t_run:.1f} s after the build")

    # --- the stack BVH walk against the dense kernels ---
    bvh_oracle("sphere_field(80)", bench.geometry, bench.bvh, bench.prim_soa,
               random_rays(np.random.RandomState(2020), ORACLE_RAYS, [-20, 0.05, -20],
                           [20, 4, 20], bench.prim_soa.num_prims), smi)
    log(f"[time] {time.perf_counter() - t_run:.1f} s after the build")

    # --- slice phase: TLAS instancing, counters from zero ---
    inst_rows = instanced_phase(dev, rs, smi)
    log(f"[time] {time.perf_counter() - t_run:.1f} s after the build")

    # --- the Plücker micro-benchmark's kernels, counters from zero ---
    plk_rows = plucker_phase(dev, smi)
    log(f"[time] {time.perf_counter() - t_run:.1f} s after the build")

    # --- composition, denoiser, checkpoints, device checks, scheduler ---
    compose_phase(dev, smi, bench, large)
    log(f"[time] {time.perf_counter() - t_run:.1f} s after the build")

    # --- the frontends: the CLI, the .echo loader, the preview, the mesh files,
    # the C++ BVH builder ---
    frontend_phase(dev, smi, grid_tables)
    del grid_tables
    log(f"[time] {time.perf_counter() - t_run:.1f} s after the build")

    # --- multi-GPU: pixel shards, processes, the dry run ---
    multigpu_phase(dev, smi, bench)
    log(f"[time] {time.perf_counter() - t_run:.1f} s after the build")

    # --- the offline tools: the denoiser's trainer, the tile-stats oracle ---
    train_phase(dev, smi)
    log(f"[time] {time.perf_counter() - t_run:.1f} s after the build")

    kernels = [
        dict(name="dense_trace", route="cuda", source=DENSE_SOURCE, replaces=TRACE_SITE,
             launches=dense["trace"],
             max_abs_err=max(err_a["trace"], err_b["trace"], err_c["trace"], err_d["trace"]),
             ms=ms_c["trace"], plain_ms=ms_c["trace_plain"], bound_ms=bound_c["trace"][0],
             bound_by=bound_c["trace"][1], library_ms=None),
        dict(name="dense_occlude", route="cuda", source=DENSE_SOURCE, replaces=OCCLUDE_SITE,
             launches=dense["occlude"],
             max_abs_err=max(err_a["occlude"], err_b["occlude"], err_c["occlude"],
                             err_d["occlude"]),
             ms=ms_c["occlude"], plain_ms=ms_c["occlude_plain"],
             bound_ms=bound_c["occlude"][0], bound_by=bound_c["occlude"][1], library_ms=None),
        dict(name="megakernel", route="cuda", source=MEGA_SOURCE, replaces=MEGA_SITE,
             launches=mega_launches, max_abs_err=mega_err, ms=mega_ms["ms"],
             plain_ms=mega_ms["plain_ms"], bound_ms=mega_bound[0], bound_by=mega_bound[1],
             library_ms=None),
        dict(name="megakernel_textured", route="cuda", source=MEGA_SOURCE,
             replaces=MEGA_TEX_SITE, launches=tex_launches, max_abs_err=tex_err,
             ms=tex_ms["ms"], plain_ms=tex_ms["plain_ms"], bound_ms=tex_bound[0],
             bound_by=tex_bound[1], library_ms=None),
        hier_row,
    ] + [
        dict(name=f"hier_{k}", route="cuda", source=HIER_SOURCE, replaces=HIER_SITE,
             launches=hier[k],
             max_abs_err=max(err_h[k], err_r[k], adaptive["checked"]["err"][k]), ms=ms_h[k],
             plain_ms=ms_h[f"{k}_plain"], bound_ms=bound_h[k][0], bound_by=bound_h[k][1],
             library_ms=None)
        for k in ("trace", "occlude")
    ] + [
        dict(name=f"binned_{k}", route="cuda", source=BINNED_SOURCE, replaces=BINNED_SITES[k],
             launches=binned[k],
             max_abs_err=float(max(b_rnd[k]["max_abs_err"], b_out[k]["max_abs_err"],
                                   adaptive["checked"]["binned"][k]["max_abs_err"])),
             ms=b_out[k]["ms"],
             plain_ms=b_out[k]["plain_ms"], bound_ms=b_out[k]["bound_ms"],
             bound_by=b_out[k]["bound_by"], library_ms=b_out[k]["library_ms"])
        for k in ("setup", "refill", "select", "seg")
    ] + [
        dict(name="binned_seg_exact", route="cuda", source=BINNED_SOURCE,
             replaces=BINNED_SITES["seg"], launches=exact_launches,
             max_abs_err=float(max(b_rnd["seg_exact"]["max_abs_err"],
                                   b_out["seg_exact"]["max_abs_err"])),
             ms=b_out["seg_exact"]["ms"], plain_ms=b_out["seg_exact"]["plain_ms"],
             bound_ms=b_out["seg_exact"]["bound_ms"], bound_by=b_out["seg_exact"]["bound_by"],
             library_ms=None),
    ] + inst_rows + plk_rows
    for line in DENSE_REPORTS:
        log(f"[dense] {line}")
    for line in MEGA_REPORTS:
        log(f"[mega] {line} | {smi}")
    for line in WALK_REPORTS:
        log(f"[walk] {line} | {smi}")
    for line in seg_form_reports(smi):
        log(f"[seg] {line}")
    for line in shape_form_reports(smi):
        log(f"[{line.split(',')[0]}] {line}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
