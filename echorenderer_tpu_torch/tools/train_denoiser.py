"""Offline training of the learned denoiser (counterpart of
tools/train_denoiser.py; the network is processes/denoise.py's).

    python -m echorenderer_tpu_torch.tools.train_denoiser [--steps 20000] [--batch 16]
        [--lr 2e-3] [--out PATH] [--cache PATH] [--device cuda|cpu]

Renders the dataset with the port (deterministic: a scene generator and a
seed define every frame): per scene variant one CLEAN_SPP target and
NOISY_VIEWS renders at NOISY_SPP with their albedo and normal AOVs, at
RES. Then trains the kernel-predicting CNN with autograd and Adam on
random CROP x CROP crops, the loss the mean L1 of log1p-tonemapped colors,
logging it every 200 steps. Then evaluates the trained weights and the
committed ones on tests/fixtures/denoise_eval.npz (MSE and SSIM of the
noisy input, the cross-bilateral filter and the learned denoiser, and
tests/test_denoise.py's gate) and saves the weights to `--out` in the JAX
package's layout (w0..w4 HWIO, b0..b4, float32), which both packages'
`load_params` read.

It writes only `--out` and `--cache` (by default under the package's
_build/ directory): never the committed weights or the eval fixture.
Runs on the card unless `--device cpu` is given; with no card it raises.

Against the JAX tool: the crops are drawn from a torch.Generator on the
CPU (`sample_crops`), so the same seed gives the same crops on every
device, but other crops than jax.random's (the same ranges: frame in
[0, n), y in [0, H - CROP), x in [0, W - CROP)); the initial weights come
from a seeded torch.Generator; the convolutions run in float32 forward and
backward (`denoise.float32_convs`).
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import numpy as np
import torch

from ..models import scenes
from ..processes import denoise
from ..processes.render import EvaluationProfile, RenderProfile, render
from ..scene.prepare import prepare_scene
from . import BUILD_DIR, REPO, card_line, check_writable, require_device

RES = (192, 128)
NOISY_SPP = 16
CLEAN_SPP = 1024
NOISY_VIEWS = 4
CROP = 64
EVAL_FIXTURE = os.path.join(REPO, "tests", "fixtures", "denoise_eval.npz")
EVAL_SCENES = ("cornell", "ball", "spheres")
DEFAULT_OUT = os.path.join(BUILD_DIR, "denoiser_trained.npz")
DEFAULT_CACHE = os.path.join(BUILD_DIR, "denoise_dataset_v2.npz")
INIT_SEED = 0  # the initial weights' generator
CROP_SEED = 42  # the crop draws' generator, as the JAX tool's PRNGKey(42)
# tests/test_denoise.py's gate: learned MSE below the bilateral's and the
# noisy input's, SSIM at least the bilateral's less this
SSIM_SLACK = 0.005


def scene_variants():
    """(name, scene maker) of every training variant, as the JAX tool's."""
    from ..scene.materials import Conductor, Dielectric

    yield "cornell", lambda: scenes.cornell_box()
    yield "cornell-dim", lambda: scenes.cornell_box(light_scale=0.35)
    yield "cornell-hot", lambda: scenes.cornell_box(light_scale=3.0)
    yield "ball-diffuse", lambda: scenes.material_ball()
    yield "ball-gold", lambda: scenes.material_ball(
        Conductor(albedo=(1.0, 0.75, 0.3), roughness=0.25)
    )
    yield "ball-glass", lambda: scenes.material_ball(
        Dielectric(albedo=(0.95, 0.95, 0.99), refractive_index=1.5)
    )
    yield "spheres-40", lambda: scenes.sphere_field(count=40, seed=11)
    yield "spheres-80", lambda: scenes.sphere_field(count=80, seed=3)
    yield "spheres-120", lambda: scenes.sphere_field(count=120, seed=29)
    yield "lights", lambda: scenes.many_lights(count=96, seed=5)


def render_frame(prepared, spp, seed, resolution=RES):
    """(color, albedo, normal) float32 (H, W, 3) arrays of one frame: the
    path layer at `spp` in non-adaptive epochs of at most 64 samples, then
    the albedo and normal_depth AOVs (normals only)."""
    epochs = max(1, spp // 64)
    spe = spp // epochs
    prof = RenderProfile(
        resolution=tuple(resolution),
        seed=seed,
        evaluations=(
            EvaluationProfile(
                evaluator="path", samples_per_epoch=spe, min_epoch=epochs,
                max_epoch=epochs, bounce_limit=8, adaptive=False,
                layer_name="main",
            ),
            EvaluationProfile(evaluator="albedo", layer_name="albedo"),
            EvaluationProfile(evaluator="normal_depth", layer_name="nd"),
        ),
    )
    out = render(prepared, prof)
    return (
        out["main"].astype(np.float32),
        out["albedo"].astype(np.float32),
        out["nd"][..., :3].astype(np.float32),
    )


def build_dataset(cache=None, device="cuda", variants=None, views=NOISY_VIEWS, log=print):
    """Per scene variant (all, or the names in `variants`): one CLEAN_SPP
    target and `views` noisy renders at distinct seeds, the clean frame
    shared. Returns frame-aligned (noisy, albedo, normal, clean) float32
    arrays of shape (frames, H, W, 3). A `cache` file that exists is loaded
    instead; one that does not is written."""
    if cache is not None and os.path.exists(cache):
        with np.load(cache) as d:
            return [d[k] for k in ("noisy", "albedo", "normal", "clean")]
    noisy_l, alb_l, nrm_l, clean_l = [], [], [], []
    for name, make in scene_variants():
        if variants is not None and name not in variants:
            continue
        t0 = time.perf_counter()
        prepared = prepare_scene(make(), device=device)
        clean, _, _ = render_frame(prepared, CLEAN_SPP, seed=100)
        for seed in range(views):
            noisy, alb, nrm = render_frame(prepared, NOISY_SPP, seed=seed * 7 + 1)
            noisy_l.append(noisy)
            alb_l.append(alb)
            nrm_l.append(nrm)
            clean_l.append(clean)
        log(f"  {name}: {time.perf_counter() - t0:.1f}s")
    arrs = [np.stack(x) for x in (noisy_l, alb_l, nrm_l, clean_l)]
    if cache is not None:
        os.makedirs(os.path.dirname(check_writable(cache)), exist_ok=True)
        np.savez_compressed(cache, noisy=arrs[0], albedo=arrs[1], normal=arrs[2], clean=arrs[3])
    return arrs


def build_eval_fixture(path, device="cuda"):
    """Unseen-seed eval pairs on the three showcase scenes, in the layout of
    tests/fixtures/denoise_eval.npz, written to `path` (which must not be
    that committed file)."""
    path = check_writable(path)
    packs = {}
    for name, make in (
        ("cornell", lambda: scenes.cornell_box()),
        ("ball", lambda: scenes.material_ball()),
        ("spheres", lambda: scenes.sphere_field(count=80, seed=3)),
    ):
        prepared = prepare_scene(make(), device=device)
        noisy, alb, nrm = render_frame(prepared, NOISY_SPP, seed=53)
        clean, _, _ = render_frame(prepared, CLEAN_SPP, seed=900)
        packs[f"{name}_noisy"] = noisy
        packs[f"{name}_albedo"] = alb
        packs[f"{name}_normal"] = nrm
        packs[f"{name}_clean"] = clean
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **packs)


def tonemap(x):
    """log1p(max(x, 0)): the loss's and the metrics' tonemap."""
    return torch.log1p(torch.maximum(x, x.new_zeros(())))


def init_params(seed: int = INIT_SEED, device="cuda") -> dict:
    """denoise.init_params from a seeded CPU generator (the same weights on
    every device), as leaves that require grad."""
    params = denoise.init_params(torch.Generator().manual_seed(seed))
    return {k: v.to(device).requires_grad_() for k, v in params.items()}


def make_optimizer(params: dict, lr: float) -> torch.optim.Adam:
    """Adam with optax.adam's defaults. torch computes the bias corrections
    in double, optax in float32 (1 - 0.999^t is 1.3e-5 off at t = 1), so a
    step differs from optax's by up to ~1e-5 of the learning rate."""
    return torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def sample_crops(generator: torch.Generator, n_frames: int, batch: int, size=RES,
                 width: int = CROP):
    """(frame, y, x) int64 CPU tensors of `batch` crops, drawn in that order
    from `generator` (a CPU generator): frame in [0, n_frames), y in
    [0, H - width), x in [0, W - width), the JAX tool's ranges; size is
    (W, H)."""
    f = torch.randint(0, n_frames, (batch,), generator=generator)
    y = torch.randint(0, size[1] - width, (batch,), generator=generator)
    x = torch.randint(0, size[0] - width, (batch,), generator=generator)
    return f, y, x


def crop(images, f, y, x, width: int = CROP) -> list:
    """Each (frames, H, W, 3) tensor of `images` cut to the (batch, width,
    width, 3) crops at frames f, rows y.., columns x.. (by slicing)."""
    at = list(zip(f.tolist(), y.tolist(), x.tolist()))
    return [torch.stack([img[fi, yi:yi + width, xi:xi + width] for fi, yi, xi in at])
            for img in images]


def loss_fn(params: dict, cn, ca, cm, cc):
    """Mean L1 between the denoised noisy crops and the clean crops, both
    tonemapped."""
    out = denoise.apply(params, cn, ca, cm)
    return torch.mean(torch.abs(tonemap(out) - tonemap(cc)))


def train_step(params: dict, optimizer, batch) -> torch.Tensor:
    """One Adam step on `batch` = (noisy, albedo, normal, clean) crops; the
    forward and backward convolutions in float32. Returns the loss (on the
    params' device, not read back). The crops must not require grad: the
    replicate pad of the denoiser's shifted sum is never differentiated."""
    if any(t.requires_grad for t in batch):
        raise ValueError("the crops must not require grad")
    optimizer.zero_grad(set_to_none=True)
    with denoise.float32_convs():
        loss = loss_fn(params, *batch)
        loss.backward()
    optimizer.step()
    return loss.detach()


def train(params: dict, data, steps: int, batch: int, lr: float, seed: int = CROP_SEED,
          width: int = CROP, log_every: int = 200, log=print) -> torch.Tensor:
    """`steps` Adam steps on crops of `data` (noisy, albedo, normal, clean
    tensors on the params' device), drawn from a generator seeded `seed`.
    Updates `params` in place; returns the loss of every step."""
    optimizer = make_optimizer(params, lr)
    generator = torch.Generator().manual_seed(seed)
    n_frames, height, w = data[0].shape[:3]
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        f, y, x = sample_crops(generator, n_frames, batch, (w, height), width)
        losses.append(train_step(params, optimizer, crop(data, f, y, x, width)))
        if log_every and (i % log_every == 0 or i == steps - 1):
            log(f"step {i}: loss {float(losses[-1]):.4f} ({time.perf_counter() - t0:.0f}s)")
    return torch.stack(losses)


def mse(a, b) -> float:
    """MSE of the tonemapped images."""
    return float(torch.mean((tonemap(a) - tonemap(b)) ** 2))


def ssim(a, b) -> float:
    """Global SSIM on log-tonemapped luminance (tests/test_denoise.py's
    single-window variant)."""
    x = tonemap(a).mean(-1).double()
    y = tonemap(b).mean(-1).double()
    mx, my = x.mean(), y.mean()
    vx, vy = x.var(unbiased=False), y.var(unbiased=False)
    cxy = ((x - mx) * (y - my)).mean()
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return float(((2 * mx * my + c1) * (2 * cxy + c2))
                 / ((mx * mx + my * my + c1) * (vx + vy + c2)))


def evaluate(params: dict, device="cuda") -> dict:
    """Per eval scene: MSE and SSIM of the noisy input, the cross-bilateral
    filter and the learned denoiser against the clean frame, and whether
    tests/test_denoise.py's gate holds."""
    from ..processes.composition import BilateralDenoise

    rows = {}
    with np.load(EVAL_FIXTURE) as fx, torch.no_grad():
        for name in EVAL_SCENES:
            hn, ha, hm, hc = (torch.as_tensor(fx[f"{name}_{k}"], device=device)
                              for k in ("noisy", "albedo", "normal", "clean"))
            images = dict(
                noisy=hn,
                bilateral=BilateralDenoise().apply(
                    {"main": hn, "albedo": ha, "normal_depth": hm})["main"],
                learned=denoise.apply(params, hn[None], ha[None], hm[None])[0],
            )
            row = {f"{k}_mse": mse(v, hc) for k, v in images.items()}
            row.update({f"{k}_ssim": ssim(v, hc) for k, v in images.items()})
            row["gate"] = (row["learned_mse"] < row["bilateral_mse"]
                           and row["learned_mse"] < row["noisy_mse"]
                           and row["learned_ssim"] >= row["bilateral_ssim"] - SSIM_SLACK)
            rows[name] = row
    return rows


def format_eval(label: str, rows: dict) -> list:
    return [f"{label} {name}: MSE noisy {r['noisy_mse']:.6f}  bilateral {r['bilateral_mse']:.6f}  "
            f"learned {r['learned_mse']:.6f} | SSIM noisy {r['noisy_ssim']:.6f}  bilateral "
            f"{r['bilateral_ssim']:.6f}  learned {r['learned_ssim']:.6f} | gate "
            f"{'pass' if r['gate'] else 'FAIL'}" for name, r in rows.items()]


def save_params(params: dict, path) -> str:
    """Write `params` to `path` in the JAX package's layout (float32
    arrays w0..w4 HWIO, b0..b4); refuses the committed files."""
    path = check_writable(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **{k: v.detach().cpu().numpy().astype(np.float32) for k, v in params.items()})
    return path


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--cache", default=DEFAULT_CACHE,
                    help="dataset file: loaded when it exists, else rendered and written")
    ap.add_argument("--out", default=DEFAULT_OUT, help="where the trained weights go")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    dev = require_device(args.device)
    out = check_writable(args.out)  # refuse before the work, not after
    check_writable(args.cache)
    if args.steps < 1:
        raise ValueError("--steps must be at least 1")
    log = functools.partial(print, flush=True)
    if dev.type == "cuda":
        log(f"card: {card_line()}")
    t_all = time.perf_counter()
    log("building dataset...")
    arrays = build_dataset(args.cache, device=dev, log=log)
    log(f"dataset: {arrays[0].shape[0]} frames {arrays[0].shape[1:]} in "
        f"{time.perf_counter() - t_all:.1f}s")
    data = [torch.as_tensor(a, device=dev) for a in arrays]

    params = init_params(device=dev)
    t0 = time.perf_counter()
    losses = train(params, data, args.steps, args.batch, args.lr, log=log)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    tail = losses[-200:]
    log(f"trained {args.steps} steps in {train_s:.1f}s: {args.steps / train_s:.2f} steps/s; "
        f"final loss {float(losses[-1]):.6f}, mean of the last {len(tail)} "
        f"{float(tail.mean()):.6f}")

    for line in format_eval("trained", evaluate(params, device=dev)):
        log(line)
    committed = denoise.load_params(device=dev)
    if committed is not None:
        for line in format_eval("committed", evaluate(committed, device=dev)):
            log(line)
    log(f"saved {save_params(params, out)}; total {time.perf_counter() - t_all:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
