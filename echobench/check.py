"""Whether the images of the window are right: `correct`.

As the window runs, `Sample` keeps `pixels_per_image` pixels of every
image it completes, drawn from the run's seed and the image's place in the
window, and drops the rest. Once the window has closed, the plain reference
(reference/) works those pixels out again from the benchmark's own scene
arrays, with each image's seed and the traffic's samples and bounce limit.
A `render_layer` mix compares its one layer: an adaptive path layer's
epochs replayed pixel by pixel (`Reference.adaptive`), any other layer's
samples as one mean (`Reference.pixels`). A `render` mix (the README's
standard profile) compares the path layer that went into the composition
stack (its adaptive epochs replayed pixel by pixel) and the albedo and
normal-and-depth layers at the pixels. `Sample` also keeps
`compose_images` whole images, a reservoir over the window drawn from the
seed. Of each, the reference works out the albedo and normal-and-depth
layers at every pixel and compares them whole; it replays the path layer
at `whole_pixels` more pixels; and it runs its own stack on the port's
path layer and its own two layers, to compare the composed image. The
path layer is the one input of the stack that the reference takes from
the program: a whole 1080p adaptive layer is beyond its time, so it is
checked at the pixels.

The numbers compared (checks/<cell>.json gives the pixels an image and a
limit for each; every one is below its limit in a correct run):

  rel_err          sum |port - reference| / sum |reference| over the compared pixels'
                   channels of the (path) layer: the share of the light
                   that differs;
  off_share        the share of compared pixels whose largest channel differs by more
                   than `off_tol` times (1 + the reference's largest
                   channel): pixels that a different path, not rounding, made;
  aov_rel_err      rel_err of the albedo and normal-and-depth layers at the
                   pixels;
  aov_image_rel_err  the same over every pixel of the whole images;
  compose_rel_err  rel_err of the composed images, every pixel.

Channels equal on both sides (an infinite depth on a miss) differ by 0; a
channel that is not finite on one side only differs by BIG.
The reference sets its own float flags (TF32 off) and puts them back, so
the timed path runs with the flags users get.

The reference of a configuration is reference/flat.py's `flatten` and
reference/tracer.py's `Reference`, unless its file names a module of its
own (`"reference": "<module>"`, manifest.Cell.reference): then that
module's `flatten(spec)` and `Reference(flat, device, dtype)`, with the
methods called here (`pixels`, `adaptive`, `first_hits`).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .reference import flat, tracer
from .reference.compose import standard_stack


def _rng(seed: int, *key: int):
    return np.random.Generator(np.random.PCG64([int(seed) & (2**63 - 1), *key]))


def image_pixels(seed: int, index: int, resolution, count: int) -> np.ndarray:
    """The pixel ids compared of the window's `index`-th image."""
    return _rng(seed, 0xEC40, index).integers(0, resolution[0] * resolution[1], count)


@contextlib.contextmanager
def plain_float():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


BIG = 1e30


def rel_err(port: np.ndarray, ref: np.ndarray) -> float:
    port, ref = port.astype(np.float64), ref.astype(np.float64)
    with np.errstate(invalid="ignore"):  # inf - inf, where both are inf
        diff = np.where(port == ref, 0.0, np.abs(port - ref))
    # a channel finite on one side only, or NaN, differs by BIG
    diff = np.nan_to_num(diff, nan=BIG, posinf=BIG)
    scale = np.abs(ref[np.isfinite(ref)]).sum()
    return float(diff.sum() / max(scale, 1e-30))


def numbers(port: np.ndarray, ref: np.ndarray, off_tol: float) -> dict:
    """rel_err and off_share of (P, C) pixels."""
    diff = np.abs(port.astype(np.float64) - ref.astype(np.float64))
    scale = 1.0 + np.abs(ref).max(axis=1)
    return {"rel_err": rel_err(port, ref),
            "off_share": float(np.mean(diff.max(axis=1) > off_tol * scale))}


def adaptive(profile: dict) -> bool:
    """Whether a mix's layer runs adaptive epochs, as the port's
    `EvaluationProfile` reads the profile: the path evaluator with
    "adaptive" true (both the defaults)."""
    return profile.get("evaluator", "path") == "path" and profile.get("adaptive", True)


def build_reference(spec, device, dtype=torch.float32, module=None):
    """The plain reference of a scene spec: `module`'s (a configuration's
    own reference module) `Reference(flatten(spec), device, dtype)`, or,
    with none, reference/flat.py's and reference/tracer.py's."""
    flatten, reference = ((module.flatten, module.Reference) if module is not None
                          else (flat.flatten, tracer.Reference))
    return reference(flatten(spec), device, dtype)


def _adaptive_pixels(ref, prof: dict, seeds, pixels, res):
    return ref.adaptive(seeds, pixels, res, prof["samples_per_epoch"], prof["min_epoch"],
                        prof["max_epoch"], prof["noise_threshold"], prof["bounce_limit"],
                        prof["survivability"])


def reference_pixels(spec, traffic: dict, seeds, pixels, device, dtype=torch.float32,
                     module=None) -> dict:
    """The reference's layers at the (image seed, pixel id) pairs: "main"
    (P, 3) of a render_layer mix; "path" (P, 3) and "aov" (P, 7: albedo,
    normal, depth) of a render mix. `module`: as `build_reference`."""
    prof = traffic["profile"]
    res = tuple(traffic["resolution"])
    with plain_float():
        ref = build_reference(spec, device, dtype, module)
        if traffic["entry"] == "render_layer":
            if adaptive(prof):
                px = _adaptive_pixels(ref, prof, seeds, pixels, res)
            else:
                px = ref.pixels(seeds, pixels, res, prof["samples_per_epoch"] * prof["max_epoch"],
                                prof["bounce_limit"], prof["survivability"])
            return {"main": px.cpu().numpy()}
        path = _adaptive_pixels(ref, prof, seeds, pixels, res)
        alb, nd = ref.first_hits(seeds, pixels, res, traffic["aov_samples"])
        return {"path": path.cpu().numpy(), "aov": torch.cat([alb, nd], -1).cpu().numpy()}


def pixels_of(layers: dict, kind: str, pixels, width: int) -> dict:
    """An image's layers at pixel ids, as `reference_pixels` names them."""
    rows, cols = pixels // width, pixels % width
    at = lambda layer, channels: layers[layer][rows, cols, :channels].astype(np.float32)
    if kind == "render_layer":
        return {"main": at("main", 3)}
    return {"path": at("path", 3),
            "aov": np.concatenate([at("albedo", 3), at("normal_depth", 4)], -1)}


def compare(port: dict, ref: dict, off_tol: float) -> dict:
    layer = "main" if "main" in ref else "path"
    got = numbers(port[layer], ref[layer], off_tol)
    if "aov" in ref:
        got["aov_rel_err"] = rel_err(port["aov"], ref["aov"])
    return got


def whole_reference(images: list, spec, traffic: dict, device, dtype=torch.float32,
                    block: int = 1 << 18, module=None) -> list:
    """The reference's layers of whole images, each (image seed, the
    port's layers): "albedo" and "normal_depth" at every pixel (in blocks
    of `block` pixels), and "main", its stack over the port's path layer
    and those two layers. Host arrays, float32. `module`: as
    `build_reference`."""
    width, height = traffic["resolution"]
    ids = np.arange(width * height)
    out = []
    with plain_float():
        ref = build_reference(spec, device, dtype, module)
        for seed, layers in images:
            alb, nd = [], []
            for a in range(0, ids.shape[0], block):
                got = ref.first_hits(np.full(min(block, ids.shape[0] - a), seed),
                                     ids[a:a + block], (width, height), traffic["aov_samples"])
                alb.append(got[0])
                nd.append(got[1])
            alb = torch.cat(alb).reshape(height, width, 3)
            nd = torch.cat(nd).reshape(height, width, 4)
            path = torch.as_tensor(layers["path"], device=device).to(dtype)
            main = standard_stack(path, alb.to(dtype), nd.to(dtype)).float()
            out.append({"albedo": alb.cpu().numpy(), "normal_depth": nd.cpu().numpy(),
                        "main": main.cpu().numpy()})
    return out


def whole_numbers(port: list, ref: list) -> dict:
    """aov_image_rel_err and compose_rel_err of whole images' layers."""
    aov = lambda ims: np.stack([np.concatenate([im["albedo"][..., :3],
                                                im["normal_depth"][..., :4]], -1) for im in ims])
    return {"aov_image_rel_err": rel_err(aov(port), aov(ref)),
            "compose_rel_err": rel_err(np.stack([im["main"] for im in port]),
                                       np.stack([im["main"] for im in ref]))}


class Sample:
    """What the check keeps of the window's images as they come: the pixels
    `image_pixels` draws of each, and `compose_images` whole images (their
    place in the window, image seed and layers), a uniform reservoir over
    the window drawn from the seed, with `whole_pixels` more pixels of each
    compared. A window so holds a few images in memory, not all of them.
    `module` is the configuration's own reference module, None for the
    default (`build_reference`)."""

    def __init__(self, check: dict, traffic: dict, seed: int, pixels_per_image=None,
                 module=None):
        self.check, self.traffic, self.seed, self.module = check, traffic, seed, module
        self.per_image = pixels_per_image or check["pixels_per_image"]
        self.res = tuple(traffic["resolution"])
        self.seeds, self.pixels, self.port, self.whole = [], [], [], []
        self.images = 0
        self._reservoir = _rng(seed, 0xC0)

    def take(self, image_seed: int, layers: dict):
        i, self.images = self.images, self.images + 1
        pix = image_pixels(self.seed, i, self.res, self.per_image)
        self.seeds.append(np.full(pix.shape, image_seed, np.int64))
        self.pixels.append(pix)
        self.port.append(pixels_of(layers, self.traffic["entry"], pix, self.res[0]))
        keep = self.check.get("compose_images", 0)
        if len(self.whole) < keep:
            self.whole.append((i, image_seed, layers))
        elif keep:
            j = self._reservoir.integers(0, i + 1)
            if j < keep:
                self.whole[j] = (i, image_seed, layers)

    def _pairs(self):
        """(image seeds, pixel ids, the port's values) of every compared
        pixel: each image's drawn pixels, then the whole images' more."""
        seeds, pixels, port = list(self.seeds), list(self.pixels), list(self.port)
        for i, image_seed, layers in self.whole:
            pix = _rng(self.seed, 0xEC41, i).integers(0, self.res[0] * self.res[1],
                                                      self.check.get("whole_pixels", 0))
            seeds.append(np.full(pix.shape, image_seed, np.int64))
            pixels.append(pix)
            port.append(pixels_of(layers, self.traffic["entry"], pix, self.res[0]))
        return np.concatenate(seeds), np.concatenate(pixels), port

    def port_pixels(self) -> dict:
        port = self._pairs()[2]
        return {k: np.concatenate([p[k] for p in port]) for k in port[0]}

    def reference(self, spec, device, dtype=torch.float32) -> dict:
        seeds, pixels, _ = self._pairs()
        return reference_pixels(spec, self.traffic, seeds, pixels, device, dtype, self.module)

    def whole_reference(self, spec, device, dtype=torch.float32) -> list:
        return whole_reference([(s, layers) for _, s, layers in self.whole], spec,
                               self.traffic, device, dtype, module=self.module)

    def whole_numbers(self, spec, device) -> dict:
        """The port's whole images against the reference's."""
        if not self.whole:
            return {}
        return whole_numbers([layers for _, _, layers in self.whole],
                             self.whole_reference(spec, device))

    def numbers(self, spec, device) -> dict:
        got = compare(self.port_pixels(), self.reference(spec, device), self.check["off_tol"])
        got.update(self.whole_numbers(spec, device))
        return got


def run(sample: Sample, spec, device) -> dict:
    """{number: (value, limit)} of the window's sample."""
    got = sample.numbers(spec, device)
    return {k: (v, sample.check["limits"][k]) for k, v in got.items()}
