"""The check that decides `correct`: the port agrees with the reference,
and the control and each fault a cell can have come out not correct. On
the CPU at a size a test run holds (the port's plain path); the cells'
own sizes run on the card (the `cuda` tests)."""

import dataclasses

import numpy as np
import pytest
import torch

from echobench import check, manifest, port, run

BENCH = manifest.load(run.ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


def small(name, res=(24, 12), spp=8, per_image=80, stamp=False):
    """The cell at a size the CPU runs in seconds: a render mix at quality
    0.1 (8 samples an epoch, 2 epochs), wide enough for the watermark with
    `stamp`; an adaptive render_layer mix at `spp` an epoch, 1..3 epochs."""
    c = manifest.cell(run.ROOT, name, BENCH)
    if c.config["generator"] == "sphere_grid":
        c.config = dict(c.config, args={"n_tris": 4000})
    if c.traffic["entry"] == "render":
        c.traffic = dict(c.traffic, resolution=[224, 40] if stamp else list(res), quality=0.1,
                         profile=dict(
            c.traffic["profile"], samples_per_epoch=8, max_epoch=2, noise_threshold=0.18))
        c.check = dict(c.check, pixels_per_image=per_image, compose_images=1, whole_pixels=16)
        return c
    prof = dict(c.traffic["profile"], samples_per_epoch=spp)
    if check.adaptive(prof):
        prof.update(max_epoch=3, noise_threshold=0.18)
    c.traffic = dict(c.traffic, resolution=list(res), profile=prof)
    c.check = dict(c.check, pixels_per_image=per_image)
    return c


ADAPTIVE = [n for n in CELLS if check.adaptive(small(n).traffic["profile"])]


@pytest.mark.parametrize("name", CELLS)
def test_the_port_agrees_with_the_reference(name):
    r = run.measure(small(name, stamp=True), 2**32 + 77, 0.3, False, "cpu")
    assert r["correct"], r["check"]
    assert all(c["value"] < 1e-5 for c in r["check"].values()), r["check"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name):
    """The reference in bfloat16 put in the port's place fails a limit, on
    three seeds."""
    c = small(name)
    spec = c.scene()
    failed = 0
    for seed in (11, 2**31 + 3, 2**33 + 9):
        sample = check.Sample(c.check, c.traffic, seed)
        blank = {"main": np.zeros((12, 24, 3), np.float32), "path": np.zeros((12, 24, 3)),
                 "albedo": np.zeros((12, 24, 3)), "normal_depth": np.zeros((12, 24, 4))}
        for s in (101, 202, 303):
            sample.take(s, blank)
        ref = sample.reference(spec, "cpu")
        got = check.compare(sample.reference(spec, "cpu", torch.bfloat16), ref,
                            c.check["off_tol"])
        failed += any(got[k] > c.check["limits"][k] for k in got)
    assert failed == 3


@pytest.mark.parametrize("name", [n for n in CELLS
                                  if manifest.cell(run.ROOT, n, BENCH).traffic["entry"] == "render"])
def test_the_control_fails_on_whole_images(name):
    """The reference's whole images in bfloat16 put in the port's place
    fail a limit, on three seeds."""
    c = small(name)
    spec = c.scene()
    path = np.random.default_rng(5).uniform(0, 2, (12, 24, 3)).astype(np.float32)
    failed = 0
    for seed in (11, 2**31 + 3, 2**33 + 9):
        images = [(seed, {"path": path})]
        ref = check.whole_reference(images, spec, c.traffic, "cpu")
        got = check.whole_numbers(check.whole_reference(images, spec, c.traffic, "cpu",
                                                        torch.bfloat16), ref)
        assert check.whole_numbers(ref, ref) == {k: 0.0 for k in got}
        failed += any(got[k] > c.check["limits"][k] for k in got)
    assert failed == 3


class _Stale(port.Entry):
    """A step that returns its state unchanged: every image is the first."""

    first = None

    def __call__(self, scene, seed):
        if self.first is None:
            self.first = super().__call__(scene, seed)
        return self.first


def _half(monkeypatch):
    """Half of the samples left out, the mean taken over the rest: every
    path layer renders half its samples an epoch."""
    from echorenderer_tpu_torch.processes import render as render_mod

    full = render_mod.render_layer

    def render_layer(scene, profile, *args, **kw):
        if profile.evaluator == "path":
            profile = dataclasses.replace(profile,
                                          samples_per_epoch=profile.samples_per_epoch // 2)
        return full(scene, profile, *args, **kw)

    monkeypatch.setattr(render_mod, "render_layer", render_layer)


def _min_epoch(monkeypatch):
    """Every pixel stopped after `min_epoch` epochs: each adaptive path
    layer renders its full-frame epochs alone."""
    from echorenderer_tpu_torch.processes import render as render_mod

    full = render_mod.render_layer

    def render_layer(scene, profile, *args, **kw):
        if profile.evaluator == "path" and profile.adaptive:
            profile = dataclasses.replace(profile, max_epoch=profile.min_epoch)
        return full(scene, profile, *args, **kw)

    monkeypatch.setattr(render_mod, "render_layer", render_layer)


class _Altered(port.Entry):
    """An answer altered where it is produced: a quarter of the image."""

    def __call__(self, scene, seed):
        layers, infos = super().__call__(scene, seed)
        for img in layers.values():
            img[: img.shape[0] // 2, : img.shape[1] // 2] += 0.1
        return layers, infos


FAULTS = [(f, n) for f in ("stale", "half", "altered") for n in CELLS] + [
    ("min_epoch", n) for n in ADAPTIVE]


@pytest.mark.parametrize("fault,name", FAULTS, ids=[f"{f}-{n}" for f, n in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    if fault == "half":
        _half(monkeypatch)
    elif fault == "min_epoch":
        _min_epoch(monkeypatch)
    else:
        monkeypatch.setattr(port, "Entry", {"stale": _Stale, "altered": _Altered}[fault])
    r = run.measure(small(name), 2**32 + 78, 0.3, False, "cpu")
    assert r["attempted"] >= 1
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("name", [n for n in CELLS if small(n).traffic["entry"] == "render_layer"])
def test_an_adaptive_layer_is_replayed_epoch_by_epoch(monkeypatch, name):
    """A render_layer mix whose layer is adaptive goes through
    `Reference.adaptive` and agrees with the port; any other goes through
    `Reference.pixels`, as before."""
    from echobench.reference import tracer

    called = []
    for method in ("pixels", "adaptive"):
        def spy(self, *args, _method=method, _full=getattr(tracer.Reference, method)):
            called.append(_method)
            return _full(self, *args)

        monkeypatch.setattr(tracer.Reference, method, spy)
    c = small(name, res=(16, 10), per_image=60)
    r = run.measure(c, 2**32 + 79, 0.2, False, "cpu")
    assert called == ["adaptive" if name in ADAPTIVE else "pixels"]
    assert r["correct"] and r["check"]["rel_err"]["value"] < 1e-5, r["check"]


def test_pixels_and_whole_images_are_drawn_from_the_seed():
    a = check.image_pixels(2**40 + 1, 3, (30, 20), 50)
    assert np.array_equal(a, check.image_pixels(2**40 + 1, 3, (30, 20), 50))
    assert not np.array_equal(a, check.image_pixels(2**40 + 2, 3, (30, 20), 50))
    assert not np.array_equal(a, check.image_pixels(2**40 + 1, 4, (30, 20), 50))
    assert a.max() < 600

    def kept(seed):
        s = check.Sample({"pixels_per_image": 2, "compose_images": 2}, {
            "entry": "render_layer", "resolution": [4, 2]}, seed)
        for i in range(50):
            s.take(i, {"main": np.full((2, 4, 3), float(i), np.float32)})
        assert all(int(layers["main"][0, 0, 0]) == i for i, _, layers in s.whole)
        return sorted(i for i, _, _ in s.whole)

    assert len(kept(5)) == 2 and kept(5) == kept(5)
    assert len({tuple(kept(seed)) for seed in range(6)}) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_runs_correct_on_the_card(cuda, name):
    """A short run of each cell at its own size on the card."""
    r = run.measure(manifest.cell(run.ROOT, name, BENCH), 2**31 + 99, 2.0, False, cuda)
    assert r["correct"], r["check"]
    assert r["device"]["platform"] == "gpu" and r["metrics"]["setup_s"]["value"] > 0
