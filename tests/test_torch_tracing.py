"""PyTorch port: the tracing of `utils/diagnostics.py`, on the CPU.

- With no profiler recording, `span` hands back the one shared no-op and
  the host counters count all the same; the registry loses no count to
  threads; `log_event` formats nothing below INFO.
- Under `torch.profiler`, a wavefront `render_layer` emits its `echo.*`
  spans, each inside its parent's interval: `echo.lane_order` and the
  wavefront's steps inside `echo.render_layer`, `echo.trace` and
  `echo.occlude` inside a step, an `echo.read` at each host read. The image
  is bitwise the one rendered with no profiler, `info["counters"]` counts
  one `reads.*` for each `echo.read` span and `wavefront.iterations` is
  the layer's `wavefront_iterations`.
- A `render` with the standard stack emits one `echo.compose.<operator>`
  span for each operator, inside `echo.compose`, and reports the stack's
  seconds and counters in its info.
"""

import dataclasses
import logging
import sys
import threading

import numpy as np
import pytest
import torch

from echorenderer_tpu_torch.models import scenes
from echorenderer_tpu_torch.processes.render import (
    EvaluationProfile,
    render,
    render_layer,
    standard_path_traced_profile,
)
from echorenderer_tpu_torch.scene.prepare import prepare_scene
from echorenderer_tpu_torch.utils import diagnostics

torch.set_num_threads(1)

RES = (12, 8)


@pytest.fixture(scope="module")
def cornell():
    return prepare_scene(scenes.cornell_box(), device="cpu")


def _spans(prof) -> list:
    """(name, start ns, end ns) of every `echo.*` range of a profile."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.name().startswith("echo.")]


def _inside(child, parents) -> bool:
    return any(a <= child[1] and child[2] <= b for _, a, b in parents)


def test_span_is_the_shared_noop_and_counters_count_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert diagnostics.span("echo.test") is diagnostics.NO_SPAN
    assert diagnostics.span("echo.test", "detail") is diagnostics.NO_SPAN
    before = diagnostics.counts()
    with diagnostics.span("echo.test"):
        diagnostics.count("test.events")
        diagnostics.count("test.events", 3)
    with diagnostics.host_read("test_site") as held:
        assert held is None
    assert diagnostics.counts_since(before) == {"test.events": 4, "reads.test_site": 1}
    assert diagnostics.counts()["test.never"] == 0


def test_counters_lose_no_count_to_threads():
    """Eight threads adding to one counter with a short switch interval:
    a lost read-modify-write would show as a short total."""
    before = diagnostics.counts()["test.threads"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [diagnostics.count("test.threads")
                                                    for _ in range(5000)]) for _ in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=30)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert diagnostics.counts()["test.threads"] - before == 8 * 5000


def test_log_event_formats_nothing_below_info():
    formatted = []

    class Field:
        def __format__(self, spec):
            formatted.append(spec)
            return "field"

    logger = diagnostics.get_logger("tracing_test")
    logger.setLevel(logging.WARNING)
    diagnostics.log_event(logger, "event", field=Field())
    assert formatted == []
    logger.setLevel(logging.INFO)
    try:
        diagnostics.log_event(logger, "event", field=Field())
    finally:
        logger.setLevel(logging.NOTSET)
    assert formatted == [""]


def test_wavefront_layer_spans_nest_and_leave_the_image_unchanged(cornell):
    prof = EvaluationProfile(samples_per_epoch=2, min_epoch=1, max_epoch=2, noise_threshold=0.0,
                             bounce_limit=3)
    plain, _ = render_layer(cornell, prof, RES, seed=3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        image, info = render_layer(cornell, prof, RES, seed=3)
    assert info["dispatch"]["integrator"] == "wavefront"
    assert np.array_equal(image, plain)

    spans = _spans(p)
    by = lambda name: [s for s in spans if s[0] == name]
    layer, steps = by("echo.render_layer"), by("echo.wavefront.step")
    assert len(layer) == 1
    for name in ("echo.lane_order", "echo.wavefront", "echo.adaptive.step", "echo.read"):
        assert by(name) and all(_inside(s, layer) for s in by(name)), name
    assert steps and all(_inside(s, by("echo.wavefront")) for s in steps)
    for name in ("echo.trace", "echo.occlude"):
        assert by(name) and all(_inside(s, steps) for s in by(name)), name

    counters = info["counters"]
    reads = sum(v for k, v in counters.items() if k.startswith("reads."))
    assert reads == len(by("echo.read")) and counters["reads.layer_image"] == 1
    assert counters["wavefront.iterations"] == info["wavefront_iterations"] == len(steps)
    # every sample traces at least its camera ray
    assert counters["rays.trace"] >= info["samples"] and counters["rays.occlude"] > 0


def test_render_stack_spans_each_operator_inside_compose(cornell):
    """The standard stack over its three layers, each at a few samples."""
    profile = standard_path_traced_profile(0.25, RES)
    profile = dataclasses.replace(profile, evaluations=tuple(
        dataclasses.replace(ep, samples_per_epoch=2, max_epoch=1, bounce_limit=2)
        for ep in profile.evaluations))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        out = render(cornell, profile)
    infos = out["__info__"]
    assert "composition_errors" not in infos
    spans = _spans(p)
    compose = [s for s in spans if s[0] == "echo.compose"]
    ops = [s for s in spans if s[0].startswith("echo.compose.")]
    assert len(compose) == 1 and all(_inside(s, compose) for s in ops)
    assert sorted(s[0] for s in ops) == sorted(
        f"echo.compose.{type(op).__name__}" for op in profile.composition)
    stack = infos["composition"]
    assert stack["seconds"] > 0
    assert stack["counters"]["reads.compose_download"] == len(profile.evaluations)
    assert len([s for s in spans if s[0] == "echo.render_layer"]) == len(profile.evaluations)
