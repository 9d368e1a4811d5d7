"""PyTorch port: the diagnostics layer (host ensure, structured logging,
device asserts) and path_step's device checks.

tests/test_diagnostics.py's reference tests run on the port's module;
`dcheck` keeps a device flag a call and `run_checked` reads them all in
one host transfer. With ECHO_DEBUG_DEVICE=1 a render's first epoch runs
under `run_checked`: path_step's three checks pass on the Cornell box and
the image equals the unchecked render bitwise (the checks only read).
"""

import logging
import threading

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from echorenderer_tpu_torch.evaluation import integrators
from echorenderer_tpu_torch.models import scenes
from echorenderer_tpu_torch.processes.render import EvaluationProfile, RenderProfile, render
from echorenderer_tpu_torch.scene.prepare import prepare_scene
from echorenderer_tpu_torch.utils import diagnostics as dg

torch.set_num_threads(1)


def test_ensure_inactive_by_default(monkeypatch):
    monkeypatch.delenv("ECHO_DEBUG", raising=False)
    dg.ensure(False, "must not raise")  # release build: no-op


def test_ensure_active_under_flag(monkeypatch):
    monkeypatch.setenv("ECHO_DEBUG", "1")
    dg.ensure(True, "fine")
    with pytest.raises(AssertionError, match="negative radius"):
        dg.ensure(False, "negative radius")


def test_logger_named_and_structured(caplog):
    log = dg.get_logger("scheduler")
    assert log.name == "echo.scheduler"
    root = logging.getLogger("echo")
    root.propagate = True  # the console handler owns output in production
    try:
        with caplog.at_level(logging.INFO, logger="echo.scheduler"):
            dg.log_event(log, "operation_done", samples=1024, seconds=0.51)
    finally:
        root.propagate = False
    assert "operation_done samples=1024 seconds=0.51" in caplog.text


def test_dcheck_noop_without_flag(monkeypatch):
    """Off, dcheck returns before touching its predicate, even inside
    run_checked (None would raise in torch.all)."""
    monkeypatch.delenv("ECHO_DEBUG_DEVICE", raising=False)

    def f(x):
        dg.dcheck(None, "positive input")
        return x * 2.0

    assert float(f(torch.tensor(-1.0))) == -2.0
    assert float(dg.run_checked(f, torch.tensor(-1.0))) == -2.0


def test_dcheck_noop_outside_run_checked(monkeypatch):
    monkeypatch.setenv("ECHO_DEBUG_DEVICE", "1")
    dg.dcheck(None, "not collected")  # no run_checked active: nothing computed


def test_dcheck_raises_through_run_checked(monkeypatch):
    monkeypatch.setenv("ECHO_DEBUG_DEVICE", "1")

    def f(x):
        dg.dcheck(torch.isfinite(x), "non-finite throughput")
        return x + 1.0

    assert float(dg.run_checked(f, torch.tensor(1.0))) == 2.0
    with pytest.raises(Exception, match="non-finite throughput"):
        dg.run_checked(f, torch.tensor(np.inf))


def test_dcheck_message_formats_and_first_failure_wins(monkeypatch):
    monkeypatch.setenv("ECHO_DEBUG_DEVICE", "1")

    def f(x):
        dg.dcheck(x > -10.0, "first: {v}", v=x.min())
        dg.dcheck(x > 0.0, "lane value {v} not positive", v=x.min())
        dg.dcheck(x > 5.0, "third")
        return x

    with pytest.raises(AssertionError, match="lane value -3.0 not positive"):
        dg.run_checked(f, torch.tensor([1.0, -3.0, 2.0]))


class _Reads(TorchFunctionMode):
    """Counts the calls that move a tensor's values to the host."""

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in ("tolist", "item", "__bool__", "__float__", "__int__", "numpy", "cpu"):
            self.reads.append(name)
        return func(*args, **(kwargs or {}))


def test_run_checked_reads_the_host_once(monkeypatch):
    monkeypatch.setenv("ECHO_DEBUG_DEVICE", "1")

    def f(x):
        for i in range(7):
            dg.dcheck(x > -i, f"check {i}")
        return x

    watch = _Reads()
    with watch:
        dg.run_checked(f, torch.rand(64))
    assert watch.reads == ["tolist"]


def test_nested_and_threads_keep_their_own_checks(monkeypatch):
    monkeypatch.setenv("ECHO_DEBUG_DEVICE", "1")
    bad = torch.tensor([-1.0])

    def inner():
        dg.dcheck(bad > 0, "inner failed")

    def outer():
        with pytest.raises(AssertionError, match="inner failed"):
            dg.run_checked(inner)
        # another thread's dcheck lands in no run_checked of this one
        t = threading.Thread(target=lambda: dg.dcheck(bad > 0, "other thread"))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        dg.dcheck(bad < 0, "outer holds")

    dg.run_checked(outer)


def _cornell_profile():
    return RenderProfile(resolution=(16, 12), evaluations=(
        EvaluationProfile(evaluator="path", samples_per_epoch=2, max_epoch=1,
                          bounce_limit=3, adaptive=False),))


def test_path_step_checks_clean_on_cornell(monkeypatch):
    """A real render's first epoch passes path_step's checks (3 flags a
    bounce, read once) and gives the unchecked render's image bitwise."""
    prepared = prepare_scene(scenes.cornell_box(), device="cpu")
    counts = []
    real = dg.run_checked

    def spy(fn, *args, **kwargs):
        def counted(*a, **kw):
            out = fn(*a, **kw)
            counts.append(len(dg._checks.flags))
            return out
        return real(counted, *args, **kwargs)

    monkeypatch.setattr(dg, "run_checked", spy)
    monkeypatch.setenv("ECHO_DEBUG_DEVICE", "1")
    img = render(prepared, _cornell_profile())["main"]
    assert np.all(np.isfinite(img)) and img.mean() > 0
    assert len(counts) == 1 and counts[0] > 0 and counts[0] % 3 == 0

    monkeypatch.delenv("ECHO_DEBUG_DEVICE", raising=False)
    img2 = render(prepared, _cornell_profile())["main"]
    assert len(counts) == 1  # no run_checked without the flag
    np.testing.assert_array_equal(img, img2)


def test_path_step_builds_no_check_when_off(monkeypatch):
    """path_step builds its predicates only under an active run_checked
    with ECHO_DEBUG_DEVICE=1: off, or on past the first epoch, dcheck is
    not called at all (eager torch would launch the predicates even if
    dcheck dropped them)."""
    prepared = prepare_scene(scenes.cornell_box(), device="cpu")
    calls = []
    real = dg.dcheck
    monkeypatch.setattr(dg, "dcheck", lambda *a, **kw: (
        calls.append(dg._checks.flags is not None), real(*a, **kw)))
    monkeypatch.delenv("ECHO_DEBUG_DEVICE", raising=False)
    render(prepared, _cornell_profile())
    assert calls == []
    monkeypatch.setenv("ECHO_DEBUG_DEVICE", "1")
    two = RenderProfile(resolution=(16, 12), evaluations=(
        EvaluationProfile(evaluator="path", samples_per_epoch=2, min_epoch=2, max_epoch=2,
                          bounce_limit=3, adaptive=False),))
    render(prepared, two)
    assert calls and all(calls)  # the first epoch's checks alone, each under run_checked


def test_path_step_check_catches_non_finite_radiance(monkeypatch):
    prepared = prepare_scene(scenes.cornell_box(), device="cpu")
    monkeypatch.setattr(integrators, "_power_heuristic",
                        lambda a, b: torch.full_like(a, float("nan")))
    monkeypatch.setenv("ECHO_DEBUG_DEVICE", "1")
    with pytest.raises(AssertionError, match="path_step: non-finite radiance"):
        render(prepared, _cornell_profile())
    monkeypatch.delenv("ECHO_DEBUG_DEVICE", raising=False)
    render(prepared, _cornell_profile())  # unchecked: the accumulator rejects the NaNs


def test_render_layer_logs_its_dispatch(caplog):
    prepared = prepare_scene(scenes.cornell_box(), device="cpu")
    root = logging.getLogger("echo")
    dg.get_logger("render")
    root.propagate = True
    try:
        with caplog.at_level(logging.INFO, logger="echo.render"):
            render(prepared, _cornell_profile())
    finally:
        root.propagate = False
    assert "dispatch layer=main" in caplog.text and "integrator=wavefront" in caplog.text
