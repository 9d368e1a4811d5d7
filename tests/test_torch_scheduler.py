"""PyTorch port: the render scheduler (tests/test_scheduler.py's cases on
the port's Device: FIFO completion, progress, pause/resume, abort, failure
capture), a scheduled standard-profile render against `render`'s layers
(bitwise: the same render_layer calls and the same composition on the
scene's device), and the lock that keeps two threads from building the
CUDA kernels at once.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from echorenderer_tpu_torch.models import scenes
from echorenderer_tpu_torch.ops import cuda_build
from echorenderer_tpu_torch.processes.render import (
    EvaluationProfile,
    RenderProfile,
    render,
    standard_path_traced_profile,
)
from echorenderer_tpu_torch.processes.scheduler import (
    AbortError,
    Device,
    EventRow,
    OperationState,
)
from echorenderer_tpu_torch.scene.prepare import prepare_scene

torch.set_num_threads(1)


@pytest.fixture
def device():
    d = Device()
    yield d
    d.dispose()
    assert not d._thread.is_alive()


def _sleep_op(duration=0.2, steps=10):
    def run(control, stats):
        for i in range(steps):
            time.sleep(duration / steps)
            control.checkpoint(progress=(i + 1) / steps)
            stats.report("Step/Completed")
        return "done"

    return run


class TestDevice:
    def test_fifo_completion(self, device):
        ops = [device.schedule(f"op{i}", _sleep_op(0.05, 2)) for i in range(3)]
        assert device.await_idle(timeout=10)
        assert [o.state for o in ops] == [OperationState.COMPLETED] * 3
        assert all(o.result == "done" for o in ops)
        for a, b in zip(ops, ops[1:]):
            assert b.started >= a.finished

    def test_progress_monotone_and_stats(self, device):
        op = device.schedule("p", _sleep_op(0.1, 5))
        seen = []
        deadline = time.time() + 10
        while op.state != OperationState.COMPLETED and time.time() < deadline:
            seen.append(op.progress)
            time.sleep(0.01)
        assert op.state == OperationState.COMPLETED
        assert all(b >= a for a, b in zip(seen, seen[1:]))
        assert op.stats["Step/Completed"] == 5

    def test_pause_resume(self, device):
        op = device.schedule("pause", _sleep_op(0.4, 20))
        time.sleep(0.06)
        device.pause()
        time.sleep(0.1)
        frozen = op.progress
        assert op.state in (OperationState.PAUSED, OperationState.RUNNING)
        time.sleep(0.15)
        assert op.progress == frozen  # no advance while paused
        device.resume()
        assert device.await_idle(timeout=10)
        assert op.state == OperationState.COMPLETED

    def test_pause_series(self, device):
        op = device.schedule("series", _sleep_op(0.4, 40))
        for _ in range(8):
            device.pause()
            time.sleep(0.01)
            device.resume()
            time.sleep(0.01)
        assert device.await_idle(timeout=15)
        assert op.state == OperationState.COMPLETED

    def test_abort(self, device):
        op1 = device.schedule("long", _sleep_op(5.0, 100))
        op2 = device.schedule("queued", _sleep_op(0.05, 2))
        time.sleep(0.1)
        device.abort()
        deadline = time.time() + 5
        while op1.state == OperationState.RUNNING and time.time() < deadline:
            time.sleep(0.01)
        assert op1.state == OperationState.ABORTED
        assert op2.state == OperationState.ABORTED
        assert op1.progress < 1.0
        op3 = device.schedule("after", _sleep_op(0.05, 2))
        assert device.await_idle(timeout=10)
        assert op3.state == OperationState.COMPLETED

    def test_failure_captured(self, device):
        def boom(control, stats):
            raise RuntimeError("exploded")

        op = device.schedule("fail", boom)
        next_op = device.schedule("next", _sleep_op(0.02, 1))
        assert device.await_idle(timeout=10)
        assert op.state == OperationState.FAILED
        assert "exploded" in op.error
        assert next_op.state == OperationState.COMPLETED

    def test_abort_error_is_an_exception(self):
        assert issubclass(AbortError, Exception)


def test_event_row_counts():
    row = EventRow()
    row.report("Ray/Traced", 10)
    row.report("Ray/Traced", 5)
    row.report("Sample/Accepted")
    assert row.snapshot() == {"Ray/Traced": 15, "Sample/Accepted": 1}


@pytest.fixture(scope="module")
def cornell():
    return prepare_scene(scenes.cornell_box(), device="cpu")


def test_scheduled_albedo(device, cornell):
    prof = RenderProfile(resolution=(16, 12), evaluations=(
        EvaluationProfile(evaluator="albedo", layer_name="albedo", max_epoch=1),))
    ops = device.schedule_render(cornell, prof)
    assert device.await_idle(timeout=300)
    assert all(o.state == OperationState.COMPLETED for o in ops)
    assert device._render_layers["albedo"].shape == (12, 16, 3)
    assert ops[0].stats["Sample/Evaluated"] > 0


def test_scheduled_standard_render_equals_render(device, cornell):
    """evaluate:albedo, evaluate:main, evaluate:normal_depth, composition,
    on the scheduler's thread: the layers `render` gives, bitwise."""
    prof = standard_path_traced_profile(0.25, (32, 24))
    ops = device.schedule_render(cornell, prof)
    assert device.await_idle(timeout=300)
    assert [o.name for o in ops] == ["evaluate:albedo", "evaluate:main",
                                     "evaluate:normal_depth", "composition"]
    assert all(o.state == OperationState.COMPLETED for o in ops), [o.error for o in ops]
    assert ops[-1].result == {}
    assert ops[1].stats["Epoch/Completed"] >= 1
    want = render(cornell, prof)
    got = device._render_layers
    assert sorted(got) == sorted(k for k in want if k != "__info__")
    for k in got:
        assert isinstance(got[k], np.ndarray), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_scheduled_composition_reports_errors(device, cornell):
    class Broken:
        def apply(self, layers):
            raise RuntimeError("boom")

    prof = RenderProfile(resolution=(8, 6), evaluations=(
        EvaluationProfile(evaluator="albedo", layer_name="main"),), composition=(Broken(),))
    ops = device.schedule_render(cornell, prof)
    assert device.await_idle(timeout=300)
    assert ops[-1].state == OperationState.COMPLETED
    assert ops[-1].result == {"Broken": "boom"}
    assert ops[-1].stats["Error/Broken"] == 1


def test_build_lock_serialises_threads(monkeypatch):
    """Many threads calling build() (more than the cores): one at a time."""
    inside, most, seen = [0], [0], []
    guard = threading.Lock()

    def fake_build():
        with guard:
            inside[0] += 1
            most[0] = max(most[0], inside[0])
        time.sleep(0.002)
        with guard:
            inside[0] -= 1
            seen.append(1)
        return {}

    monkeypatch.setattr(cuda_build, "_build", fake_build)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=cuda_build.build) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(seen) == 32 and most[0] == 1
