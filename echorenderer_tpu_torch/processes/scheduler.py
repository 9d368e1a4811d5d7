"""Render scheduling (counterpart of echorenderer_tpu/processes/scheduler.py):
operation queue with pause/resume/abort + statistics.

Rebuild of the reference compute runtime (Common/Compute/Device.cs,
Worker.cs, Operation.cs) with the roles shifted: the device's kernels own
its parallelism, so "workers" disappear; what remains is the
*orchestration* contract — a FIFO queue of operations (prepare, evaluate,
compose), a background execution thread, cooperative pause/resume/abort
at safe points (epoch boundaries — the analogue of Worker.CheckSchedule
per pixel row, EvaluationOperation.cs:143), progress/time tracking, and
named event statistics (the reference's generated IStatistics counters,
Echo.Generation/StatisticsGenerator.cs).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable


class OperationState(Enum):
    QUEUED = "queued"
    RUNNING = "running"
    PAUSED = "paused"
    COMPLETED = "completed"
    ABORTED = "aborted"
    FAILED = "failed"


class EventRow:
    """Named monotonically increasing counters, reported from operation
    code and summed for display (reference Statistics/EventRow.cs)."""

    def __init__(self):
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def report(self, label: str, count: int = 1):
        with self._lock:
            self._counts[label] = self._counts.get(label, 0) + int(count)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def __getitem__(self, label: str) -> int:
        with self._lock:
            return self._counts.get(label, 0)


@dataclass
class Operation:
    """One schedulable unit. `fn(control, stats)` runs on the scheduler
    thread and must call `control.checkpoint()` at safe points."""

    name: str
    fn: Callable
    state: OperationState = OperationState.QUEUED
    progress: float = 0.0
    result: object = None
    error: str | None = None
    started: float | None = None
    finished: float | None = None
    stats: EventRow = field(default_factory=EventRow)

    @property
    def elapsed(self) -> float:
        if self.started is None:
            return 0.0
        end = self.finished if self.finished is not None else time.perf_counter()
        return end - self.started


class AbortError(Exception):
    pass


class Control:
    """Cooperative pause/abort handle passed into operations
    (reference WorkerState machine, Common/Compute/WorkerState.cs)."""

    def __init__(self, device: "Device", op: Operation):
        self._device = device
        self._op = op

    def checkpoint(self, progress: float | None = None):
        """Safe point: honors pause (blocks) and abort (raises)."""
        if progress is not None:
            self._op.progress = float(progress)
        dev = self._device
        if dev._abort.is_set():
            raise AbortError()
        paused = False
        while dev._pause.is_set() and not dev._abort.is_set():
            if not paused:
                self._op.state = OperationState.PAUSED
                paused = True
            time.sleep(0.01)
        if paused:
            self._op.state = OperationState.RUNNING
        if dev._abort.is_set():
            raise AbortError()

    def report(self, label: str, count: int = 1):
        self._op.stats.report(label, count)


class Device:
    """FIFO operation queue executing on one background thread
    (reference Device.Schedule/Pause/Resume/Abort, Device.cs:86-138).
    The accelerator is the lone 'worker'; operations run strictly in order."""

    def __init__(self):
        self.operations: list[Operation] = []
        self._queue: list[Operation] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._pause = threading.Event()
        self._abort = threading.Event()
        self._shutdown = False
        self._thread = threading.Thread(target=self._main, daemon=True)
        self._thread.start()

    # --- scheduling ---

    def schedule(self, name: str, fn: Callable) -> Operation:
        op = Operation(name=name, fn=fn)
        with self._wake:
            self.operations.append(op)
            self._queue.append(op)
            self._wake.notify()
        return op

    def schedule_render(self, prepared, profile) -> list[Operation]:
        """Queue the standard 3-phase render: evaluations then composition
        (reference ScheduledRender.Create, Processes/ScheduledRender.cs:160).
        The composition runs on the scene's device, as `render`'s does."""
        from .render import compose_on, render_layer

        layers: dict = {}
        ops = []

        def make_eval(ep):
            def run(control, stats):
                def progress(epoch, max_epoch, noise, **kw):
                    control.checkpoint(progress=epoch / max(max_epoch, 1))
                    stats.report("Epoch/Completed")

                img, info = render_layer(
                    prepared, ep, profile.resolution, profile.seed, progress
                )
                layers[ep.layer_name] = img
                stats.report("Sample/Evaluated", info["samples"])
                return info

            return run

        for ep in profile.evaluations:
            ops.append(self.schedule(f"evaluate:{ep.layer_name}", make_eval(ep)))

        if profile.composition:

            def run_compose(control, stats):
                control.checkpoint(progress=0.0)
                out, errors = compose_on(prepared.device, layers, profile.composition)
                layers.update(out)
                for k in errors:
                    stats.report(f"Error/{k}")
                control.checkpoint(progress=1.0)
                return errors

            ops.append(self.schedule("composition", run_compose))

        self._render_layers = layers
        return ops

    # --- control (reference Device.Pause/Resume/Abort) ---

    def pause(self):
        self._pause.set()

    def resume(self):
        self._pause.clear()

    def abort(self):
        """Cancel the running operation (at its next safe point) and all
        queued ones; operations scheduled afterwards run normally."""
        with self._lock:
            for op in self._queue:
                op.state = OperationState.ABORTED
            self._queue.clear()
            if self._current is not None:
                self._abort.set()
        self._pause.clear()

    def await_idle(self, timeout: float | None = None) -> bool:
        """Block until the queue drains (reference Operations.Await)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                busy = bool(self._queue) or self._current is not None
            if not busy:
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.01)

    def dispose(self):
        with self._wake:
            self._shutdown = True
            self._wake.notify()
        self.abort()
        self._thread.join(timeout=5)

    # --- worker loop (reference Worker.Main, Worker.cs:344-383) ---

    _current: Operation | None = None

    def _main(self):
        while True:
            with self._wake:
                while not self._queue and not self._shutdown:
                    self._wake.wait()
                if self._shutdown and not self._queue:
                    return
                op = self._queue.pop(0)
                self._current = op
            op.state = OperationState.RUNNING
            op.started = time.perf_counter()
            try:
                op.result = op.fn(Control(self, op), op.stats)
                op.state = OperationState.COMPLETED
                op.progress = 1.0
            except AbortError:
                op.state = OperationState.ABORTED
            except Exception as exc:  # noqa: BLE001 — captured, not raised
                op.state = OperationState.FAILED
                op.error = f"{type(exc).__name__}: {exc}"
            finally:
                op.finished = time.perf_counter()
                with self._lock:
                    self._current = None
                    self._abort.clear()
