"""The device trace of a traced run, reduced to what the per-layer metrics
read.

The busy and idle arithmetic is `report` of tools/torch_profile.py (device
busy and idle share under torch.profiler, device time grouped by kernel
name, launch counts), with one change: busy time is the union of the
device intervals inside the traced window, not the sum of their lengths,
so overlapping kernels and copies count once.
"""

from __future__ import annotations

import dataclasses

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
IMAGE_SPAN = "echobench.image"


@dataclasses.dataclass
class Interval:
    name: str
    start: float  # seconds, on the profiler's clock
    end: float
    kind: str = "kernel"  # the profiler's activity type


@dataclasses.dataclass
class Trace:
    window: tuple  # (start, end) seconds: the first traced image's start to the last's end
    device: list  # Interval of every kernel, copy and set on the device
    host: list  # Interval of every host op and annotation
    images: int  # images inside the window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return union_length(self.device, *self.window)

    def kernels(self) -> list:
        """Device intervals of kernels alone (no copies or sets)."""
        return [iv for iv in self.device if iv.kind == "kernel"]

    def idle_pct(self) -> float | None:
        """The card's idle share of the window, in %."""
        return 100.0 * (1.0 - self.busy_s() / self.window_s) if self.window_s > 0 else None

    def kernel_ms_per_image(self, pick) -> float | None:
        """Device ms a traced image of the kernels whose name `pick` takes,
        inside the window; None where none ran."""
        lo, hi = self.window
        sec = [min(iv.end, hi) - max(iv.start, lo) for iv in self.kernels()
               if pick(iv.name) and iv.end > lo and iv.start < hi]
        return 1e3 * sum(sec) / self.images if sec and self.images else None


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of the intervals, clipped to [lo, hi]."""
    spans = sorted((max(iv.start, lo), min(iv.end, hi)) for iv in intervals)
    total, cur_a, cur_b = 0.0, None, None
    for a, b in spans:
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The idle (start, end) spans of [lo, hi] between the intervals."""
    out, at = [], lo
    for a, b in sorted((iv.start, iv.end) for iv in intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def _activity(e) -> str:
    """The profiler's activity type of an event: "kernel", "gpu_memcpy",
    "gpu_memset", "gpu_user_annotation" on the device, "cpu" on the host
    (torch builds whose events do not report it are read by name)."""
    if hasattr(e, "activity_type"):
        kind = e.activity_type()
        return "cpu" if kind in ("cpu_op", "user_annotation", "cuda_runtime",
                                 "cuda_driver", "python_function") else kind
    if str(e.device_type()).endswith("CPU"):
        return "cpu"
    name = e.name()
    if name == IMAGE_SPAN:
        return "gpu_user_annotation"
    return "gpu_memcpy" if name.startswith("Memcpy") else (
        "gpu_memset" if name.startswith("Memset") else "kernel")


def from_kineto(events) -> Trace:
    """A Trace of the kineto events of a torch.profiler run."""
    device, host, images = [], [], []
    for e in events:
        kind = _activity(e)
        iv = Interval(e.name(), e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9,
                      kind)
        if kind in DEVICE_ACTIVITIES:
            device.append(iv)
        elif kind == "cpu":
            (images if iv.name == IMAGE_SPAN else host).append(iv)
    window = (min(iv.start for iv in images), max(iv.end for iv in images)) if images else (0, 0)
    return Trace(window, device, host, len(images))


def by_name(intervals, lo: float, hi: float) -> dict:
    """Seconds inside [lo, hi] and launch count, by name."""
    out: dict = {}
    for iv in intervals:
        s = max(0.0, min(iv.end, hi) - max(iv.start, lo))
        if iv.end > lo and iv.start < hi:
            sec, n = out.get(iv.name, (0.0, 0))
            out[iv.name] = (sec + s, n + 1)
    return out


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device ops that took most time, and the idle time by what the
    host was doing in each gap: the innermost host op open at the gap's
    middle ("host Python" where none was)."""
    lo, hi = tr.window
    ops = sorted(((name, sec) for name, (sec, _) in by_name(tr.device, lo, hi).items()),
                 key=lambda r: -r[1])[:top]
    host = sorted(tr.host, key=lambda iv: (iv.start, -iv.end))
    idle: dict = {}
    open_ops, k = [], 0  # host ops nest: a stack of those open at the sweep's point
    for a, b in gaps(tr.device, lo, hi):
        mid = 0.5 * (a + b)
        while k < len(host) and host[k].start <= mid:
            while open_ops and open_ops[-1].end < host[k].start:
                open_ops.pop()
            open_ops.append(host[k])
            k += 1
        while open_ops and open_ops[-1].end < mid:
            open_ops.pop()
        label = open_ops[-1].name if open_ops else "host Python"
        idle[label] = idle.get(label, 0.0) + (b - a)
    gaps_top = sorted(idle.items(), key=lambda r: -r[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps_top]}
