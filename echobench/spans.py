"""The port's own spans in a traced run, reduced to what the per-layer
metrics read.

The port opens an `echo.*` range (`echorenderer_tpu_torch.utils.
diagnostics.span`) around each layer's work while a torch profiler
records; kineto stamps it on the clock of the card's kernels and copies,
and `trace.from_kineto` keeps it among the trace's host intervals. Over
the traced window:

- `union_s`: the seconds that the spans of some names cover together;
- `self_s`: the seconds that the spans of some names cover and their
  children's do not (a span's self time, its children being the other
  names);
- `idle_by_span`: the card's idle gaps, each credited to the innermost
  `echo.*` span open at its middle (None where none is), optionally only
  the parts of gaps inside given intervals (the traced images);
- `ms_per_image`: seconds as milliseconds a traced image.

As a module it runs one traced cell on the card and prints, as one JSON
line, the run's per-layer and end-to-end metrics, the traced and untraced
images' seconds, and the card's idle time inside the traced images by span:

    python3 -m echobench.spans --workload field80.image256 --seed 7 --seconds 51
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from . import trace

PREFIX = "echo."
# the spans that hold a whole layer: idle time under them alone is not named
ROOTS = ("echo.render_layer",)


def named(tr, names) -> list:
    """The trace's host intervals whose name is one of `names`."""
    names = set(names)
    return [iv for iv in tr.host if iv.name in names]


def union_s(tr, names) -> float:
    """Seconds inside the window that the spans of `names` cover."""
    return trace.union_length(named(tr, names), *tr.window)


def self_s(tr, names, children) -> float:
    """Seconds inside the window that the spans of `names` cover and the
    spans of `children` do not."""
    lo, hi = tr.window
    return (trace.union_length(named(tr, set(names) | set(children)), lo, hi)
            - trace.union_length(named(tr, children), lo, hi))


def ms_per_image(tr, seconds: float) -> float | None:
    """`seconds` as ms a traced image; None where nothing was covered."""
    return 1e3 * seconds / tr.images if seconds > 0 and tr.images else None


def _clip(spans, within) -> list:
    """The parts of the sorted (start, end) `spans` inside the union of
    the (start, end) intervals `within`."""
    merged = []
    for a, b in sorted(within):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    out, k = [], 0
    for a, b in spans:
        while k < len(merged) and merged[k][1] <= a:
            k += 1
        j = k
        while j < len(merged) and merged[j][0] < b:
            lo, hi = max(a, merged[j][0]), min(b, merged[j][1])
            if hi > lo:
                out.append((lo, hi))
            j += 1
    return out


def idle_by_span(tr, within=None) -> dict:
    """Seconds of the card's idle gaps inside the window (and inside the
    intervals `within`, where given), by the innermost `echo.*` span open
    at each gap's middle; None takes the gaps where no such span is open.
    The spans nest, as they do on the port's one render thread."""
    lo, hi = tr.window
    gaps = trace.gaps(tr.device, lo, hi)
    if within is not None:
        gaps = _clip(gaps, within)
    spans = sorted((iv for iv in tr.host if iv.name.startswith(PREFIX)),
                   key=lambda iv: (iv.start, -iv.end))
    out: dict = {}
    chain, k = [], 0  # the spans open at the sweep's point, outermost first
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while k < len(spans) and spans[k].start <= mid:
            while chain and chain[-1].end <= spans[k].start:
                chain.pop()
            chain.append(spans[k])
            k += 1
        while chain and chain[-1].end < mid:
            chain.pop()
        label = chain[-1].name if chain else None
        out[label] = out.get(label, 0.0) + (b - a)
    return out


def named_share(idle: dict, roots=ROOTS) -> float | None:
    """The share of `idle_by_span`'s seconds under a span other than
    `roots`."""
    total = sum(idle.values())
    named_s = sum(s for name, s in idle.items() if name is not None and name not in roots)
    return named_s / total if total > 0 else None


def capture(cell, seed: int, seconds: float, device, root, bench) -> dict:
    """One traced run of `cell` on `device` through the harness's own
    `run.measure`, reduced to main's JSON object. `Trace` keeps no image's
    interval, so the run's kineto events and window images are caught on
    their way through `trace.from_kineto` and `run.window`, which are put
    back afterwards."""
    from . import run

    # the traced run reports the cell's end-to-end metrics beside its per-layer ones
    cell = dataclasses.replace(cell, per_layer=cell.per_layer + cell.end_to_end)
    got = {}
    from_kineto, window = trace.from_kineto, run.window

    def keep_trace(events):
        events = list(events)
        got["images"] = [(e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9)
                         for e in events
                         if e.name() == trace.IMAGE_SPAN and trace._activity(e) == "cpu"]
        got["trace"] = from_kineto(events)
        return got["trace"]

    def keep_images(*args, **kw):
        images, failed, events = window(*args, **kw)
        got["seconds"] = [im.end - im.start for im in images]
        return images, failed, events

    trace.from_kineto, run.window = keep_trace, keep_images
    try:
        result = run.measure(cell, seed, seconds, True, device, root, bench)
    finally:
        trace.from_kineto, run.window = from_kineto, window
    traced = min(int(cell.traffic.get("trace_images", 10**9)), len(got["seconds"]))
    out = {"workload": cell.name, "seed": seed, "correct": result["correct"],
           "metrics": {k: m["value"] for k, m in result["metrics"].items()},
           "image_s": {"traced": got["seconds"][:traced], "untraced": got["seconds"][traced:]},
           "breakdown": result.get("breakdown")}
    tr = got.get("trace")
    if tr is not None:
        idle = idle_by_span(tr, got["images"])
        out["idle_in_images_s"] = sum(idle.values())
        out["idle_named_share"] = named_share(idle)
        out["idle_by_span"] = sorted(([k or "(no echo span)", v] for k, v in idle.items()),
                                     key=lambda r: -r[1])
        out["window_s"] = tr.window_s
        out["traced_images"] = tr.images
    return out


def main(argv=None) -> int:
    from . import manifest, run

    ap = argparse.ArgumentParser(prog="python3 -m echobench.spans",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    import torch

    bench = manifest.load(run.ROOT)
    cell = manifest.cell(run.ROOT, a.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"echobench.spans: {a.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    print(json.dumps(capture(cell, a.seed, a.seconds, "cuda", run.ROOT, bench)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
