"""The card's idle share of the traced window, in %: one minus the union of
its kernel, copy and set intervals over the window (trace.py). The reader
of `device_idle_pct.frames` and `device_idle_pct.standard` (manifest.reader)."""


def read(run):
    return run.trace.idle_pct() if run.trace is not None else None
