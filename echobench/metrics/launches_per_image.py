"""Device kernels launched a traced image (every kernel the trace holds
inside the window, over the traced images)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.images:
        return None
    lo, hi = tr.window
    n = sum(1 for iv in tr.kernels() if iv.end > lo and iv.start < hi)
    return n / tr.images if n else None
