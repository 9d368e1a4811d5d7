"""Host ms a traced image inside the port's `scene_ops.trace` and
`occlude` calls: the union of their `echo.trace` and `echo.occlude` spans
(the walk's and the binned traversal's launches, rounds and host reads),
to set beside the device's `traversal_ms_per_image` (spans.py)."""

from echobench import spans

NAMES = ("echo.trace", "echo.occlude")


def read(run):
    if run.trace is None:
        return None
    return spans.ms_per_image(run.trace, spans.union_s(run.trace, NAMES))
