"""Host ms a traced image of the epoch loop's dispatch: the union of the
port's `echo.lane_order` spans (the tile-major lane order and its upload)
and `echo.mega.prepare` spans (the megakernel's tables and launch
arguments), over the traced images (spans.py)."""

from echobench import spans

NAMES = ("echo.lane_order", "echo.mega.prepare")


def read(run):
    if run.trace is None:
        return None
    return spans.ms_per_image(run.trace, spans.union_s(run.trace, NAMES))
