"""Host ms a traced image of the composition stack: the union of the port's
`echo.compose` spans (the layers' upload, every operator, the download;
spans.py)."""

from echobench import spans


def read(run):
    if run.trace is None:
        return None
    return spans.ms_per_image(run.trace, spans.union_s(run.trace, ("echo.compose",)))
