"""Host ms a traced image of the wavefront's own work: its
`echo.wavefront.step` spans less the `echo.trace` and `echo.occlude` spans
inside them (shading, sampling, regeneration; spans.py)."""

from echobench import spans


def read(run):
    if run.trace is None:
        return None
    return spans.ms_per_image(run.trace, spans.self_s(run.trace, ("echo.wavefront.step",),
                                                      ("echo.trace", "echo.occlude")))
