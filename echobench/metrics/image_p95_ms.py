"""The 95th percentile of the window's image times, in ms: each image from
the entry's call to its image on the host (host clock). The percentile is
statistics.quantiles' inclusive method over every image of the window."""

import statistics


def read(run):
    times = [(im.end - im.start) * 1e3 for im in run.images]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=100, method="inclusive")[94]
