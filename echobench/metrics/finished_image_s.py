"""Seconds a finished image: the window's seconds over the images it
completed (every layer and the composition), host clock."""


def read(run):
    return run.window_s / len(run.images) if run.images else None
