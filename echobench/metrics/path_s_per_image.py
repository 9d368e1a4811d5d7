"""Seconds an image of the adaptive path layer: its `render_layer` info's
`seconds` (the program's host clock), averaged over the window."""


def read(run):
    times = [im.infos["main"]["seconds"] for im in run.images if "main" in im.infos]
    return sum(times) / len(times) if times else None
