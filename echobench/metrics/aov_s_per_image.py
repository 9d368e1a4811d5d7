"""Seconds an image of the albedo and normal-and-depth layers: the sum of
their `render_layer` infos' `seconds` (the program's host clock, from the
layer's start to its image on the host), averaged over the window."""


def read(run):
    times = [im.infos["albedo"]["seconds"] + im.infos["normal_depth"]["seconds"]
             for im in run.images if "albedo" in im.infos and "normal_depth" in im.infos]
    return sum(times) / len(times) if times else None
