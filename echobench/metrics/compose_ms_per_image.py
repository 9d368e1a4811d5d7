"""Milliseconds an image outside the three layers: each image's wall time
(host clock, the call to its composed image on the host) less its layers'
`seconds`: the composition stack, its uploads and downloads, averaged over
the window."""


def read(run):
    out = []
    for im in run.images:
        layers = [im.infos.get(k, {}).get("seconds") for k in ("albedo", "main", "normal_depth")]
        if None not in layers:
            out.append(1e3 * ((im.end - im.start) - sum(layers)))
    return sum(out) / len(out) if out else None
