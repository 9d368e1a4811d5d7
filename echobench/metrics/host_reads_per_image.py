"""Device-to-host reads an image: the port's `reads.*` counters summed over
each image's infos (every layer's `counters`, and the composition stack's
under "composition"), averaged over the window's images. The reader of
`host_reads_per_image.frames` and `host_reads_per_image.standard`
(manifest.reader)."""


def _reads(infos: dict):
    counters = [i["counters"] for i in infos.values() if isinstance(i, dict) and "counters" in i]
    if not counters:
        return None
    return sum(v for c in counters for k, v in c.items() if k.startswith("reads."))


def read(run):
    per_image = [r for r in (_reads(im.infos) for im in run.images) if r is not None]
    return sum(per_image) / len(per_image) if per_image else None
