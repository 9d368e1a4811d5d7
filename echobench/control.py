"""The readings that a cell's check limits are set from (check.py).

    python3 -m echobench.control --workload field80.image256 --seeds 12 --controls 3

Sets the cell up once, as a run does, then for each of --seeds seeds
renders --images images with that seed's image seeds (the first one, a
run's warm-up, skipped), samples --pixels-per-image pixels of each as a run
does and compares the port with the reference: the lower readings. For each of
--controls seeds it puts the reference computed in bfloat16 in the port's
place: the control, whose readings are the upper ones. Beside them it reads
two faults from the same images: each image compared as the one before it
(a state returned unchanged), and, for a render_layer mix, the port at half
the samples an epoch ("half_samples"), or, where the mix's layer is
adaptive, the port with every pixel stopped after `min_epoch` epochs
("min_epoch_only"). Prints one JSON object of every reading; runs only on
a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import check, manifest, port, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m echobench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--pixels-per-image", type=int, default=0,
                    help="pixels compared an image (default: the check's; give a run's "
                         "pixels over --images to compare as many as a run)")
    ap.add_argument("--base-seed", type=int, default=2**31 + 12345)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("echobench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(run.ROOT, a.workload)
    spec = cell.scene()
    scene = port.prepare(spec, "cuda")
    tr = cell.traffic
    entry = port.Entry(tr)
    fault, faulty = "half_samples", None
    if tr["entry"] == "render_layer":
        prof = tr["profile"]
        if check.adaptive(prof):
            fault, prof = "min_epoch_only", dict(prof, max_epoch=prof["min_epoch"])
        else:
            prof = dict(prof, samples_per_epoch=max(1, prof["samples_per_epoch"] // 2))
        faulty = port.Entry(dict(tr, profile=prof))
    tol = cell.check["off_tol"]
    per_image = a.pixels_per_image or cell.check["pixels_per_image"]
    out = {"workload": a.workload, "card": run.host_info()["card"], "pixels": per_image * a.images,
           "sound": [], "control": [], "stale": [], fault: []}
    sample_of = lambda seed: check.Sample(cell.check, tr, seed, per_image, module=cell.reference)
    g = np.random.Generator(np.random.PCG64(a.base_seed))
    for k in range(max(a.seeds, a.controls)):
        seed = int(g.integers(2**31, 2**33))
        seeds_it = run.image_seeds(seed)
        next(seeds_it)  # a run's warm-up image
        im_seeds = [next(seeds_it) for _ in range(a.images)]
        t0 = time.perf_counter()
        images = [entry(scene, s)[0] for s in im_seeds]
        t1 = time.perf_counter()
        sample, stale = sample_of(seed), sample_of(seed)
        for i, (s, im) in enumerate(zip(im_seeds, images)):
            sample.take(s, im)
            stale.take(s, images[i - 1])  # each image as the one before it
        ref = sample.reference(spec, "cuda")
        whole = sample.whole_reference(spec, "cuda") if sample.whole else None
        t2 = time.perf_counter()
        if k < a.seeds:
            sound = check.compare(sample.port_pixels(), ref, tol)
            if whole:
                sound.update(check.whole_numbers([w[2] for w in sample.whole], whole))
            out["sound"].append(dict(seed=seed, **sound))
            out["stale"].append(dict(seed=seed, **check.compare(stale.port_pixels(), ref, tol)))
            if faulty is not None and k < 3:
                h = sample_of(seed)
                for s in im_seeds:
                    h.take(s, faulty(scene, s)[0])
                out[fault].append(dict(seed=seed, **check.compare(h.port_pixels(), ref, tol)))
        if k < a.controls:
            ctl = check.compare(sample.reference(spec, "cuda", torch.bfloat16), ref, tol)
            if whole:  # the bfloat16 reference's whole images in the port's place
                ctl.update(check.whole_numbers(
                    sample.whole_reference(spec, "cuda", torch.bfloat16), whole))
            out["control"].append(dict(seed=seed, **ctl))
        print(f"echobench.control: seed {seed}: images {t1 - t0:.2f} s, reference "
              f"{t2 - t1:.2f} s, {out['sound'][-1] if k < a.seeds else ''}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
