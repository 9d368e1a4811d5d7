"""Entry point of the PyTorch port: one 8-sample path-traced evaluation
epoch over a 128x128 pixel grid of the Cornell box (bounce limit 16,
survivability 2.5), the counterpart of `__graft_entry__.entry()`.

    from echorenderer_tpu_torch.entry import entry
    fn, args = entry("cuda")
    s_sum, s_sq = fn(*args)
"""

from __future__ import annotations

RESOLUTION = (128, 128)
SAMPLES = 8
BOUNCE_LIMIT = 16
SURVIVABILITY = 2.5


def entry(device="cuda"):
    """Returns (fn, example_args): fn(scene, sample_start) renders one
    epoch and returns per-pixel (sum, sum_sq), each (128*128, 3)."""
    from .models import scenes
    from .processes.render import _sample_frame
    from .scene.prepare import prepare_scene

    scene = prepare_scene(scenes.cornell_box(), device=device)

    def fn(scene, sample_start):
        return _sample_frame(
            scene, "path", RESOLUTION, 0, sample_start, SAMPLES, BOUNCE_LIMIT, SURVIVABILITY
        )

    return fn, (scene, 0)
