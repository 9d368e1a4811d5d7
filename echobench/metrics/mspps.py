"""Million path samples a second: every sample of every image the window
completed (width x height x samples an epoch x epochs, from the traffic
mix), over the window's seconds, host clock."""


def read(run):
    if not run.images or run.window_s <= 0:
        return None
    w, h = run.traffic["resolution"]
    prof = run.traffic["profile"]
    per_image = w * h * prof["samples_per_epoch"] * prof["max_epoch"]
    return len(run.images) * per_image / run.window_s / 1e6
