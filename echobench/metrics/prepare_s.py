"""Seconds of the port's `prepare_scene` in set-up, host clock to the
card's last operation: the flat tables, the SAH BVH (C++ builder), the
kernels' prim layouts and chunk tables."""


def read(run):
    return run.setup["prepare_s"]
