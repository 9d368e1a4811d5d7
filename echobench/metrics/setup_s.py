"""Set-up seconds, host clock: from the process's start through the
imports, the kernels' build or load, the scene, `prepare_scene` and one
warm-up image, to the card's last operation of it."""


def read(run):
    return run.setup["setup_s"]
