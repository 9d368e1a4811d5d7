"""Device ms a traced image of the large-scene traversal kernels: the
chunk-tree walk (csrc/hier_walk.cu `hier_kernel`) and the binned
traversal (csrc/binned.cu `setup_kernel`, `setup_group`, `select_kernel`,
`select_group`, `seg_kernel`), from the trace's kernel intervals."""

import re

NAMES = re.compile(r"\b(hier_kernel|setup_kernel|setup_group|select_kernel|select_group|"
                   r"seg_kernel)\b")


def read(run):
    if run.trace is None:
        return None
    return run.trace.kernel_ms_per_image(lambda name: NAMES.search(name) is not None)
