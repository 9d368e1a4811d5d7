"""Device ms of the fused megakernel (csrc/megakernel.cu `mega_kernel<...>`)
a traced image, from the trace's kernel intervals."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.kernel_ms_per_image(lambda name: "mega_kernel" in name)
