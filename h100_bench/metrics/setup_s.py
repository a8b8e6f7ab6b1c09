"""Set-up: from the process's start to the window's start: the imports,
the CUDA context, the kernels loaded (built on a checkout's first run), the
data made on the device and the warm-up at the cell's own shapes
(``host_clock``)."""


def read(ctx, name):
    return ctx.setup_s
