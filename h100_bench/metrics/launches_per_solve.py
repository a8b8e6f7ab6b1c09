"""Device kernels launched per unit of work (a fleet solve) in the traced
device phase, counted by the profiler (``device_trace``)."""


def read(ctx, name):
    t = ctx.trace
    if t is None or t.units == 0 or t.kernels == 0:
        return None
    return t.kernels / t.units
