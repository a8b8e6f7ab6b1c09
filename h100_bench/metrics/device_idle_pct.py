"""The share of the traced device phase in which nothing ran on the card:
the union of the device's kernels, copies and fills, against the phase's
window, from a trace of CUDA activity alone (``device_trace``)."""


def read(ctx, name):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
