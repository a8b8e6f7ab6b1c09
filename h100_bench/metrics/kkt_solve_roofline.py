"""Kernel 3's share of its roofline (``device_trace``): the least time of
its launches' work at the launched shapes (``work.kkt_work``: each input
read once in float32, dx written once; the symmetric product, the factor
and both substitutions) at the float32-accurate peak
(``work.PEAK_F32_ACCURATE``) and HBM's rate, over the device time of the
kernels those launches ran, on whatever route."""

from h100_bench import work


def read(ctx, name):
    if ctx.trace is None:
        return None
    return work.launch_roofline(ctx.trace.launches,
                                lambda entry, dtype: entry.startswith("kkt_solve"))
