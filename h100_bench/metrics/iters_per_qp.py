"""The mean of ``Result.info.iterations`` (warm-up iterations included)
over every problem the window solved (``program_counter``)."""


def read(ctx, name):
    if not ctx.units:
        return None
    return float(ctx.iterations().mean())
