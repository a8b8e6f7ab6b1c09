"""QPs that returned SOLVED and passed the check, over the window: from
its start to the end of the first unit that ended after ``--seconds``
(``host_clock``)."""


def read(ctx, name):
    return (ctx.attempted - ctx.failed) / ctx.window_s
