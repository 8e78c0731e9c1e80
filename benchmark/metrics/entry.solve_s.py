"""entry.solve_s: seconds per request, the window over its completed
requests, as the end-to-end `solve_s` takes it, but read in the traced run
(its traced stretch of a few requests included). It stands per layer where
the host's speed from run to run spreads the mean wider than any bound
that `solve_s` may have."""


def read(ctx):
    done = len(ctx.readings)
    return ctx.window_s / done if done and ctx.window_s > 0 else None
