"""persist.load_s: seconds per job of `load_case`, `load_amg` and
`load_operator` together, the benchmark's own host clock around the three
calls, the mean over the window's jobs."""


def read(ctx):
    vals = [r["load_s"] for r in ctx.readings if "load_s" in r]
    return sum(vals) / len(vals) if vals else None
