"""host_prep.amg_build_s: seconds of the AMG hierarchy's host build per
job, the program's own span (`CompiledProblem.timings["amg_build_s"]`),
the mean over the window's jobs."""


def read(ctx):
    vals = [r["amg_build_s"] for r in ctx.readings if "amg_build_s" in r]
    return sum(vals) / len(vals) if vals else None
