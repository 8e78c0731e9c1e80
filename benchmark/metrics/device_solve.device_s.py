"""device_solve.device_s: seconds of the device solve per request, the
program's own span (`SolveResult.timings["solve_s"]`: CG, the V-cycles and
the recovery, up to a device sync, before the copy to the host), the mean
over the window's requests."""


def read(ctx):
    vals = [r["device_s"] for r in ctx.readings if "device_s" in r]
    return sum(vals) / len(vals) if vals else None
