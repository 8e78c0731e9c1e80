"""device_solve.first_solve_s: seconds of a job's device solve, its
compiled part's first and only solve, issued eagerly: the program's
`solve.device` span (`SolveResult.timings["solve_s"]`: CG, the
preconditioner and the recovery, up to a device sync, before the copy to
the host), the mean over the window's jobs."""


def read(ctx):
    vals = [r["device_s"] for r in ctx.readings if "device_s" in r]
    return sum(vals) / len(vals) if vals else None
