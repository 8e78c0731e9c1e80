"""device_solve.first_solve_iterations: CG iterations of a job's first
(eager) solve, the program's counter `SolveResult.iterations`, the mean
over the window's jobs."""


def read(ctx):
    vals = [r["iterations"] for r in ctx.readings if "iterations" in r]
    return sum(vals) / len(vals) if vals else None
