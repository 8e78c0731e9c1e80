"""device_solve.iterations: CG iterations per request (under classic
refinement, the inner iterations of all passes), the program's counter
`SolveResult.iterations`, the mean over the window's requests."""


def read(ctx):
    vals = [r["iterations"] for r in ctx.readings if "iterations" in r]
    return sum(vals) / len(vals) if vals else None
