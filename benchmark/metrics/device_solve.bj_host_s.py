"""device_solve.bj_host_s: the host's seconds per solve in the block-Jacobi
preconditioner: the program's `bj.apply` spans (one an application in CG)
and `bj.build` spans (the inverse blocks' build), over the traced
stretch's `solve` spans. None where the program has neither span."""

from benchmark.harness import spans


def read(ctx):
    return spans.per_solve(spans.totals(), "bj.apply", "bj.build")
