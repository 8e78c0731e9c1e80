"""device_solve.remainder_host_s: the host's seconds per solve in the
hybrid operator's COO remainder (the gather, the block product and the
`index_add_` of every matvec: the right-hand side, each CG iteration and
the force recovery), the program's `op.remainder` spans over the traced
stretch's `solve` spans. None where the program has no such span."""

from benchmark.harness import spans


def read(ctx):
    return spans.per_solve(spans.totals(), "op.remainder")
