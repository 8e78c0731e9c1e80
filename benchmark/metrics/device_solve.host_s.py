"""device_solve.host_s: the host's seconds issuing a solve's device work,
per solve: the program's `solve.device` span (`timings["solve_s"]`: CG,
the V-cycles and the recovery, up to a device sync) less its `solve.wait`
spans (the convergence reads, the progress reads, the refinement passes'
residual reads and the closing sync), over the traced stretch's `solve`
spans. The part a CUDA graph of the solve's launches would cut."""

from benchmark.harness import spans


def read(ctx):
    tally = spans.totals()
    device = spans.per_solve(tally, "solve.device")
    wait = spans.per_solve(tally, "solve.wait")
    return None if device is None or wait is None else device - wait
