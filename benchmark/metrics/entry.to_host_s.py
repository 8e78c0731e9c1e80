"""entry.to_host_s: seconds per solve of the answer's copy to the host,
the program's `solve.to_host` span (u, f, sigma, the two stresses and the
solve's scalars, `.cpu().numpy()` each) over the traced stretch's `solve`
spans."""

from benchmark.harness import spans


def read(ctx):
    return spans.per_solve(spans.totals(), "solve.to_host")
