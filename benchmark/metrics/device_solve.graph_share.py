"""device_solve.graph_share: the share of the traced stretch's PCG chunks
that replayed from CUDA graphs, in %: the program's `cg.replay` spans (one
a replayed chunk or set-up graph) over those and its `cg.chunk` spans (one
a chunk of iterations issued eagerly). None where the program records
neither (a program without the graphs)."""

from benchmark.harness import spans


def read(ctx):
    tally = spans.totals()
    if not tally:
        return None
    replayed, eager = (tally.get(n, {}).get("count", 0) for n in ("cg.replay", "cg.chunk"))
    return 100.0 * replayed / (replayed + eager) if replayed + eager else None
