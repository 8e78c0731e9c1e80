"""kernel.mg_smooth_roofline: the fused V-cycle smoothing kernels'
(`mg_presmooth_kernel`, `mg_postsmooth_kernel`) share of their bound, in
percent.

Bytes of one V-cycle's smoothing, from the hierarchy's shapes: on every
level of R x C nodes that has a coarser level (Rc x Cc), presmooth reads
the stencil (9 x 2 x 2 values a node), the inverse centre blocks (2 x 2)
and r (2), writes e (2) and the restricted residual (2 a coarse node);
postsmooth reads the stencil, the inverse blocks, r, e and the coarse
correction (2 a coarse node) and writes e (2). A coarsest level without a
dense inverse runs 48 sweeps as 24 postsmooth calls, the first without an
input e. The V-cycles counted: the presmooth calls of the traced stretch
over the levels that presmooth, per value type. Memory bound (under one
flop a byte against the card's 10 to 20): the bound is bytes over the
bandwidth (harness/yardstick.py). Share: that bound over the kernels'
profiled time. None where the trace holds no such call."""

import re

from benchmark.harness import yardstick as ys

PRE = re.compile(r"\bmg_presmooth_kernel<\s*(float|double)")
POST = re.compile(r"\bmg_postsmooth_kernel<\s*(float|double)")
COARSE_CALLS = 24  # 48 sweeps, two a call


def vcycle_values(levels: list) -> int:
    """Values moved by one V-cycle's smoothing calls."""
    total = 0
    for i, lv in enumerate(levels):
        nodes = lv["rows"] * lv["cols"]
        if i + 1 < len(levels):
            coarse = levels[i + 1]["rows"] * levels[i + 1]["cols"]
            total += (36 + 4 + 2 + 2) * nodes + 2 * coarse  # presmooth
            total += (36 + 4 + 2 + 2 + 2) * nodes + 2 * coarse  # postsmooth
        elif not lv["dense"]:
            total += (36 + 4 + 2 + 2) * nodes + (COARSE_CALLS - 1) * (36 + 4 + 2 + 2 + 2) * nodes
    return total


def read(ctx):
    levels = ctx.shapes.get("mg_levels")
    if ctx.trace is None or not levels or len(levels) < 2:
        return None
    pre_calls = {"float": 0, "double": 0}
    spent = 0.0
    for name, seconds in ctx.trace.kernels:
        m = PRE.search(name) or POST.search(name)
        if not m:
            continue
        spent += seconds
        if PRE.search(name):
            pre_calls[m.group(1)] += 1
    bound = sum(
        ys.bound_s(calls / (len(levels) - 1) * vcycle_values(levels) * ys.ITEMSIZE[t], 0.0, t)
        for t, calls in pre_calls.items()
    )
    return 100.0 * bound / spent if spent > 0 else None
