"""The program's own spans, as the per-layer readers take them: the tally
of `magnetite_tpu_torch.utils.logging.span_totals()`, {name: {"count",
"total_s", "self_s"}}. The program keeps it only while a profiler runs,
so in a run it covers the traced stretch alone, the stretch the device
metrics read. A program without the tally (older than its spans) gives
None, and so does a tally that lacks a name a reader needs."""

from __future__ import annotations


def totals():
    """The tally, or None where the program keeps none."""
    try:
        from magnetite_tpu_torch.utils.logging import span_totals
    except ImportError:
        return None
    return span_totals()


def per_solve(tally, *names):
    """The spans' summed total seconds over the tally's `solve` spans (one a
    request of the load-case cells), or None where any name is missing."""
    if not tally or any(n not in tally for n in ("solve",) + names):
        return None
    solves = tally["solve"]["count"]
    return sum(tally[n]["total_s"] for n in names) / solves if solves else None
