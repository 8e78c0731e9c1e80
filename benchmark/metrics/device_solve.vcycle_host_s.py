"""device_solve.vcycle_host_s: the host's seconds per V-cycle, the mean
duration of the program's `amg.vcycle` / `mg.vcycle` spans (one a
preconditioner application, the f32 V-cycle's normalisation and casts
included) over the traced stretch. Nothing inside a V-cycle waits for the
device, so this is the host's enqueue of its launches."""

from benchmark.harness import spans


def read(ctx):
    tally = spans.totals()
    cycles = [tally[n] for n in ("amg.vcycle", "mg.vcycle") if tally and n in tally]
    count = sum(c["count"] for c in cycles)
    return sum(c["total_s"] for c in cycles) / count if count else None
