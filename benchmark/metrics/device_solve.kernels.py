"""device_solve.kernels: the kernels a solve runs, aten's included: the
traced stretch's device events (harness/trace.py) other than copies and
memsets (names starting `Memcpy` / `Memset`) and the device mirrors of
the program's spans, over the stretch's `solve` spans. It counts what ran
on the device, so it holds under CUDA graph replay, where the kernel
wrappers' `.launches` counters do not."""

from benchmark.harness import spans


def read(ctx):
    tally = spans.totals()
    if ctx.trace is None or not tally or not tally.get("solve", {}).get("count"):
        return None
    kernels = [name for name, _ in ctx.trace.kernels
               if not name.startswith(("Memcpy", "Memset")) and name not in tally]
    return len(kernels) / tally["solve"]["count"]
