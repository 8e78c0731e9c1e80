"""device.idle_share: the share of the traced stretch's wall time (host
clock, ending in a device sync) in which no operation ran on the device,
1 - busy / wall, in percent (harness/trace.py)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
