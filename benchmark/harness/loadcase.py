"""Load cases drawn from the seed.

Load case `index` of a run is drawn from (seed, stream, index) alone, so
it is the same whatever came before it, and every seed draws the same
kind of work: each variable uniform in the range that the configuration's
`loads` gives it. Stream 0 is the measured window's, stream 1 the
warm-up's."""

from __future__ import annotations

import numpy as np

WINDOW, WARM_UP = 0, 1


def draw(seed: int, index: int, loads: dict, stream: int = WINDOW) -> dict:
    """{variable: value} of one load case."""
    rng = np.random.default_rng([int(seed) % (1 << 64), stream, index])
    return {name: float(rng.uniform(lo, hi)) for name, (lo, hi) in sorted(loads.items())}
