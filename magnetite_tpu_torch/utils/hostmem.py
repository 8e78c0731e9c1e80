"""Host allocator tuning for large-array workloads (the port's copy of
magnetite_tpu/utils/hostmem.py, which it cannot import without JAX).

glibc serves every allocation above its mmap threshold straight from
mmap(2) and munmaps it on free, and the threshold's auto-adaptation is
hard-capped at 32 MB — so the multi-hundred-MB numpy temporaries that
dominate meshing, closed-form assembly, and the AMG hierarchy build each
pay a kernel mmap + first-touch-fault + munmap round trip, every time.
The JAX package measured it on its TPU bench's 1-core host (a sequence of
200-500 MB temporaries spent 2x more wall time in the kernel than in the
arithmetic, 21.1 s -> 6.2 s after tuning); the churn also makes host prep
timings swing run to run with heap state.

Raising M_MMAP_THRESHOLD keeps big blocks on the main heap and raising
M_TRIM_THRESHOLD stops the heap top from being returned to the OS, so
freed pages stay faulted-in and later temporaries reuse them. The cost is
a process RSS that stays at its high-water mark — the right trade for a
batch solver, but NOT necessarily for a long-lived process that embeds
this package for occasional solves: set MAGNETITE_NO_MALLOC_TUNE=1 to
leave the allocator alone (mirrors MAGNETITE_NO_NATIVE).

Called once at package import (see magnetite_tpu_torch/__init__.py).
No-op on non-Linux or non-glibc systems.
"""

from __future__ import annotations

import os
import sys

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3


def tune_glibc_malloc(threshold_bytes: int = 1 << 30) -> bool:
    """Raise glibc's mmap/trim thresholds. Returns True when applied.

    `threshold_bytes` must fit a C int (mallopt's parameter type)."""
    if os.environ.get("MAGNETITE_NO_MALLOC_TUNE") == "1":
        return False
    if not sys.platform.startswith("linux"):
        return False
    try:
        import ctypes

        libc = ctypes.CDLL(None)
        ok_mmap = libc.mallopt(_M_MMAP_THRESHOLD, int(threshold_bytes))
        ok_trim = libc.mallopt(_M_TRIM_THRESHOLD, int(threshold_bytes))
        return bool(ok_mmap) and bool(ok_trim)
    except Exception:
        return False
