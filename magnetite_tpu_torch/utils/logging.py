"""Structured stage logging + timers.

The reference logs with ``info:``/``warning:`` println prefixes and indicatif
progress bars (e.g. src/mesher.rs:121, src/solver.rs:124, 551, 570). Here:
the same ``info:`` message vocabulary, plus nestable stage timers whose
durations accumulate into a global registry (the profiling hook the
reference lacks -- SURVEY.md section 5).
"""

from __future__ import annotations

import contextlib
import sys
import time

_timings: dict[str, float] = {}
_enabled = True


def set_logging(enabled: bool) -> None:
    global _enabled
    _enabled = enabled


def log(message: str) -> None:
    if _enabled:
        print(message, file=sys.stderr if message.startswith("warning") else sys.stdout)


@contextlib.contextmanager
def stage(name: str):
    """Time a pipeline stage; duration lands in `stage_timings()`."""
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        _timings[name] = _timings.get(name, 0.0) + elapsed
        log(f"info: stage '{name}' took {elapsed:.3f}s")


def stage_timings() -> dict[str, float]:
    return dict(_timings)


def reset_stage_timings() -> None:
    _timings.clear()


class ProgressBar:
    """Minimal host-side progress bar (the indicatif analog) for long host
    loops; device work is one jit call and needs no bar."""

    def __init__(self, total: int, label: str = "", width: int = 40):
        self.total = max(total, 1)
        self.label = label
        self.width = width
        self._last = -1

    def update(self, count: int) -> None:
        # hide on non-tty output like indicatif does (keeps piped logs clean)
        if not _enabled or not sys.stdout.isatty():
            return
        filled = int(self.width * count / self.total)
        if filled == self._last:
            return
        self._last = filled
        bar = "#" * filled + "-" * (self.width - filled)
        print(f"\r{self.label} [{bar}] {count}/{self.total}", end="", flush=True)

    def finish(self, message: str = "") -> None:
        if not _enabled:
            return
        if sys.stdout.isatty():
            self.update(self.total)
            print()
        if message:
            log(message)
