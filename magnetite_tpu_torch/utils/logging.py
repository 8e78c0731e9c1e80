"""Structured stage logging + the program's one timer, `span`.

The reference logs with ``info:``/``warning:`` println prefixes and indicatif
progress bars (e.g. src/mesher.rs:121, src/solver.rs:124, 551, 570). Here:
the same ``info:`` message vocabulary, plus named spans (the profiling hook
the reference lacks -- SURVEY.md section 5).

A span is free unless something reads it. With no torch profiler running
and no `timings` key to write, `span()` returns one shared no-op context
after a single `_profiler_enabled()` check. Under a profiler it enters
`torch.profiler.record_function(name)`, so the span is a host event in the
same trace, on the same clock, as the device activity, and it adds its
duration and self time (the duration less its child spans') to an
in-memory tally (`span_totals`). A span given `timings` and `key` always
times its body on the host clock and writes `timings[key]`.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import threading
import time

import torch
from torch.autograd import _profiler_enabled

_enabled = True
_NO_SPAN = contextlib.nullcontext()
# the spans open on each thread, innermost last: a child adds its
# duration to its parent's children time
_open = threading.local()
_tally: dict[str, list] = {}  # name -> [count, total_s, self_s]
_tally_lock = threading.Lock()


def set_logging(enabled: bool) -> None:
    global _enabled
    _enabled = enabled


def log(message: str) -> None:
    if _enabled:
        print(message, file=sys.stderr if message.startswith("warning") else sys.stdout)


class _Span:
    __slots__ = ("name", "timings", "key", "traced", "start", "children", "range")

    def __init__(self, name: str, timings, key, traced: bool):
        self.name, self.timings, self.key, self.traced = name, timings, key, traced
        self.children = 0.0

    def __enter__(self):
        if self.traced:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
            stack = getattr(_open, "stack", None)
            if stack is None:
                stack = _open.stack = []
            stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        elapsed = time.perf_counter() - self.start
        if self.timings is not None:
            self.timings[self.key] = elapsed
        if self.traced:
            stack = _open.stack
            stack.pop()
            if stack:
                stack[-1].children += elapsed
            record_span(self.name, elapsed, elapsed - self.children)
            self.range.__exit__(*exc)
        return False


def span(name: str, timings: dict = None, key: str = None):
    """A named span around a `with` block (see the module docstring);
    with `timings` and `key` it writes the block's seconds to
    `timings[key]`, profiler or not."""
    traced = _profiler_enabled()
    if not traced and key is None:
        return _NO_SPAN
    return _Span(name, timings, key, traced)


def spanned(name: str):
    """Decorator: each call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def record_span(name: str, total_s: float, self_s: float = None) -> None:
    """Add one span of `total_s` seconds, `self_s` of them its own (all of
    them when not given), to the tally."""
    with _tally_lock:
        entry = _tally.setdefault(name, [0, 0.0, 0.0])
        entry[0] += 1
        entry[1] += total_s
        entry[2] += total_s if self_s is None else self_s


def span_totals() -> dict:
    """{name: {"count", "total_s", "self_s"}} of the spans that ran under a
    profiler since the last `reset_spans()`."""
    with _tally_lock:
        return {
            name: {"count": c, "total_s": total, "self_s": own}
            for name, (c, total, own) in _tally.items()
        }


def reset_spans() -> None:
    with _tally_lock:
        _tally.clear()


@contextlib.contextmanager
def stage(name: str):
    """A pipeline stage: the span `cli.<name>`, and its time in the log."""
    took: dict = {}
    try:
        with span("cli." + name, took, "s"):
            yield
    finally:
        log(f"info: stage '{name}' took {took['s']:.3f}s")


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
