"""The traced stretch: torch.profiler over a few of the window's requests,
reduced to the device's busy time, its kernels, and what the host was
doing while the device sat idle.

The busy and idle arithmetic is frozen from the program's smoke script
(`profile_call`): busy is the device events' time (kernels, copies,
memsets; never the aten rows, which would count the same kernels again),
taken here as the union of their intervals, which on one stream is their
sum; idle is 1 - busy / the stretch's wall time on the host clock. Each
idle moment is put down to the innermost host event that covers it (an
aten op, a CUDA runtime call, or one of the drivers' `bench.*` ranges),
and the rest to the host outside any profiled op."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: list = field(default_factory=list)  # (name, seconds) per device event
    device_ops: list = field(default_factory=list)  # [name, seconds], most first
    idle_gaps: list = field(default_factory=list)  # [host activity, idle seconds]


class Tracer:
    """Starts and stops the profiler around requests [skip, skip + count)."""

    def __init__(self, device, skip: int, count: int):
        self.device, self.skip, self.count = device, int(skip), int(count)
        self.prof = None
        self.t0 = 0.0
        self.wall = 0.0
        self.done = None  # the stopped profiler, reduced by `finish`

    def _sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        loads and starts CUPTI, seconds that belong to no request."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities):
            self._sync()

    def before(self, index: int) -> None:
        if index == self.skip and self.done is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._sync()
            self.prof = profile(activities=activities)
            self.prof.start()
            self.t0 = time.perf_counter()

    def after(self, index: int, last: bool = False) -> None:
        if self.prof is not None and (index == self.skip + self.count - 1 or last):
            self._sync()
            self.wall = time.perf_counter() - self.t0
            self.prof.stop()
            self.done, self.prof = self.prof, None

    def finish(self):
        """The Trace of the stretch (None if it never started)."""
        return None if self.done is None else reduce(self.done.events(), self.wall)


def short_name(name: str) -> str:
    """A device event's name without its parameter list: kernels keep
    their template arguments, which tell value types and instances apart."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    depth = 0
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and s[i - 1] != " ":
            return s[:i][:160]
    return s[:160]


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events, wall_s: float, top: int = 10) -> Trace:
    """The Trace of a profiler's events over a stretch of `wall_s`."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            # the profiler mirrors the named ranges on the device's
            # timeline; no operation ran there for them
            if not (getattr(e, "is_user_annotation", False) or e.name.startswith("bench.")):
                device.append((e.name, e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CPU:
            host.append(e)
    busy = _merge([(s, e) for _, s, e in device])
    busy_us = sum(e - s for s, e in busy)
    by_op: dict = defaultdict(float)
    for name, s, e in device:
        by_op[short_name(name)] += (e - s) * 1e-6
    starts = [s for s, _ in busy]
    cum = [0.0]
    for s, e in busy:
        cum.append(cum[-1] + e - s)

    def busy_before(t: float) -> float:
        i = bisect.bisect_right(starts, t)
        if i == 0:
            return 0.0
        s, e = busy[i - 1]
        return cum[i - 1] + min(t, e) - s

    def idle_in(e) -> float:
        s, t = e.time_range.start, e.time_range.end
        return (t - s) - (busy_before(t) - busy_before(s))

    # each idle moment goes to the innermost host event that covers it:
    # an event's idle time less its children's
    idle_by: dict = defaultdict(float)
    for e in host:
        own = idle_in(e) - sum(idle_in(c) for c in e.cpu_children)
        if own > 0:
            idle_by[e.name] += own * 1e-6
    idle_s = max(wall_s - busy_us * 1e-6, 0.0)
    rest = idle_s - sum(idle_by.values())
    if rest > 0:
        idle_by["(host outside any profiled op)"] += rest
    return Trace(
        window_s=wall_s,
        busy_s=busy_us * 1e-6,
        kernels=[(name, (e - s) * 1e-6) for name, s, e in device],
        device_ops=[[k, v] for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[k, v] for k, v in sorted(idle_by.items(), key=lambda kv: -kv[1])[:top]],
    )
