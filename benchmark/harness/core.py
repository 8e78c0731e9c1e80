"""One run of one cell: set-up and warm-up, the measured closed loop, the
readings, and the reference's judgement of the answers.

A driver (drivers/<name>.py) supplies `Session(env)`, whose constructor
is the set-up, and which has `request(load_case) -> Answer`, `shapes() ->
dict` and `close()`; the warm-up is the traffic's `warm_up` requests. The loop here is the same for every
driver: one caller, each request sent when the last has returned, for
`seconds`; the request that is under way when the time is up finishes and
counts."""

from __future__ import annotations

import contextlib
import math
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

from . import loadcase, spec
from .trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "magnetite_tpu")


@dataclass
class Env:
    """What a driver's session gets: the cell's files, the device, the seed."""

    config: dict
    traffic: dict
    device: object  # torch.device
    seed: int
    control: bool = False
    trace: bool = False

    def span(self, name: str):
        """A named range in the traced run's profile (nothing otherwise)."""
        if not self.trace:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function("bench." + name)

    def warm_up_case(self, k: int) -> dict:
        return loadcase.draw(self.seed, k, self.config["loads"], loadcase.WARM_UP)


@dataclass
class Answer:
    """One request's answer, in the caller's node order, on the host, with
    the mesh it was solved on and the request's own readings (spans and
    counters, by name)."""

    coords: np.ndarray
    tris: np.ndarray
    u: np.ndarray
    f: np.ndarray
    sigma: np.ndarray
    stress: np.ndarray
    von_mises: np.ndarray
    readings: dict = field(default_factory=dict)


@dataclass
class Context:
    """What a per-layer metric reader gets."""

    readings: list  # each completed request's `Answer.readings`
    trace: object  # trace.Trace, or None when the run was not traced
    shapes: dict  # the compiled problem's shapes (Session.shapes())
    window_s: float = 0.0  # the measured window, to the end of its last request


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _judge(cell: spec.Cell, sample: list, seed: int) -> dict:
    from ..reference import judge

    cfg = cell.config
    numbers: dict = {}
    seen = set()
    for index, answer in sample:
        got = judge.solve_numbers(
            answer.coords, np.asarray(answer.tris, np.int64), cfg["material"],
            cfg["supports"], loadcase.draw(seed, index, cfg["loads"]), answer.__dict__,
            sign_threshold=cfg["solver"].get("stress_sign_threshold", 1.0),
        )
        if id(answer.coords) not in seen:
            seen.add(id(answer.coords))
            got.update(judge.mesh_numbers(answer.coords, answer.tris, cfg["geometry"],
                                          cfg["mesh"]))
        for k, v in got.items():
            numbers[k] = max(numbers.get(k, -math.inf), v)
    return numbers


def execute(root: str, name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", control: bool = False, folder: str = "benchmark",
            started: float = None, log=print) -> dict:
    """Run cell `name` once; returns the result line's object."""
    import torch

    started = time.perf_counter() if started is None else started
    cell = spec.load_cell(root, name, folder)
    driver = spec.driver_of(cell)
    env = Env(cell.config, cell.traffic, torch.device(device), int(seed), control, trace)

    log(f"setup: imports and files read at {time.perf_counter() - started:.3f} s",
        file=sys.stderr)
    session = driver.Session(env)
    log(f"setup: session built at {time.perf_counter() - started:.3f} s", file=sys.stderr)
    try:
        window = _window(cell, session, env, seconds, started, log)
    finally:
        # the program's state is freed before the reference runs
        session.close()
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    return _report(cell, env, window, log)


@dataclass
class Window:
    """What the measured loop leaves: counts, each completed request's
    time and readings, the judged sample, the trace and the device."""

    setup_s: float
    window_s: float
    attempted: int
    failed: int
    durations: list
    readings: list
    sample: list  # (load-case index, Answer)
    traced: object  # trace.Trace or None
    device: dict
    shapes: dict


def _window(cell, session, env, seconds, started, log) -> Window:
    import torch

    dev, seed = env.device, env.seed
    n_sample = cell.workload["check"]["sample"]
    for k in range(int(cell.traffic["warm_up"])):
        session.request(env.warm_up_case(k))
    _sync(dev)
    log(f"setup: warm-up done at {time.perf_counter() - started:.3f} s", file=sys.stderr)
    tracer = None
    if env.trace:
        t = cell.traffic["trace"]
        tracer = Tracer(dev, t["skip"], t["requests"])
        tracer.warm()
    rng = np.random.default_rng([int(seed) % (1 << 64), 2])
    sample: list = []
    durations, readings = [], []
    attempted = failed = 0
    t_win = time.perf_counter()
    t_end = t_win
    while True:
        lc = loadcase.draw(seed, attempted, cell.config["loads"])
        if tracer:
            tracer.before(attempted)
        t0 = time.perf_counter()
        try:
            answer = session.request(lc)
        except Exception:  # a request that fails is counted and the loop goes on
            failed += 1
            log(traceback.format_exc(), file=sys.stderr)
            answer = None
        t_end = time.perf_counter()
        if tracer:
            tracer.after(attempted)
        if answer is not None:
            durations.append(t_end - t0)
            readings.append(answer.readings)
            k = len(durations) - 1
            if len(sample) < n_sample:
                sample.append((attempted, answer))
            else:
                j = int(rng.integers(0, k + 1))
                if j < n_sample:
                    sample[j] = (attempted, answer)
        attempted += 1
        if t_end - t_win >= seconds:
            break
    traced = None
    if tracer:
        tracer.after(attempted - 1, last=True)
        traced = tracer.finish()
    cuda = dev.type == "cuda"
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": cell.chips,
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if cuda else 0}
    return Window(t_win - started, t_end - t_win, attempted, failed, durations, readings,
                  sample, traced, device, session.shapes())


def _end_to_end(cell, w: Window) -> dict:
    """The cell's end-to-end metrics by name: setup_s; `<request>_s`, the
    window over the completed requests; `<request>_p95_s`, the 95th
    percentile of all of them."""
    kind = cell.traffic["request"]
    done = len(w.durations)
    values = {}
    for m in cell.end_to_end:
        name = m["name"]
        if name == "setup_s":
            values[name] = w.setup_s
        elif name == f"{kind}_s" and done:
            values[name] = w.window_s / done
        elif name == f"{kind}_p95_s" and done:
            values[name] = float(np.percentile(w.durations, 95))
    return values


def _report(cell, env, w: Window, log) -> dict:
    metrics = {}
    device = w.device
    if env.trace:
        ctx = Context(readings=w.readings, trace=w.traced, shapes=w.shapes, window_s=w.window_s)
        for m in cell.per_layer:
            value = spec.reader_of(cell, m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if w.traced is not None:
            device["busy_s"] = w.traced.busy_s
            device["window_s"] = w.traced.window_s
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in _end_to_end(cell, w).items()}

    numbers = _judge(cell, w.sample, env.seed) if w.sample else {}
    limits = cell.workload["check"]["limits"]
    # a number that was not read (no answer to judge) is None, and fails
    compared = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
    correct = (
        len(w.durations) > 0 and w.failed == 0
        and set(numbers) <= set(limits)
        and all(c["value"] is not None and c["value"] <= c["limit"] for c in compared.values())
    )
    result = {"correct": bool(correct), "attempted": w.attempted, "failed": w.failed,
              "metrics": metrics, "device": device}
    if w.traced is not None:
        result["breakdown"] = {"device_ops": w.traced.device_ops,
                               "idle_gaps": w.traced.idle_gaps}
    log(f"window {w.window_s!r} s: {len(w.durations)} of {w.attempted} requests completed, "
        f"{len(w.sample)} judged", file=sys.stderr)
    result["check"] = compared
    return result
