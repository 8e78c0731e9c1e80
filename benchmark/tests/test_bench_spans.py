"""The readers of the program's spans on hand-built contexts: the tally
set through the program's own `record_span`, a fake trace's device
events. Each reader's arithmetic, and None where the trace, the spans or
the program's tally are missing."""

import pytest

from benchmark.harness import core, spec
from benchmark.harness.trace import Trace
from magnetite_tpu_torch.utils import logging as program

from .tiny import REPO

READERS = ("device_solve.host_s", "device_solve.vcycle_host_s", "entry.to_host_s",
           "device_solve.kernels")
KERNELS = [("dia_matvec_kernel<float, 2>(float const*, ...)", 1e-4),
           ("Memcpy DtoH (Device -> Pageable)", 5e-3),
           ("Memset (Device)", 1e-6),
           ("at::native::vectorized_elementwise_kernel<4, ...>", 2e-6),
           ("solve.device", 0.08),  # a device mirror of a program span
           ("gemvx::kernel<int, ...>", 3e-6)]


def reader(name):
    cell = spec.load_cell(REPO, "delaunay_1m.load_cases")
    assert name in {m["name"] for m in cell.per_layer}
    return spec.reader_of(cell, name)


def context(trace=True):
    return core.Context(readings=[], trace=Trace(window_s=1.0, busy_s=0.5, kernels=KERNELS)
                        if trace else None, shapes={})


@pytest.fixture
def tally():
    """Two solves' spans, as the program records them under a profiler."""
    program.reset_spans()
    for _ in range(2):
        program.record_span("solve", 0.100, 0.002)
        program.record_span("solve.device", 0.080, 0.030)
        program.record_span("solve.to_host", 0.012)
        program.record_span("solve.wait", 0.010)
        program.record_span("solve.wait", 0.015)
    for seconds in (0.001, 0.002, 0.003):
        program.record_span("amg.vcycle", seconds)
    program.record_span("mg.vcycle", 0.006)
    yield
    program.reset_spans()


def test_readers_arithmetic(tally):
    ctx = context()
    assert reader("device_solve.host_s").read(ctx) == pytest.approx(0.080 - 0.025)
    assert reader("device_solve.vcycle_host_s").read(ctx) == pytest.approx(0.012 / 4)
    assert reader("entry.to_host_s").read(ctx) == pytest.approx(0.012)
    # dia_matvec, the elementwise kernel and gemv, over two solves
    assert reader("device_solve.kernels").read(ctx) == pytest.approx(3 / 2)


def test_readers_without_a_trace_or_spans(tally):
    assert reader("device_solve.kernels").read(context(trace=False)) is None
    program.reset_spans()
    for name in READERS:
        assert reader(name).read(context()) is None, name
    program.record_span("solve", 0.1)
    for name in ("device_solve.host_s", "device_solve.vcycle_host_s", "entry.to_host_s"):
        assert reader(name).read(context()) is None, name


def test_readers_of_a_program_without_spans(tally, monkeypatch):
    """A program older than its spans (the parent of the change that added
    them) has no tally: every reader gives None and none raises."""
    monkeypatch.delattr(program, "span_totals")
    for name in READERS:
        assert reader(name).read(context()) is None, name
