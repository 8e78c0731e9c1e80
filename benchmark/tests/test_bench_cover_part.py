"""The cell `small_parts.fresh_jobs` (the upstream's own cover part as a
CLI job): its files, its five per-layer readers on hand-built contexts,
and its control, the program's float32 path at the cell's own size,
which the output check has to find not correct."""

import pytest

from benchmark.harness import core, spec
from benchmark.harness.trace import Trace
from magnetite_tpu_torch.utils import logging as program

from .tiny import REPO

CELL = "small_parts.fresh_jobs"
READERS = ("host_prep.compile_s", "device_solve.first_solve_s",
           "device_solve.first_solve_iterations", "device_solve.remainder_host_s",
           "device_solve.bj_host_s")
SPAN_READERS = ("host_prep.compile_s", "device_solve.remainder_host_s", "device_solve.bj_host_s")


def reader(name):
    return spec.reader_of(spec.load_cell(REPO, CELL), name)


def context(readings=()):
    return core.Context(readings=list(readings), trace=Trace(window_s=1.0, busy_s=0.1),
                        shapes={"mode": "hybrid"})


@pytest.fixture
def tally():
    """Two jobs' spans, as the program records them under a profiler."""
    program.reset_spans()
    for _ in range(2):
        program.record_span("compile_problem", 0.040)
        program.record_span("solve", 0.300)
        program.record_span("bj.build", 0.001)
    for _ in range(10):
        program.record_span("op.remainder", 0.002)
        program.record_span("bj.apply", 0.003)
    yield
    program.reset_spans()


def test_the_cell_and_its_metrics():
    cell = spec.load_cell(REPO, CELL)
    assert cell.chips == 1 and cell.config["name"] == "cover_part"
    assert cell.traffic["driver"] == "fresh_jobs"
    assert {m["name"] for m in cell.end_to_end} == {"job_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(READERS)
    assert all(m["moves"] == "job_s" for m in cell.per_layer)
    assert cell.config["solver"] == {"dtype": "float64", "cg_rtol": 1e-10,
                                     "preconditioner": "auto"}
    assert cell.workload["check"]["limits"]["residual"] == cell.config["solver"]["cg_rtol"]
    assert cell.config["reduced"] == []
    # no other cell reads the five
    for other in ("delaunay_1m.fresh_jobs", "delaunay_1m.load_cases"):
        assert not {m["name"] for m in spec.load_cell(REPO, other).per_layer} & set(READERS)


def test_readers_arithmetic(tally):
    ctx = context([{"device_s": 0.2, "iterations": 332}, {"device_s": 0.4, "iterations": 334}])
    assert reader("host_prep.compile_s").read(ctx) == pytest.approx(0.040)
    assert reader("device_solve.first_solve_s").read(ctx) == pytest.approx(0.3)
    assert reader("device_solve.first_solve_iterations").read(ctx) == pytest.approx(333)
    assert reader("device_solve.remainder_host_s").read(ctx) == pytest.approx(0.020 / 2)
    assert reader("device_solve.bj_host_s").read(ctx) == pytest.approx((0.030 + 0.002) / 2)


def test_readers_without_their_spans_or_readings(tally):
    for name in ("device_solve.first_solve_s", "device_solve.first_solve_iterations"):
        assert reader(name).read(context()) is None, name
    program.reset_spans()
    for name in READERS:
        assert reader(name).read(context()) is None, name
    # a tally with solves but none of the new spans: the parent's program,
    # or a job on another operator or preconditioner
    program.record_span("solve", 0.1)
    program.record_span("compile_problem", 0.05)
    for name in ("device_solve.remainder_host_s", "device_solve.bj_host_s"):
        assert reader(name).read(context()) is None, name
    assert reader("host_prep.compile_s").read(context()) == pytest.approx(0.05)


def test_readers_of_a_program_without_spans(tally, monkeypatch):
    monkeypatch.delattr(program, "span_totals")
    for name in SPAN_READERS:
        assert reader(name).read(context()) is None, name


def test_control_at_the_cells_size_comes_out_not_correct():
    """The program's float32 path, clamped to the float32 floor, in the
    float64 path's place: two whole jobs of the 1,745-node part."""
    r = core.execute(REPO, CELL, 2**31 + 4242, 0.1, False, device="cpu", control=True,
                     log=lambda *a, **k: None)
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert r["correct"] is False
    check = r["check"]
    for name in ("residual", "force_gap", "stress_gap"):
        assert check[name]["value"] > check[name]["limit"], name
    for name in ("mesh_defects", "mesh_measure_gap", "mesh_size_gap"):
        assert check[name]["value"] <= check[name]["limit"], name
