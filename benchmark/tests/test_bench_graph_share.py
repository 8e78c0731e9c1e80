"""The reader of `device_solve.graph_share` on hand-made tallies, set
through the program's own `record_span`: replayed over replayed and eager
chunks, and None where the program records neither."""

import pytest

from benchmark.harness import spec
from magnetite_tpu_torch.utils import logging as program

from .test_bench_spans import context
from .tiny import REPO

NAME = "device_solve.graph_share"


def reader(cell):
    loaded = spec.load_cell(REPO, cell)
    assert NAME in {m["name"] for m in loaded.per_layer}
    return spec.reader_of(loaded, NAME)


@pytest.fixture
def tally():
    program.reset_spans()
    yield program.record_span
    program.reset_spans()


@pytest.mark.parametrize("cell", ["delaunay_1m.load_cases", "structured_1m.load_cases"])
@pytest.mark.parametrize("replays,chunks,share", [(20, 0, 100.0), (6, 2, 75.0), (0, 5, 0.0)])
def test_share_of_replayed_chunks(tally, cell, replays, chunks, share):
    tally("solve", 0.05)
    for _ in range(replays):
        tally("cg.replay", 1e-5)
    for _ in range(chunks):
        tally("cg.chunk", 2e-3)
    tally("cg.capture", 0.01)  # a capture replays nothing
    assert reader(cell).read(context()) == pytest.approx(share)


def test_none_without_chunk_spans(tally, monkeypatch):
    read = reader("delaunay_1m.load_cases").read
    assert read(context()) is None
    tally("solve", 0.05)
    tally("amg.vcycle", 1e-3)
    assert read(context()) is None
    monkeypatch.delattr(program, "span_totals")  # a program older than its spans
    assert read(context()) is None


def test_only_the_load_case_cells_list_it():
    cells = {"delaunay_1m.load_cases", "structured_1m.load_cases"}
    for cell in ("delaunay_1m.fresh_jobs", "delaunay_1m.resumed_jobs"):
        assert NAME not in {m["name"] for m in spec.load_cell(REPO, cell).per_layer}
    for cell in cells:
        reader(cell)
