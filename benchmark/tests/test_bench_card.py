"""The tiny cells on the card: the kernels' paths end to end, the traced
stretch's readers, and the control. Run on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider benchmark/tests -m cuda
"""

import pytest
import torch

from benchmark.harness import core

from .tiny import CELLS, make_root

SEED = 2**31 + 5151


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench_card")))


def run(root, cell, **kw):
    return core.execute(root, cell, SEED, kw.pop("seconds", 1.0), kw.pop("trace", False),
                        device="cuda", log=lambda *a, **k: None, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_cell_on_the_card(card, root, cell):
    r = run(root, cell)
    assert r["correct"] is True, r["check"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_cell_traced_on_the_card(card, root, cell):
    r = run(root, cell, trace=True)
    assert r["correct"] is True
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["breakdown"]["device_ops"]
    # the drivers' named ranges are host spans, never device work
    assert not any(name.startswith("bench.") for name, _ in r["breakdown"]["device_ops"])
    for name, m in r["metrics"].items():
        if name.endswith("_roofline") or name.endswith("idle_share"):
            assert 0 < m["value"] <= 105, (name, m)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny_delaunay.load_cases", "tiny_structured.load_cases"])
def test_control_on_the_card(card, root, cell):
    assert run(root, cell, control=True)["correct"] is False
