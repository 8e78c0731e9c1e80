"""Whole runs of tiny cells on the CPU (the harness's look for a card
skipped): the result line, the control and the planted faults that the
output check has to catch, a cell added as files only, and the modules a
run may load."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import core

from .tiny import CELLS, REPO, make_root

SEED = 2**31 + 4242
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")))


def run(root, cell, trace=False, control=False, seconds=0.5):
    return core.execute(root, cell, SEED, seconds, trace, device="cpu", control=control,
                        log=lambda *a, **k: None)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_cell_runs_correct(root, cell):
    """Each driver end to end; every tiny cell is added as files and
    entries only, with no edit to any file the benchmark had."""
    r = run(root, cell)
    assert list(r) == KEYS + ["check"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert {"setup_s"} < set(r["metrics"])
    assert r["device"]["platform"] == "cpu"
    assert all(c["value"] <= c["limit"] for c in r["check"].values())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_cell_traced(root, cell):
    r = run(root, cell, trace=True, seconds=1.0)
    assert list(r) == KEYS + ["breakdown", "check"]
    assert r["correct"] is True
    bd = r["breakdown"]
    assert set(bd) == {"device_ops", "idle_gaps"} and len(bd["idle_gaps"]) <= 10
    assert r["metrics"] and all(m["unit"] for m in r["metrics"].values())
    assert r["device"]["window_s"] > 0
    assert json.loads(json.dumps(r)) == r


@pytest.mark.parametrize("cell", ["tiny_delaunay.load_cases", "tiny_structured.load_cases"])
def test_control_comes_out_not_correct(root, cell):
    """The control: the program's float32 path, with no refinement, in the
    refined path's place."""
    r = run(root, cell, control=True)
    assert r["correct"] is False
    assert r["check"]["residual"]["value"] > r["check"]["residual"]["limit"]


def _fault_state_unchanged(monkeypatch):
    """The solve's step returns its state unchanged: u stays at its start."""
    from magnetite_tpu_torch.fem import solve

    real = solve.pcg

    def pcg(op, b, x0=None, **kw):
        res = real(op, b, x0=x0, **kw)
        res.x.copy_(x0)
        return res

    monkeypatch.setattr(solve, "pcg", pcg)


def _fault_answer_altered(monkeypatch):
    """One element's stress is altered where it is produced."""
    from magnetite_tpu_torch.fem import solve

    real = solve.element_stress_tensors

    def stresses(*a, **kw):
        s = real(*a, **kw).clone()
        s[len(s) // 2] *= 1.001
        return s

    monkeypatch.setattr(solve, "element_stress_tensors", stresses)


def _fault_u_altered(monkeypatch):
    """One free displacement altered where the solve produces it."""
    from magnetite_tpu_torch.fem import solve

    real = solve.CompiledProblem.solve_device

    def solve_device(self, info=None):
        out = list(real(self, info))
        u = out[0].clone()
        free = (~self.u_known).nonzero()
        i, j = free[len(free) // 2].tolist()
        u[i, j] += 1e-4 * u.abs().max()
        out[0] = u
        return tuple(out)

    monkeypatch.setattr(solve.CompiledProblem, "solve_device", solve_device)


@pytest.mark.parametrize("fault", [_fault_state_unchanged, _fault_answer_altered,
                                   _fault_u_altered])
@pytest.mark.parametrize("cell", ["tiny_delaunay.load_cases", "tiny_delaunay.resumed_jobs"])
def test_planted_fault_comes_out_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    assert run(root, cell)["correct"] is False


def test_refinement_fault_structured(root, monkeypatch):
    """The structured plate refines by classic passes: the refinement
    returns its state unchanged."""
    from magnetite_tpu_torch.fem import refine

    real = refine.mixed_precision_solve

    def mixed_precision_solve(op, op32, b, x0=None, **kw):
        res = real(op, op32, b, x0=x0, **kw)
        res.x.copy_(x0)
        return res

    monkeypatch.setattr(refine, "mixed_precision_solve", mixed_precision_solve)
    assert run(root, "tiny_structured.load_cases")["correct"] is False


def test_coarser_mesh_comes_out_not_correct(root, monkeypatch):
    """The timed path meshes the part at a coarser resolution than the
    configuration states: a sound mesh of the same domain, and a faster job."""
    from magnetite_tpu_torch.meshing import delaunay_backend

    real = delaunay_backend.triangulate

    def triangulate(loops, h_min, h_max, *a, **kw):
        return real(loops, h_min, 1.5 * h_max, *a, **kw)

    monkeypatch.setattr(delaunay_backend, "triangulate", triangulate)
    r = run(root, "tiny_delaunay.fresh_jobs")
    assert r["correct"] is False
    assert r["check"]["mesh_size_gap"]["value"] > r["check"]["mesh_size_gap"]["limit"]
    assert r["check"]["mesh_defects"]["value"] == 0


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after("import benchmark.reference.judge, benchmark.reference.plane_stress")
    assert not mods & {"jax", "jaxlib", "flax", "magnetite_tpu", "magnetite_tpu_torch"}


def test_a_run_loads_no_jax(root):
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.harness import core\n"
        "r = core.execute(%r, 'tiny_delaunay.resumed_jobs', 7, 0.3, True, device='cpu',"
        " log=lambda *a, **k: None)\n"
        "assert r['correct'], r\n" % (REPO, root)
    )
    mods = _modules_after(code)
    assert "magnetite_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "magnetite_tpu"}
    names = [n for n in os.listdir(os.path.join(REPO, "benchmark", "metrics"))]
    assert not any(n.split(".")[0] in {"jax", "jaxlib", "magnetite_tpu"} for n in names)


def test_run_without_a_card_prints_no_result(tmp_path):
    """run.py refuses a machine without the cell's cards, here and in a
    directory that holds only BENCHMARK.json and the benchmark's folder."""
    cmd = [sys.executable, "benchmark/run.py", "--workload", "delaunay_1m.load_cases",
           "--seed", str(SEED), "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
    bare = make_root(str(tmp_path))
    out = subprocess.run(cmd, cwd=bare, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""

