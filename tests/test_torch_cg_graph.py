"""A warm solve's PCG replayed from CUDA graphs (fem/cg.PCGGraph, the
systems' fem/solve.SolveGraphs): the first solve of a compiled part runs
eagerly, the second captures, later ones replay, and every replayed answer
is the eager solve's, bit for bit; a replayed call issues at most one
iteration past convergence.

The CUDA cases skip themselves without a card (decided inside each test);
the CPU cases hold the gate off on the CPU, the eager loop unchanged, and
the replay's host logic with its CUDA parts faked.
The file imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cg_graph.py -q
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from magnetite_tpu_torch.config import ModelMetadata, SolverOptions
from magnetite_tpu_torch.fem.cg import (
    CHECK_EVERY, PCGGraph, _distinct, _Graph, _start, pcg,
)
from magnetite_tpu_torch.fem.solve import compile_problem
from magnetite_tpu_torch.kernels import cuda_lib
from magnetite_tpu_torch.utils import logging as spans
# tests/ is on sys.path (pytest's prepend import mode); `tests.torch_cases`
# would not import where an installed package is named `tests`
from torch_cases import HOLE, OUTER
from torch_cases import one_thread  # noqa: F401  (autouse)

MD = ModelMetadata(youngs_modulus=69e9, poisson_ratio=0.33, part_thickness=0.5,
                   characteristic_length_min=0.0, characteristic_length_max=0.03)
GRAPH_SPANS = ("cg.capture", "cg.replay")


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _delaunay(h=0.03, **opts):
    """The plate with a hole under AMG: the benchmark's f32 V-cycle in one
    f64 CG (refine on)."""
    from magnetite_tpu_torch.meshing.delaunay_backend import triangulate
    from magnetite_tpu_torch.meshing.generators import tensile_bcs_for_rect

    mesh = triangulate([np.array(OUTER), np.array(HOLE)], 0.0, h)
    kw = dict(dtype="float32", cg_rtol=1e-8, refine="on", preconditioner="amg")
    return mesh, tensile_bcs_for_rect(mesh.coords), SolverOptions(**{**kw, **opts})


def _structured(**opts):
    """A structured plate under multigrid: classic refinement, f32 inner
    PCG in f64 passes."""
    from magnetite_tpu_torch.meshing.generators import plate_with_hole_mesh, tensile_bcs_for_rect

    mesh = plate_with_hole_mesh(32, 64)
    kw = dict(dtype="float32", cg_rtol=1e-8)
    return mesh, tensile_bcs_for_rect(mesh.coords), SolverOptions(**{**kw, **opts})


CASES = {
    "delaunay-amg": _delaunay, "structured-mg": _structured,
    "ell-amg": lambda: _delaunay(operator="ell"),
    # no V-cycle: hundreds of iterations, each replayed on its own
    "banded-none": lambda: _delaunay(preconditioner="none", refine="off", dtype="float64"),
    "banded-block_jacobi": lambda: _delaunay(preconditioner="block_jacobi", refine="off",
                                             dtype="float64"),
    "ell-jacobi": lambda: _delaunay(operator="ell", preconditioner="jacobi", refine="off",
                                    dtype="float64"),
    # classic refinement whose inner PCG has no preconditioner
    "structured-none": lambda: _structured(preconditioner="none"),
    "ell-none": lambda: _delaunay(operator="ell", preconditioner="none"),
}


def _case_b(problem):
    """Load case B: a y-force on the right edge, whose uy is free."""
    coords = problem.coords.cpu().numpy()
    right = torch.from_numpy(np.isclose(coords[:, 0], coords[:, 0].max()))
    f = problem.f_value.clone()
    f[right.to(f.device), 1] = 2e6
    return dataclasses.replace(problem, f_value=f)


def _answer(res) -> tuple:
    return (res.u, res.f, res.sigma, res.stress, res.von_mises, res.iterations,
            res.residual_norm, res.residual_rel)


def _assert_same(got, want):
    for a, b in zip(_answer(got), _answer(want)):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert a == b


def _traced(fn):
    """fn() under the profiler (host events only): (its value, the span
    tally)."""
    spans.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    totals = spans.span_totals()
    spans.reset_spans()
    return out, totals


def _count(totals, name) -> int:
    return totals.get(name, {}).get("count", 0)


# ------------------------------- on the card -------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["delaunay-amg", "structured-mg", "banded-none",
                                  "banded-block_jacobi", "ell-jacobi", "structured-none",
                                  "ell-none"])
def test_replayed_solves_are_the_eager_solves_bit_for_bit(case):
    """A (eager), A again (captured, replayed), then B and A (replayed),
    each against the eager solve of the same load case: B's on a second
    compile of the part, whose first solve it is. Every preconditioner
    kind, with more than CHECK_EVERY iterations where there is no V-cycle."""
    dev = require_cuda()
    mesh, bca, opts = CASES[case]()
    a = compile_problem(mesh, bca, MD, opts, device=dev)
    first = a.solve()
    assert not a.system.graphs.entries
    again = a.solve()
    assert a.system.graphs.entries, "the second solve captures"
    b = _case_b(a).solve()
    last, totals = _traced(a.solve)
    assert _count(totals, "cg.replay") > 1 and not _count(totals, "cg.chunk")
    fresh = compile_problem(mesh, bca, MD, opts, amg_setup=a.amg_setup, device=dev)
    b_eager = _case_b(fresh).solve()
    assert not fresh.system.graphs.entries
    _assert_same(again, first)
    _assert_same(last, first)
    _assert_same(b, b_eager)
    assert first.iterations > 0 and b.iterations > 0
    assert not np.array_equal(b.u, first.u)
    if a.preconditioner not in ("amg", "multigrid"):
        assert first.iterations > CHECK_EVERY and b.iterations > CHECK_EVERY
    if "refine_inner" in first.timings:
        assert again.timings["refine_inner"] == first.timings["refine_inner"]
    for res in (again, last):  # at most one frozen iteration a PCG call
        calls = len(res.timings.get("refine_inner", [None]))
        assert 0 <= res.timings["cg_issued"] - res.iterations <= calls


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["delaunay-amg", "ell-amg"])
def test_support_change_refreshes_the_static_fields(case):
    """The supports change through `dataclasses.replace` of u_known between
    two replayed solves: the replay reads the new free mask and block-Jacobi
    inverse, and gives what the same replaced problem gives solved eagerly
    on a second compile of the part."""
    dev = require_cuda()
    mesh, bca, opts = CASES[case]()
    p = compile_problem(mesh, bca, MD, opts, device=dev)
    p.solve()
    p.solve()  # captured

    def held(problem):
        coords = problem.coords.cpu().numpy()
        right = torch.from_numpy(np.isclose(coords[:, 0], coords[:, 0].max())).to(dev)
        known = problem.u_known.clone()
        known[right, 1] = True  # the right edge's uy held at 0 as well
        return dataclasses.replace(problem, u_known=known)

    got = held(p).solve()
    q = compile_problem(mesh, bca, MD, opts, amg_setup=p.amg_setup, device=dev)
    want = held(q).solve()
    assert not q.system.graphs.entries
    _assert_same(got, want)
    assert not np.array_equal(got.u, p.solve().u)


def _dense_spd(n, seed, shift, device="cpu"):
    """A dense SPD system: (A, b, the Jacobi diagonal), f64."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(n, n, generator=g, dtype=torch.float64)
    a = (q @ q.T + shift * torch.eye(n, dtype=torch.float64)).to(device)
    b = torch.randn(n, generator=g, dtype=torch.float64).to(device)
    return a, b, torch.diagonal(a).clone()


@pytest.mark.cuda
@pytest.mark.parametrize("maxiter", [CHECK_EVERY + 5, CHECK_EVERY - 3, 2 * CHECK_EVERY])
def test_a_short_last_chunk_runs_eagerly(maxiter):
    """maxiter not a multiple of CHECK_EVERY, and never converged: the call
    stops after exactly maxiter iterations, all replayed, one iteration a
    replay, with no eager tail. The answer is the eager loop's."""
    dev = require_cuda()
    a, b, d = _dense_spd(96, 3, 96, dev)

    def run(graph):
        return pcg(lambda v: a @ v, b, preconditioner=lambda r: r / d, rtol=1e-30,
                   maxiter=maxiter, graph=graph)

    want = run(None)
    graph = PCGGraph(torch.cuda.graph_pool_handle())
    for k in range(3):
        got, totals = _traced(lambda: run(graph))
        for x, y in zip(got[:4], want[:4]):
            assert torch.equal(x, y)
        assert got.issued == maxiter
        assert _count(totals, "cg.capture") == (0 if k else 1 + min(maxiter, 2))
        assert _count(totals, "cg.replay") == 1 + maxiter
        assert _count(totals, "cg.chunk") == 0
    assert int(want.iterations) == maxiter


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["delaunay-amg", "structured-mg", "banded-block_jacobi"])
def test_a_replay_stops_one_iteration_past_convergence(case):
    """Solve 1 eager, 2 captures, 3 and 4 replay, one iteration a replay:
    each the eager solve's bits, each PCG call one frozen iteration past its
    converged one, the long block-Jacobi solve's too."""
    dev = require_cuda()
    mesh, bca, opts = CASES[case]()
    p = compile_problem(mesh, bca, MD, opts, device=dev)
    first = p.solve()
    for k in range(3):
        res, totals = _traced(p.solve)
        _assert_same(res, first)
        calls = len(res.timings.get("refine_inner", [None]))
        assert res.timings["cg_issued"] == res.iterations + calls
        # set-up, A -> B, B -> A
        assert _count(totals, "cg.capture") == (0 if k else 3)
        assert _count(totals, "cg.replay") == calls + res.timings["cg_issued"]
        assert not _count(totals, "cg.chunk")
    if case == "banded-block_jacobi":
        assert first.iterations > 2 * CHECK_EVERY
    assert first.timings["cg_issued"] >= first.iterations  # the eager loop's chunks


@pytest.mark.cuda
def test_a_loop_whose_layouts_drift_is_refused():
    """A preconditioner whose output layout changes after its first call
    gives the state B other layouts than A: replays would sum in other
    orders than the eager loop, so the capture fails before any replay."""
    dev = require_cuda()
    n = 48
    g = torch.Generator().manual_seed(4)
    q = torch.randn(n * n, n * n, generator=g, dtype=torch.float64)
    a = (q @ q.T / n + n * torch.eye(n * n, dtype=torch.float64)).to(dev)
    b = torch.randn(n, n, generator=g, dtype=torch.float64).to(dev)
    calls = []

    def m(r):  # row-major at its first call, column-major after
        calls.append(1)
        y = r / 2.0
        return y if len(calls) == 1 else y.t().contiguous().t()

    graph = PCGGraph(torch.cuda.graph_pool_handle())
    with pytest.raises(AssertionError, match="memory layout"):
        pcg(lambda v: (a @ v.reshape(-1)).reshape(n, n), b, preconditioner=m, rtol=1e-30,
            maxiter=CHECK_EVERY, graph=graph)


@pytest.mark.cuda
def test_progress_history_and_sharded_solves_never_capture():
    dev = require_cuda()
    from magnetite_tpu_torch.parallel.pipeline import DeviceMesh, compile_sharded_problem

    mesh, bca, opts = _delaunay()
    observed = compile_problem(mesh, bca, MD, dataclasses.replace(
        opts, cg_progress_every=4, residual_history=8), device=dev)
    sharded = compile_sharded_problem(mesh, bca, MD, opts,
                                      device_mesh=DeviceMesh(("cuda:0",) * 2))

    def solves():
        return [problem.solve() for problem in (observed, sharded) for _ in range(3)]

    _, totals = _traced(solves)
    assert not any(_count(totals, name) for name in GRAPH_SPANS)
    assert _count(totals, "cg.chunk") > 0
    assert not observed.system.graphs.entries


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["delaunay-amg", "structured-mg"])
def test_span_and_launch_counts_follow_the_chunks(case):
    """Solve 1 runs its chunks eagerly (`cg.chunk`); solve 2 captures the
    set-up and the two one-iteration graphs once each and replays them,
    an iteration a replay, one past the converged one; solve 3 only
    replays, the same way. The launch counter counts the wrappers' calls: solve 2
    counts the captured set-up and two iterations, solve 3 only what runs
    outside the PCG (none of the smoothers)."""
    dev = require_cuda()
    mesh, bca, opts = CASES[case]()
    p = compile_problem(mesh, bca, MD, opts, device=dev)
    kernel = "mt_dia_matvec" if case == "delaunay-amg" else "mt_mg_presmooth"
    runs = []
    for _ in range(3):
        before = cuda_lib.launched(kernel)
        res, totals = _traced(p.solve)
        runs.append((res, totals, cuda_lib.launched(kernel) - before))
    (r1, t1, n1), (r2, t2, n2), (r3, t3, n3) = runs
    passes = len(r1.timings.get("refine_inner", [None]))  # one PCG a pass
    chunks = _count(t1, "cg.chunk")
    assert chunks >= passes and not any(_count(t1, s) for s in GRAPH_SPANS)
    assert r1.timings["cg_issued"] == CHECK_EVERY * chunks
    assert (_count(t2, "cg.capture"), _count(t3, "cg.capture")) == (3, 0)
    for r, t in ((r2, t2), (r3, t3)):
        assert r.timings["cg_issued"] == r.iterations + passes
        assert _count(t, "cg.replay") == r.timings["cg_issued"] + passes
        assert _count(t, "cg.chunk") == 0
    assert n1 >= n2 > n3
    if case == "structured-mg":
        assert n3 == 0


# --------------------------------- on the CPU --------------------------------


@pytest.mark.parametrize("case", ["delaunay-amg", "structured-mg"])
def test_the_gate_stays_off_on_the_cpu(case):
    """Three solves of one part on the CPU: every chunk eager, no graph
    kept, and each answer the first one's."""
    from magnetite_tpu_torch.meshing.generators import plate_with_hole_mesh, tensile_bcs_for_rect

    if case == "delaunay-amg":
        mesh, bca, opts = _delaunay(h=0.06, amg_sweeps=1)
    else:
        mesh = plate_with_hole_mesh(16, 32)
        bca, opts = tensile_bcs_for_rect(mesh.coords), _structured()[2]
    p = compile_problem(mesh, bca, MD, opts, device="cpu")
    results, totals = _traced(lambda: [p.solve() for _ in range(3)])
    assert not any(_count(totals, name) for name in GRAPH_SPANS)
    assert _count(totals, "cg.chunk") >= 3
    assert not p.system.graphs.entries and p.system.graphs.pool is None
    for res in results[1:]:
        _assert_same(res, results[0])


def _reference_pcg(matvec, b, m, rtol, maxiter, history):
    """The eager loop as it stood before the graphs: every iteration in
    line, the flag read every CHECK_EVERY iterations."""
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = m(r)
    p = z
    rz = torch.sum(r * z)
    rnorm2 = torch.sum(r * r)
    bnorm = torch.sqrt(torch.sum(b * b))
    threshold = torch.clamp(rtol * bnorm, min=0.0)
    thresh2 = threshold * threshold
    k = torch.zeros((), dtype=torch.int64)
    one, zero = torch.ones((), dtype=b.dtype), torch.zeros((), dtype=b.dtype)
    hist = torch.zeros(history, dtype=b.dtype)
    slots = torch.arange(history)
    steps = 0
    while steps < maxiter:
        for _ in range(min(CHECK_EVERY, maxiter - steps)):
            active = rnorm2 > thresh2
            ap = matvec(p)
            pap = torch.sum(p * ap)
            alpha = torch.where((pap > 0) & active, rz / torch.where(pap == 0, one, pap), zero)
            x = x + alpha * p
            r = r - alpha * ap
            z = m(r)
            rz_new = torch.sum(r * z)
            beta = rz_new / torch.where(rz == 0, one, rz)
            p = torch.where(active, z + beta * p, p)
            rz = torch.where(active, rz_new, rz)
            rnorm2 = torch.where(active, torch.sum(r * r), rnorm2)
            hist = torch.where((slots == k) & active, torch.sqrt(rnorm2), hist)
            k = k + active.to(torch.int64)
            steps += 1
        if not bool(rnorm2 > thresh2):
            break
    return x, k, torch.sqrt(rnorm2), rnorm2 <= thresh2, hist


@pytest.mark.parametrize("maxiter,rtol", [(1000, 1e-10), (21, 1e-30)])
def test_the_eager_loop_is_unchanged(maxiter, rtol):
    n = 80
    g = torch.Generator().manual_seed(5)
    q = torch.randn(n, n, generator=g, dtype=torch.float64)
    a = q @ q.T + 0.5 * n * torch.eye(n, dtype=torch.float64)
    b = torch.randn(n, generator=g, dtype=torch.float64)
    d = torch.diagonal(a).clone()
    got = pcg(lambda v: a @ v, b, preconditioner=lambda r: r / d, rtol=rtol,
              maxiter=maxiter, history=40)
    want = _reference_pcg(lambda v: a @ v, b, lambda r: r / d, rtol, maxiter, 40)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def _faked_graph(monkeypatch) -> PCGGraph:
    """A PCGGraph whose CUDA parts are faked on the CPU: a capture keeps
    its body and leaves every state as it was, a replay runs the body again
    into the captured outputs, events and flag slots are host no-ops. What
    is left is the replay's own host logic."""
    def capture(self, body):
        graph.captures += 1
        live = [t for g in (self.start, *self.steps) if g is not None for t in g.state]
        saved = [t.clone() for t in live]
        s = body()
        flag = s.rnorm2 > self.thresh2
        for t, v in zip(live, saved):
            t.copy_(v)

        def replay():
            again = body()
            for dst, src in zip((*s, flag), (*again, again.rnorm2 > self.thresh2)):
                if dst is not src:
                    dst.copy_(src)

        return _Graph(types.SimpleNamespace(replay=replay), s, flag)

    event = types.SimpleNamespace(record=lambda stream: None, synchronize=lambda: None)
    monkeypatch.setattr(PCGGraph, "_capture", capture)
    monkeypatch.setattr(PCGGraph, "_device_parts", staticmethod(
        lambda device: (None, torch.empty(2, dtype=torch.bool), (event, event))))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    graph = PCGGraph(None)
    graph.captures = 0
    return graph


@pytest.mark.parametrize("n,shift,rtol,maxiter,jacobi,rhs", [
    (80, 40.0, 1e-10, 1000, True, "random"),  # 31 iterations
    (120, 2.0, 1e-8, 400, True, "random"),  # 111-117
    (60, 0.5, 1e-10, 5000, False, "random"),  # no preconditioner: p is r at the set-up
    (96, 96.0, 1e-30, 21, True, "random"),  # never converged: exactly maxiter
    (96, 96.0, 1e-30, 2, True, "random"),  # A -> B -> A, then the cap
    (96, 96.0, 1e-30, 1, True, "random"),  # the cap after A -> B
    (96, 96.0, 1e-30, 0, True, "random"),  # no iteration: the set-up's state
    (80, 40.0, 1e-10, 31, True, "random"),  # the cap at the first converged count
    (80, 40.0, 1e-10, 32, True, "random"),  # the cap one past it
    (80, 40.0, 0.9, 1000, True, "random"),  # converged after one iteration
    (120, 2.0, 1e-8, 400, True, "zero_first"),  # converged at the set-up, then long
    (60, 0.5, 1e-10, 5000, False, "zero_first"),
    (80, 40.0, 1e-10, 1000, True, "x0"),  # a start vector, refilled each call
    (120, 2.0, 1e-8, 400, True, "x0"),
    (60, 0.5, 1e-10, 5000, False, "x0"),
    (96, 96.0, 1e-30, 21, True, "x0"),
])
def test_the_replay_host_logic_on_faked_graphs(monkeypatch, n, shift, rtol, maxiter, jacobi, rhs):
    """Five right-hand sides through one graph (the first one zero, where
    `rhs` says so): each replayed call is the eager loop's bits, issues one
    iteration past convergence (exactly maxiter where it runs out first),
    replays the set-up and each iteration once, and captures each graph at
    its first use."""
    graph = _faked_graph(monkeypatch)
    a, _, d = _dense_spd(n, n, shift)
    m = (lambda r: r / d) if jacobi else None
    g = torch.Generator().manual_seed(7)
    most = 0  # the most iterations a call has issued
    for call in range(5):
        b = torch.randn(n, generator=g, dtype=torch.float64)
        if rhs == "zero_first" and call == 0:
            b = torch.zeros_like(b)
        x0 = torch.randn(n, generator=g, dtype=torch.float64) if rhs == "x0" else None

        def run(graph):
            return pcg(lambda v: a @ v, b, preconditioner=m, x0=x0, rtol=rtol,
                       maxiter=maxiter, graph=graph)

        want = run(None)
        captured = graph.captures
        got, totals = _traced(lambda: run(graph))
        for x, y in zip(got[:4], want[:4]):
            assert torch.equal(x, y)
        k = int(got.iterations)
        assert got.issued == min(k + 1, maxiter) <= want.issued
        assert _count(totals, "cg.replay") == 1 + got.issued
        assert graph.captures - captured == (call == 0) + min(got.issued, 2) - min(most, 2)
        most = max(most, got.issued)
        if rhs == "zero_first" and call == 0:
            assert k == 0 and got.issued == 1 and want.issued == CHECK_EVERY
    assert graph.captures == 1 + min(most, 2)


def test_pcg_graph_takes_only_the_captured_vectors():
    graph = PCGGraph(None)
    v = torch.zeros(2, 5)
    assert graph.takes(v, None) and graph.takes(v, v)  # nothing captured yet
    graph.b, graph.x0 = v, None  # as after a capture without x0
    assert graph.takes(v.clone(), None)
    assert not graph.takes(v, v)
    assert not graph.takes(torch.zeros(2, 6), None)
    assert not graph.takes(v.double(), None)
    assert not graph.takes(torch.zeros(5, 2).t(), None)  # another layout


def test_the_graph_state_holds_each_field_in_memory_of_its_own():
    """Without a preconditioner the set-up's p is its r (and x is x0): the
    graph's state clones them, each in its own layout, and keeps the rest."""
    a = torch.diag(torch.arange(1.0, 7.0, dtype=torch.float64)).reshape(6, 6)
    b = torch.ones(3, 2, dtype=torch.float64).t()  # a transposed layout
    x0 = torch.zeros_like(b)
    s, _, _ = _start(lambda v: (a @ v.reshape(-1)).reshape(v.shape), lambda r: r, b, x0,
                     1e-8, 0.0, lambda u, w: torch.sum(u * w))
    assert s.p is s.r and s.x is x0
    d = _distinct(s, b, x0)
    ptrs = [t.untyped_storage().data_ptr() for t in d]
    assert len(set(ptrs)) == len(ptrs) and x0.data_ptr() not in ptrs
    assert d.r is s.r and d.rz is s.rz and d.k is s.k
    for got, was in zip(d, s):
        assert got.stride() == was.stride() and torch.equal(got, was)
