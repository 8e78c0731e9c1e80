"""A solve's answer on its way to the host (fem/solve._to_host).

On a CUDA device the answer is copied into typed views of one page-locked
block from torch's caching host allocator and read after one stream sync;
on the CPU the arrays are the outputs' own. Either way every array is
`t.cpu().numpy()` of the device outputs bit for bit, in the same shape,
dtype and strides, and an answer owns its memory: a later solve leaves it
as it was.

The CUDA cases skip themselves without a card (decided inside each test).
The file imports no JAX, so it runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_to_host.py -q
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from magnetite_tpu_torch.config import ModelMetadata, SolverOptions
from magnetite_tpu_torch.fem import solve as solve_mod
from magnetite_tpu_torch.fem.solve import compile_problem
# tests/ is on sys.path (pytest's prepend import mode); `tests.torch_cases`
# would not import where an installed package is named `tests`
from torch_cases import HOLE, OUTER
from torch_cases import one_thread  # noqa: F401  (autouse)

MD = ModelMetadata(youngs_modulus=69e9, poisson_ratio=0.33, part_thickness=0.5,
                   characteristic_length_min=0.0, characteristic_length_max=0.05)
ARRAYS = ("u", "f", "sigma", "stress", "von_mises", "residual_history")
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _device(name: str) -> torch.device:
    return require_cuda() if name == "cuda" else torch.device("cpu")


def _delaunay():
    """A small plate with a hole under AMG, renumbered (the answer is
    unpermuted), f32 V-cycles in one f64 CG."""
    from magnetite_tpu_torch.meshing.delaunay_backend import triangulate
    from magnetite_tpu_torch.meshing.generators import tensile_bcs_for_rect

    mesh = triangulate([np.array(OUTER), np.array(HOLE)], 0.0, 0.05)
    opts = SolverOptions(dtype="float32", cg_rtol=1e-8, refine="on", preconditioner="amg",
                         residual_history=8)
    return mesh, tensile_bcs_for_rect(mesh.coords), opts


def _structured():
    """A small structured plate under multigrid, classic refinement."""
    from magnetite_tpu_torch.meshing.generators import plate_with_hole_mesh, tensile_bcs_for_rect

    mesh = plate_with_hole_mesh(16, 32)
    return mesh, tensile_bcs_for_rect(mesh.coords), SolverOptions(dtype="float32", cg_rtol=1e-8)


CASES = {"delaunay": _delaunay, "structured": _structured}


def _compile(case: str, dev: torch.device):
    mesh, bca, opts = CASES[case]()
    return compile_problem(mesh, bca, MD, opts, device=dev)


def _load_case(problem, fy: float):
    """The compiled part under a y-force on its right edge, whose uy is
    free."""
    coords = problem.coords.cpu().numpy()
    right = torch.from_numpy(np.isclose(coords[:, 0], coords[:, 0].max()))
    f = problem.f_value.clone()
    f[right.to(f.device), 1] = fy
    return dataclasses.replace(problem, f_value=f)


def _spied(problem):
    """`problem` whose solve_device also appends its raw outputs to the
    returned list."""
    calls = []
    inner = problem.solve_device

    def solve_device(info=None):
        out = inner(info)
        calls.append(out)
        return out

    problem.solve_device = solve_device
    return calls


def _nbytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in out)


def _expected(problem, out) -> dict:
    """The answer as the pageable copy makes it: `t.cpu().numpy()` of each
    output, then the solve's unpermute and history slice."""
    u, f, sigma, stress, vm, iters, resnorm, _, _, history = (t.cpu().numpy() for t in out)
    if problem.perm is not None:
        u_o, f_o = np.empty_like(u), np.empty_like(f)
        u_o[problem.perm], f_o[problem.perm] = u, f
        u, f = u_o, f_o
    return dict(u=u, f=f, sigma=sigma, stress=stress, von_mises=vm,
                residual_history=history[: int(iters)], iterations=int(iters),
                residual_norm=float(resnorm))


def _same(got, want):
    """Bit for bit, in the same dtype, shape and strides."""
    assert got.dtype == want.dtype and got.shape == want.shape and got.strides == want.strides
    assert got.tobytes() == want.tobytes()


def _assert_answer(res, want: dict):
    for name in ARRAYS:
        _same(getattr(res, name), want[name])
    assert res.iterations == want["iterations"] and res.residual_norm == want["residual_norm"]


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("case", CASES)
def test_answers_are_the_outputs_and_outlive_the_next_solve(case, device):
    """Two load cases on one compiled part: each answer is its outputs'
    pageable copy bit for bit, the first is unchanged by the second solve,
    and the two share no memory."""
    problem = _compile(case, _device(device))
    first_p, second_p = _load_case(problem, 1e6), _load_case(problem, 3e6)
    first_out, second_out = _spied(first_p), _spied(second_p)
    first = first_p.solve()
    want_first = _expected(first_p, first_out[-1])
    kept = {name: np.copy(getattr(first, name)) for name in ARRAYS}
    second = second_p.solve()
    _assert_answer(first, want_first)
    _assert_answer(second, _expected(second_p, second_out[-1]))
    for name in ARRAYS:
        _same(getattr(first, name), kept[name])
        assert not np.shares_memory(getattr(first, name), getattr(second, name))
    assert not np.array_equal(first.u, second.u)
    pinned = 0 if device == "cpu" else _nbytes(first_out[-1])
    assert first.timings["to_host_pinned_bytes"] == pinned


@pytest.mark.parametrize("case", CASES)
def test_cpu_solve_copies_nothing_through_pinned_memory(case):
    """On the CPU the answer is the outputs' own memory: both counters read
    0 and no pinned block is asked for."""
    problem = _compile(case, torch.device("cpu"))
    out = _spied(problem)
    res = problem.solve()
    assert res.timings["to_host_pinned_bytes"] == 0 and res.timings["to_host_new_pinned"] == 0
    assert np.shares_memory(res.sigma, out[-1][2].numpy())


@pytest.mark.parametrize("device", DEVICES)
def test_to_host_keeps_dtype_shape_and_strides(device):
    """Every layout and dtype a solve returns, and the odd ones: a
    transposed view, a strided slice (not dense: `.cpu()` makes it
    contiguous), 0-d scalars, an empty history."""
    dev = _device(device)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 37, generator=gen, dtype=torch.float64).to(dev)
    wide = torch.randn(11, 6, generator=gen, dtype=torch.float32).to(dev)
    rest = [torch.tensor(True), torch.tensor(17, dtype=torch.int32),
            torch.tensor(2.5, dtype=torch.float64), torch.zeros(0, dtype=torch.float64),
            torch.arange(9, dtype=torch.int64), torch.randn(5, 3, generator=gen)]
    out = [x.T, wide[:, ::2]] + [t.to(dev) for t in rest]
    timings = {}
    got = solve_mod._to_host(out, timings)
    for g, t in zip(got, out):
        _same(g, t.cpu().numpy())
    assert timings["to_host_pinned_bytes"] == (0 if device == "cpu" else _nbytes(out))


# ------------------------------- on the card -------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_answer_is_complete_when_solve_returns(case, monkeypatch):
    """Device work is queued on the stream right before the copies are
    issued: a sleep, then a write to every output. The answer holds the
    written values bit for bit as soon as solve() returns, five solves in a
    row (an asynchronous copy to the host returns before it lands)."""
    dev = require_cuda()
    problem = _compile(case, dev)
    late = []
    inner = problem.solve_device

    def solve_device(info=None):
        late[:] = [t.clone() for t in inner(info)]
        return tuple(late)

    problem.solve_device = solve_device
    sync = solve_mod._sync

    def sync_then_queue(d):
        sync(d)
        torch.cuda._sleep(20_000_000)
        for t in late:
            if t.dtype != torch.bool:
                t.add_(1)

    monkeypatch.setattr(solve_mod, "_sync", sync_then_queue)
    for _ in range(5):
        res = problem.solve()
        _assert_answer(res, _expected(problem, late))
        assert res.timings["to_host_pinned_bytes"] == _nbytes(late)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_pinned_bytes_are_the_answers_bytes(case):
    """`to_host_pinned_bytes` counts each output's bytes once, padding
    left out."""
    problem = _compile(case, require_cuda())
    out = _spied(problem)
    for _ in range(2):
        res = problem.solve()
        assert res.timings["to_host_pinned_bytes"] == _nbytes(out[-1]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_warm_solves_allocate_no_pinned_memory(case):
    """After 3 warm solves, a caller holding at most 2 answers: the answer's
    block comes from the allocator's cache, 10 solves in a row."""
    problem = _compile(case, require_cuda())
    held = collections.deque(maxlen=2)
    for _ in range(3):
        held.append(problem.solve())
    new = []
    for _ in range(10):
        held.append(problem.solve())
        new.append(held[-1].timings["to_host_new_pinned"])
    assert new == [0] * 10
