"""The port's `entry()` against the JAX package on the same case.

`magnetite_tpu_torch.dryrun.entry(device="cpu")` compiles the 48x96 plate
with a hole of the JAX package's `__graft_entry__.entry` (f32, cg_rtol
1e-6, at most 2,000 iterations) and returns `(CompiledProblem.solve_device,
(problem,))`. The JAX side is built through
`magnetite_tpu.fem.solve.compile_problem` on the same case and options
(`__graft_entry__.entry` itself spawns a backend probe process first), as
an f32 run and as an f64 reference (dtype float64, cg_rtol 1e-10).

Bars: the port's f32 u, f and von Mises each lie within
max(2 x the JAX f32 run's own distance from the f64 reference, 1e-5 of the
reference's max) of the f64 reference, and its iteration count is within
+-2 of the JAX f32 run's.
"""

import numpy as np
import pytest
import torch

from tests.torch_cases import one_thread  # noqa: F401  (autouse)

FIELDS = (("u", 0), ("f", 1), ("von_mises", 4))


@pytest.fixture(scope="module")
def port_entry():
    from magnetite_tpu_torch.dryrun import entry

    return entry(device="cpu")


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's f32 run and f64 reference on the entry case."""
    from magnetite_tpu.bc import BCArrays
    from magnetite_tpu.config import ModelMetadata, SolverOptions
    from magnetite_tpu.fem.solve import compile_problem
    from magnetite_tpu.meshing.generators import plate_with_hole_mesh

    mesh = plate_with_hole_mesh(48, 96)
    n, c = mesh.num_nodes, mesh.coords
    u_known = np.zeros((n, 2), dtype=bool)
    u_value = np.zeros((n, 2))
    right = np.isclose(c[:, 0], c[:, 0].max())
    u_known[np.isclose(c[:, 0], c[:, 0].min())] = True
    u_known[right, 0] = True
    u_value[right, 0] = 0.01
    bca = BCArrays(u_known=u_known, u_value=u_value, f_value=np.zeros((n, 2)))
    md = ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.1)
    runs = {}
    for name, opts in (
        ("f32", SolverOptions(dtype="float32", cg_rtol=1e-6, max_cg_iters=2000)),
        ("f64", SolverOptions(dtype="float64", cg_rtol=1e-10)),
    ):
        problem = compile_problem(mesh, bca, md, opts)
        assert problem.mode == "stencil" and problem.preconditioner == "multigrid"
        runs[name] = problem.solve()
    return runs


def test_entry_calls_repeat_bit_for_bit_and_launch_nothing_on_the_cpu(port_entry):
    from magnetite_tpu_torch.kernels import cuda_lib

    fn, args = port_entry
    (problem,) = args
    assert problem.mode == "stencil" and problem.preconditioner == "multigrid"
    assert problem.device.type == "cpu" and problem.dtype == torch.float32
    entries = ("mt_stencil_matvec", "mt_mg_presmooth", "mt_mg_postsmooth")
    before = [cuda_lib.launched(e) for e in entries]
    first, second = fn(*args), fn(*args)
    assert [cuda_lib.launched(e) for e in entries] == before
    assert len(first) == 10
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    u, f, sigma, stress, vm, iters, resnorm, converged, bnorm, _ = first
    n, e = problem.coords.shape[0], problem.tris.shape[0]
    assert tuple(u.shape) == (n, 2) and tuple(f.shape) == (n, 2)
    assert tuple(sigma.shape) == (e, 3) and tuple(stress.shape) == (e,)
    assert tuple(vm.shape) == (e,)
    assert bool(converged) and float(resnorm) <= 1e-6 * float(bnorm)


def test_entry_matches_the_jax_package(port_entry, jax_runs):
    fn, args = port_entry
    out = fn(*args)
    f32, ref = jax_runs["f32"], jax_runs["f64"]
    assert abs(int(out[5]) - int(f32.iterations)) <= 2, (int(out[5]), f32.iterations)
    for name, i in FIELDS:
        want = np.asarray(getattr(ref, name), np.float64)
        jax_err = np.abs(np.asarray(getattr(f32, name), np.float64) - want).max()
        bar = max(2 * jax_err, 1e-5 * np.abs(want).max())
        err = np.abs(out[i].double().numpy() - want).max()
        assert err <= bar, (name, err, bar, jax_err)
