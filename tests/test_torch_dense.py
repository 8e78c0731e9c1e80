"""The dense mode of the port (fem/solve.py::DenseSystem, with
fem/element.py::element_stiffness_matrices and fem/assembly.py::
assemble_dense) against the JAX package on the same inputs.

The solve: `dense_cutoff=10_000` on the JAX package's dense test case
(tests/test_solve.py: rect_mesh(4, 4), tensile pull 0.005) and on the
h = 0.05 plate, f64 and f32. Bars: f64 displacements within 1e-8 of
max|u|, forces and stresses within 1e-7 of their max (the same LU in
another summation order), relative residual <= 1e-10; f32 held to the
JAX package's f64 answer at the f32 bar of tests/test_torch_solve.py,
2e-3 of max|u| and of the forces' and stresses' max (an f32 LU at the
plate's conditioning: the JAX package's own f32 answer is 3.8e-4 of
max|u| off its f64 one, the port's 2.3e-4, measured), relative residual
<= 1e-5 (measured 1.3e-6 / 1.6e-6). The pieces: the element matrices and
the dense matrix to 1e-13 of their max in f64, 1e-5 in f32.
"""

import numpy as np
import pytest
import torch

import magnetite_tpu
import magnetite_tpu_torch
from magnetite_tpu.meshing.generators import rect_mesh, tensile_bcs_for_rect
from tests.torch_cases import E_MOD, NU, THICK, jax_plate, to_port
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

# dtype: (u bar, forces and stresses bar, relative residual bar)
BARS = {"float64": (1e-8, 1e-7, 1e-10), "float32": (2e-3, 2e-3, 1e-5)}


def _rect_case():
    from magnetite_tpu_torch import interop

    mesh = rect_mesh(4, 4)
    bca = tensile_bcs_for_rect(mesh.coords, pull=0.005)
    md = (E_MOD, NU, THICK, 0.0, 0.3)
    return (mesh, bca, magnetite_tpu.ModelMetadata(*md)), (
        interop.mesh_from_arrays(mesh.coords, mesh.tris),
        interop.bca_from_arrays(bca.u_known, bca.u_value, bca.f_value),
        magnetite_tpu_torch.ModelMetadata(*md),
    )


def _plate_case():
    mesh, bca, md = jax_plate(0.05)
    return (mesh, bca, md), to_port(mesh, bca, 0.05)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", ["rect_4x4", "plate_h0.05"])
def test_dense_solve_matches_jax(case, dtype):
    jax_case, port_case = _rect_case() if case == "rect_4x4" else _plate_case()
    ref = magnetite_tpu.solve_system(
        *jax_case, magnetite_tpu.SolverOptions(dense_cutoff=10_000, dtype=dtype))
    ref64 = ref if dtype == "float64" else magnetite_tpu.solve_system(
        *jax_case, magnetite_tpu.SolverOptions(dense_cutoff=10_000))
    problem = magnetite_tpu_torch.compile_problem(
        *port_case, magnetite_tpu_torch.SolverOptions(dense_cutoff=10_000, dtype=dtype),
        device="cpu")
    assert (problem.mode, problem.preconditioner, problem.refine) == (
        "dense", "block_jacobi", False)
    assert ref.timings["operator"] == "dense"
    res = problem.solve()
    assert (res.iterations, res.converged) == (ref.iterations, ref.converged) == (0, True)
    assert res.u.dtype == np.dtype(dtype)
    u_tol, tol, res_tol = BARS[dtype]
    assert np.abs(res.u - ref64.u).max() <= u_tol * np.abs(ref64.u).max()
    for field in ("f", "stress", "von_mises"):
        a, b = getattr(res, field), getattr(ref64, field)
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), field
    assert res.residual_rel <= res_tol and ref.residual_rel <= res_tol


def test_dense_matches_the_ports_sparse_solve():
    """The JAX package's own check (tests/test_solve.py): the dense answer
    is the sparse one's."""
    _, port_case = _rect_case()
    opts = magnetite_tpu_torch.SolverOptions
    sparse = magnetite_tpu_torch.solve_system(*port_case, opts(), device="cpu")
    dense = magnetite_tpu_torch.solve_system(*port_case, opts(dense_cutoff=10_000), device="cpu")
    np.testing.assert_allclose(sparse.u, dense.u, rtol=1e-7, atol=1e-12)


def test_dense_never_refines_and_refuses_amg():
    """As in the JAX package: refine='on' leaves the dense mode unrefined,
    a cutoff below the node count leaves the mesh to the sparse formats,
    and preconditioner='amg' raises."""
    _, port_case = _rect_case()
    opts = magnetite_tpu_torch.SolverOptions
    n = port_case[0].num_nodes
    refined = magnetite_tpu_torch.compile_problem(
        *port_case, opts(dense_cutoff=n, refine="on"), device="cpu")
    assert (refined.mode, refined.refine) == ("dense", False)
    above = magnetite_tpu_torch.compile_problem(
        *port_case, opts(dense_cutoff=n - 1), device="cpu")
    assert above.mode == "dia"
    with pytest.raises(magnetite_tpu_torch.SolverError, match="dia/hybrid/ell"):
        magnetite_tpu_torch.compile_problem(
            *port_case, opts(dense_cutoff=n, preconditioner="amg"), device="cpu")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_element_stiffness_and_dense_assembly_match_jax(dtype):
    import jax.numpy as jnp
    from magnetite_tpu.fem.assembly import assemble_dense as jax_assemble_dense
    from magnetite_tpu.fem.element import element_stiffness_matrices as jax_ke
    from magnetite_tpu_torch.fem.assembly import assemble_dense
    from magnetite_tpu_torch.fem.element import element_stiffness_matrices

    mesh, _, _ = jax_plate(0.05)
    coords = mesh.coords.astype(dtype)
    ref_ke = np.asarray(jax_ke(jnp.asarray(coords), jnp.asarray(mesh.tris), E_MOD, NU, THICK))
    ke = element_stiffness_matrices(
        torch.from_numpy(coords), torch.from_numpy(mesh.tris.astype(np.int64)), E_MOD, NU, THICK)
    assert ke.dtype == torch.from_numpy(coords).dtype and tuple(ke.shape) == ref_ke.shape
    tol = 1e-13 if dtype == np.float64 else 1e-5
    assert np.abs(ke.numpy() - ref_ke).max() <= tol * np.abs(ref_ke).max()

    ref_k = np.asarray(jax_assemble_dense(jnp.asarray(ref_ke), jnp.asarray(mesh.tris),
                                          mesh.num_nodes))
    k = assemble_dense(torch.from_numpy(ref_ke.copy()), torch.from_numpy(mesh.tris),
                       mesh.num_nodes)
    assert tuple(k.shape) == (2 * mesh.num_nodes,) * 2
    assert np.abs(k.numpy() - ref_k).max() <= tol * np.abs(ref_k).max()
