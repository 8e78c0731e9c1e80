"""Mixed precision in the port against the JAX package: iterative
refinement (fem/refine.py), the structured-grid solve in f64 and with
f32 storage + refinement, the refined AMG solve (f64 CG around the f32
V-cycle) and its double-float band matvec, and the refine / operator
switches.

Bars (tests/test_golden.py:48-55): displacements within 1e-6 of max|u|;
forces, scalar stress and von Mises within 1e-5 of their max; iteration
counts within +-1. The JAX package recovers refined stresses in f32, the
port in f64: that, not the solve, is most of the stress difference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import magnetite_tpu
import magnetite_tpu_torch
from magnetite_tpu.meshing.generators import plate_with_hole_mesh, tensile_bcs_for_rect
from tests.torch_cases import E_MOD, NU, THICK, jax_plate, to_port
from tests.torch_cases import one_thread  # noqa: F401  (autouse)


def _structured(nr, nt):
    from magnetite_tpu_torch import interop

    mesh = plate_with_hole_mesh(nr, nt)
    bca = tensile_bcs_for_rect(mesh.coords)
    pmesh = magnetite_tpu_torch.Mesh(
        coords=mesh.coords, tris=mesh.tris, grid_shape=mesh.grid_shape,
        wrap_cols=mesh.wrap_cols, grid_local=mesh.grid_local,
        canonical_grid=mesh.canonical_grid,
    )
    pbca = interop.bca_from_arrays(bca.u_known, bca.u_value, bca.f_value)
    md = (E_MOD, NU, THICK, 0.0, 0.01)
    return (mesh, bca, magnetite_tpu.ModelMetadata(*md)), (
        pmesh, pbca, magnetite_tpu_torch.ModelMetadata(*md),
    )


def _agree(res, ref):
    assert abs(res.iterations - ref.iterations) <= 1
    assert np.abs(res.u - ref.u).max() <= 1e-6 * np.abs(ref.u).max()
    for field in ("f", "stress", "von_mises"):
        a, b = getattr(res, field), getattr(ref, field)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), field


def test_mixed_precision_solve_matches_jax():
    from magnetite_tpu.fem.refine import mixed_precision_solve as jax_mps
    from magnetite_tpu_torch.fem.refine import mixed_precision_solve

    rng = np.random.default_rng(3)
    m = rng.standard_normal((40, 40))
    a64 = m @ m.T + 40 * np.eye(40)
    b = rng.standard_normal(40)
    kw = dict(rtol=1e-12, inner_maxiter=200, max_outer=10)
    ja, jb = jnp.asarray(a64), jnp.asarray(b)
    ref = jax_mps(lambda v: ja @ v, lambda v: ja.astype(jnp.float32) @ v, jb,
                  inner_rtol=1e-4, **kw)
    ta, tb = torch.from_numpy(a64), torch.from_numpy(b)
    got = mixed_precision_solve(lambda v: ta @ v, lambda v: ta.float() @ v, tb, **kw)
    assert bool(got.converged) and got.outer_steps == int(ref.outer_steps) >= 2
    assert abs(int(got.inner_iterations) - int(ref.inner_iterations)) <= 1
    assert float(torch.linalg.norm(tb - ta @ got.x)) <= 1e-12 * float(torch.linalg.norm(tb))
    assert np.abs(got.x.numpy() - np.asarray(ref.x)).max() <= 1e-10 * np.abs(ref.x).max()


@pytest.mark.parametrize(
    "kwargs,refine",
    [({"dtype": "float64"}, False), ({"dtype": "float32", "cg_rtol": 1e-10}, True)],
    ids=["f64", "f32_refined"],
)
def test_structured_solve_matches_jax(kwargs, refine):
    (mesh, bca, md), (pmesh, pbca, pmd) = _structured(32, 64)
    ref = magnetite_tpu.solve_system(mesh, bca, md, magnetite_tpu.SolverOptions(**kwargs))
    problem = magnetite_tpu_torch.compile_problem(
        pmesh, pbca, pmd, magnetite_tpu_torch.SolverOptions(**kwargs), device="cpu"
    )
    assert (problem.mode, problem.preconditioner, problem.refine) == (
        "stencil", "multigrid", refine,
    )
    res = problem.solve()
    assert res.residual_rel <= 1e-10
    assert ("refine_outer" in res.timings) == refine
    _agree(res, ref)


def test_refined_amg_solve_and_double_float_matvec_match_jax():
    """f64 CG around the f32 V(3,3)-cycle on a Delaunay plate, with the
    native f64 band matvec and with the double-float one (plain version)."""
    h = 0.04
    mesh, bca, md = jax_plate(h)
    kwargs = dict(dtype="float32", refine="on", preconditioner="amg", df_matvec="off")
    ref = magnetite_tpu.solve_system(mesh, bca, md, magnetite_tpu.SolverOptions(**kwargs))
    for df, expect in (("off", ""), ("interpret", "plain"), ("on", "plain")):
        kwargs["df_matvec"] = df
        problem = magnetite_tpu_torch.compile_problem(
            *to_port(mesh, bca, h), magnetite_tpu_torch.SolverOptions(**kwargs),
            device="cpu",
        )
        assert (problem.mode, problem.refine, problem.sweeps, problem.system.df64) == (
            "dia", True, 3, expect,
        )
        assert problem.system.amg.fast0[1].dtype == torch.float32  # the f32 V-cycle
        res = problem.solve()
        assert res.residual_rel <= 1e-10
        _agree(res, ref)


def test_double_float_matvec_matches_jax_interpret_and_its_bound():
    """The df plain version against the TPU kernel in interpreter mode on
    an assembled operator and a smooth field (the cancellation worst
    case), and against the exact f64 product: ~2^-46 of sum |K||u|
    (tests/test_pallas_kernel.py holds the TPU kernel to 1e-13)."""
    from magnetite_tpu.pallas.dia_kernel import make_df_dia_operator
    from magnetite_tpu_torch.fem.dia import (
        build_dia_structure, df_dia_matvec, dia_matvec_blocks, split_bands,
    )
    from magnetite_tpu_torch.kernels import cuda_lib

    mesh, bca, md = jax_plate(0.05)
    problem = magnetite_tpu_torch.compile_problem(
        *to_port(mesh, bca, 0.05),
        magnetite_tpu_torch.SolverOptions(preconditioner="block_jacobi"), device="cpu",
    )
    assert problem.perm is None and build_dia_structure(mesh.tris, mesh.num_nodes)
    bands, offsets = problem.system.bands, problem.system.offsets
    x, y = mesh.coords[:, 0], mesh.coords[:, 1]
    u = np.stack([0.01 * np.sin(x) * np.cosh(y), 0.005 * np.cos(x) * y**2])
    u_t = torch.from_numpy(u)

    exact = dia_matvec_blocks(bands, offsets, u_t).numpy()
    before = cuda_lib.launched("mt_df_dia_matvec")
    got = df_dia_matvec(split_bands(bands), offsets, u_t).numpy()
    assert cuda_lib.launched("mt_df_dia_matvec") == before  # CPU operand: the plain version
    ref = np.asarray(make_df_dia_operator(jnp.asarray(bands.numpy()), offsets, interpret=True)(
        jnp.asarray(u)
    ))
    scale = dia_matvec_blocks(bands.abs(), offsets, u_t.abs()).numpy().max()
    assert np.abs(got - exact).max() <= 1e-13 * scale
    assert np.abs(got - ref).max() <= 1e-13 * scale
    # plain f32 is ~2^-24 off: the pairs carry the f64 digits
    f32 = dia_matvec_blocks(bands.float(), offsets, u_t.float()).double().numpy()
    assert np.abs(f32 - exact).max() > 1e3 * np.abs(got - exact).max()


def test_refine_auto_engages_below_the_f32_floor():
    _, (pmesh, pbca, pmd) = _structured(16, 32)
    opts = magnetite_tpu_torch.SolverOptions
    tight = magnetite_tpu_torch.compile_problem(
        pmesh, pbca, pmd, opts(dtype="float32", cg_rtol=1e-9), device="cpu"
    )
    loose = magnetite_tpu_torch.compile_problem(
        pmesh, pbca, pmd, opts(dtype="float32", cg_rtol=1e-4), device="cpu"
    )
    assert tight.refine and not loose.refine
    assert tight.system.reduced.dtype == torch.float64
    assert tight.system.mg_levels[0].stencil.dtype == torch.float32  # f32 hierarchy
    # "auto" leaves the banded formats alone (they opt in with "on")
    mesh, bca, md = jax_plate(0.05)
    banded = magnetite_tpu_torch.compile_problem(
        *to_port(mesh, bca, 0.05), opts(dtype="float32", cg_rtol=1e-9), device="cpu"
    )
    assert not banded.refine and banded.rtol == pytest.approx(50 * np.finfo(np.float32).eps)


@pytest.mark.parametrize(
    "structured,kwargs,match",
    [
        (False, {"operator": "stencil"}, "structured-grid"),
        (False, {"preconditioner": "multigrid"}, "structured-grid"),
        (True, {"preconditioner": "amg"}, "multigrid"),
    ],
    # operator='ell' on a grid, once refused here, runs: the parity case
    # tests/test_torch_ell_solve.py::test_ell_on_grid_matches_jax
    ids=["stencil_on_delaunay", "multigrid_on_delaunay", "amg_on_grid"],
)
def test_operator_and_preconditioner_mismatches_raise(structured, kwargs, match):
    if structured:
        _, case = _structured(8, 16)
    else:
        mesh, bca, _ = jax_plate(0.05)
        case = to_port(mesh, bca, 0.05)
    with pytest.raises(magnetite_tpu_torch.SolverError, match=match):
        magnetite_tpu_torch.compile_problem(
            *case, magnetite_tpu_torch.SolverOptions(**kwargs), device="cpu"
        )
