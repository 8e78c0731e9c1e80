"""The whole slice: magnetite_tpu.solve_system against
magnetite_tpu_torch.solve_system(..., device="cpu") on the same mesh and
boundary conditions, both in f64 at the default rtol 1e-10.

Bars: displacements within 1e-8 of max|u|; forces, scalar stress and von
Mises within 1e-7 of their max; CG iterations within +-1 (the two
frameworks sum in different orders, which can move the iteration that
crosses the tolerance by one).
"""

import numpy as np
import pytest

import magnetite_tpu
import magnetite_tpu_torch
from tests.torch_cases import jax_plate, shuffled, to_port
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

CASES = {
    # name: (h, shuffle, SolverOptions kwargs, expected mode, expected preconditioner)
    "h0.05_single_level_amg": (0.05, False, {}, "dia", "amg"),
    "h0.03_block_jacobi": (0.03, False, {}, "dia", "block_jacobi"),
    "h0.02_multilevel_amg": (0.02, False, {}, "dia", "amg"),
    "h0.05_shuffled_renumbered": (0.05, True, {}, "dia", "amg"),
    "h0.05_hybrid": (0.05, False, {"max_diags": 20}, "hybrid", "amg"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_solve_matches_jax(name):
    h, shuffle, kwargs, mode, precond = CASES[name]
    mesh, bca, md = jax_plate(h)
    if shuffle:
        mesh, bca = shuffled(mesh, bca)
    ref = magnetite_tpu.solve_system(
        mesh, bca, md, magnetite_tpu.SolverOptions(**kwargs)
    )
    pmesh, pbca, pmd = to_port(mesh, bca, h)
    problem = magnetite_tpu_torch.compile_problem(
        pmesh, pbca, pmd, magnetite_tpu_torch.SolverOptions(**kwargs), device="cpu"
    )
    assert (problem.mode, problem.preconditioner) == (mode, precond)
    assert (problem.perm is not None) == shuffle
    res = problem.solve()

    assert abs(res.iterations - ref.iterations) <= 1
    assert res.residual_rel <= 1e-10
    assert np.abs(res.u - ref.u).max() <= 1e-8 * np.abs(ref.u).max()
    for field in ("f", "stress", "von_mises"):
        a, b = getattr(res, field), getattr(ref, field)
        assert np.abs(a - b).max() <= 1e-7 * np.abs(b).max(), field


def test_f32_solve_converges_to_its_floor():
    """f32 runs the float instances; CG's rtol clamps to 50 eps_f32 as in
    the JAX package, and the answer stays near the f64 one."""
    mesh, bca, md = jax_plate(0.05)
    pmesh, pbca, pmd = to_port(mesh, bca, 0.05)
    opts = magnetite_tpu_torch.SolverOptions
    r64 = magnetite_tpu_torch.solve_system(pmesh, pbca, pmd, opts(), device="cpu")
    r32 = magnetite_tpu_torch.solve_system(
        pmesh, pbca, pmd, opts(dtype="float32"), device="cpu"
    )
    assert r32.u.dtype == np.float32 and np.isfinite(r32.u).all()
    assert r32.residual_rel <= 50 * np.finfo(np.float32).eps
    # f32 stopping floor (~6e-6 relative residual) amplified by the
    # operator's conditioning; 1.9e-4 measured at h=0.02
    assert np.abs(r32.u - r64.u).max() <= 2e-3 * np.abs(r64.u).max()


@pytest.mark.parametrize(
    "kwargs,match",
    [
        ({"operator": "stencil"}, "structured-grid"),
        ({"preconditioner": "multigrid"}, "structured-grid"),
    ],
    # the ids these cases had beside the ELL, dense and device-assembly
    # refusals (now the parity cases of test_formerly_refused_options_match_jax)
    ids=["kwargs1-structured-grid", "kwargs4-structured-grid"],
)
def test_unported_options_raise_typed_errors(kwargs, match):
    mesh, bca, md = jax_plate(0.05)
    pmesh, pbca, pmd = to_port(mesh, bca, 0.05)
    with pytest.raises(magnetite_tpu_torch.SolverError, match=match):
        magnetite_tpu_torch.compile_problem(
            pmesh, pbca, pmd, magnetite_tpu_torch.SolverOptions(**kwargs),
            device="cpu",
        )


@pytest.mark.parametrize(
    "kwargs,mode,precond",
    [({"operator": "ell"}, "ell", "amg"), ({"dense_cutoff": 10_000}, "dense", "block_jacobi"),
     ({"assembly": "device"}, "dia", "amg")],
    ids=["operator_ell", "dense_cutoff", "assembly_device"],
)
def test_formerly_refused_options_match_jax(kwargs, mode, precond):
    """operator='ell', dense_cutoff and assembly='device', which the port
    refused before it had the ELL and dense modes and the device assembly,
    choose JAX's mode and preconditioner and hold the module's bars against
    the JAX package on the same inputs."""
    mesh, bca, md = jax_plate(0.05)
    ref = magnetite_tpu.solve_system(mesh, bca, md, magnetite_tpu.SolverOptions(**kwargs))
    problem = magnetite_tpu_torch.compile_problem(
        *to_port(mesh, bca, 0.05), magnetite_tpu_torch.SolverOptions(**kwargs), device="cpu"
    )
    assert (problem.mode, problem.preconditioner) == (mode, precond)
    assert ref.timings["operator"] == mode and problem.perm is None
    res = problem.solve()
    assert abs(res.iterations - ref.iterations) <= 1
    assert res.residual_rel <= 1e-10
    assert np.abs(res.u - ref.u).max() <= 1e-8 * np.abs(ref.u).max()
    for field in ("f", "stress", "von_mises"):
        a, b = getattr(res, field), getattr(ref, field)
        assert np.abs(a - b).max() <= 1e-7 * np.abs(b).max(), field


@pytest.mark.parametrize("pinned", ["structure_with_operator_ell", "ell_operator_cache"])
def test_ell_pinned_resume_raises_not_ported(pinned):
    """A resume that runs the ELL operator -- a checkpoint's block-ELL
    structure under operator='ell', or a matching operator cache of the
    ELL format -- once raised the typed not-ported error; it now runs in
    the mesh's own order and matches the JAX package's ELL solve (the
    cache's values are the port's own assembly: the resume skips the
    structure and the assembly)."""
    from magnetite_tpu_torch.fem.assembly import build_ell_structure

    mesh, bca, md = jax_plate(0.05)
    ref = magnetite_tpu.solve_system(
        mesh, bca, md, magnetite_tpu.SolverOptions(operator="ell"))
    pmesh, pbca, pmd = to_port(mesh, bca, 0.05)
    structure = build_ell_structure(pmesh.tris, pmesh.num_nodes)
    opts = magnetite_tpu_torch.SolverOptions(operator="ell", keep_operator_host=True)
    kwargs = {"structure": structure, "options": opts}
    if pinned == "ell_operator_cache":
        fresh = magnetite_tpu_torch.compile_problem(pmesh, pbca, pmd, opts, device="cpu")
        kwargs = {"operator_cache": fresh.operator_host}
    problem = magnetite_tpu_torch.compile_problem(pmesh, pbca, pmd, device="cpu", **kwargs)
    assert (problem.mode, problem.perm) == ("ell", None)
    assert problem.timings.get("operator_cache") == (
        "hit" if pinned == "ell_operator_cache" else None)
    np.testing.assert_array_equal(problem.system.cols.T.numpy(), structure.cols)
    res = problem.solve()
    assert abs(res.iterations - ref.iterations) <= 1
    assert np.abs(res.u - ref.u).max() <= 1e-8 * np.abs(ref.u).max()
    assert np.abs(res.stress - ref.stress).max() <= 1e-7 * np.abs(ref.stress).max()


def test_pinned_structure_skips_renumbering_as_jax_does():
    """A checkpoint's block-ELL structure pins the node order: no
    renumbering, the band format the order allows, the JAX package's
    choice and answer."""
    from magnetite_tpu.fem.assembly import build_ell_structure
    from magnetite_tpu_torch import interop

    mesh, bca, md = jax_plate(0.05)
    mesh, bca = shuffled(mesh, bca)
    structure = build_ell_structure(mesh.tris, mesh.num_nodes)
    ref_problem = magnetite_tpu.compile_problem(mesh, bca, md, structure=structure)
    ref = ref_problem.solve()
    pstructure = interop.ell_structure_from_arrays(
        structure.cols, structure.slot_ids, structure.n_nodes, structure.width)
    problem = magnetite_tpu_torch.compile_problem(
        *to_port(mesh, bca, 0.05), structure=pstructure, device="cpu")
    assert problem.perm is None and ref_problem.perm is None
    assert problem.mode == ref_problem.mode == "hybrid"
    res = problem.solve()
    assert np.abs(res.u - ref.u).max() <= 1e-6 * np.abs(ref.u).max()


def test_structured_grid_mesh_names_the_stencil_operator():
    from magnetite_tpu_torch.bc import apply_boundary_conditions
    from magnetite_tpu_torch.meshing.generators import rect_mesh
    from tests.torch_cases import plate_rules

    mesh = rect_mesh(12, 4, width=3.0, height=1.0)
    bca = apply_boundary_conditions(mesh.coords, plate_rules(magnetite_tpu_torch))
    md = magnetite_tpu_torch.ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.3)
    # operator='auto' takes the stencil operator on a structured grid
    problem = magnetite_tpu_torch.compile_problem(mesh, bca, md, device="cpu")
    assert problem.mode == "stencil" and problem.timings["operator"] == "stencil"
    res = problem.solve()
    assert np.isfinite(res.u).all() and res.residual_rel <= 1e-10
    # the band format, asked for explicitly, solves the same system
    ref = magnetite_tpu_torch.solve_system(
        mesh, bca, md, magnetite_tpu_torch.SolverOptions(operator="dia"), device="cpu"
    )
    assert np.abs(res.u - ref.u).max() <= 1e-8 * np.abs(ref.u).max()


def test_cuda_request_without_cuda_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path is not reachable")
    mesh, bca, md = jax_plate(0.05)
    with pytest.raises(magnetite_tpu_torch.SolverError, match="cuda"):
        magnetite_tpu_torch.compile_problem(*to_port(mesh, bca, 0.05), device="cuda")


def test_iteration_cap_raises_like_jax():
    """max_cg_iters stops CG; an unconverged solve raises in both packages."""
    mesh, bca, md = jax_plate(0.03)
    opts = dict(max_cg_iters=20, preconditioner="block_jacobi")
    with pytest.raises(magnetite_tpu.SolverError, match="failed to converge in 20"):
        magnetite_tpu.solve_system(mesh, bca, md, magnetite_tpu.SolverOptions(**opts))
    with pytest.raises(magnetite_tpu_torch.SolverError, match="failed to converge in 20"):
        magnetite_tpu_torch.solve_system(
            *to_port(mesh, bca, 0.03), magnetite_tpu_torch.SolverOptions(**opts),
            device="cpu",
        )
