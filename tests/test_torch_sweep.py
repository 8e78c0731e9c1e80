"""The port's AMG-lane load sweeps against the JAX package's, on the CPU.

`compile_unstructured_sweep` of both packages runs on the same mesh, the
same boundary conditions and the same 128-lane batch (numpy seeds), with
ONE hierarchy: the JAX package builds it and it crosses over through
`interop.amg_setup_from_arrays`. The JAX side runs its lane Pallas kernel in
interpreter mode, as its own tests do. Meshes: h = 0.08 (2N <= 3072: the
single-level dense-inverse branch), h = 0.04 (a real multi-level
hierarchy) and a shuffled h = 0.08 mesh that forces a renumber.

Bars. f64 CG over the f32 V-cycle (`refined=True`): u within 1e-5 of
max|u| (the JAX package's kernel-versus-roll bar), von Mises within 1e-4 of
its max. Pure f32 CG (`refined=False`): two f32 runs of the same algorithm
land up to ~1e-4 of max|u| apart at h = 0.04 -- each that far from the f64
answer, the f32 floor kappa * eps_f32 -- so the port is held to the f64
answer, no further from it than twice the JAX package's own f32 sweep (and
always 1e-5 of max|u| / 1e-4 of max von Mises). Per-lane relative residual
<= max(2 x the JAX package's, 1e-4) in both.
"""

import functools

import numpy as np
import pytest
import torch

from magnetite_tpu.fem.amg import setup_to_arrays
from magnetite_tpu.fem.cg import pcg_fixed_iterations as jax_pcg_fixed
from magnetite_tpu.parallel import sweep as js
from magnetite_tpu_torch import interop
from magnetite_tpu_torch.errors import InputError, SolverError
from magnetite_tpu_torch.fem.cg import pcg_fixed_iterations
from magnetite_tpu_torch.parallel import sweep as ps
from tests.torch_cases import jax_plate, shuffled, to_port
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

B, ITERS = 128, 10
MESHES = {
    "single_level_h0.08": (0.08, False),
    "multi_level_h0.04": (0.04, False),
    "shuffled_h0.08": (0.08, True),
}


@functools.lru_cache(maxsize=None)
def make_case(name):
    """The mesh, both packages' views of it, a batch, and the JAX package's
    f64-CG sweep (the reference of both refined settings)."""
    h, shuffle = MESHES[name]
    mesh, bca, md = jax_plate(h)
    if shuffle:
        mesh, bca = shuffled(mesh, bca)
    rng = np.random.default_rng(7)
    batch = (rng.uniform(0.5, 2.0, B), np.ones(B), rng.uniform(0.5, 2.0, B))
    ref = js.compile_unstructured_sweep(
        mesh, bca, md, iterations=ITERS, refined=True, lane_kernel="interpret"
    )
    return dict(
        name=name, jax=(mesh, bca, md), port=to_port(mesh, bca, h),
        batch=batch, ref=ref, ref_result=ref.solve_factors(*batch),
    )


@pytest.fixture(scope="module", params=list(MESHES))
def case(request):
    return make_case(request.param)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def check_against_jax(got, jax_res, ref_res, refined):
    """The bars of this module's docstring; returns the u error."""
    u, u_j, u_r = _np(got.u), _np(jax_res.u), _np(ref_res.u)
    vm, vm_j, vm_r = _np(got.von_mises), _np(jax_res.von_mises), _np(ref_res.von_mises)
    s, s_vm = np.abs(u_r).max(), np.abs(vm_r).max()
    assert np.isfinite(u).all() and u.shape == u_j.shape
    if refined:
        err = np.abs(u - u_j).max() / s
        assert err <= 1e-5
        assert np.abs(vm - vm_j).max() <= 1e-4 * s_vm
    else:
        err = np.abs(u - u_r).max() / s
        assert err <= max(1e-5, 2.0 * np.abs(u_j - u_r).max() / s)
        assert np.abs(vm - vm_r).max() <= max(1e-4 * s_vm, 2.0 * np.abs(vm_j - vm_r).max())
    rel = _np(got.residual_norm) / _np(got.rhs_norm)
    rel_j = _np(jax_res.residual_norm) / _np(jax_res.rhs_norm)
    assert np.isfinite(rel).all() and rel.max() <= max(2.0 * rel_j.max(), 1e-4)
    return err


@pytest.mark.parametrize("refined", [False, True], ids=["f32", "refined"])
def test_load_sweep_solve_factors_matches_jax(case, refined):
    mesh, bca, md = case["jax"]
    if refined:
        cj, rj = case["ref"], case["ref_result"]
    else:
        cj = js.compile_unstructured_sweep(
            mesh, bca, md, iterations=ITERS, refined=False, lane_kernel="interpret"
        )
        rj = cj.solve_factors(*case["batch"])
    cp = ps.compile_unstructured_sweep(
        *case["port"], iterations=ITERS, refined=refined, device="cpu",
        amg_setup=interop.amg_setup_from_arrays(setup_to_arrays(cj.amg_setup)),
    )
    # the case exercises what its name says
    assert bool(cp.amg_setup.transfers) == case["name"].startswith("multi")
    assert (cp.perm is not None) == case["name"].startswith("shuffled")
    assert (cp.bands.dtype, cp.bands_sm.dtype) == (
        (torch.float64, torch.float32) if refined else (torch.float32, torch.float32)
    )
    check_against_jax(cp.solve_factors(*case["batch"]), rj, case["ref_result"], refined)


def test_dense_solve_matches_solve_factors_and_jax():
    """solve() of the equivalent dense [B, N, 2] fields (permuted into the
    renumbered order of the shuffled mesh) against solve_factors() and the
    JAX package's solve()."""
    case = make_case("shuffled_h0.08")
    u_factors, f_factors, k_scales = case["batch"]
    _, bca, _ = case["jax"]
    u_values = bca.u_value.astype(np.float32)[None] * u_factors.astype(np.float32)[:, None, None]
    f_values = bca.f_value.astype(np.float32)[None] * f_factors.astype(np.float32)[:, None, None]
    cp = ps.compile_unstructured_sweep(*case["port"], iterations=ITERS, device="cpu")
    dense = cp.solve(u_values, f_values, k_scales)
    fact = cp.solve_factors(u_factors, f_factors, k_scales)
    s = float(fact.u.abs().max())
    assert float((dense.u - fact.u).abs().max()) <= 1e-6 * s
    check_against_jax(dense, case["ref"].solve(u_values, f_values, k_scales),
                      case["ref_result"], refined=True)


def test_pcg_fixed_iterations_matches_jax():
    """A small SPD system per lane (each lane scaled), Jacobi-preconditioned,
    with a per-lane dot: x, the true final residual and its shape."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    n, b = 15, 4
    q = rng.standard_normal((2 * n, 2 * n))
    a = q @ q.T + 2 * n * np.eye(2 * n)
    scales = rng.uniform(0.5, 2.0, b)
    rhs = rng.standard_normal((2, n, b))
    x0 = rng.standard_normal((2, n, b))
    dinv = (1.0 / np.diag(a)).reshape(2, n, 1)

    def run(xp, asarray, dot):
        am, sc, dv = asarray(a), asarray(scales), asarray(dinv)

        def mv(v):
            return (am @ v.reshape(2 * n, b)).reshape(2, n, b) * sc

        return pcg_fn[xp](mv, asarray(rhs), preconditioner=lambda r: dv * r / sc,
                          x0=asarray(x0), iterations=7, dot=dot)

    pcg_fn = {"jax": jax_pcg_fixed, "torch": pcg_fixed_iterations}
    rj = run("jax", jnp.asarray, lambda p, q_: jnp.sum(p * q_, axis=(0, 1)))
    rp = run("torch", torch.as_tensor, ps._lane_dot)
    assert tuple(rp.residual_norm.shape) == (b,) and int(rp.iterations) == 7
    xs = np.abs(np.asarray(rj.x)).max()
    assert np.abs(rp.x.numpy() - np.asarray(rj.x)).max() <= 1e-12 * xs
    np.testing.assert_allclose(rp.residual_norm.numpy(), np.asarray(rj.residual_norm),
                               rtol=1e-8)


def test_sweep_solve_routes():
    """sweep_solve(impl="amg") is compile + solve, and so is the grid route
    (auto and impl="stencil" on a coarsenable canonical grid: compile_sweep);
    impl="lanes" and "vmap" are the DIA block-Jacobi lanes and the block-ELL
    route, and auto below the AMG size is the lanes; lane sharding
    (device_mesh=), which the port does not carry, raises a typed error
    naming it."""
    from magnetite_tpu_torch.fem.dia import build_dia_structure

    from magnetite_tpu_torch.meshing.generators import plate_with_hole_mesh, tensile_bcs_for_rect

    mesh, bca, md = to_port(*jax_plate(0.08)[:2], 0.08)
    b = 4
    rng = np.random.default_rng(12)
    u_values = np.tile(bca.u_value[None], (b, 1, 1)) * rng.uniform(0.5, 2.0, (b, 1, 1))
    f_values = np.zeros_like(u_values)
    k_scales = rng.uniform(0.5, 2.0, b)
    got = ps.sweep_solve(mesh, bca, md, u_values, f_values, k_scales, iterations=6,
                         impl="amg", device="cpu")
    want = ps.compile_unstructured_sweep(mesh, bca, md, iterations=6, device="cpu").solve(
        u_values, f_values, k_scales)
    assert torch.equal(got.u, want.u)
    dia = build_dia_structure(mesh.tris, mesh.num_nodes)
    lanes = ps._sweep_lanes(mesh, bca, md, u_values, f_values, k_scales, 6, np.float32, dia,
                            "cpu")
    vmapped = ps._sweep_vmap(mesh, bca, md, u_values, f_values, k_scales, 6, np.float32,
                             None, "cpu")
    for impl, want in (("lanes", lanes), ("vmap", vmapped), ("auto", lanes)):
        # auto: below the AMG size, the DIA lanes
        got = ps.sweep_solve(mesh, bca, md, u_values, f_values, k_scales, iterations=6,
                             impl=impl, device="cpu")
        assert torch.equal(got.u, want.u) and torch.equal(got.von_mises, want.von_mises)
        assert torch.equal(got.residual_norm, want.residual_norm)
    grid = plate_with_hole_mesh(16, 32)
    gbca = tensile_bcs_for_rect(grid.coords)
    gu = np.tile(gbca.u_value[None], (b, 1, 1))
    want = ps.compile_sweep(grid, gbca, md, iterations=6, device="cpu").solve(
        gu, np.zeros_like(gu), k_scales)
    for impl in ("auto", "stencil"):
        got = ps.sweep_solve(grid, gbca, md, gu, np.zeros_like(gu), k_scales, iterations=6,
                             impl=impl, device="cpu")
        assert torch.equal(got.u, want.u)
    with pytest.raises(SolverError, match="stencil sweep unavailable"):
        ps.sweep_solve(mesh, bca, md, u_values, f_values, k_scales, impl="stencil",
                       device="cpu")
    for compile_fn, args in ((ps.compile_unstructured_sweep, (mesh, bca, md)),
                             (ps.compile_sweep, (grid, gbca, md)),
                             (ps.compile_material_sweep, (grid, gbca))):
        with pytest.raises(SolverError, match="not yet ported"):
            compile_fn(*args, device="cpu", device_mesh=object())


def test_lane_kernel_modes_on_the_cpu():
    """`lane_kernel` (the JAX package's switch) does not change what runs on
    the CPU: every mode gives the plain versions' answer bit for bit."""
    mesh, bca, md = to_port(*jax_plate(0.08)[:2], 0.08)
    b = 4
    rng = np.random.default_rng(13)
    batch = (rng.uniform(0.5, 2.0, b), np.ones(b), rng.uniform(0.5, 2.0, b))
    runs = [
        ps.compile_unstructured_sweep(mesh, bca, md, iterations=4, lane_kernel=mode,
                                      device="cpu").solve_factors(*batch)
        for mode in ("auto", "interpret", "off")
    ]
    assert all(torch.equal(r.u, runs[0].u) for r in runs[1:])
    with pytest.raises(InputError, match="lane_kernel"):
        ps.compile_unstructured_sweep(mesh, bca, md, lane_kernel="on", device="cpu")


def test_compile_defaults_to_cuda():
    """The entry points default to the card and raise without one."""
    import inspect

    for fn in (ps.compile_unstructured_sweep, ps.compile_unstructured_material_sweep):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        mesh, bca, md = to_port(*jax_plate(0.08)[:2], 0.08)
        with pytest.raises(SolverError, match="cuda"):
            ps.compile_unstructured_sweep(mesh, bca, md)
        with pytest.raises(SolverError, match="cuda"):
            ps.compile_unstructured_material_sweep(mesh, bca)
