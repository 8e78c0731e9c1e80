"""The port's structured-grid material sweep against the JAX package's, on the
CPU.

Per-lane (E, nu, t) over three basis stencils and the 4-stencil Galerkin
hierarchy. The whole solve (`material_sweep_solve` / `compile_material_sweep`,
8 lanes, 25 CG iterations, f64) runs in both packages on `rect_mesh(32, 16,
width=2.0)` (17x33; hierarchy 17x33 / 9x17, whose coarsest level smooths 48
times), once with the port's own setup and once with the JAX package's
crossed over through `interop` (one hierarchy). The JAX package's jit of
this solve takes over a minute on the CPU, so the wrapped grid
(`plate_with_hole_mesh(16, 32)`, 17x32) is held to it at the V-cycle level:
the setup array by array, and one V-cycle over random residuals. The lane
matvec's plain version is held to the JAX function on random stencils,
wrapped and not.

Bars as in tests/test_torch_grid_sweep.py: u within 1e-9 of max|u|, von
Mises within 1e-8 of its max, per-lane residual <= 2 x the JAX package's +
1e-13 (JAX reaches ~2.7e-15 at 17x33); the port's f32 solve within 1e-4 of
max|u| of the JAX package's f64 answer; the pieces 1e-12 x the scale of
the same computation with every term in absolute value.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magnetite_tpu.fem.solve import _grid as jax_grid
from magnetite_tpu.meshing import generators as jgen
from magnetite_tpu.parallel import sweep as js
from magnetite_tpu_torch import interop
from magnetite_tpu_torch.kernels import lane_stencil_kernel as lk
from magnetite_tpu_torch.parallel import sweep as ps
from tests.test_torch_grid_sweep import GRIDS, _np, check_f64, port_bca, port_mesh
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

B, ITERS = 8, 25


def material_batch(mesh, bca, nb, seed):
    """Per-lane pulls on the right edge and (E, nu, t) as bench.py's
    bench_material_sweep draws them."""
    rng = np.random.default_rng(seed)
    right = np.isclose(mesh.coords[:, 0], mesh.coords[:, 0].max())
    u_values = np.tile(bca.u_value[None], (nb, 1, 1))
    u_values[:, right, 0] = rng.uniform(0.005, 0.02, nb)[:, None]
    return (u_values, np.zeros_like(u_values), rng.uniform(40e9, 250e9, nb),
            rng.uniform(0.22, 0.38, nb), rng.uniform(0.2, 1.0, nb))


@functools.lru_cache(maxsize=None)
def jax_setup(name):
    """The grid, its BCs and the JAX package's f64 material setup."""
    mesh = GRIDS[name]()
    bca = jgen.tensile_bcs_for_rect(mesh.coords, pull=0.01)
    rows, cols = mesh.grid_shape
    free_g = jax_grid(jnp.asarray(~bca.u_known, dtype=jnp.float64), rows, cols)
    setup = js._material_sweep_setup(jnp.asarray(mesh.coords), jnp.asarray(mesh.tris), free_g,
                                     rows, cols, mesh.wrap_cols)
    return mesh, bca, setup


@functools.lru_cache(maxsize=None)
def jax_solve():
    """The JAX package's whole f64 material sweep on the 17x33 rectangle
    (its only run of the solve in this module)."""
    mesh, bca, _ = jax_setup("rect_17x33")
    batch = material_batch(mesh, bca, B, 5)
    ref = js.compile_material_sweep(mesh, bca, iterations=ITERS, dtype=np.float64)
    return batch, ref, ref.solve(*batch)


def port_setup_of(setup):
    basis_raw, levels, b_mat = setup
    return interop.material_grid_sweep_setup_from_arrays(
        [np.asarray(a) for a in basis_raw], [[np.asarray(a) for a in lv] for lv in levels],
        np.asarray(b_mat))


def close(got, ref, tol=1e-12):
    ref = np.asarray(ref)
    return np.abs(_np(got) - ref).max() <= tol * max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("wrap", [False, True], ids=["zero_cols", "wrapped"])
def test_lane_material_matvec_matches_jax(wrap):
    rng = np.random.default_rng(6)
    rows, cols, nb = 9, 16, 5
    st = [rng.standard_normal((9, 2, 2, rows, cols)) for _ in range(4)]
    w = [rng.uniform(0.5, 2.0, nb) for _ in range(3)]
    u = rng.standard_normal((2, rows, cols, nb))
    got = lk.lane_stencil_matvec3(tuple(map(torch.from_numpy, st)),
                                  tuple(map(torch.from_numpy, w)), torch.from_numpy(u), wrap)
    level = js._MaterialLevel(*(jnp.asarray(s) for s in st))
    ref = np.asarray(js._lane_material_matvec(level, *(jnp.asarray(x) for x in w),
                                              jnp.asarray(u), wrap))
    scale = lk.lane_material_matvec_plain(
        tuple(torch.from_numpy(np.abs(s)) for s in st), tuple(map(torch.from_numpy, w)),
        torch.from_numpy(np.abs(u)), wrap).max()
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * float(scale)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_material_setup_matches_jax(grid):
    """Raw bases, every level's masked bases and fixed-DOF stencil (the
    Galerkin hierarchy), and the B matrices, array by array."""
    mesh, bca, (j_raw, j_levels, j_bmat) = jax_setup(grid)
    pm, pb = port_mesh(mesh), port_bca(bca)
    rows, cols = mesh.grid_shape
    coords, tris, free_g = ps._grid_arrays(pm, pb, rows, cols, torch.device("cpu"))
    p_raw, p_levels, p_bmat = ps._material_sweep_setup(coords, tris, free_g, rows, cols,
                                                       mesh.wrap_cols)
    assert len(p_levels) == len(j_levels) == 2
    assert all(close(p, j) for p, j in zip(p_raw, j_raw))
    for pl, jl in zip(p_levels, j_levels):
        assert all(tuple(p.shape) == tuple(j.shape) and close(p, j) for p, j in zip(pl, jl))
    assert close(p_bmat, j_bmat)


def test_material_vcycle_matches_jax_on_the_wrapped_grid():
    """One lane V-cycle (two smoothing levels, 48 sweeps on the coarsest)
    over the JAX package's hierarchy with per-lane center inverses."""
    mesh, _, setup = jax_setup("plate_17x32_wrapped")
    _, j_levels, _ = setup
    _, p_levels, _ = port_setup_of(setup)
    rng = np.random.default_rng(9)
    nb = 4
    e, nu, t = rng.uniform(40e9, 250e9, nb), rng.uniform(0.22, 0.38, nb), rng.uniform(0.2, 1, nb)
    rows, cols = mesh.grid_shape
    r = rng.standard_normal((2, rows, cols, nb))
    jw = js.material_weights(jnp.asarray(e), jnp.asarray(nu), jnp.asarray(t))
    j_dinvs = tuple(js._lane_material_center_inv(lv, *jw) for lv in j_levels)
    ref = np.asarray(js._lane_material_vcycle(j_levels, j_dinvs, *jw, True)(jnp.asarray(r)))
    pw = ps.material_weights(*(torch.from_numpy(x) for x in (e, nu, t)))
    p_dinvs = tuple(ps._lane_material_center_inv(lv, *pw) for lv in p_levels)
    for pd, jd in zip(p_dinvs, j_dinvs):
        assert close(pd, jd)
    got = ps._lane_material_vcycle(p_levels, p_dinvs, *pw, True)(torch.from_numpy(r))
    assert close(got, ref, 1e-11)


def test_material_sweep_solve_matches_jax():
    batch, _, ref = jax_solve()
    mesh, bca, _ = jax_setup("rect_17x33")
    got = ps.material_sweep_solve(port_mesh(mesh), port_bca(bca), *batch, iterations=ITERS,
                                  dtype=np.float64, device="cpu")
    check_f64(got, ref)


def test_one_hierarchy_through_interop():
    batch, cj, ref = jax_solve()
    mesh, bca, _ = jax_setup("rect_17x33")
    cp = ps.compile_material_sweep(port_mesh(mesh), port_bca(bca), iterations=ITERS,
                                   dtype=np.float64, device="cpu", setup=port_setup_of(cj.setup))
    check_f64(cp.solve(*batch), ref)


def test_material_sweep_f32_held_to_jax_f64():
    batch, _, ref = jax_solve()
    mesh, bca, _ = jax_setup("rect_17x33")
    got = ps.compile_material_sweep(port_mesh(mesh), port_bca(bca), iterations=ITERS,
                                    device="cpu").solve(*batch)
    u, u_r = _np(got.u), _np(ref.u)
    assert got.u.dtype == torch.float32 and np.isfinite(u).all()
    assert np.abs(u - u_r).max() <= 1e-4 * np.abs(u_r).max()
