"""The port's structured-grid load sweep against the JAX package's, on the CPU.

`compile_sweep(...).solve` of both packages runs on the same grid, the same
boundary conditions and the same 8-lane batch (numpy seeds: per-lane pulls
on the right edge, forces on the top edge, stiffness scales), 20 CG
iterations. Grids: `rect_mesh(32, 16, width=2.0)` (17x33, hierarchy 17x33 /
9x17 with its dense inverse) and `plate_with_hole_mesh(16, 32)` (17x32,
columns wrapped). The pieces of the solve -- the lane stencil matvec's
plain version, the lane transfers, the dense coarse level, the V-cycle and
the `dcoefs` basis assembly -- are held to the JAX functions one by one.

Bars. f64: u within 1e-9 of max|u|, von Mises within 1e-8 of its max, the
per-lane true relative residual <= 2 x the JAX package's + 1e-13 (JAX
reaches ~2.6e-15 unwrapped, ~2.2e-8 wrapped at 20 iterations). f32: held to
the JAX package's f64 answer, no further from it than twice the JAX
package's own f32 run and within 1e-4 of max|u|. The pieces: 1e-12 x the
scale of the same computation with every term in absolute value.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magnetite_tpu.config import ModelMetadata as JaxMetadata
from magnetite_tpu.fem.stencil import assemble_stencil_structured as jax_assemble
from magnetite_tpu.meshing import generators as jgen
from magnetite_tpu.parallel import sweep as js
from magnetite_tpu_torch import interop
from magnetite_tpu_torch.config import ModelMetadata
from magnetite_tpu_torch.errors import InputError, SolverError
from magnetite_tpu_torch.fem.stencil import assemble_stencil_structured
from magnetite_tpu_torch.kernels import lane_stencil_kernel as lk
from magnetite_tpu_torch.parallel import sweep as ps
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

B, ITERS = 8, 20
E_MOD, NU, THICK = 69e9, 0.33, 0.5
GRIDS = {
    "rect_17x33": lambda: jgen.rect_mesh(32, 16, width=2.0),
    "plate_17x32_wrapped": lambda: jgen.plate_with_hole_mesh(16, 32),
}


def port_mesh(mesh):
    """The JAX package's generator mesh as the port's (numpy arrays only)."""
    from magnetite_tpu_torch.meshing.core import Mesh

    return Mesh(coords=mesh.coords, tris=mesh.tris, grid_shape=mesh.grid_shape,
                wrap_cols=mesh.wrap_cols, grid_local=mesh.grid_local,
                canonical_grid=mesh.canonical_grid)


def port_bca(bca):
    return interop.bca_from_arrays(bca.u_known, bca.u_value, bca.f_value)


def load_batch(mesh, bca, nb, seed):
    """Per-lane pulls U(0.005, 0.02) on the right edge (bench.py's
    bench_sweep), vertical forces on the top edge, stiffness scales."""
    rng = np.random.default_rng(seed)
    x, y = mesh.coords[:, 0], mesh.coords[:, 1]
    right, top = np.isclose(x, x.max()), np.isclose(y, y.max())
    u_values = np.tile(bca.u_value[None], (nb, 1, 1))
    u_values[:, right, 0] = rng.uniform(0.005, 0.02, nb)[:, None]
    f_values = np.zeros_like(u_values)
    f_values[:, top, 1] = rng.uniform(-2e4, 2e4, nb)[:, None]
    return u_values, f_values, rng.uniform(0.5, 2.0, nb)


@functools.lru_cache(maxsize=None)
def make_case(name):
    """The grid, its BCs, a batch, and the JAX package's f64 and f32
    sweeps (compiled once per module)."""
    mesh = GRIDS[name]()
    bca = jgen.tensile_bcs_for_rect(mesh.coords, pull=0.01)
    md = JaxMetadata(E_MOD, NU, THICK, 0.0, 0.05)
    batch = load_batch(mesh, bca, B, 3)
    ref = js.compile_sweep(mesh, bca, md, iterations=ITERS, dtype=np.float64)
    ref32 = js.compile_sweep(mesh, bca, md, iterations=ITERS, dtype=np.float32)
    return dict(mesh=mesh, bca=bca, batch=batch, ref=ref, ref_result=ref.solve(*batch),
                ref32_result=ref32.solve(*batch))


@pytest.fixture(scope="module", params=list(GRIDS))
def case(request):
    return make_case(request.param)


def port_sweep(case, dtype, **kw):
    return ps.compile_sweep(port_mesh(case["mesh"]), port_bca(case["bca"]),
                            ModelMetadata(E_MOD, NU, THICK, 0.0, 0.05), iterations=ITERS,
                            dtype=dtype, device="cpu", **kw)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def check_f64(got, ref):
    """The f64 bars of the module docstring."""
    u, u_r = _np(got.u), _np(ref.u)
    vm, vm_r = _np(got.von_mises), _np(ref.von_mises)
    assert u.shape == u_r.shape and vm.shape == vm_r.shape and np.isfinite(u).all()
    assert np.abs(u - u_r).max() <= 1e-9 * np.abs(u_r).max()
    assert np.abs(vm - vm_r).max() <= 1e-8 * np.abs(vm_r).max()
    rel = _np(got.residual_norm) / _np(got.rhs_norm)
    rel_r = _np(ref.residual_norm) / _np(ref.rhs_norm)
    assert np.isfinite(rel).all() and rel.max() <= 2.0 * rel_r.max() + 1e-13


# --------------------------------- pieces ----------------------------------


def random_lane_case(rows, cols, nb, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((9, 2, 2, rows, cols)), rng.standard_normal((2, rows, cols, nb))


@pytest.mark.parametrize("wrap", [False, True], ids=["zero_cols", "wrapped"])
def test_lane_stencil_matvec_matches_jax(wrap):
    st, u = random_lane_case(9, 16, 5, 1)
    got = lk.lane_stencil_matvec(torch.from_numpy(st), torch.from_numpy(u), wrap)
    ref = np.asarray(js._lane_stencil_matvec(jnp.asarray(st), jnp.asarray(u), wrap))
    scale = lk.lane_stencil_matvec_plain(torch.from_numpy(np.abs(st)),
                                         torch.from_numpy(np.abs(u)), wrap).max()
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * float(scale)


@pytest.mark.parametrize("wrap", [False, True], ids=["zero_cols", "wrapped"])
def test_lane_transfers_match_jax_and_are_adjoint(wrap):
    rc, cc = 9, (8 if wrap else 9)
    rf, cf = 2 * rc - 1, (2 * cc if wrap else 2 * cc - 1)
    rng = np.random.default_rng(2)
    uc = rng.standard_normal((2, rc, cc, 3))
    rf_ = rng.standard_normal((2, rf, cf, 3))
    pu = ps._lane_prolong(torch.from_numpy(uc), wrap)
    ru = ps._lane_restrict(torch.from_numpy(rf_), wrap)
    assert tuple(pu.shape) == (2, rf, cf, 3) and tuple(ru.shape) == (2, rc, cc, 3)
    np.testing.assert_allclose(pu.numpy(), np.asarray(js._lane_prolong(jnp.asarray(uc), wrap)),
                               rtol=0, atol=1e-12 * np.abs(uc).max())
    np.testing.assert_allclose(ru.numpy(), np.asarray(js._lane_restrict(jnp.asarray(rf_), wrap)),
                               rtol=0, atol=1e-12 * 4 * np.abs(rf_).max())
    # <R f, c> = <f, P c> per lane
    lhs = (ru.numpy() * uc).sum(axis=(0, 1, 2))
    rhs = (rf_ * pu.numpy()).sum(axis=(0, 1, 2))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


@pytest.mark.parametrize("basis", [0, 1, 2])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_dcoefs_basis_assembly_matches_jax(grid, basis):
    mesh = GRIDS[grid]()
    rows, cols = mesh.grid_shape
    dc = tuple(float(i == basis) for i in range(3))
    got = assemble_stencil_structured(torch.from_numpy(mesh.coords), 0.0, 0.0, 1.0, rows, cols,
                                      mesh.wrap_cols, dcoefs=dc)
    ref = np.asarray(jax_assemble(jnp.asarray(mesh.coords), 0.0, 0.0, 1.0, rows, cols,
                                  mesh.wrap_cols, dcoefs=dc))
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("grid", list(GRIDS))
def test_basis_combination_is_the_material_stencil(grid):
    """wa Ka + wb Kb + wc Kc is the stencil assembled at (E, nu, t)."""
    mesh = GRIDS[grid]()
    rows, cols = mesh.grid_shape
    coords = torch.from_numpy(mesh.coords)
    e, nu, t = 123e9, 0.29, 0.7
    wa, wb, wc = ps.material_weights(e, nu, t)
    basis = [assemble_stencil_structured(coords, 0.0, 0.0, 1.0, rows, cols, mesh.wrap_cols,
                                         dcoefs=tuple(float(i == k) for i in range(3)))
             for k in range(3)]
    ref = assemble_stencil_structured(coords, e, nu, t, rows, cols, mesh.wrap_cols)
    got = wa * basis[0] + wb * basis[1] + wc * basis[2]
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def test_lane_vcycle_matches_jax(case):
    """The port's lane V-cycle (two smoothing levels, the dense coarse
    solve) over the JAX package's own hierarchy, on random residuals."""
    raw, reduced, levels, b_mat, d_mat = case["ref"].setup
    port = interop.stencil_sweep_setup_from_arrays(
        raw, reduced, [(lv.stencil, lv.diag_inv, lv.dense_inv) for lv in levels], b_mat, d_mat)
    assert port[2][-1].dense_inv is not None and len(port[2]) == 2
    rows, cols = reduced.shape[-2:]
    r = np.random.default_rng(4).standard_normal((2, rows, cols, 3))
    got = ps._lane_vcycle(port[2], case["mesh"].wrap_cols)(torch.from_numpy(r))
    ref = np.asarray(js._lane_vcycle(levels, case["mesh"].wrap_cols)(jnp.asarray(r)))
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


# --------------------------------- solves ----------------------------------


def test_compile_sweep_f64_matches_jax(case):
    cp = port_sweep(case, np.float64)
    assert cp.dtype == torch.float64 and len(cp.setup[2]) == 2
    assert cp.setup[2][-1].dense_inv is not None
    check_f64(cp.solve(*case["batch"]), case["ref_result"])


def test_compile_sweep_f32_held_to_jax_f64(case):
    got = port_sweep(case, np.float32).solve(*case["batch"])
    u_r = _np(case["ref_result"].u)
    s = np.abs(u_r).max()
    err = np.abs(_np(got.u) - u_r).max() / s
    err_jax = np.abs(_np(case["ref32_result"].u) - u_r).max() / s
    assert got.u.dtype == torch.float32 and np.isfinite(_np(got.u)).all()
    assert err <= 2.0 * err_jax and err <= 1e-4


def test_one_hierarchy_through_interop(case):
    """Both packages on ONE setup: the JAX package's arrays crossed over."""
    raw, reduced, levels, b_mat, d_mat = case["ref"].setup
    setup = interop.stencil_sweep_setup_from_arrays(
        raw, reduced, [(lv.stencil, lv.diag_inv, lv.dense_inv) for lv in levels], b_mat, d_mat)
    check_f64(port_sweep(case, np.float64, setup=setup).solve(*case["batch"]),
              case["ref_result"])


def test_sweep_solve_routes_grids_to_compile_sweep():
    case = make_case("plate_17x32_wrapped")
    mesh, bca = port_mesh(case["mesh"]), port_bca(case["bca"])
    md = ModelMetadata(E_MOD, NU, THICK, 0.0, 0.05)
    want = ps.compile_sweep(mesh, bca, md, iterations=6, device="cpu").solve(*case["batch"])
    for impl in ("auto", "stencil"):
        got = ps.sweep_solve(mesh, bca, md, *case["batch"], iterations=6, impl=impl,
                             device="cpu")
        assert torch.equal(got.u, want.u)


# ------------------------------ device rules -------------------------------


def test_wrappers_launch_nothing_on_cpu_tensors(case):
    n1, n3 = lk.lane_stencil_matvec.launches, lk.lane_stencil_matvec3.launches
    port_sweep(case, np.float64).solve(*case["batch"])
    st, u = random_lane_case(9, 17, 4, 5)
    st, u = torch.from_numpy(st), torch.from_numpy(u)
    w = tuple(torch.ones(4, dtype=torch.float64) for _ in range(3))
    lk.lane_stencil_matvec3((st, st, st, st), w, u, False)
    assert (lk.lane_stencil_matvec.launches, lk.lane_stencil_matvec3.launches) == (n1, n3)


def test_compile_defaults_to_cuda_and_raises_without_a_card():
    import inspect

    for fn in (ps.compile_sweep, ps.compile_material_sweep, ps.material_sweep_solve):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        case = make_case("rect_17x33")
        mesh, bca = port_mesh(case["mesh"]), port_bca(case["bca"])
        with pytest.raises(SolverError, match="cuda"):
            ps.compile_sweep(mesh, bca, ModelMetadata(E_MOD, NU, THICK, 0.0, 0.05))
        with pytest.raises(SolverError, match="cuda"):
            ps.compile_material_sweep(mesh, bca)


def test_compile_sweep_refuses_what_it_cannot_run():
    case = make_case("rect_17x33")
    mesh, bca = port_mesh(case["mesh"]), port_bca(case["bca"])
    md = ModelMetadata(E_MOD, NU, THICK, 0.0, 0.05)
    # a device_mesh that is not a parallel.pipeline mesh: a typed error
    with pytest.raises(InputError, match="device_mesh must be"):
        ps.compile_sweep(mesh, bca, md, device="cpu", device_mesh=object())
    small = port_mesh(jgen.rect_mesh(8, 4))  # 5x9: cannot coarsen
    with pytest.raises(SolverError, match="cannot coarsen"):
        ps.compile_sweep(small, port_bca(jgen.tensile_bcs_for_rect(small.coords)), md,
                         device="cpu")


@pytest.mark.parametrize("rows,cols,nb,es,aligned,plan", [
    (33, 65, 4096, 4, True, (True, 13, 6)), (33, 65, 4096, 8, True, (True, 13, 6)),
    (33, 65, 37, 4, True, (False, 13, 6)), (33, 65, 32, 4, False, (False, 13, 6)),
    (33, 64, 4096, 4, True, (True, 16, 6)), (9, 17, 4096, 8, True, (True, 9, 2)),
    (17, 33, 1, 8, True, (False, 11, 6)), (1, 16, 8, 4, True, (True, 16, 1)),
], ids=["bench-f32", "bench-f64", "b37", "unaligned", "wrapped-33x64-f32", "9x17-f64",
        "17x33-b1", "one-row"])
def test_lane_stencil_plan(rows, cols, nb, es, aligned, plan):
    """16-byte chunks of lanes where B and the alignment allow it, the
    columns in the fewest tiles of at most 16 evened out (65 columns: 5
    tiles of 13), strips of 6 rows, of 2 on grids of at most 12 rows."""
    assert lk.lane_stencil_plan(rows, cols, nb, es, aligned) == plan
