"""The port's geometric multigrid (fem/multigrid.py) against the JAX
package's, in f64 on the same seeded inputs.

Bars: within 1e-12 of the reference's max (the same arithmetic; the
port's dense coarse solve sums a row in another order than JAX's matmul).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magnetite_tpu.fem import multigrid as jmg
from magnetite_tpu.fem import solve as jsolve
from magnetite_tpu.fem import stencil as jst
from magnetite_tpu.meshing.generators import plate_with_hole_mesh, rect_mesh
from magnetite_tpu_torch.fem import multigrid as pmg
from magnetite_tpu_torch.fem import solve as psolve
from tests.torch_cases import E_MOD, NU, THICK
from tests.torch_cases import one_thread  # noqa: F401  (autouse)


def _close(got, ref, tol=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def _reduced_case(wrap: bool):
    """A BC-reduced stencil that coarsens once, to a dense coarse solve:
    the annulus with its inner ring fixed, or the rectangle with its left
    edge fixed."""
    mesh = plate_with_hole_mesh(16, 32) if wrap else rect_mesh(16, 16)
    rows, cols = mesh.grid_shape
    raw = jst.assemble_stencil_fused(
        jnp.asarray(mesh.coords), jnp.asarray(mesh.tris), E_MOD, NU, THICK,
        rows, cols, wrap,
    )
    free = np.ones((2, rows, cols))
    if wrap:
        free[:, 0, :] = 0.0
    else:
        free[:, :, 0] = 0.0
    reduced = np.array(jsolve._reduce_stencil(raw, jnp.asarray(free), wrap))
    return reduced, rows, cols


@pytest.mark.parametrize("wrap", [True, False])
def test_transfers_match_jax_and_are_adjoint(wrap):
    rc, cc = (5, 8) if wrap else (5, 6)
    rows, cols = 2 * rc - 1, (2 * cc if wrap else 2 * cc - 1)
    rng = np.random.default_rng(11)
    uc = rng.standard_normal((3, 2, rc, cc))  # a leading batch dimension
    rf = rng.standard_normal((3, 2, rows, cols))
    up = pmg.prolong(torch.from_numpy(uc), wrap)
    down = pmg.restrict(torch.from_numpy(rf), wrap)
    np.testing.assert_array_equal(up.numpy(), np.asarray(jmg.prolong(jnp.asarray(uc), wrap)))
    np.testing.assert_array_equal(down.numpy(), np.asarray(jmg.restrict(jnp.asarray(rf), wrap)))
    lhs = float(torch.sum(up * torch.from_numpy(rf)))
    rhs = float(torch.sum(torch.from_numpy(uc) * down))
    assert abs(lhs - rhs) <= 1e-12 * (abs(lhs) + abs(rhs))


@pytest.mark.parametrize("wrap", [True, False])
def test_hierarchy_and_vcycle_match_jax(wrap):
    reduced, rows, cols = _reduced_case(wrap)
    ref_levels = jmg.build_hierarchy(jnp.asarray(reduced), None, wrap)
    levels = pmg.build_hierarchy(torch.from_numpy(reduced), wrap)
    assert [(lv.rows, lv.cols) for lv in levels] == [
        (lv.rows, lv.cols) for lv in ref_levels
    ]
    assert len(levels) == 2
    for lv, ref in zip(levels[1:], ref_levels[1:]):
        # the Galerkin coarse stencils and their block-Jacobi inverses
        _close(lv.stencil, ref.stencil)
        _close(lv.diag_inv, ref.diag_inv)
    assert levels[-1].dense_inv is not None and ref_levels[-1].dense_inv is not None
    _close(levels[-1].dense_inv, ref_levels[-1].dense_inv, 1e-10)

    r = np.random.default_rng(4).standard_normal((2, rows, cols))
    ref = jmg.vcycle_preconditioner(ref_levels, wrap)(jnp.asarray(r))
    got = pmg.vcycle_preconditioner(levels, wrap)(torch.from_numpy(r))
    _close(got, ref)


@pytest.mark.parametrize("wrap", [True, False])
def test_galerkin_probing_matches_jax(wrap):
    mesh = plate_with_hole_mesh(8, 16) if wrap else rect_mesh(8, 8)
    rows, cols = mesh.grid_shape
    st = np.array(jst.assemble_stencil_fused(
        jnp.asarray(mesh.coords), jnp.asarray(mesh.tris), E_MOD, NU, THICK,
        rows, cols, wrap,
    ))
    rc, cc = (rows - 1) // 2 + 1, (cols // 2 if wrap else (cols - 1) // 2 + 1)
    ref = jmg.galerkin_coarse_stencil(
        lambda v: jst.stencil_matvec_xla(jnp.asarray(st), v, wrap), rc, cc, wrap, jnp.float64
    )
    st_t = torch.from_numpy(st)
    got = pmg.galerkin_coarse_stencil(
        lambda v: pmg.stencil_matvec_plain(st_t, v, wrap), rc, cc, wrap, torch.float64
    )
    _close(got, ref)


@pytest.mark.parametrize("wrap", [True, False])
def test_dense_expansion_on_the_device_matches_host(wrap):
    mesh = plate_with_hole_mesh(4, 8) if wrap else rect_mesh(5, 4)
    rows, cols = mesh.grid_shape
    st = np.array(jst.assemble_stencil_fused(
        jnp.asarray(mesh.coords), jnp.asarray(mesh.tris), E_MOD, NU, THICK,
        rows, cols, wrap,
    ))
    dense = pmg.stencil_to_dense_device(torch.from_numpy(st), wrap)
    np.testing.assert_array_equal(dense.numpy(), jst.stencil_to_dense(st, wrap))


def test_can_coarsen_matches_jax():
    for rows in (15, 16, 17, 33, 513):
        for cols in (16, 17, 24, 32, 33, 1000, 1024):
            for wrap in (True, False):
                assert pmg.can_coarsen(rows, cols, wrap) == jmg.can_coarsen(rows, cols, wrap)


def test_stencil_preconditioner_block_jacobi_matches_jax():
    reduced, rows, cols = _reduced_case(False)
    r = np.random.default_rng(6).standard_normal((2, rows, cols))
    from magnetite_tpu.fem.solve import CoreSpec

    spec = CoreSpec("stencil", None, "block_jacobi", 1e-10, 0.0, 10, 1.0)
    ref = jsolve._stencil_preconditioner(spec, jnp.asarray(reduced), None, False)
    got = psolve._stencil_preconditioner("block_jacobi", torch.from_numpy(reduced), None, False)
    _close(got(torch.from_numpy(r)), ref(jnp.asarray(r)))
    assert psolve._stencil_preconditioner("none", None, None, False) is None
