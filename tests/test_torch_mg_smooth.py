"""The port's fused V-cycle kernels (kernels/mg_smooth_kernel.py) through
their plain versions, against the JAX package's V-cycle composition, in f64
on the same seeded inputs.

Cases: the 16x32 annulus and the 16x16 rectangle of test_torch_multigrid's
`_reduced_case` (one coarse level, a dense coarse solve), and a 67x61
rectangle whose second level (34x31: rows cannot coarsen, 2,108 DOF) has no
dense inverse and smooths 48 times. On the CPU the JAX package's stencil
operator is its XLA reference (the Pallas kernel runs only on a TPU).

Bars: within 1e-12 of the reference's max (the same arithmetic in another
framework); the V-cycle's symmetry within 1e-12 relative.
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
from magnetite_tpu_torch.kernels import cuda_lib
from magnetite_tpu_torch.kernels import mg_smooth_kernel as mgk
from tests.torch_cases import E_MOD, NU, THICK
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

CASES = {
    "annulus_16x32": (lambda: plate_with_hole_mesh(16, 32), True),
    "rect_16x16": (lambda: rect_mesh(16, 16), False),
    "rect_67x61_coarsest_smooths": (lambda: rect_mesh(60, 66), False),
}


def _close(got, ref, tol=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def _reduced(case):
    """The case's BC-reduced stencil (inner ring or left edge fixed)."""
    make, wrap = CASES[case]
    mesh = make()
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
    return np.array(jsolve._reduce_stencil(raw, jnp.asarray(free), wrap)), wrap


@pytest.fixture(scope="module", params=sorted(CASES))
def hierarchies(request):
    reduced, wrap = _reduced(request.param)
    ref_levels = jmg.build_hierarchy(jnp.asarray(reduced), None, wrap)
    levels = pmg.build_hierarchy(torch.from_numpy(reduced), wrap)
    return request.param, wrap, ref_levels, levels


def _inputs(seed, rows, cols):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, rows, cols)), rng.standard_normal((2, rows, cols))


def test_plain_fused_versions_match_jax_composition(hierarchies):
    _, wrap, ref_levels, _ = hierarchies
    smoothing = [lv for lv in ref_levels if lv.dense_inv is None]
    assert smoothing
    for k, lv in enumerate(smoothing):
        st = torch.from_numpy(np.array(lv.stencil))
        dinv = torch.from_numpy(np.array(lv.diag_inv))
        r, e = _inputs(20 + k, lv.rows, lv.cols)
        rt, et = torch.from_numpy(r), torch.from_numpy(e)
        zero = jnp.zeros_like(jnp.asarray(r))
        if lv is not ref_levels[-1]:
            # pre: two sweeps from zero, the residual, its restriction
            e_ref = jmg._smooth(lv, wrap, zero, jnp.asarray(r), 2, 0.7)
            rc_ref = jmg.restrict(jnp.asarray(r) - lv.op(e_ref), wrap)
            e_got, rc_got = mgk.mg_presmooth_plain(st, dinv, rt, wrap)
            _close(e_got, e_ref)
            _close(rc_got, rc_ref)
            # post: the coarse correction, then two sweeps
            ec = np.random.default_rng(40 + k).standard_normal(rc_ref.shape)
            post_ref = jmg._smooth(
                lv, wrap, jnp.asarray(e) + jmg.prolong(jnp.asarray(ec), wrap), jnp.asarray(r),
                2, 0.7,
            )
            _close(mgk.mg_postsmooth_plain(st, dinv, rt, et, torch.from_numpy(ec), wrap),
                   post_ref)
        else:
            # the coarsest smoothing solve's calls: from zero, then from e
            _close(mgk.mg_postsmooth_plain(st, dinv, rt, None, None, wrap),
                   jmg._smooth(lv, wrap, zero, jnp.asarray(r), 2, 0.7))
            _close(mgk.mg_postsmooth_plain(st, dinv, rt, et, None, wrap),
                   jmg._smooth(lv, wrap, jnp.asarray(e), jnp.asarray(r), 2, 0.7))


def test_vcycle_over_a_coarsest_smoothing_hierarchy_matches_jax():
    reduced, wrap = _reduced("rect_67x61_coarsest_smooths")
    ref_levels = jmg.build_hierarchy(jnp.asarray(reduced), None, wrap)
    levels = pmg.build_hierarchy(torch.from_numpy(reduced), wrap)
    assert [(lv.rows, lv.cols) for lv in levels] == [(67, 61), (34, 31)]
    assert [(lv.rows, lv.cols) for lv in ref_levels] == [(67, 61), (34, 31)]
    assert levels[-1].dense_inv is None and ref_levels[-1].dense_inv is None
    assert 2 * 34 * 31 > pmg._DENSE_COARSE_MAX_DOF
    r = np.random.default_rng(5).standard_normal((2, 67, 61))
    ref = jmg.vcycle_preconditioner(ref_levels, wrap)(jnp.asarray(r))
    _close(pmg.vcycle_preconditioner(levels, wrap)(torch.from_numpy(r)), ref)


def test_vcycle_is_symmetric(hierarchies):
    _, wrap, _, levels = hierarchies
    apply = pmg.vcycle_preconditioner(levels, wrap)
    x, y = (torch.from_numpy(a) for a in _inputs(7, levels[0].rows, levels[0].cols))
    lhs = float(torch.sum(x * apply(y)))
    rhs = float(torch.sum(apply(x) * y))
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), abs(rhs))


def test_wrappers_take_the_plain_versions_on_cpu_and_launch_nothing(hierarchies):
    _, wrap, _, levels = hierarchies
    entries = ("mt_mg_presmooth", "mt_mg_postsmooth")
    counts = [cuda_lib.launched(e) for e in entries]
    lv = levels[0]
    r, e = (torch.from_numpy(a) for a in _inputs(9, lv.rows, lv.cols))
    got = mgk.mg_presmooth(lv.stencil, lv.diag_inv, r, wrap)
    ref = mgk.mg_presmooth_plain(lv.stencil, lv.diag_inv, r, wrap)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    ec = torch.from_numpy(np.random.default_rng(10).standard_normal(tuple(ref[1].shape)))
    assert torch.equal(mgk.mg_postsmooth(lv.stencil, lv.diag_inv, r, e, ec, wrap),
                       mgk.mg_postsmooth_plain(lv.stencil, lv.diag_inv, r, e, ec, wrap))
    pmg.vcycle_preconditioner(levels, wrap)(r)
    assert [cuda_lib.launched(e) for e in entries] == counts


@pytest.mark.parametrize("wrap", [True, False])
def test_coarse_shape_is_what_prolong_maps_onto(wrap):
    for rows in range(1, 40):
        for cols in range(2, 40):
            rcc = mgk.coarse_shape(rows, cols, wrap)
            if rcc is None:
                continue
            fine = mgk.prolong(torch.zeros((2, *rcc), dtype=torch.float64), wrap)
            assert tuple(fine.shape[-2:]) == (rows, cols)
            assert tuple(mgk.restrict(torch.zeros((2, rows, cols)), wrap).shape[-2:]) == rcc
    # every level the hierarchy smooths above its coarsest has a coarse grid
    for rows, cols in ((513, 1024), (257, 512), (17, 32), (601, 1001), (67, 61)):
        if pmg.can_coarsen(rows, cols, wrap):
            assert mgk.coarse_shape(rows, cols, wrap) is not None
