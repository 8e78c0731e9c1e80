"""The port's V-cycle against the JAX package's, on ONE hierarchy.

The AMGSetup is built by the JAX package, flattened with its
`setup_to_arrays` and carried over with `interop.amg_setup_from_arrays`;
both packages then apply their V-cycle (layout "t", f64, the JAX side with
its gather-form transfers) to the same residual, around the same level-0
band operator. Cases cover the single-level dense inverse, a dense
coarsest level, banded coarse levels with transfers between them,
smoothing on the coarsest level, and band-hostile (ELL) coarse levels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_cases import jax_plate
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

CASES = {
    # name: (h, build_amg_setup kwargs, ELL coarse levels)
    "single_level_dense": (0.05, {}, False),
    "two_level_dense": (0.02, {}, False),
    "banded_coarse_levels": (0.02, {"coarse_dof": 300}, False),
    "coarsest_smoothing": (0.02, {"coarse_dof": 60, "max_levels": 3}, False),
    "ell_coarse_levels": (0.02, {"coarse_dof": 300}, True),
}


def _level0(mesh, bca):
    """Unreduced DIA bands [D, 2, 2, N] + offsets + free mask [2, N]."""
    from magnetite_tpu_torch.fem.dia import build_dia_structure
    from magnetite_tpu_torch.native import amg_assemble

    n, e = mesh.num_nodes, mesh.num_elements
    s = build_dia_structure(mesh.tris, n)
    slots = s.slot_ids.astype(np.int64).reshape(e, 3, 3).transpose(1, 2, 0).reshape(-1)
    flat = amg_assemble(mesh.coords, mesh.tris, np.ones((n, 2)), 69e9, 0.33, 0.5,
                        slots, s.n_diags * n)
    bands = flat.reshape(s.n_diags, n, 2, 2).transpose(0, 2, 3, 1).copy()
    free_t = (~bca.u_known).astype(np.float64).T.copy()
    return bands, tuple(int(o) for o in s.offsets), free_t


def _jax_vcycle(setup, bands, offsets, free_t, ell):
    from magnetite_tpu.fem import amg as jamg
    from magnetite_tpu.fem.dia import block_jacobi_inverse_t, make_dia_operator

    b, f = jnp.asarray(bands), jnp.asarray(free_t)
    mv = make_dia_operator(b, offsets)
    arrays = jamg.amg_device_arrays(setup, jnp.float64, transfer_plan="off", lanes=ell)
    return jamg.make_amg_preconditioner(
        arrays,
        lambda v: f * mv(f * v) + (1.0 - f) * v,
        block_jacobi_inverse_t(b[offsets.index(0)], f),
        layout="t",
        a_op=lambda v: f * mv(f * v),
    )


def _port_vcycle(setup, bands, offsets, free_t, ell):
    from magnetite_tpu_torch.fem import amg as pamg
    from magnetite_tpu_torch.fem.dia import block_jacobi_inverse_t, make_dia_operator

    b, f = torch.as_tensor(bands), torch.as_tensor(free_t)
    mv = make_dia_operator(b, offsets)
    arrays = pamg.amg_device_arrays(
        setup, torch.float64, "cpu", **({"coarse_max_diags": 0} if ell else {})
    )
    return pamg.make_amg_preconditioner(
        arrays,
        lambda v: f * mv(f * v) + (1.0 - f) * v,
        block_jacobi_inverse_t(b[offsets.index(0)], f),
        a_op=lambda v: f * mv(f * v),
    ), arrays


@pytest.mark.parametrize("name", list(CASES))
def test_vcycle_matches_jax(name):
    from magnetite_tpu.fem.amg import build_amg_setup, setup_to_arrays
    from magnetite_tpu_torch import interop

    h, kwargs, ell = CASES[name]
    mesh, bca, md = jax_plate(h)
    setup_j = build_amg_setup(
        mesh.coords, mesh.tris, md.youngs_modulus, md.poisson_ratio,
        md.part_thickness, (~bca.u_known).astype(np.float64), **kwargs,
    )
    setup_p = interop.amg_setup_from_arrays(setup_to_arrays(setup_j))
    bands, offsets, free_t = _level0(mesh, bca)
    apply_j = _jax_vcycle(setup_j, bands, offsets, free_t, ell)
    apply_p, arrays = _port_vcycle(setup_p, bands, offsets, free_t, ell)

    # the case exercises what its name says
    levels = len(setup_j.level_sizes)
    assert (levels == 1) == (name == "single_level_dense")
    assert (setup_j.coarsest_inv is None) == (name == "coarsest_smoothing")
    if levels > 1:
        banded = [cb is not None for cb in arrays.coarse_bands]
        assert not any(banded) if ell else all(banded)

    r = np.random.default_rng(0).standard_normal((2, mesh.num_nodes))
    z_j = np.asarray(apply_j(jnp.asarray(r)))
    z_p = apply_p(torch.as_tensor(r)).numpy()
    # same f64 operations, summed in other orders by two frameworks
    scale = np.abs(z_j).max()
    assert np.abs(z_p - z_j).max() <= 1e-12 * scale


def test_setup_round_trips_between_packages():
    """A hierarchy built by the port runs in the JAX package too: the dict
    the port writes is the one the JAX package reads."""
    from magnetite_tpu.fem.amg import setup_from_arrays, setup_to_arrays
    from magnetite_tpu_torch.fem import amg as pamg

    mesh, bca, md = jax_plate(0.02)
    setup_p = pamg.build_amg_setup(
        mesh.coords, mesh.tris, md.youngs_modulus, md.poisson_ratio,
        md.part_thickness, (~bca.u_known).astype(np.float64),
    )
    d = pamg.setup_to_arrays(setup_p)
    back = setup_to_arrays(setup_from_arrays(d))
    assert sorted(back) == sorted(d)
    for key in d:
        np.testing.assert_array_equal(back[key], d[key], err_msg=key)
