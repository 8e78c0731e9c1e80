"""The port's AMG-lane material sweeps against the JAX package's, on the CPU.

`compile_unstructured_material_sweep` of both packages runs on the same
mesh with the same 128-lane (E, nu, t) batch (numpy seeds) and ONE basis
hierarchy: the JAX package builds it and it crosses over through
`interop.material_setup_from_arrays`. The JAX side runs its weighted lane
Pallas kernel in interpreter mode. Meshes: h = 0.08 (too small to coarsen:
the V-cycle is the per-lane block-Jacobi sweep) and h = 0.04 (a real
multi-level basis hierarchy). Bars as in tests/test_torch_sweep.py.
"""

import functools

import numpy as np
import pytest
import torch

from magnetite_tpu.parallel import sweep as js
from magnetite_tpu_torch import interop
from magnetite_tpu_torch.parallel import sweep as ps
from tests.test_torch_sweep import check_against_jax
from tests.torch_cases import jax_plate, to_port
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

B, ITERS = 128, 10
MESHES = {"single_level_h0.08": 0.08, "multi_level_h0.04": 0.04}


@functools.lru_cache(maxsize=None)
def make_case(name):
    h = MESHES[name]
    mesh, bca, md = jax_plate(h)
    rng = np.random.default_rng(8)
    batch = (
        rng.uniform(0.5, 2.0, B), np.ones(B), rng.uniform(40e9, 250e9, B),
        rng.uniform(0.22, 0.38, B), rng.uniform(0.2, 1.0, B),
    )
    ref = js.compile_unstructured_material_sweep(
        mesh, bca, iterations=ITERS, refined=True, lane_kernel="interpret"
    )
    return dict(
        name=name, jax=(mesh, bca), port=to_port(mesh, bca, h)[:2], batch=batch,
        ref=ref, ref_result=ref.solve_factors(*batch),
    )


@pytest.fixture(scope="module", params=list(MESHES))
def case(request):
    return make_case(request.param)


def _port_setup(setup):
    return interop.material_setup_from_arrays(
        setup.transfers, setup.coarse_basis, setup.level_sizes, setup.fingerprint
    )


@pytest.mark.parametrize("refined", [False, True], ids=["f32", "refined"])
def test_material_sweep_solve_factors_matches_jax(case, refined):
    mesh, bca = case["jax"]
    if refined:
        cj, rj = case["ref"], case["ref_result"]
    else:
        cj = js.compile_unstructured_material_sweep(
            mesh, bca, iterations=ITERS, refined=False, lane_kernel="interpret"
        )
        rj = cj.solve_factors(*case["batch"])
    setup = _port_setup(cj.material_setup)
    cp = ps.compile_unstructured_material_sweep(
        *case["port"], iterations=ITERS, refined=refined, device="cpu",
        material_setup=setup,
    )
    assert cp.material_setup is setup  # the JAX package's hierarchy was taken
    assert bool(cp.material_setup.transfers) == case["name"].startswith("multi")
    check_against_jax(cp.solve_factors(*case["batch"]), rj, case["ref_result"], refined)


def test_material_dense_solve_matches_solve_factors_and_jax():
    case = make_case("single_level_h0.08")
    u_factors, f_factors, *material = case["batch"]
    _, bca = case["jax"]
    u_values = bca.u_value.astype(np.float32)[None] * u_factors.astype(np.float32)[:, None, None]
    f_values = bca.f_value.astype(np.float32)[None] * f_factors.astype(np.float32)[:, None, None]
    cp = ps.compile_unstructured_material_sweep(
        *case["port"], iterations=ITERS, device="cpu",
        material_setup=_port_setup(case["ref"].material_setup),
    )
    dense = cp.solve(u_values, f_values, *material)
    fact = cp.solve_factors(u_factors, f_factors, *material)
    s = float(fact.u.abs().max())
    assert float((dense.u - fact.u).abs().max()) <= 1e-6 * s
    check_against_jax(dense, case["ref"].solve(u_values, f_values, *material),
                      case["ref_result"], refined=True)


def test_material_weights_and_lane_inv3():
    """The basis weights and the per-lane guarded 3x3 solve, against the
    JAX package's on the same inputs (a degenerate block included)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    e, nu, t = rng.uniform(40e9, 250e9, 6), rng.uniform(0.22, 0.38, 6), rng.uniform(0.2, 1, 6)
    for a, b in zip(ps.material_weights(*(torch.as_tensor(x) for x in (e, nu, t))),
                    js.material_weights(*(jnp.asarray(x) for x in (e, nu, t)))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15)
    q = rng.standard_normal((5, 3, 3, 6))
    d = np.einsum("nijb,nkjb->nikb", q, q) + 0.1 * np.eye(3)[None, :, :, None]
    d[2] = 0.0  # a degenerate aggregate solves to 0
    r = rng.standard_normal((5, 3, 6))
    got = ps._lane_inv3_apply(torch.as_tensor(d), torch.as_tensor(r)).numpy()
    want = np.asarray(js._lane_inv3_apply(jnp.asarray(d), jnp.asarray(r)))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert (got[2] == 0).all()
