"""The port's level-0 AMG transfers (P0 prolong / P0^T restrict) against the
JAX package: its gather branch (fem/amg.py, f64) and its Pallas transfer
kernels run in interpret mode (f32). On the CPU the port's wrappers take
their plain versions; the CUDA kernels are held to those on the card in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_cases import jax_plate
from tests.torch_cases import one_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def fast0():
    """The factored level-0 transfer arrays of a real two-level hierarchy."""
    from magnetite_tpu.fem.amg import build_amg_setup

    mesh, bca, md = jax_plate(0.02)
    setup = build_amg_setup(
        mesh.coords, mesh.tris, md.youngs_modulus, md.poisson_ratio,
        md.part_thickness, (~bca.u_known).astype(np.float64),
    )
    agg, p0, ptc, ptv, _ = setup.fast0
    return agg, p0, ptc, ptv, setup.level_sizes[1][0]


def _jax_gathers(agg, p0, ptc, ptv, ec, tmp):
    """The JAX package's gather branch (amg.py:1286-1307), layout "t"."""
    uf = jnp.einsum("nij,nj->ni", jnp.asarray(p0), jnp.asarray(ec)[jnp.asarray(agg)]).T
    rc = jnp.einsum("nwij,jnw->ni", jnp.asarray(ptv),
                    jnp.asarray(tmp)[:, jnp.asarray(ptc)])
    return np.asarray(uf), np.asarray(rc)


def test_plain_transfers_match_jax_gathers_f64(fast0):
    from magnetite_tpu_torch.kernels.transfer_kernel import prolong0, restrict0

    agg, p0, ptc, ptv, n1 = fast0
    rng = np.random.default_rng(0)
    ec, tmp = rng.standard_normal((n1, 3)), rng.standard_normal((2, agg.size))
    uf_jax, rc_jax = _jax_gathers(agg, p0, ptc, ptv, ec, tmp)
    uf = prolong0(torch.as_tensor(ec), torch.as_tensor(agg), torch.as_tensor(p0)).numpy()
    rc = restrict0(torch.as_tensor(tmp), torch.as_tensor(ptc), torch.as_tensor(ptv)).numpy()
    # f64 block products of <= 64 terms in another order: rounding only
    np.testing.assert_allclose(uf, uf_jax, rtol=0, atol=1e-14 * np.abs(uf_jax).max())
    np.testing.assert_allclose(rc, rc_jax, rtol=0, atol=1e-13 * np.abs(rc_jax).max())


def test_plain_transfers_match_pallas_interpret_f32():
    """The synthetic row-major aggregation of tests/test_transfer_kernel.py,
    through the Pallas windowed one-hot kernel pair in interpret mode."""
    from magnetite_tpu.pallas.transfer_kernel import (
        build_transfer_plan, make_plan_transfers,
    )
    from magnetite_tpu_torch.fem.amg import _fast0_arrays
    from magnetite_tpu_torch.kernels.transfer_kernel import prolong0, restrict0

    n_rows, row_len = 40, 130
    n0 = n_rows * row_len - 17
    ri, ci = np.arange(n0) // row_len, np.arange(n0) % row_len
    _, agg = np.unique((ri // 3) * (-(-row_len // 3)) + ci // 3, return_inverse=True)
    n1 = int(agg.max()) + 1
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((n0, 2, 3)).astype(np.float32)
    plan = build_transfer_plan(agg, p0, n1, interpret=True)
    k_prolong, k_restrict = make_plan_transfers(plan, n1)
    ec = rng.standard_normal((n1, 3)).astype(np.float32)
    tmp = rng.standard_normal((2, n0)).astype(np.float32)
    uf_pal = np.asarray(k_prolong(jnp.asarray(ec)))
    rc_pal = np.asarray(k_restrict(jnp.asarray(tmp)))

    agg32, _, ptc, ptv, _ = _fast0_arrays(agg, p0.astype(np.float64),
                                          np.zeros((n0, 2, 2)), 1.0, n1)
    uf = prolong0(torch.as_tensor(ec), torch.as_tensor(agg32),
                  torch.as_tensor(p0)).numpy()
    rc = restrict0(torch.as_tensor(tmp), torch.as_tensor(ptc),
                   torch.as_tensor(ptv.astype(np.float32))).numpy()
    # f32 sums in another order (the TPU pair also splits values into
    # bf16-exact pieces): the bar tests/test_transfer_kernel.py sets
    np.testing.assert_allclose(uf, uf_pal, rtol=0, atol=2e-6 * np.abs(uf_pal).max())
    np.testing.assert_allclose(rc, rc_pal, rtol=0, atol=2e-6 * np.abs(rc_pal).max())


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-13), (torch.float32, 1e-5)])
def test_restrict_is_adjoint_of_prolong(fast0, dtype, tol):
    from magnetite_tpu_torch.kernels.transfer_kernel import prolong0, restrict0

    agg, p0, ptc, ptv, n1 = fast0
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((n1, 3)), dtype=dtype)
    y = torch.as_tensor(rng.standard_normal((2, agg.size)), dtype=dtype)
    agg_t, ptc_t = torch.as_tensor(agg), torch.as_tensor(ptc)
    p0_t, ptv_t = torch.as_tensor(p0, dtype=dtype), torch.as_tensor(ptv, dtype=dtype)
    lhs = float((prolong0(x, agg_t, p0_t) * y).sum())
    rhs = float((x * restrict0(y, ptc_t, ptv_t)).sum())
    # <P0 x, y> = <x, P0^T y> up to rounding of the sum of |terms|: the
    # V-cycle is an SPD preconditioner only if the pair is adjoint
    mag = float((prolong0(x.abs(), agg_t, p0_t.abs()) * y.abs()).sum())
    assert abs(lhs - rhs) <= tol * mag


def test_padding_contributes_nothing():
    """ELL padding (col 0, zero block) must add exactly 0, whatever tmp[:, 0]."""
    from magnetite_tpu_torch.kernels.transfer_kernel import restrict0

    ptc = torch.tensor([[1, 0, 0], [2, 3, 0]], dtype=torch.int32)
    ptv = torch.zeros((2, 3, 3, 2), dtype=torch.float64)
    ptv[0, 0] = 1.0
    ptv[1, :2] = 2.0
    tmp = torch.tensor([[1e300, 1.0, 2.0, 3.0], [-1e300, 1.0, 2.0, 3.0]],
                       dtype=torch.float64)
    rc = restrict0(tmp, ptc, ptv)
    expected = torch.tensor([[2.0] * 3, [20.0] * 3], dtype=torch.float64)
    assert torch.allclose(rc, expected, rtol=1e-15, atol=1e-300)
