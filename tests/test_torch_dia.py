"""The port's band operators against the JAX package's.

On the CPU the port's band matvec is its plain PyTorch version; it is held
to JAX's `fem.dia.dia_matvec_blocks` (f64) and to the Pallas TPU kernel run
in interpret mode (f32), on random bands that are zero wherever the band
leaves [0, n) -- the invariant of every assembled operator. The CUDA kernel
is held to the plain version on the card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_cases import jax_plate, random_bands
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

OFFSETS_M2 = (-1300, -512, -37, -1, 0, 1, 37, 512, 1300)
OFFSETS_M3 = (-601, -37, -1, 0, 1, 37, 601)
# stands for the first banded coarse level of a real AMG hierarchy
COARSE = "coarse_level"


@pytest.fixture(scope="module")
def coarse_level():
    """(bands [D, 3, 3, n1] f64, offsets) of the first banded coarse level of
    the plate's AMG hierarchy at h = 0.009 (n1 = 4,113 -- the Pallas
    kernel takes n >= 4,096 --, 29 offsets reaching +-199), as the port
    uploads it for its V-cycle."""
    from magnetite_tpu_torch.fem.amg import amg_device_arrays, build_amg_setup

    mesh, bca, md = jax_plate(0.009)
    setup = build_amg_setup(
        mesh.coords, mesh.tris, md.youngs_modulus, md.poisson_ratio,
        md.part_thickness, (~bca.u_known).astype(np.float64),
    )
    cb = next(cb for cb in amg_device_arrays(setup, torch.float64, "cpu").coarse_bands
              if cb is not None)
    return cb.bands.numpy(), cb.offsets


def _operands(m, offsets, n, seed, request):
    """(bands, offsets, n): random bands at `offsets`, or the coarse level's."""
    if offsets == COARSE:
        bands, offsets = request.getfixturevalue("coarse_level")
        return bands, offsets, bands.shape[-1]
    return random_bands(n, offsets, m, seed=seed), offsets, n


def _scale(bands, offsets, u):
    """max over rows of sum |B| |u|: the magnitude every row's rounding
    error is relative to."""
    from magnetite_tpu_torch.fem.dia import dia_matvec_blocks

    return float(dia_matvec_blocks(torch.as_tensor(np.abs(bands)), offsets,
                                   torch.as_tensor(np.abs(u))).max())


@pytest.mark.parametrize("m,offsets", [(2, OFFSETS_M2), (3, OFFSETS_M3), (3, COARSE)])
def test_plain_matvec_matches_jax_f64(m, offsets, request):
    from magnetite_tpu.fem.dia import dia_matvec_blocks as jax_mv
    from magnetite_tpu_torch.fem.dia import dia_matvec_blocks as port_mv

    bands, offsets, n = _operands(m, offsets, 5000, 0, request)
    u = np.random.default_rng(1).standard_normal((m, n))
    y_jax = np.asarray(jax_mv(jnp.asarray(bands), offsets, jnp.asarray(u)))
    y_port = port_mv(torch.as_tensor(bands), offsets, torch.as_tensor(u)).numpy()
    # the same roll + FMA sequence in f64: only the last bits may differ
    np.testing.assert_allclose(y_port, y_jax, rtol=0,
                               atol=1e-13 * _scale(bands, offsets, u))


@pytest.mark.parametrize("m,offsets", [(2, OFFSETS_M2), (3, OFFSETS_M3), (3, COARSE)])
def test_plain_matvec_matches_pallas_interpret_f32(m, offsets, request):
    from magnetite_tpu.pallas.dia_kernel import (
        dia_pallas_applicable, make_pallas_dia_operator,
    )
    from magnetite_tpu_torch.fem.dia import make_dia_operator

    # random bands: n past one lane tile, not a multiple of it
    bands, offsets, n = _operands(m, offsets, 4096 + 517, 2, request)
    assert dia_pallas_applicable(offsets, n, m=m)
    bands = bands.astype(np.float32)
    u = np.random.default_rng(3).standard_normal((m, n)).astype(np.float32)
    op = make_pallas_dia_operator(jnp.asarray(bands), offsets, interpret=True)
    y_pal = np.asarray(op(jnp.asarray(u)))
    y_port = make_dia_operator(torch.as_tensor(bands), offsets)(
        torch.as_tensor(u)).numpy()
    # f32 sums in different orders: a few ulps of the row magnitude
    np.testing.assert_allclose(y_port, y_pal, rtol=0,
                               atol=1e-5 * _scale(bands, offsets, u))


def test_hybrid_operator_matches_jax():
    from magnetite_tpu.fem.dia import make_hybrid_operator as jax_hyb
    from magnetite_tpu_torch.fem.dia import make_hybrid_operator as port_hyb

    n, offsets, r = 3000, (-40, -1, 0, 1, 40), 700
    rng = np.random.default_rng(4)
    bands = random_bands(n, offsets, 2, seed=5)
    rem_vals = rng.standard_normal((r, 2, 2))
    rem_rows = rng.integers(0, n, r).astype(np.int32)  # duplicates included
    rem_cols = rng.integers(0, n, r).astype(np.int32)
    u = rng.standard_normal((2, n))
    y_jax = np.asarray(jax_hyb(
        jnp.asarray(bands), offsets, jnp.asarray(rem_vals),
        jnp.asarray(rem_rows), jnp.asarray(rem_cols),
    )(jnp.asarray(u)))
    y_port = port_hyb(
        torch.as_tensor(bands), offsets, torch.as_tensor(rem_vals),
        torch.as_tensor(rem_rows, dtype=torch.int64),
        torch.as_tensor(rem_cols, dtype=torch.int64),
    )(torch.as_tensor(u)).numpy()
    scale = _scale(bands, offsets, u) + np.abs(rem_vals).sum(axis=(1, 2)).max() * 4
    # f64, scatter-add order may differ: last bits of the row magnitude
    np.testing.assert_allclose(y_port, y_jax, rtol=0, atol=1e-13 * scale)


def test_block_jacobi_inverse_matches_jax():
    from magnetite_tpu.fem.dia import block_jacobi_inverse_t as jax_bj
    from magnetite_tpu_torch.fem.dia import block_jacobi_inverse_t as port_bj

    n = 500
    rng = np.random.default_rng(6)
    a = rng.standard_normal((n, 2, 2))
    diag = (a @ a.transpose(0, 2, 1) + np.eye(2)).transpose(1, 2, 0)  # SPD
    free = (rng.random((2, n)) > 0.2).astype(np.float64)
    r = rng.standard_normal((2, n))
    z_jax = np.asarray(jax_bj(jnp.asarray(diag), jnp.asarray(free))(jnp.asarray(r)))
    z_port = port_bj(torch.as_tensor(diag), torch.as_tensor(free))(
        torch.as_tensor(r)).numpy()
    # closed-form 2x2 inverse, same formula: rounding only
    np.testing.assert_allclose(z_port, z_jax, rtol=1e-13, atol=1e-13 * np.abs(z_jax).max())


def test_cpu_tensor_takes_plain_version_and_launches_nothing():
    from magnetite_tpu_torch.kernels import cuda_lib
    from magnetite_tpu_torch.kernels.dia_kernel import dia_matvec, dia_matvec_blocks

    n, offsets = 300, (-3, 0, 3)
    bands = torch.as_tensor(random_bands(n, offsets, 2, seed=7))
    u = torch.as_tensor(np.random.default_rng(8).standard_normal((2, n)))
    before = cuda_lib.launched("mt_dia_matvec")
    y = dia_matvec(bands, offsets, u)
    assert cuda_lib.launched("mt_dia_matvec") == before
    # the wrapper IS the plain version on the CPU: bitwise the same call
    assert torch.equal(y, dia_matvec_blocks(bands, offsets, u))


def test_mixed_devices_raise():
    """A CPU operand beside a non-CPU one is refused, never moved."""
    from magnetite_tpu_torch.kernels.cuda_lib import KernelError
    from magnetite_tpu_torch.kernels.dia_kernel import dia_matvec

    n, offsets = 64, (0,)
    bands = torch.zeros((1, 2, 2, n), device="meta")
    with pytest.raises(KernelError):
        dia_matvec(bands, offsets, torch.zeros((2, n)))
