"""The stencil operator of the port (fem/stencil.py, kernels/stencil_kernel.py)
against the JAX package's, on the same seeded inputs.

Bars: f64 results within 1e-12 of their max (the same arithmetic, summed
in another order); the f32 Pallas kernels (interpreter mode) against the
port's plain version in f32 within 1e-5 of max, as tests/test_pallas_kernel
holds them against XLA.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magnetite_tpu.fem import solve as jsolve
from magnetite_tpu.fem import stencil as jst
from magnetite_tpu.meshing.generators import plate_with_hole_mesh, rect_mesh
from magnetite_tpu_torch.fem import solve as psolve
from magnetite_tpu_torch.fem import stencil as pst
from magnetite_tpu_torch.kernels import cuda_lib
from tests.torch_cases import E_MOD, NU, THICK
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

MESHES = {
    # the meshes of tests/test_pallas_kernel.py
    "annulus_25x128_wrap": lambda: plate_with_hole_mesh(24, 128),
    "rect_128x32_nowrap": lambda: rect_mesh(31, 127),
}


def _jax_stencil(mesh) -> np.ndarray:
    rows, cols = mesh.grid_shape
    return np.array(jst.assemble_stencil_fused(
        jnp.asarray(mesh.coords), jnp.asarray(mesh.tris), E_MOD, NU, THICK,
        rows, cols, mesh.wrap_cols,
    ))


def _field(rows, cols, seed):
    return np.random.default_rng(seed).standard_normal((2, rows, cols))


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("name", list(MESHES))
def test_plain_matvec_matches_xla_and_pallas(name):
    from magnetite_tpu.pallas.stencil_kernel import (
        _matvec_blocked,
        _pick_row_tile_blocked,
        pretile_stencil,
        stencil_matvec_pallas,
    )

    mesh = MESHES[name]()
    rows, cols = mesh.grid_shape
    wrap = mesh.wrap_cols
    st64, u64 = _jax_stencil(mesh), _field(rows, cols, 0)
    ref = jst.stencil_matvec_xla(jnp.asarray(st64), jnp.asarray(u64), wrap)
    got = pst.stencil_matvec_plain(torch.from_numpy(st64), torch.from_numpy(u64), wrap)
    _close(got, ref, 1e-12)

    # the two TPU kernels, f32, in interpreter mode
    st32, u32 = jnp.asarray(st64, jnp.float32), jnp.asarray(u64, jnp.float32)
    got32 = pst.stencil_matvec_plain(
        torch.from_numpy(st64).float(), torch.from_numpy(u64).float(), wrap
    )
    _close(got32, stencil_matvec_pallas(st32, u32, wrap, interpret=True), 1e-5)
    tr = _pick_row_tile_blocked(cols)
    blocked = _matvec_blocked(pretile_stencil(st32, tr), u32, rows, wrap, interpret=True)
    _close(got32, blocked, 1e-5)


def test_batched_plain_matvec_applies_each_field():
    mesh = plate_with_hole_mesh(8, 16)
    rows, cols = mesh.grid_shape
    st = torch.from_numpy(_jax_stencil(mesh))
    u = torch.from_numpy(np.stack([_field(rows, cols, s) for s in range(3)]))
    batched = pst.stencil_matvec_plain(st, u, True)
    for k in range(3):
        assert torch.equal(batched[k], pst.stencil_matvec_plain(st, u[k], True))


def test_cpu_operand_takes_the_plain_version():
    mesh = rect_mesh(6, 5)
    rows, cols = mesh.grid_shape
    st = torch.from_numpy(_jax_stencil(mesh))
    u = torch.from_numpy(_field(rows, cols, 1))
    before = cuda_lib.launched("mt_stencil_matvec")
    y = pst.make_stencil_operator(st, False)(u)
    assert cuda_lib.launched("mt_stencil_matvec") == before  # no kernel on the CPU
    assert torch.equal(y, pst.stencil_matvec_plain(st, u, False))


@pytest.mark.parametrize("wrap", [True, False])
def test_dense_expansion_matches_jax(wrap):
    mesh = plate_with_hole_mesh(4, 8) if wrap else rect_mesh(5, 4)
    st = _jax_stencil(mesh)
    np.testing.assert_array_equal(
        pst.stencil_to_dense(st, wrap), jst.stencil_to_dense(st, wrap)
    )


@pytest.mark.parametrize("make", [lambda: plate_with_hole_mesh(9, 16), lambda: rect_mesh(7, 11)])
def test_assembly_matches_jax(make):
    mesh = make()
    rows, cols = mesh.grid_shape
    wrap = mesh.wrap_cols
    coords = torch.from_numpy(mesh.coords)
    tris = torch.from_numpy(mesh.tris.astype(np.int64))
    ref_fused = _jax_stencil(mesh)
    ref_struct = np.asarray(jst.assemble_stencil_structured(
        jnp.asarray(mesh.coords), E_MOD, NU, THICK, rows, cols, wrap
    ))
    fused = pst.assemble_stencil_fused(coords, tris, E_MOD, NU, THICK, rows, cols, wrap)
    struct = pst.assemble_stencil_structured(coords, E_MOD, NU, THICK, rows, cols, wrap)
    # index_add_ sums in another order than segment_sum
    _close(fused, ref_fused, 1e-12)
    _close(struct, ref_struct, 1e-12)
    _close(struct, ref_fused, 1e-9)  # the two assemblies agree, as in JAX


def test_structure_scan_matches_jax():
    mesh = plate_with_hole_mesh(6, 12)
    rows, cols = mesh.grid_shape
    ref = jst.build_stencil_structure(mesh.tris, rows, cols, True)
    got = pst.build_stencil_structure(mesh.tris, rows, cols, True)
    np.testing.assert_array_equal(got.slot_ids, ref.slot_ids)
    # a coupling that is not grid-local is refused by both
    bad = mesh.tris.copy()
    bad[0, 2] = bad[0, 0] + 3 * cols
    assert jst.build_stencil_structure(bad, rows, cols, True) is None
    assert pst.build_stencil_structure(bad, rows, cols, True) is None


@pytest.mark.parametrize("wrap", [True, False])
def test_reduce_stencil_matches_jax(wrap):
    mesh = plate_with_hole_mesh(9, 16) if wrap else rect_mesh(7, 11)
    rows, cols = mesh.grid_shape
    st = _jax_stencil(mesh)
    free = (np.random.default_rng(5).random((2, rows, cols)) > 0.2).astype(np.float64)
    ref = jsolve._reduce_stencil(jnp.asarray(st), jnp.asarray(free), wrap)
    got = psolve._reduce_stencil(torch.from_numpy(st), torch.from_numpy(free), wrap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
