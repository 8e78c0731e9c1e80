"""The port's host front end against the JAX package's originals.

magnetite_tpu_torch carries its own copies of the host modules (geometry,
meshing, boundary conditions, band structures, the AMG hierarchy build),
because importing magnetite_tpu pulls in JAX. These tests hold the copies to
the originals: every output must be IDENTICAL, bit for bit -- the copies run
the same numpy code and the same C++ sources built with the same flags, so
any difference at all means a copy drifted.
"""

import numpy as np
import pytest

import magnetite_tpu
import magnetite_tpu.config  # noqa: F401
import magnetite_tpu_torch
import magnetite_tpu_torch.config  # noqa: F401
from tests.torch_cases import (
    HOLE, OUTER, jax_plate, plate_rules, shuffled, write_case,
)
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

CASES = [("plate_h0.05", 0.05, False), ("plate_h0.02", 0.02, False),
         ("shuffled_h0.05", 0.05, True)]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    _, h, shuffle = request.param
    mesh, bca, md = jax_plate(h)
    if shuffle:
        mesh, bca = shuffled(mesh, bca)
    return h, mesh, bca, md


def test_mesh_and_bcs_identical():
    from magnetite_tpu.bc import apply_boundary_conditions as jax_bc
    from magnetite_tpu.meshing.delaunay_backend import triangulate as jax_tri
    from magnetite_tpu_torch.bc import apply_boundary_conditions as port_bc
    from magnetite_tpu_torch.meshing.delaunay_backend import triangulate as port_tri

    for h in (0.05, 0.02):
        loops = [np.array(OUTER), np.array(HOLE)]
        a, b = jax_tri(loops, 0.0, h), port_tri(loops, 0.0, h)
        np.testing.assert_array_equal(a.coords, b.coords)
        np.testing.assert_array_equal(a.tris, b.tris)
        ba = jax_bc(a.coords, plate_rules(magnetite_tpu))
        bb = port_bc(b.coords, plate_rules(magnetite_tpu_torch))
        for name in ("u_known", "u_value", "f_value"):
            np.testing.assert_array_equal(getattr(ba, name), getattr(bb, name))


def test_runner_from_csv_files_identical(tmp_path):
    """The CLI's meshing stage: CSV parse -> mesh -> orientation -> BCs."""
    from magnetite_tpu.config import load_simulation_input as jax_load
    from magnetite_tpu.meshing.runner import run as jax_run
    from magnetite_tpu_torch.config import load_simulation_input as port_load
    from magnetite_tpu_torch.meshing.runner import run as port_run

    paths = write_case(str(tmp_path), 0.05)
    quiet = dict(backend="delaunay", log=lambda msg: None)
    ma, ba = jax_run(paths[1:], jax_load(paths[0]), **quiet)
    mb, bb = port_run(paths[1:], port_load(paths[0]), **quiet)
    np.testing.assert_array_equal(ma.coords, mb.coords)
    np.testing.assert_array_equal(ma.tris, mb.tris)
    np.testing.assert_array_equal(ba.u_known, bb.u_known)
    np.testing.assert_array_equal(ba.u_value, bb.u_value)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_ell_structure_identical(case, use_native, monkeypatch):
    """The block-ELL structure from the port's native routine and from its
    numpy fallback, each against the JAX package's from the same path."""
    import magnetite_tpu.native
    import magnetite_tpu_torch.native
    from magnetite_tpu.fem import assembly as jasm
    from magnetite_tpu_torch.fem import assembly as pasm

    _, mesh, _, _ = case
    n = mesh.num_nodes
    if not use_native:  # both packages as on a host without the library
        monkeypatch.setattr(magnetite_tpu.native, "ell_structure", lambda tris, n_nodes: None)
        monkeypatch.setattr(magnetite_tpu_torch.native, "load", lambda: None)
    want = jasm.build_ell_structure(mesh.tris, n)
    got = pasm.build_ell_structure(mesh.tris, n)
    assert got.width == want.width and got.n_nodes == want.n_nodes == n
    for name in ("cols", "slot_ids"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_band_structures_identical(case):
    from magnetite_tpu.fem import dia as jdia
    from magnetite_tpu_torch.fem import dia as pdia

    _, mesh, _, _ = case
    n = mesh.num_nodes
    for max_diags in (48, 512):
        a = jdia.build_dia_structure(mesh.tris, n, max_diags=max_diags)
        b = pdia.build_dia_structure(mesh.tris, n, max_diags=max_diags)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.offsets, b.offsets)
            np.testing.assert_array_equal(a.slot_ids, b.slot_ids)
    for max_diags in (9, 20, 48):
        a = jdia.build_hybrid_structure(mesh.tris, n, max_diags=max_diags)
        b = pdia.build_hybrid_structure(mesh.tris, n, max_diags=max_diags)
        for name in ("offsets", "slot_ids", "rem_rows", "rem_cols"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_renumbering_identical(case):
    from magnetite_tpu.meshing import reorder as jr
    from magnetite_tpu_torch.meshing import reorder as pr
    from tests.torch_cases import to_port

    h, mesh, bca, _ = case
    pmesh = to_port(mesh, bca, h)[0]
    for method in ("geometric", "rcm"):
        ma, perm_a, sa = jr.renumber(mesh, method=method)
        mb, perm_b, sb = pr.renumber(pmesh, method=method)
        np.testing.assert_array_equal(perm_a, perm_b)
        np.testing.assert_array_equal(ma.tris, mb.tris)
        assert (sa.n_offsets, sa.remainder_frac) == (sb.n_offsets, sb.remainder_frac)


def test_amg_setup_identical(case):
    from magnetite_tpu.fem import amg as jamg
    from magnetite_tpu_torch.fem import amg as pamg

    _, mesh, bca, md = case
    free = (~bca.u_known).astype(np.float64)
    args = (mesh.coords, mesh.tris, md.youngs_modulus, md.poisson_ratio,
            md.part_thickness, free)
    for kwargs in ({}, {"coarse_dof": 300}):
        a = jamg.setup_to_arrays(jamg.build_amg_setup(*args, **kwargs))
        b = pamg.setup_to_arrays(pamg.build_amg_setup(*args, **kwargs))
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_basis_assembly_identical(case):
    """The material-sweep basis assemblies (unit D-bases through the ELL
    structure and the numpy pair-block scatter)."""
    from magnetite_tpu.fem import amg as jamg
    from magnetite_tpu_torch.fem import amg as pamg

    _, mesh, bca, _ = case
    free = (~bca.u_known).astype(np.float64)
    for dc in jamg._UNIT_DCOEFS + ((0.7, 0.2, 0.3),):
        a = jamg._assemble_block_coo(mesh.coords, mesh.tris, 0.0, 0.0, 1.0, free, dcoefs=dc)
        b = pamg._assemble_block_coo(mesh.coords, mesh.tris, 0.0, 0.0, 1.0, free, dcoefs=dc)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_amg_material_setup_identical(case):
    from magnetite_tpu.fem import amg as jamg
    from magnetite_tpu_torch.fem import amg as pamg

    _, mesh, bca, _ = case
    free = (~bca.u_known).astype(np.float64)
    for kwargs in ({}, {"coarse_dof": 300, "nu_ref": 0.25}):
        a = jamg.build_amg_material_setup(mesh.coords, mesh.tris, free, **kwargs)
        b = pamg.build_amg_material_setup(mesh.coords, mesh.tris, free, **kwargs)
        assert a.level_sizes == b.level_sizes and a.fingerprint == b.fingerprint
        assert len(a.transfers) == len(b.transfers)
        for ta, tb in zip(a.transfers, b.transfers):
            for x, y in zip(ta, tb):
                np.testing.assert_array_equal(x, y)
        assert len(a.coarse_basis) == len(b.coarse_basis)
        for (ac, av3, d3), (bc, bv3, e3) in zip(a.coarse_basis, b.coarse_basis):
            np.testing.assert_array_equal(ac, bc)
            for x, y in zip(av3 + d3, bv3 + e3):
                np.testing.assert_array_equal(x, y)
