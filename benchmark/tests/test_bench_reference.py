"""The plain reference against a hand-worked element, against itself
(matrix-free and assembled), and against the program's CPU path."""

import warnings

import numpy as np
import pytest
import torch

from benchmark.reference import judge, plane_stress

# E = 1, nu = 0, t = 1 on the triangle (0, 0), (1, 0), (0, 1): B's rows are
# v0 = [-1, 0, 1, 0, 0, 0], v1 = [0, -1, 0, 0, 0, 1], v2 = [-1, -1, 0, 1, 1, 0]
# and K = A t B^T D B = 0.5 (v0 v0^T + v1 v1^T + 0.5 v2 v2^T), worked by hand
HAND_K = np.array([
    [0.75, 0.25, -0.5, -0.25, -0.25, 0.0],
    [0.25, 0.75, 0.0, -0.25, -0.25, -0.5],
    [-0.5, 0.0, 0.5, 0.0, 0.0, 0.0],
    [-0.25, -0.25, 0.0, 0.25, 0.25, 0.0],
    [-0.25, -0.25, 0.0, 0.25, 0.25, 0.0],
    [0.0, -0.5, 0.0, 0.0, 0.0, 0.5],
])
UNIT = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])


def test_hand_worked_element():
    tris = np.array([[0, 1, 2]])
    k = plane_stress.stiffness_matrix(UNIT, tris, 1.0, 0.0, 1.0).toarray()
    np.testing.assert_allclose(k, HAND_K, atol=1e-15)
    # u_x = x: a unit strain in x, sigma = [1, 0, 0] at nu = 0
    u = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 0.0]])
    np.testing.assert_allclose(plane_stress.stresses(UNIT, tris, u, 1.0, 0.0), [[1.0, 0.0, 0.0]])
    # nu = 0.25 scales by E / (1 - nu^2) and couples sy
    s = plane_stress.stresses(UNIT, tris, u, 2.0, 0.25)
    np.testing.assert_allclose(s, [[2.0 / 0.9375, 0.5 / 0.9375, 0.0]])
    np.testing.assert_allclose(plane_stress.von_mises(np.array([[3.0, 0.0, 0.0]])), [3.0])
    np.testing.assert_allclose(plane_stress.scalar_stress(np.array([[-3.0, 4.0, 9.0]])), [5.0])
    np.testing.assert_allclose(plane_stress.scalar_stress(np.array([[0.2, 0.3, 9.0]])),
                               [-np.hypot(0.2, 0.3)])


def _plate():
    from magnetite_tpu_torch.meshing.generators import plate_with_hole_mesh

    return plate_with_hole_mesh(8, 16)


def test_matrix_free_equals_assembled():
    mesh = _plate()
    tris = np.asarray(mesh.tris, np.int64)
    u = np.random.default_rng(0).standard_normal(mesh.coords.shape)
    k = plane_stress.stiffness_matrix(mesh.coords, tris, 69e9, 0.33, 0.5)
    ku = plane_stress.apply_stiffness(mesh.coords, tris, u, 69e9, 0.33, 0.5, rows=37)
    np.testing.assert_allclose(ku.ravel(), k @ u.ravel(), rtol=1e-12, atol=1e-12 * np.abs(ku).max())


def test_element_stiffness_matches_program():
    from magnetite_tpu_torch.fem.element import element_stiffness_matrices

    mesh = _plate()
    tris = np.asarray(mesh.tris, np.int64)
    ke = element_stiffness_matrices(
        torch.from_numpy(mesh.coords), torch.from_numpy(tris), 69e9, 0.33, 0.5
    ).numpy()
    from scipy.sparse import coo_matrix

    dofs = (2 * tris[:, :, None] + np.arange(2)).reshape(-1, 6)
    n2 = 2 * mesh.num_nodes
    k_prog = coo_matrix((ke.ravel(), (np.repeat(dofs, 6, axis=1).ravel(),
                                      np.tile(dofs, (1, 6)).ravel())), shape=(n2, n2))
    k_ref = plane_stress.stiffness_matrix(mesh.coords, tris, 69e9, 0.33, 0.5)
    diff = abs(k_prog.tocsr() - k_ref).max()
    assert diff <= 1e-12 * abs(k_ref).max()


@pytest.mark.parametrize("precision", ["refined", "float32"])
def test_judge_on_the_programs_cpu_solve(precision):
    """The program's CPU solve of a small plate passes the reference's
    judgement when refined to 1e-8, and float32 alone does not."""
    from magnetite_tpu_torch.bc import apply_boundary_conditions
    from magnetite_tpu_torch.config import (BoundaryRegion, BoundaryRule, BoundaryTarget,
                                            ModelMetadata, SolverOptions)
    from magnetite_tpu_torch.fem.solve import compile_problem

    mesh = _plate()
    right = mesh.coords[:, 0] > 1 - 1e-6
    supports = [
        {"name": "left", "region": {"x_max": -1 + 1e-6}, "ux": 0.0, "uy": 0.0},
        {"name": "right", "region": {"x_min": 1 - 1e-6}, "ux": "pull", "fy": "shear"},
    ]
    lc = {"pull": 0.012, "shear": -3e7}
    rules = (
        BoundaryRule("left", BoundaryRegion(x_max=-1 + 1e-6), BoundaryTarget(ux=0.0, uy=0.0)),
        BoundaryRule("right", BoundaryRegion(x_min=1 - 1e-6),
                     BoundaryTarget(ux=0.012, fy=-3e7 / right.sum())),
    )
    bca = apply_boundary_conditions(mesh.coords, rules)
    opts = (SolverOptions(dtype="float32", cg_rtol=1e-8) if precision == "refined"
            else SolverOptions(dtype="float32", cg_rtol=1e-8, refine="off"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # float32 alone clamps the tolerance, and says so
        res = compile_problem(mesh, bca, ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.01), opts,
                              device="cpu").solve()
    material = {"youngs_modulus": 69e9, "poisson_ratio": 0.33, "part_thickness": 0.5}
    got = judge.solve_numbers(mesh.coords, np.asarray(mesh.tris, np.int64), material, supports,
                              lc, res.__dict__)
    if precision == "refined":
        assert got["residual"] <= 1e-8
        assert got["force_gap"] < 1e-10 and got["stress_gap"] < 1e-10
    else:
        assert got["residual"] > 1e-7
        assert got["stress_gap"] > 1e-9


def test_boundary_arrays_later_rules_win_and_spread_forces():
    coords = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.5, 0.5]])
    supports = [
        {"name": "all", "region": {}, "fx": 0.0, "fy": 0.0},
        {"name": "right", "region": {"x_min": 0.9}, "ux": "pull", "fy": "shear"},
    ]
    held, u, f = judge.boundary_arrays(coords, supports, {"pull": 0.5, "shear": 4.0})
    np.testing.assert_array_equal(held, [[0, 0], [1, 0], [1, 0], [0, 0]])
    np.testing.assert_allclose(u[:, 0], [0, 0.5, 0.5, 0])
    np.testing.assert_allclose(f[:, 1], [0, 2.0, 2.0, 0])


def test_mesh_numbers_find_defects():
    mesh = _plate()
    geometry = {"kind": "plate_with_hole", "half_width": 1.0, "hole_radius": 0.25,
                "n_tangential": 16}
    size = {"nodes": 9 * 16, "elements": 2 * 8 * 16}
    tris = np.asarray(mesh.tris, np.int64)
    good = judge.mesh_numbers(mesh.coords, tris, geometry, size)
    assert good["mesh_defects"] == 0 and good["mesh_measure_gap"] < 1e-12
    assert good["mesh_size_gap"] == 0
    assert judge.mesh_numbers(mesh.coords, tris[1:], geometry, size)["mesh_measure_gap"] > 1e-4
    flipped = tris.copy()
    flipped[0] = flipped[0, ::-1]
    assert judge.mesh_numbers(mesh.coords, flipped, geometry, size)["mesh_defects"] >= 1
    # the same domain at half the resolution: sound, but not the stated mesh
    from magnetite_tpu_torch.meshing.generators import plate_with_hole_mesh

    coarse = plate_with_hole_mesh(4, 16)
    got = judge.mesh_numbers(coarse.coords, np.asarray(coarse.tris, np.int64), geometry, size)
    assert got["mesh_defects"] == 0 and got["mesh_measure_gap"] < 1e-12
    assert got["mesh_size_gap"] >= 0.4
    area, perimeter = judge.domain_measures(
        {"kind": "polygons", "loops": [[[0, 0], [3, 0], [3, 1], [0, 1]],
                                       [[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]]]})
    assert area == pytest.approx(2.88) and perimeter == pytest.approx(9.4)
