"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

The repo's arbitrary-geometry case (examples/unstructured_plate.py): a 3x1
plate with a 0.4x0.3 hole, left edge fixed, right edge pulled by
ux = 0.01 with fy = 0. Meshes come from the JAX package's host mesher and
cross to the port as numpy arrays; inputs are drawn from
np.random.default_rng(seed).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

OUTER = [[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]]
HOLE = [[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]]
E_MOD, NU, THICK = 69e9, 0.33, 0.5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Single-threaded BLAS and PyTorch while a port test module runs.

    The suite runs several pytest workers side by side on the CPU, and a
    multi-threaded OpenBLAS in each of them spins one thread per core:
    measured, that made these small tests ~10x slower. Import this fixture
    into a test module to apply it (it is autouse there)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # not installed: leave the pools as they are
        limits = None
    else:
        import scipy.linalg  # noqa: F401  (loads scipy's own OpenBLAS first)

        limits = threadpool_limits(limits=1)
    try:
        yield
    finally:
        if limits is not None:
            limits.restore_original_limits()
        torch.set_num_threads(old)


def plate_rules(pkg):
    """The plate's two boundary rules, built with `pkg`'s config classes."""
    c = pkg.config
    return (
        c.BoundaryRule("left", c.BoundaryRegion(x_max=1e-6),
                       c.BoundaryTarget(ux=0.0, uy=0.0)),
        c.BoundaryRule("right", c.BoundaryRegion(x_min=3.0 - 1e-6),
                       c.BoundaryTarget(ux=0.01, fy=0.0)),
    )


def jax_plate(h: float):
    """(mesh, bca, metadata) of the plate from the JAX package's mesher."""
    import magnetite_tpu.config
    from magnetite_tpu.bc import apply_boundary_conditions
    from magnetite_tpu.meshing.delaunay_backend import triangulate

    mesh = triangulate([np.array(OUTER), np.array(HOLE)], 0.0, h)
    bca = apply_boundary_conditions(mesh.coords, plate_rules(magnetite_tpu))
    md = magnetite_tpu.config.ModelMetadata(E_MOD, NU, THICK, 0.0, h)
    return mesh, bca, md


def to_port(mesh, bca, h: float):
    """The same case as the port's own types (numpy arrays only)."""
    import magnetite_tpu_torch.config
    from magnetite_tpu_torch import interop

    return (
        interop.mesh_from_arrays(mesh.coords, mesh.tris),
        interop.bca_from_arrays(bca.u_known, bca.u_value, bca.f_value),
        magnetite_tpu_torch.config.ModelMetadata(E_MOD, NU, THICK, 0.0, h),
    )


def shuffled(mesh, bca, seed: int = 0):
    """The mesh with its nodes in a random order (so it misses the band
    format and must be renumbered)."""
    from magnetite_tpu.bc import BCArrays
    from magnetite_tpu.meshing.core import Mesh

    perm = np.random.default_rng(seed).permutation(mesh.num_nodes)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return (
        Mesh(coords=mesh.coords[perm], tris=inv[mesh.tris].astype(np.int32)),
        BCArrays(u_known=bca.u_known[perm], u_value=bca.u_value[perm],
                 f_value=bca.f_value[perm]),
    )


def write_case(dirname: str, h: float) -> list:
    """input.json + outer.csv + hole.csv, as a user of either CLI writes them."""
    case = {
        "metadata": {
            "part_thickness": THICK, "material_elasticity": E_MOD,
            "poisson_ratio": NU, "characteristic_length_min": 0.0,
            "characteristic_length_max": h,
        },
        "boundary_conditions": {
            "left": {"region": {"x_target_max": 1e-6},
                     "targets": {"ux": 0.0, "uy": 0.0}},
            "right": {"region": {"x_target_min": 3.0 - 1e-6},
                      "targets": {"ux": 0.01, "fy": 0.0}},
        },
    }
    paths = [os.path.join(dirname, n) for n in ("input.json", "outer.csv", "hole.csv")]
    with open(paths[0], "w") as f:
        json.dump(case, f)
    for path, loop in ((paths[1], OUTER), (paths[2], HOLE)):
        with open(path, "w") as f:
            f.write("x,y\n" + "".join(f"{x!r},{y!r}\n" for x, y in loop))
    return paths


def random_bands(n: int, offsets, m: int, seed: int) -> np.ndarray:
    """Random DIA bands [D, m, m, n], zero wherever n + offset leaves [0, n)
    (the invariant every assembled operator holds)."""
    rng = np.random.default_rng(seed)
    bands = rng.standard_normal((len(offsets), m, m, n))
    rows = np.arange(n)
    for k, off in enumerate(offsets):
        bad = (rows + off < 0) | (rows + off >= n)
        bands[k, :, :, bad] = 0.0
    return bands
