"""Lane sharding of the four compiled sweeps (`device_mesh=` of
magnetite_tpu_torch/parallel/sweep.py): the batch split into contiguous
chunks of lanes, one per shard, answered in lane order.

Each lane-sharded sweep is held, lane by lane, to the same sweep unsharded
in f64: u within 1e-12 of the lane's max|u|, the residual and rhs norms
within 1e-12 relative. (A chunk's batch reductions run over fewer lanes, so
the answers agree to rounding, not bit for bit.)
"""

import functools

import numpy as np
import pytest
import torch

from magnetite_tpu_torch.errors import InputError
from magnetite_tpu_torch.parallel import sweep as ps
from magnetite_tpu_torch.parallel.pipeline import DeviceMesh, DeviceMesh2D
from tests.torch_cases import jax_plate, to_port
from tests.torch_cases import one_thread  # noqa: F401  (autouse)
from tests.torch_shard_cases import grid_case

MESHES = {"2": DeviceMesh(("cpu",) * 2, "lanes"), "4": DeviceMesh(("cpu",) * 4, "lanes"),
          "2x2": DeviceMesh2D(("cpu",) * 4, (2, 2), ("a", "b"))}
B = 8


def _per_lane(got, want):
    assert tuple(got.u.shape) == tuple(want.u.shape)
    for b in range(want.u.shape[0]):
        scale = float(want.u[b].abs().max())
        assert float((got.u[b] - want.u[b]).abs().max()) <= 1e-12 * scale, f"lane {b}"
    for name in ("residual_norm", "rhs_norm", "von_mises"):
        a, w = getattr(got, name), getattr(want, name)
        assert float((a - w).abs().max()) <= 1e-12 * float(w.abs().max()), name


@functools.lru_cache(maxsize=None)
def _batch(n_nodes, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 2.0, B), rng.uniform(0.5, 2.0, B), rng.uniform(0.5, 2.0, B),
            rng.uniform(50e9, 80e9, B), rng.uniform(0.25, 0.35, B), rng.uniform(0.4, 0.6, B))


def _fields(bca, factors):
    u = np.asarray(bca.u_value)[None] * factors[:, None, None]
    return u, np.zeros_like(u)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_structured_sweeps_sharded_per_lane(mesh_name):
    """compile_sweep and compile_material_sweep on the 17 x 33 rectangle."""
    _, (mesh, bca, md) = grid_case("rect_17x33")
    uf, _, k, e, nu, t = _batch(mesh.num_nodes)
    u, f = _fields(bca, uf)
    dm = MESHES[mesh_name]
    want = ps.compile_sweep(mesh, bca, md, iterations=12, dtype=np.float64,
                            device="cpu").solve(u, f, k)
    sweep = ps.compile_sweep(mesh, bca, md, iterations=12, dtype=np.float64, device_mesh=dm)
    _per_lane(sweep.solve(u, f, k), want)
    assert list(sweep.replicas) == [torch.device("cpu")]  # one per distinct device
    want = ps.compile_material_sweep(mesh, bca, iterations=12, dtype=np.float64,
                                     device="cpu").solve(u, f, e, nu, t)
    got = ps.compile_material_sweep(mesh, bca, iterations=12, dtype=np.float64,
                                    device_mesh=dm).solve(u, f, e, nu, t)
    _per_lane(got, want)


@pytest.mark.parametrize("mesh_name", ["2", "2x2"])
def test_unstructured_sweeps_sharded_per_lane(mesh_name):
    """compile_unstructured_sweep (dense solve() and solve_factors()) and
    compile_unstructured_material_sweep on the h = 0.08 Delaunay plate."""
    mesh, bca, md = to_port(*jax_plate(0.08)[:2], 0.08)
    uf, ff, k, e, nu, t = _batch(mesh.num_nodes, 1)
    u, f = _fields(bca, uf)
    dm = MESHES[mesh_name]
    base = ps.compile_unstructured_sweep(mesh, bca, md, iterations=6, dtype=np.float64,
                                         device="cpu")
    sharded = ps.compile_unstructured_sweep(mesh, bca, md, iterations=6, dtype=np.float64,
                                            device_mesh=dm, amg_setup=base.amg_setup)
    _per_lane(sharded.solve(u, f, k), base.solve(u, f, k))
    _per_lane(sharded.solve_factors(uf, ff, k), base.solve_factors(uf, ff, k))
    base = ps.compile_unstructured_material_sweep(mesh, bca, iterations=6, dtype=np.float64,
                                                  device="cpu")
    sharded = ps.compile_unstructured_material_sweep(
        mesh, bca, iterations=6, dtype=np.float64, device_mesh=dm,
        material_setup=base.material_setup)
    _per_lane(sharded.solve(u, f, e, nu, t), base.solve(u, f, e, nu, t))
    _per_lane(sharded.solve_factors(uf, ff, e, nu, t), base.solve_factors(uf, ff, e, nu, t))


def test_lanes_must_divide():
    """The JAX package's _shard_lanes rule, as a typed error."""
    _, (mesh, bca, md) = grid_case("rect_17x33")
    sweep = ps.compile_sweep(mesh, bca, md, iterations=2, device_mesh=DeviceMesh(("cpu",) * 3))
    u, f = _fields(bca, np.ones(B))
    with pytest.raises(InputError, match="sweep batch of 8 lanes does not divide over 3 devices"):
        sweep.solve(u, f, np.ones(B))
