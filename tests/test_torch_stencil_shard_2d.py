"""The port's rows x cols sharded stencil path (magnetite_tpu_torch/parallel/
stencil_shard.py, 2-D, and the pipeline's kind "stencil2d") against the
JAX package's on the tests' virtual CPU devices.

Meshes of 2 x 2 and 2 x 4 tiles: the wrapped 17 x 32 plate (cols divide)
and the 17 x 33 rectangle (cols padded to a multiple of the col shards).
Bars as tests/test_torch_stencil_shard.py: the halo matvec to 1e-12 of
max|y|, f64 PCG iterations equal to JAX's and u within 1e-10 of max|u|;
the 2-D refined solve (f64 CG around an f32 preconditioner, each package
rounding its own f32) u within 1e-6; the pipeline on the golden bars.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from magnetite_tpu.errors import SolverError as JaxSolverError
from magnetite_tpu.parallel import stencil_shard as jss
from magnetite_tpu_torch.config import SolverOptions
from magnetite_tpu_torch.errors import SolverError
from magnetite_tpu_torch.parallel import stencil_shard as pss
from magnetite_tpu_torch.parallel.dia_shard import ShardVec
from magnetite_tpu_torch.parallel.pipeline import compile_sharded_problem
from tests.torch_cases import one_thread  # noqa: F401  (autouse)
from tests.torch_shard_cases import (
    assert_close_to, cpu_mesh_2d, grid_case, grid_of, jax_mesh,
)

LAYOUTS = [("plate_17x32", (2, 2)), ("rect_17x33", (2, 4))]


@functools.lru_cache(maxsize=None)
def _problems(name, shape, dtype=np.float64):
    (jm, jb, jmd), (pm, pb, pmd) = grid_case(name)
    jp = jss.prepare_sharded_stencil_problem_2d(jm, jb, jmd, jax_mesh(shape, ("rows", "cols")),
                                                dtype=dtype)
    pp = pss.prepare_sharded_stencil_problem_2d(pm, pb, pmd, cpu_mesh_2d(*shape), dtype=dtype)
    return jp, pp


def _tiles(a: np.ndarray, shape) -> ShardVec:
    nr, nc = shape
    rl, cl = a.shape[-2] // nr, a.shape[-1] // nc
    return ShardVec(torch.from_numpy(a[..., i * rl:(i + 1) * rl, j * cl:(j + 1) * cl].copy())
                    for i in range(nr) for j in range(nc))


@pytest.mark.parametrize("name,shape", LAYOUTS)
def test_2d_halo_matvec_matches_jax(name, shape):
    """The padded tiles and K u through the 8-neighbour exchange against
    JAX's make_halo_stencil_operator_2d under shard_map."""
    jp, pp = _problems(name, shape)
    assert grid_of(pp.free_g.shards, shape).shape == np.asarray(jp.free_g).shape
    red = np.asarray(jp.reduced)
    np.testing.assert_allclose(grid_of(pp.reduced, shape), red, rtol=1e-12,
                               atol=1e-12 * np.abs(red).max())
    u = np.random.default_rng(3).standard_normal(np.asarray(jp.free_g).shape)
    spec5 = P(None, None, None, "rows", "cols")
    spec3 = P(None, "rows", "cols")

    def local(st, v):
        return jss.make_halo_stencil_operator_2d(st, "rows", "cols", jp.wrap_cols, "xla")(v)

    jax_mv = jax.jit(jax.shard_map(local, mesh=jp.device_mesh, in_specs=(spec5, spec3),
                                   out_specs=spec3, check_vma=False))
    want = np.asarray(jax_mv(jp.reduced, jax.numpy.asarray(u)))
    op = pss.make_halo_stencil_operator_2d(pp.reduced, shape, pp.wrap_cols)
    assert_close_to(grid_of(op(_tiles(u, shape)).shards, shape), want, 1e-12, "2-D halo matvec")


def test_2d_exchange_corners_and_wrap():
    """Rows first, then cols on the row-extended block: the corner halo of
    tile (1, 1) is tile (0, 0)'s last row's last entry; a wrapped single
    column of tiles is its own neighbour."""
    g = torch.arange(2 * 4 * 6, dtype=torch.float64).reshape(2, 4, 6)
    tiles = [g[:, i * 2:(i + 1) * 2, j * 3:(j + 1) * 3] for i in range(2) for j in range(2)]
    ext = pss.exchange_halo_2d(tiles, (2, 2), False)
    assert torch.equal(ext[3][:, 0, 0], g[:, 1, 2])  # the corner
    assert torch.equal(ext[3][:, 1:-1, 0], g[:, 2:4, 2])  # the left column
    assert torch.equal(ext[0][:, 0], torch.zeros_like(ext[0][:, 0]))
    assert torch.equal(ext[1][:, 1:-1, -1], torch.zeros_like(ext[1][:, 1:-1, -1]))
    wrapped = pss.exchange_halo_2d(tiles, (2, 2), True)
    assert torch.equal(wrapped[1][:, 1:-1, -1], g[:, 0:2, 0])  # the ring
    single = pss.exchange_halo_2d([g], (1, 1), True)[0]
    assert torch.equal(single[:, 1:-1, 0], g[:, :, -1])
    assert torch.equal(single[:, 1:-1, -1], g[:, :, 0])
    assert pss._ring_pairs(3, True, True) == [(0, 1), (1, 2), (2, 0)]


@pytest.mark.parametrize("name,shape", LAYOUTS)
@pytest.mark.parametrize("precond", ["multigrid", "none"])
def test_2d_sharded_pcg_matches_jax(name, shape, precond):
    jp, pp = _problems(name, shape)
    want, _ = jss.sharded_stencil_pcg_solve_2d(jp, rtol=1e-10, preconditioner=precond,
                                               impl="xla")
    got, _ = pss.sharded_stencil_pcg_solve_2d(pp, rtol=1e-10, preconditioner=precond)
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    assert_close_to(grid_of(got.x.shards, shape), np.asarray(want.x), 1e-10, "u")


@pytest.mark.parametrize("precond", ["auto", "none"])
def test_2d_refined_solve_matches_jax(precond):
    shape = (2, 2)
    jp, pp = _problems("plate_17x32", shape)
    want, _ = jss.sharded_stencil_refined_solve_2d(jp, rtol=1e-9, preconditioner=precond,
                                                   impl="xla")
    got, _ = pss.sharded_stencil_refined_solve_2d(pp, rtol=1e-9, preconditioner=precond)
    assert bool(got.converged)
    # f64 CG: without a preconditioner (~370 iterations) the two packages'
    # summation orders part the counts by a few
    assert abs(int(got.iterations) - int(want.iterations)) <= max(1, int(want.iterations) // 100)
    assert_close_to(grid_of(got.x.shards, shape), np.asarray(want.x), 1e-6, "refined u")
    _, pp32 = _problems("plate_17x32", shape, np.float32)
    with pytest.raises(SolverError, match="needs an f64 problem"):
        pss.sharded_stencil_refined_solve_2d(pp32)
    with pytest.raises(SolverError, match="prepared 2D"):
        pss.sharded_stencil_pcg_solve(pp32)


def test_2d_wrapped_cols_must_divide():
    """The JAX package's typed error: 32 wrapped cols over 3 col shards."""
    (jm, jb, jmd), (pm, pb, pmd) = grid_case("plate_17x32")
    with pytest.raises(JaxSolverError, match="must divide evenly"):
        jss.prepare_sharded_stencil_problem_2d(jm, jb, jmd, jax_mesh((1, 3), ("rows", "cols")))
    with pytest.raises(SolverError, match=r"wrapped cols \(32\) must divide evenly over 3"):
        pss.prepare_sharded_stencil_problem_2d(pm, pb, pmd, cpu_mesh_2d(1, 3))
    with pytest.raises(SolverError, match="must divide evenly"):
        compile_sharded_problem(pm, pb, pmd, device_mesh=cpu_mesh_2d(2, 3))


@pytest.mark.parametrize("name,shape,dtype", [("plate_17x32", (2, 2), "float64"),
                                              ("rect_17x33", (2, 4), "float32")])
def test_compile_sharded_problem_2d_matches_jax(name, shape, dtype):
    """The pipeline over a 2-D mesh end to end (solve, forces, the tiles'
    stress recovery over one halo ring) against the JAX package's kind
    "stencil2d", golden bars; f64, and f32 at rtol 1e-8 (refined)."""
    from magnetite_tpu.config import SolverOptions as JaxOptions
    from magnetite_tpu.parallel.pipeline import compile_sharded_problem as jax_compile

    (jm, jb, jmd), (pm, pb, pmd) = grid_case(name)
    jc = jax_compile(jm, jb, jmd, JaxOptions(dtype=dtype, cg_rtol=1e-8),
                     device_mesh=jax_mesh(shape, ("rows", "cols")))
    want = jc.solve()
    compiled = compile_sharded_problem(pm, pb, pmd,
                                       SolverOptions(dtype=dtype, cg_rtol=1e-8),
                                       device_mesh=cpu_mesh_2d(*shape))
    assert (jc.kind, compiled.kind) == ("stencil2d", "stencil2d")
    assert compiled.refine is (dtype == "float32")
    assert compiled.timings["operator"] == "stencil-sharded-2d"
    assert compiled.timings["shard_layout"] == "x".join(map(str, shape))
    got = compiled.solve()
    assert got.residual_rel <= 1e-8
    if dtype == "float64":
        assert got.iterations == want.iterations
    for field, tol in (("u", 1e-6), ("f", 1e-5), ("sigma", 1e-5), ("stress", 1e-5),
                       ("von_mises", 1e-5)):
        assert_close_to(getattr(got, field), getattr(want, field), tol, f"{dtype} {field}")
