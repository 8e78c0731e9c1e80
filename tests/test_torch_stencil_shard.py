"""The port's row-sharded stencil path (magnetite_tpu_torch/parallel/
stencil_shard.py, 1-D) against the JAX package's (magnetite_tpu/parallel/
stencil_shard.py) on the tests' virtual CPU devices.

The JAX side shards over S virtual devices; the port stands opposite with
S shards of one repeated CPU device. The JAX package's stencil operator runs
its XLA formulation (the CPU's), the port's the plain version of its
kernel. Bars: the halo matvec to 1e-12 of max|y|; f64 PCG iterations equal
to the JAX package's and u within 1e-10 of max|u|; the f64 / f32
refinement (f32 inner solves in both packages, each with its own f32
rounding) u within 1e-6 of max|u| and the true residual at rtol.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from magnetite_tpu.parallel import stencil_shard as jss
from magnetite_tpu_torch.config import SolverOptions
from magnetite_tpu_torch.errors import SolverError
from magnetite_tpu_torch.parallel import stencil_shard as pss
from magnetite_tpu_torch.parallel.dia_shard import ShardVec
from magnetite_tpu_torch.parallel.pipeline import compile_sharded_problem
from tests.torch_cases import one_thread  # noqa: F401  (autouse)
from tests.torch_shard_cases import (
    assert_close_to, cpu_mesh, grid_case, grid_of, jax_mesh,
)


@functools.lru_cache(maxsize=None)
def _problems(name, s, dtype=np.float64):
    (jm, jb, jmd), (pm, pb, pmd) = grid_case(name)
    jp = jss.prepare_sharded_stencil_problem(jm, jb, jmd, jax_mesh((s,), ("rows",)), dtype=dtype)
    pp = pss.prepare_sharded_stencil_problem(pm, pb, pmd, cpu_mesh(s), dtype=dtype)
    return jp, pp


@pytest.mark.parametrize("name,s", [("plate_17x32", 2), ("plate_17x32", 8),
                                    ("rect_17x33", 4), ("rect_17x33", 8)])
def test_halo_matvec_matches_jax(name, s):
    """The layout (padded rows with identity stencil rows) and K u through
    the row-halo exchange, wrapped and unwrapped, against JAX's
    halo_stencil_matvec under shard_map."""
    jp, pp = _problems(name, s)
    red = np.asarray(jp.reduced)
    np.testing.assert_allclose(grid_of(pp.reduced, pp.shape), red, rtol=1e-12,
                               atol=1e-12 * np.abs(red).max())
    np.testing.assert_array_equal(grid_of(pp.free_g.shards, pp.shape), np.asarray(jp.free_g))
    u = np.random.default_rng(s).standard_normal(np.asarray(jp.free_g).shape)
    spec5, spec3 = P(None, None, None, "rows", None), P(None, "rows", None)
    jax_mv = jax.jit(jax.shard_map(
        functools.partial(jss.halo_stencil_matvec, axis="rows", wrap_cols=jp.wrap_cols),
        mesh=jp.device_mesh, in_specs=(spec5, spec3), out_specs=spec3))
    want = np.asarray(jax_mv(jp.reduced, jax.numpy.asarray(u)))
    rl = pp.reduced[0].shape[-2]
    uv = ShardVec(torch.from_numpy(u[:, i * rl:(i + 1) * rl].copy()) for i in range(s))
    got = grid_of(pss.halo_stencil_matvec(pp.reduced, uv, pp.wrap_cols).shards, pp.shape)
    assert_close_to(got, want, 1e-12, "halo matvec")
    # exchange_halo_rows: the neighbours' edge rows, zeros at the grid's ends
    ext = pss.exchange_halo_rows(list(uv.shards))
    assert torch.equal(ext[0][:, 0], torch.zeros_like(ext[0][:, 0]))
    assert torch.equal(ext[1][:, 0], uv.shards[0][:, -1])
    assert torch.equal(ext[0][:, -1], uv.shards[1][:, 0])


@pytest.mark.parametrize("name", ["plate_17x32", "rect_17x33"])
@pytest.mark.parametrize("precond", ["multigrid", "block_jacobi", "none"])
def test_sharded_pcg_matches_jax(name, precond):
    s = 4
    jp, pp = _problems(name, s)
    want, _ = jss.sharded_stencil_pcg_solve(jp, rtol=1e-10, preconditioner=precond,
                                            impl="xla")
    got, ku = pss.sharded_stencil_pcg_solve(pp, rtol=1e-10, preconditioner=precond)
    assert bool(got.converged) and int(got.iterations) == int(want.iterations)
    assert_close_to(grid_of(got.x.shards, pp.shape), np.asarray(want.x), 1e-10, "u")
    # ku = K x, the raw operator
    assert_close_to(grid_of(ku.shards, pp.shape),
                    grid_of(pss.halo_stencil_matvec(pp.raw, got.x, pp.wrap_cols).shards,
                            pp.shape), 1e-12, "ku")


def test_sharded_multigrid_iterations_do_not_depend_on_the_shards():
    """The sharded V-cycle is one V-cycle whatever S: the same iterations and
    answer at S = 1, 2, 8; auto is multigrid on a grid that coarsens, and
    the replicated coarse levels and the padded stencils are built once per
    problem, and a second solve reuses them."""
    runs = []
    for s in (1, 2, 8):
        _, pp = _problems("plate_17x32", s)
        res, _ = pss.sharded_stencil_pcg_solve(pp, rtol=1e-10)
        runs.append((int(res.iterations), grid_of(res.x.shards, pp.shape)[:, :17]))
        f64 = torch.float64
        assert sorted(pp.cache, key=str) == [
            ("coarse", f64), ("padded", "raw", f64), ("padded", "reduced", f64)]
        made = dict(pp.cache)
        again, _ = pss.sharded_stencil_pcg_solve(pp, rtol=1e-10)
        assert int(again.iterations) == runs[-1][0]
        assert all(pp.cache[k] is v for k, v in made.items()) and len(pp.cache) == len(made)
    assert runs[0][0] == runs[1][0] == runs[2][0]
    for _, u in runs[1:]:
        assert_close_to(u, runs[0][1], 1e-10, "u across S")


@pytest.mark.parametrize("precond", ["auto", "none"])
def test_sharded_refined_solve_matches_jax(precond):
    """f64 outer, f32 inner per shard (multigrid, and plain CG: JAX's
    tests/test_stencil_shard.py:453), against the JAX package's refined
    solve."""
    s = 2
    jp, pp = _problems("rect_17x33", s)
    want, _ = jss.sharded_stencil_refined_solve(jp, rtol=1e-8, preconditioner=precond,
                                                impl="xla")
    info = {}
    got, _ = pss.sharded_stencil_refined_solve(pp, rtol=1e-8, preconditioner=precond, info=info)
    assert bool(got.converged) and bool(want.converged)
    assert info["refine_outer"] >= 2
    assert int(got.iterations) == sum(int(k) for k in info["refine_inner"])
    # the inner f32 solves round differently in the two packages
    assert abs(int(got.iterations) - int(want.iterations)) <= 2 * info["refine_outer"]
    assert_close_to(grid_of(got.x.shards, pp.shape), np.asarray(want.x), 1e-6, "refined u")
    # the true f64 residual of the port's answer
    op = pss.halo_operator(pp)
    b = pss._rhs(pss.halo_operator(pp, "raw"), pp)
    r = b - op(got.x)
    rel = np.sqrt(sum(float((t * t).sum()) for t in r.shards)
                  / sum(float((t * t).sum()) for t in b.shards))
    assert rel <= 1e-8


def test_sharded_refined_requires_f64_and_f32_rtol_clamps(capsys):
    _, pp32 = _problems("rect_17x33", 2, np.float32)
    with pytest.raises(SolverError, match="needs an f64 problem"):
        pss.sharded_stencil_refined_solve(pp32)
    res, _ = pss.sharded_stencil_pcg_solve(pp32, rtol=1e-9)
    assert "below the f32 floor; clamping" in capsys.readouterr().err
    assert bool(res.converged)
    with pytest.raises(SolverError, match="prepared 1D"):
        pss.sharded_stencil_pcg_solve_2d(pp32)


@pytest.mark.parametrize("dtype,refine", [("float64", False), ("float32", True)])
def test_compile_sharded_problem_stencil_matches_jax(dtype, refine):
    """The pipeline end to end (solve, force and stress recovery) on a
    coarsenable grid over 4 row shards against the JAX package's kind
    "stencil", golden bars (tests/test_golden.py:48-55); f32 with rtol 1e-8
    engages the refinement in both."""
    from magnetite_tpu.config import SolverOptions as JaxOptions
    from magnetite_tpu.parallel.pipeline import compile_sharded_problem as jax_compile

    s = 4
    (jm, jb, jmd), (pm, pb, pmd) = grid_case("plate_17x32")
    jc = jax_compile(jm, jb, jmd, JaxOptions(dtype=dtype, cg_rtol=1e-8),
                     device_mesh=jax_mesh((s,), ("shard",)))
    want = jc.solve()
    compiled = compile_sharded_problem(pm, pb, pmd, SolverOptions(dtype=dtype, cg_rtol=1e-8),
                                       device_mesh=cpu_mesh(s))
    assert (jc.kind, compiled.kind, compiled.preconditioner) == ("stencil", "stencil",
                                                                 "multigrid")
    assert compiled.refine is refine and compiled.timings["shards"] == s
    got = compiled.solve()
    assert got.residual_rel <= 1e-8
    if not refine:
        assert got.iterations == want.iterations
    for field, tol in (("u", 1e-6), ("f", 1e-5), ("sigma", 1e-5), ("stress", 1e-5),
                       ("von_mises", 1e-5)):
        assert_close_to(getattr(got, field), getattr(want, field), tol, field)
