"""The port's node-sharded DIA + AMG solver (magnetite_tpu_torch/parallel/
dia_shard.py) against the JAX package's (magnetite_tpu/parallel/
dia_shard.py) on the same inputs.

The JAX side runs on the tests' virtual CPU devices (tests/conftest.py:
eight); the port stands opposite it with the same shard count on one
repeated CPU device (`DeviceMesh(("cpu",) * S)`), its halo slabs real
copies between the shards' tensors, its matvecs the kernels' plain
versions.

Bars: the halo matvec within 1e-12 of max|y| (the same products, only
the summation order differs); solves on the golden bars
(tests/test_golden.py:48-55: displacements within 1e-6 of max|u|, K u
within 1e-5 of its max) at rtol 1e-10 and iterations within +-1 (both
refined: f64 CG around the f32 V(3,3)-cycle, the scheme the two packages
share).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import magnetite_tpu.parallel.dia_shard as jds
from magnetite_tpu_torch.errors import SolverError
from magnetite_tpu_torch.parallel import dia_shard as tds
from magnetite_tpu_torch.parallel.pipeline import DeviceMesh
from tests.torch_cases import jax_plate, shuffled, to_port
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

H = 0.04  # 2,179 nodes: the AMG hierarchy coarsens (2N > 3,072)


@functools.lru_cache(maxsize=None)
def _plate(h=H, shuffle=False):
    mesh, bca, md = jax_plate(h)
    if shuffle:
        mesh, bca = shuffled(mesh, bca)
    return (mesh, bca, md), to_port(mesh, bca, h)


def _jax_mesh(s):
    return jax.make_mesh((s,), ("nodes",), devices=jax.devices()[:s])


@functools.lru_cache(maxsize=None)
def _problems(s, h=H, shuffle=False, max_diags=64):
    (mesh, bca, md), (pmesh, pbca, pmd) = _plate(h, shuffle)
    jp = jds.prepare_sharded_dia_problem(mesh, bca, md, _jax_mesh(s), dtype=np.float64,
                                         max_diags=max_diags)
    tp = tds.prepare_sharded_dia_problem(pmesh, pbca, pmd, DeviceMesh(("cpu",) * s),
                                         dtype=np.float64, max_diags=max_diags)
    return jp, tp


@functools.lru_cache(maxsize=None)
def _jax_solve(s, h=H, shuffle=False, max_diags=64, amg_sweeps=0, df="off", rtol=1e-10):
    jp, _ = _problems(s, h, shuffle, max_diags)
    res, ku = jds.sharded_dia_pcg_solve(jp, rtol=rtol, refined=True, amg_sweeps=amg_sweeps,
                                        df_matvec=df)
    return np.asarray(res.x), np.asarray(ku), int(res.iterations)


def _port_field(problem, v):
    """A [2, n] host array as the problem's padded ShardVec."""
    nl = problem.local_n
    padded = np.zeros((2, nl * len(problem.devices)))
    padded[:, : v.shape[1]] = v
    return tds.ShardVec(
        torch.from_numpy(padded[:, s * nl:(s + 1) * nl].copy())
        for s in range(len(problem.devices))
    )


def _assert_solve(tp, jax_out, n, **kw):
    res, ku, bnorm = tds.sharded_dia_pcg_solve(tp, rtol=1e-10, refined=True, **kw)
    x_j, ku_j, it_j = jax_out
    assert bool(res.converged)
    assert abs(int(res.iterations) - it_j) <= 1
    x, kx = res.x.gather(n), ku.gather(n)
    assert np.abs(x - x_j[:, :n]).max() <= 1e-6 * np.abs(x_j[:, :n]).max()
    assert np.abs(kx - ku_j[:, :n]).max() <= 1e-5 * np.abs(ku_j[:, :n]).max()
    assert float(bnorm) > 0
    return res


@pytest.mark.parametrize("s", [2, 8])
def test_halo_dia_matvec_matches_jax(s):
    jp, tp = _problems(s)
    n = tp.n_nodes
    assert tp.kind == jp.kind == "dia" and tp.perm is None and jp.perm is None
    assert tp.offsets == jp.offsets and tp.halo == jp.halo
    assert tp.local_n * s == jp.free.shape[1] and len(tp.bands) == s
    assert tuple(tp.bands[0].shape) == (len(tp.offsets), 2, 2, tp.local_n + 2 * tp.halo)
    v = np.random.default_rng(0).standard_normal((2, n))
    padded = np.zeros((2, jp.free.shape[1]))
    padded[:, :n] = v
    dm = jp.device_mesh

    def local_mv(bands, u):
        return jds.make_halo_dia_operator(bands, jp.offsets, jp.halo, "nodes")(u)

    want = np.asarray(jax.jit(jax.shard_map(
        local_mv, mesh=dm, in_specs=(P(None, None, None, "nodes"), P(None, "nodes")),
        out_specs=P(None, "nodes"), check_vma=False,
    ))(jp.bands, jax.device_put(padded, NamedSharding(dm, P(None, "nodes")))))[:, :n]
    got = tds.raw_operator(tp)(_port_field(tp, v)).gather(n)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_exchange_halo_and_shard_sum():
    shards = [torch.arange(6, dtype=torch.float64).reshape(2, 3) + 10 * s for s in range(3)]
    ext = tds.exchange_halo(shards, 2)
    assert [tuple(e.shape) for e in ext] == [(2, 7)] * 3
    assert ext[0][:, :2].abs().sum() == 0 and ext[2][:, -2:].abs().sum() == 0
    assert torch.equal(ext[1][:, :2], shards[0][:, -2:])
    assert torch.equal(ext[1][:, -2:], shards[2][:, :2])
    total = tds.shard_sum([torch.tensor(1.0), torch.tensor(2.0), torch.tensor(4.0)],
                          [torch.device("cpu")] * 3)
    assert list(total) == [torch.device("cpu")] and float(total[torch.device("cpu")]) == 7.0


def test_sharded_amg_solve_matches_jax():
    s = 8
    jp, tp = _problems(s)
    assert tp.amg_setup is not None and len(tp.amg_setup.level_sizes) > 1
    amg = tp.amg_in(torch.float32)
    # the replicated levels are uploaded once per distinct device
    assert list(amg.coarse) == [torch.device("cpu")]
    assert len(amg.p_cols) == s and amg.n1 == tp.amg_setup.level_sizes[1][0]
    _assert_solve(tp, _jax_solve(s), tp.n_nodes)


def test_sharded_solve_renumbers_a_shuffled_mesh():
    s = 2
    jp, tp = _problems(s, shuffle=True)
    assert tp.perm is not None and np.array_equal(tp.perm, jp.perm)
    _assert_solve(tp, _jax_solve(s, shuffle=True), tp.n_nodes)


def test_refined_requires_f64():
    (_, _, _), (pmesh, pbca, pmd) = _plate()
    tp = tds.prepare_sharded_dia_problem(pmesh, pbca, pmd, DeviceMesh(("cpu",) * 2),
                                         dtype=np.float32)
    with pytest.raises(SolverError, match="needs dtype=np.float64"):
        tds.sharded_dia_pcg_solve(tp, refined=True)


def test_sharded_amg_sweeps_override():
    """amg_sweeps reaches the sharded V-cycle: V(1, 1) pinned under
    refinement takes more iterations than the auto V(3, 3), in both
    packages alike."""
    s = 2
    _, tp = _problems(s)
    auto = _assert_solve(tp, _jax_solve(s), tp.n_nodes)
    pinned = _assert_solve(tp, _jax_solve(s, amg_sweeps=1), tp.n_nodes, amg_sweeps=1)
    assert int(pinned.iterations) > int(auto.iterations)


def test_ell_fallback_kind_matches_jax():
    """A budget of 4 band offsets cannot hold the plate even renumbered:
    both packages shard the block-ELL gather over the same halo."""
    s = 2
    jp, tp = _problems(s, max_diags=4)
    assert tp.kind == jp.kind == "ell" and tp.halo == jp.halo
    assert tp.ell_cols[0].shape[-1] == tp.local_n + 2 * tp.halo
    _assert_solve(tp, _jax_solve(s, max_diags=4), tp.n_nodes)


def test_df_matvec_on_matches_jax_interpret():
    """df_matvec="on": the port's plain double-float halo operator against
    the JAX package's interpret-mode kernel at two shards (the JAX
    kernel's size gate wants ~4k nodes per shard: the h = 0.02 plate)."""
    s, h = 2, 0.02
    jp, tp = _problems(s, h)
    assert jds.resolve_df_impl(jp, True, 1e-8, "interpret") == "interpret"
    assert tds.resolve_df_impl(tp, True, 1e-8, "on") == "plain"
    assert tds.resolve_df_impl(tp, True, 1e-8, "off") == ""
    assert tds.resolve_df_impl(tp, False, 1e-8, "on") == ""
    n = tp.n_nodes
    v = np.random.default_rng(3).standard_normal((2, n))
    u = _port_field(tp, v)
    want = tds.raw_operator(tp)(u).gather(n)
    got = tds.make_halo_df_dia_operator(tp.bands_hl(), tp.offsets, tp.halo)(u).gather(n)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    x_j, _, it_j = _jax_solve(s, h, df="interpret", rtol=1e-8)
    res, _, _ = tds.sharded_dia_pcg_solve(tp, rtol=1e-8, refined=True, df_matvec="on")
    assert bool(res.converged) and abs(int(res.iterations) - it_j) <= 1
    x = res.x.gather(n)
    assert np.abs(x - x_j[:, :n]).max() <= 1e-6 * np.abs(x_j[:, :n]).max()


def test_shard_vec_arithmetic_maps_over_shards():
    a = tds.ShardVec([torch.ones(2, 3), 2 * torch.ones(2, 3)])
    b = 1.0 - torch.tensor(0.5) * a + a / 2
    assert torch.equal(b.shards[1], torch.ones(2, 3))
    w = torch.where(torch.tensor(False), a, b)
    assert isinstance(w, tds.ShardVec) and torch.equal(w.shards[0], torch.ones(2, 3))
    z = torch.zeros_like(a)
    assert isinstance(z, tds.ShardVec) and float(tds.shard_dot(a, a)) == 30.0
    assert float(tds.shard_dot(z, a)) == 0.0 and a.to(torch.float64).dtype == torch.float64
    with pytest.raises(TypeError):
        torch.sum(a)
