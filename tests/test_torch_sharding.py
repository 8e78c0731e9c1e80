"""The port's all-gather block-ELL path (magnetite_tpu_torch/parallel/
sharding.py) against the JAX package's (magnetite_tpu/parallel/
sharding.py) on the tests' virtual CPU devices, the ELL kernel's plain
version with a gathered field longer than its rows, and the port's
`dryrun_multichip` on repeated CPU devices.

Bars: f64 block-Jacobi PCG iterations within one of the JAX package's
(~200 steps, where summation order moves the crossing) and u within 1e-9
of max|u|; the batch x rows sweep's lanes within 1e-10 of max|u| of
JAX's (400 fixed iterations in both, f64) and of the same fixed-iteration
PCG run one lane at a time through the single-vector ELL path.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from magnetite_tpu.parallel import sharding as jsh
from magnetite_tpu_torch.errors import InputError
from magnetite_tpu_torch.kernels.ell_kernel import ell_matvec_t, ell_matvec_t_plain
from magnetite_tpu_torch.kernels.lane_ell_kernel import lane_ell_matvec
from magnetite_tpu_torch.parallel import sharding as psh
from magnetite_tpu_torch.parallel.pipeline import DeviceMesh, DeviceMesh2D
from tests.torch_cases import jax_plate, to_port
from tests.torch_cases import one_thread  # noqa: F401  (autouse)
from tests.torch_shard_cases import assert_close_to, jax_mesh


@functools.lru_cache(maxsize=None)
def _plate(h=0.1):
    mesh, bca, md = jax_plate(h)
    return (mesh, bca, md), to_port(mesh, bca, h)


@pytest.mark.parametrize("s", [2, 8])
def test_sharded_pcg_solve_matches_jax(s):
    """Rows padded to a multiple of S (431 nodes: 432 over 2 and 8 shards)."""
    (mesh, bca, md), (pmesh, pbca, pmd) = _plate()
    jp = jsh.prepare_sharded_problem(mesh, bca, md, jax_mesh((s,), ("rows",)), dtype=np.float64)
    want = jsh.sharded_pcg_solve(jp, rtol=1e-10)
    pp = psh.prepare_sharded_problem(pmesh, pbca, pmd, DeviceMesh(("cpu",) * s, "rows"),
                                     dtype=np.float64)
    assert pp.n_pad == np.asarray(jp.free).shape[0] and pp.n_nodes == mesh.num_nodes
    np.testing.assert_allclose(pp.free.gather().T, np.asarray(jp.free))
    diag_inv = np.concatenate([d.numpy() for d in pp.diag_inv], axis=-1).transpose(2, 0, 1)
    assert_close_to(diag_inv, np.asarray(jp.diag_inv), 1e-12, "block-Jacobi inverse")
    got = psh.sharded_pcg_solve(pp, rtol=1e-10)
    # ~200 block-Jacobi steps: the packages' summation orders (JAX's
    # assembly an einsum, the port's the host C++) may move the crossing by one
    assert bool(got.converged) and abs(int(got.iterations) - int(want.iterations)) <= 1
    assert_close_to(got.x.gather().T, np.asarray(want.x), 1e-9, "u")


def test_sharded_batch_pcg_solve_matches_jax():
    """Batch x rows over a 2 x 4 mesh (tests/test_parallel.py's case): lanes
    scaled 1..4, 400 fixed iterations."""
    from magnetite_tpu.meshing import generators as jgen
    from magnetite_tpu_torch.meshing import generators as pgen

    mesh = jgen.rect_mesh(9, 5, width=2.0)
    base = jgen.tensile_bcs_for_rect(mesh.coords, pull=0.01)
    md = _plate()[0][2]
    jp = jsh.prepare_sharded_problem(mesh, base, md, jax_mesh((2, 4), ("batch", "rows")),
                                     axis="rows", dtype=np.float64)
    pmesh = pgen.rect_mesh(9, 5, width=2.0)
    pp = psh.prepare_sharded_problem(pmesh, pgen.tensile_bcs_for_rect(pmesh.coords, pull=0.01),
                                     _plate()[1][2],
                                     DeviceMesh2D(("cpu",) * 8, (2, 4), ("batch", "rows")),
                                     axis="rows", dtype=np.float64)
    lanes = 4
    u_fixed = np.tile(np.asarray(jp.u_fixed)[None], (lanes, 1, 1))
    u_fixed *= (1.0 + np.arange(lanes))[:, None, None]
    f_applied = np.zeros_like(u_fixed)
    want = np.asarray(jsh.sharded_batch_pcg_solve(jp, jax.numpy.asarray(u_fixed),
                                                  jax.numpy.asarray(f_applied), iterations=400))
    got = psh.sharded_batch_pcg_solve(pp, u_fixed, f_applied, iterations=400)
    assert tuple(got.shape) == want.shape
    for i in range(lanes):
        assert_close_to(got[i].numpy(), want[i], 1e-10, f"lane {i}")
    with pytest.raises(InputError, match="does not divide over 2 batch shards"):
        psh.sharded_batch_pcg_solve(pp, u_fixed[:3], f_applied[:3])


def test_ell_kernel_takes_a_longer_field():
    """ell_matvec_t with u [2, N_u], N_u > N: a shard's rows against the whole
    gathered field (the plain version here; the CUDA kernel on the card,
    tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(5)
    k, n, n_u = 5, 40, 160
    data = torch.from_numpy(rng.standard_normal((k, 2, 2, n)))
    cols = torch.from_numpy(rng.integers(0, n_u, (k, n)).astype(np.int32))
    u = torch.from_numpy(rng.standard_normal((2, n_u)))
    got = ell_matvec_t(data, cols, u)
    want = np.einsum("kijn,jkn->in", data.numpy(), u.numpy()[:, cols.numpy().astype(np.int64)])
    assert tuple(got.shape) == (2, n)
    assert_close_to(got.numpy(), want, 1e-14, "ELL with N_u > N")
    assert torch.equal(got, ell_matvec_t_plain(data, cols, u))


def test_lane_ell_kernel_takes_a_longer_field():
    """lane_ell_matvec with u [2, N_u, B], N_u > N: a shard's rows against
    the gathered lane fields of the batch solve (the plain version here;
    the CUDA kernel on the card, tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(6)
    n, w, n_u, nb = 40, 5, 160, 3
    ell = torch.from_numpy(rng.standard_normal((n, w, 2, 2)))
    cols = torch.from_numpy(rng.integers(0, n_u, (n, w)).astype(np.int32))
    u = torch.from_numpy(rng.standard_normal((2, n_u, nb)))
    got = lane_ell_matvec(ell, cols, u)
    want = np.einsum("nkij,jnkb->inb", ell.numpy(), u.numpy()[:, cols.numpy().astype(np.int64)])
    assert tuple(got.shape) == (2, n, nb)
    assert_close_to(got.numpy(), want, 1e-14, "lane ELL with N_u > N")


@pytest.mark.parametrize("mesh_shape", [(1, 3), (2, 2)], ids=["1x3", "2x2"])
def test_batch_lanes_match_one_lane_solves(mesh_shape):
    """Each lane of the batch solve (lane fields through the lane ELL
    kernel's plain version, per-lane alpha and beta) against the same
    fixed-iteration PCG run on that lane alone through the single-vector
    ELL path, to 1e-10 of max|u| (f64, 300 iterations, lanes scaled
    apart so that no two lanes' iterates coincide)."""
    from magnetite_tpu_torch.fem.cg import pcg_fixed_iterations
    from magnetite_tpu_torch.fem.operator import make_constrained_operator, reduced_rhs
    from magnetite_tpu_torch.parallel.dia_shard import ShardVec, shard_dot

    _, (pmesh, pbca, pmd) = _plate()
    dm = DeviceMesh2D(("cpu",) * (mesh_shape[0] * mesh_shape[1]), mesh_shape, ("batch", "rows"))
    pp = psh.prepare_sharded_problem(pmesh, pbca, pmd, dm, dtype=np.float64)
    lanes = 2 * mesh_shape[0]
    rng = np.random.default_rng(8)
    u_fixed = pp.u_fixed.gather().T[None] * rng.uniform(0.5, 2.0, lanes)[:, None, None]
    f_applied = rng.standard_normal((lanes, pp.n_pad, 2)) * 1e3
    f_applied[:, pmesh.num_nodes:] = 0.0
    got = psh.sharded_batch_pcg_solve(pp, u_fixed, f_applied, iterations=300)
    assert tuple(got.shape) == (lanes, pp.n_pad, 2)
    nl = pp.free.shards[0].shape[1]

    def field(a):
        return ShardVec(torch.from_numpy(a.T[:, s * nl:(s + 1) * nl].copy())
                        for s in range(len(pp.free.shards)))

    matvec = psh._gather_matvec(pp.ell_data, pp.cols)
    for lane in range(lanes):
        uf = field(u_fixed[lane])
        b = reduced_rhs(matvec, pp.free, uf, field(f_applied[lane]))
        one = pcg_fixed_iterations(make_constrained_operator(matvec, pp.free), b,
                                   preconditioner=psh._block_jacobi(pp.diag_inv), x0=uf,
                                   iterations=300, dot=shard_dot)
        assert_close_to(got[lane].numpy(), one.x.gather().T, 1e-10, f"lane {lane}")


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n):
    """Every sharded path at tiny shapes over n shards of the CPU, each on
    its bar (magnetite_tpu_torch/dryrun.py); the 2-D pipeline only where n
    splits as 2 x n/2."""
    from magnetite_tpu_torch.dryrun import dryrun_multichip

    out = dryrun_multichip(n, device="cpu")
    assert {"ell", "stencil", "refined", "dia", "pipeline", "sweep residual"} <= set(out)
    assert ("stencil 2d" in out) == (n == 4)
    assert out["sweep residual"] < 1e-4
