"""The ELL solve mode of the port (fem/solve.py::EllSystem and the ELL
kernel's plain version, kernels/ell_kernel.py) against the JAX package's
`solve_system(operator="ell")` on the same inputs.

Cases: the h = 0.05 plate (1,401 nodes: AMG collapses to one dense
coarse inverse), the h = 0.016 plate (13,198 nodes: a banded 1,288-node
coarse level the V-cycle runs, a dense 145-node coarsest one), and
block-Jacobi, Jacobi and no preconditioner on the h = 0.05 plate; each in
f64, f32 and f32 with refine="on".

Bars (tests/test_golden.py:48-55): f64 displacements within 1e-6 of
max|u|, forces and scalar stress within 1e-5 of their max, iterations
within +-1. f32 is held to the JAX package's f64 answer at the f32 bar of
tests/test_torch_solve.py (2e-3 of max|u|: the f32 stopping floor through
the operator's conditioning). Refined runs: iterations and displacements
against the JAX package's refined run, forces and stress against its f64
run (the JAX package recovers refined stresses in f32, ~1.5e-5 of max off
the f64 values at h = 0.016; the port recovers them in f64); classic
refinement's iterations (Jacobi, none) within +-1 per pass, each pass's
f32 inner solve crossing its tolerance on its own (791 against 793 in
three passes without a preconditioner, measured).
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import magnetite_tpu
import magnetite_tpu.persist as jax_persist
import magnetite_tpu_torch
import magnetite_tpu_torch.persist as persist
from tests.torch_cases import E_MOD, NU, THICK, jax_plate, to_port, write_case
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    # name: (h, preconditioner option, the preconditioner auto / the option gives)
    "h0.05_dense_coarse_amg": (0.05, "auto", "amg"),
    "h0.016_banded_coarse_amg": (0.016, "auto", "amg"),
    "h0.05_block_jacobi": (0.05, "block_jacobi", "block_jacobi"),
    "h0.05_jacobi": (0.05, "jacobi", "jacobi"),
    "h0.05_none": (0.05, "none", "none"),
}
PRECISIONS = {
    "f64": {},
    "f32": {"dtype": "float32"},
    "refined": {"dtype": "float32", "refine": "on"},
}


@functools.lru_cache(maxsize=None)
def _jax_ref(h, precond, precision):
    mesh, bca, md = jax_plate(h)
    opts = magnetite_tpu.SolverOptions(
        operator="ell", preconditioner=precond, **PRECISIONS[precision])
    return magnetite_tpu.solve_system(mesh, bca, md, opts)


def _fields_agree(res, ref, u_tol, tol):
    assert np.abs(res.u - ref.u).max() <= u_tol * np.abs(ref.u).max()
    for field in ("f", "stress"):
        a, b = getattr(res, field), getattr(ref, field)
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), field


@pytest.mark.parametrize("precision", list(PRECISIONS))
@pytest.mark.parametrize("name", list(CASES))
def test_ell_solve_matches_jax(name, precision):
    h, precond, chosen = CASES[name]
    mesh, bca, md = jax_plate(h)
    problem = magnetite_tpu_torch.compile_problem(
        *to_port(mesh, bca, h),
        magnetite_tpu_torch.SolverOptions(
            operator="ell", preconditioner=precond, **PRECISIONS[precision]),
        device="cpu",
    )
    assert (problem.mode, problem.preconditioner, problem.perm) == ("ell", chosen, None)
    assert problem.refine == (precision == "refined")
    assert problem.system.data.dtype == (
        torch.float32 if precision == "f32" else torch.float64)
    res = problem.solve()
    ref = _jax_ref(h, precond, precision)
    ref64 = _jax_ref(h, precond, "f64")
    assert ref.timings["operator"] == "ell"
    if precision == "f64":
        assert abs(res.iterations - ref.iterations) <= 1
        assert res.residual_rel <= 1e-10
        _fields_agree(res, ref, 1e-6, 1e-5)
    elif precision == "f32":
        assert res.u.dtype == np.float32 and np.isfinite(res.u).all()
        assert res.residual_rel <= 50 * np.finfo(np.float32).eps
        assert np.abs(res.u - ref64.u).max() <= 2e-3 * np.abs(ref64.u).max()
    else:
        # one PCG under AMG; classic refinement's passes each cross their
        # f32 tolerance on their own
        assert abs(res.iterations - ref.iterations) <= res.timings.get("refine_outer", 1)
        assert res.residual_rel <= 1e-10
        assert np.abs(res.u - ref.u).max() <= 1e-6 * np.abs(ref.u).max()
        _fields_agree(res, ref64, 1e-6, 1e-5)


def test_banded_coarse_case_runs_a_banded_level():
    """The h = 0.016 plate's hierarchy has a coarse level the V-cycle runs
    on bands (the coarsest, 145 nodes, takes its dense inverse)."""
    mesh, bca, md = jax_plate(0.016)
    problem = magnetite_tpu_torch.compile_problem(
        *to_port(mesh, bca, 0.016), magnetite_tpu_torch.SolverOptions(operator="ell"),
        device="cpu")
    amg = problem.system.amg
    assert amg.ci is not None and len(amg.coarse_bands) == 2
    assert amg.coarse_bands[0] is not None  # level 1 runs dia_matvec, m = 3
    assert problem.timings["amg_levels"][1][0] * 3 > 3072


def test_ell_matvec_plain_matches_jax_ell_matvec():
    """The ELL kernel's plain version on slot-major data against the JAX
    package's `ell_matvec` on the node-major layout, to 1e-14 of the
    term scale in f64, and the wrapper on CPU tensors takes the plain
    version (no launch)."""
    import jax.numpy as jnp
    from magnetite_tpu.fem.operator import ell_matvec as jax_ell_matvec
    from magnetite_tpu_torch.fem.assembly import build_ell_structure
    from magnetite_tpu_torch.kernels import cuda_lib
    from magnetite_tpu_torch.kernels.ell_kernel import (
        ell_matvec_t, ell_matvec_t_plain, ell_to_slot_major,
    )

    mesh, _, _ = jax_plate(0.05)
    s = build_ell_structure(mesh.tris, mesh.num_nodes)
    rng = np.random.default_rng(11)
    ell = rng.standard_normal((s.n_nodes, s.width, 2, 2))
    u = rng.standard_normal((s.n_nodes, 2))
    ref = np.asarray(jax_ell_matvec(jnp.asarray(ell), jnp.asarray(s.cols), jnp.asarray(u)))
    data, cols = ell_to_slot_major(torch.from_numpy(ell), torch.from_numpy(s.cols))
    assert tuple(data.shape) == (s.width, 2, 2, s.n_nodes) and cols.dtype == torch.int32
    got = ell_matvec_t_plain(data, cols, torch.from_numpy(u.T.copy())).T.numpy()
    scale = np.abs(ell).sum(axis=(1, 3)).max() * np.abs(u).max()
    assert np.abs(got - ref).max() <= 1e-14 * scale
    before = cuda_lib.launched("mt_ell_matvec")
    wrapped = ell_matvec_t(data, cols, torch.from_numpy(u.T.copy()))
    assert cuda_lib.launched("mt_ell_matvec") == before
    np.testing.assert_array_equal(wrapped.T.numpy(), got)


@pytest.mark.parametrize("k,n,n_u,dtype", [
    (8, 37, 148, torch.float64),  # an all-gather shard's call: N_u = 4 N
    (8, 37, 150, torch.float32),
    (7, 41, 41, torch.float64),  # the ELL mode's: N_u = N, an odd K
    (1, 5, 9, torch.float32),
], ids=["shard-f64", "shard-f32", "k7-square", "k1"])
def test_ell_wrapper_launches_nothing_on_cpu(k, n, n_u, dtype):
    """CPU operands take the plain version: no launch, the plain version's
    bits, and the sum over the slots an independent numpy product gives."""
    from magnetite_tpu_torch.kernels import cuda_lib
    from magnetite_tpu_torch.kernels import ell_kernel as ek

    rng = np.random.default_rng(12)
    data_np = rng.standard_normal((k, 2, 2, n))
    cols_np = rng.integers(0, n_u, (k, n)).astype(np.int32)
    u_np = rng.standard_normal((2, n_u))
    data, cols, u = (torch.from_numpy(x) for x in (data_np, cols_np, u_np))
    data, u = data.to(dtype), u.to(dtype)
    counts = (lambda: (cuda_lib.launched("mt_ell_matvec"),
                       cuda_lib.launched("mt_ell_matvec", dtype=torch.float64)))
    before = counts()
    y = ek.ell_matvec_t(data, cols, u)
    assert counts() == before
    assert y.dtype == dtype and tuple(y.shape) == (2, n)
    assert torch.equal(y, ek.ell_matvec_t_plain(data, cols, u))
    ref = np.einsum("kijn,jkn->in", data.double().numpy(), u.double().numpy()[:, cols_np])
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    assert np.abs(y.double().numpy() - ref).max() <= tol * np.abs(ref).max()


def test_ell_diag_blocks_match_jax_extract_block_diagonal():
    import jax.numpy as jnp
    from magnetite_tpu.fem.assembly import extract_block_diagonal
    from magnetite_tpu_torch.fem.assembly import build_ell_structure
    from magnetite_tpu_torch.kernels.ell_kernel import ell_diag_blocks, ell_to_slot_major

    mesh, _, _ = jax_plate(0.05)
    s = build_ell_structure(mesh.tris, mesh.num_nodes)
    ell = np.random.default_rng(5).standard_normal((s.n_nodes, s.width, 2, 2))
    # padding slots point at the row's own node after its real diagonal
    # slot, and hold zero blocks
    own = s.cols == np.arange(s.n_nodes)[:, None]
    ell[own & (np.arange(s.width) != own.argmax(axis=1)[:, None])] = 0.0
    ref = np.asarray(extract_block_diagonal(jnp.asarray(ell), jnp.asarray(s.cols)))
    data, cols = ell_to_slot_major(torch.from_numpy(ell), torch.from_numpy(s.cols))
    got = ell_diag_blocks(data, cols).permute(2, 0, 1).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ell_operator_cache_moves_between_packages(tmp_path, writer):
    """An ELL operator cache (the whole flat and its cols; no symmetric
    half) written by either package resumes in the other: a hit that skips
    the structure and the assembly, with the fresh solve's answer."""
    h = 0.05
    mesh, bca, md = jax_plate(h)
    pcase = to_port(mesh, bca, h)
    path = str(tmp_path / "ell.op.npz")
    if writer == "port":
        fresh = magnetite_tpu_torch.compile_problem(
            *pcase, magnetite_tpu_torch.SolverOptions(operator="ell", keep_operator_host=True),
            device="cpu")
        assert fresh.operator_host.offsets == () and not fresh.operator_host.sym_half
        persist.save_operator(path, fresh)
        cache = jax_persist.load_operator(path)
        resumed = magnetite_tpu.compile_problem(mesh, bca, md, operator_cache=cache)
    else:
        fresh = magnetite_tpu.compile_problem(
            mesh, bca, md, magnetite_tpu.SolverOptions(operator="ell", keep_operator_host=True))
        jax_persist.save_operator(path, fresh)
        cache = persist.load_operator(path)
        resumed = magnetite_tpu_torch.compile_problem(*pcase, operator_cache=cache, device="cpu")
    assert cache.mode == "ell" and not cache.sym_half
    assert (resumed.mode, resumed.timings["operator_cache"]) == ("ell", "hit")
    ref, res = fresh.solve(), resumed.solve()
    assert abs(res.iterations - ref.iterations) <= 1
    _fields_agree(res, ref, 1e-6, 1e-5)


def test_ell_on_grid_matches_jax():
    """operator='ell' on a structured grid (the 8x16 plate with a hole)
    skips the stencil operator, as in the JAX package, and matches it."""
    from magnetite_tpu.meshing.generators import plate_with_hole_mesh, tensile_bcs_for_rect
    from magnetite_tpu_torch import interop

    mesh = plate_with_hole_mesh(8, 16)
    bca = tensile_bcs_for_rect(mesh.coords)
    md = (E_MOD, NU, THICK, 0.0, 0.01)
    ref_problem = magnetite_tpu.compile_problem(
        mesh, bca, magnetite_tpu.ModelMetadata(*md), magnetite_tpu.SolverOptions(operator="ell"))
    pmesh = magnetite_tpu_torch.Mesh(
        coords=mesh.coords, tris=mesh.tris, grid_shape=mesh.grid_shape,
        wrap_cols=mesh.wrap_cols, grid_local=mesh.grid_local,
        canonical_grid=mesh.canonical_grid,
    )
    problem = magnetite_tpu_torch.compile_problem(
        pmesh, interop.bca_from_arrays(bca.u_known, bca.u_value, bca.f_value),
        magnetite_tpu_torch.ModelMetadata(*md),
        magnetite_tpu_torch.SolverOptions(operator="ell"), device="cpu")
    assert problem.mode == ref_problem.mode == "ell"
    assert problem.preconditioner == ref_problem.preconditioner
    ref, res = ref_problem.solve(), problem.solve()
    assert abs(res.iterations - ref.iterations) <= 1
    _fields_agree(res, ref, 1e-6, 1e-5)


def test_cli_operator_ell_matches_jax_and_resumes(tmp_path):
    """`--operator ell` through the port's CLI writes the JAX package's ELL
    answer; `--save-case` then `--load-case --operator ell` resumes from
    the ELL operator cache with the same answer."""
    h = 0.05
    paths = write_case(str(tmp_path), h)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    case = str(tmp_path / "case.npz")
    nodes = {}
    for name, argv in (("fresh", paths + ["--save-case", case]),
                       ("resumed", [paths[0], "--load-case", case])):
        out = tmp_path / name
        out.mkdir()
        proc = subprocess.run(
            [sys.executable, "-m", "magnetite_tpu_torch.cli", *argv, "--operator", "ell",
             "--device", "cpu", "--skip", "--out-dir", str(out)],
            capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path))
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "info: operator=ell preconditioner=amg" in proc.stdout
        nodes[name] = np.loadtxt(out / "nodes.csv", delimiter=",", skiprows=1)
        if name == "resumed":
            assert "info: operator cache hit" in proc.stdout
    mesh, bca, md = jax_plate(h)
    ref = _jax_ref(h, "auto", "f64")
    np.testing.assert_array_equal(nodes["fresh"][:, :2], mesh.coords)
    for got in nodes.values():
        assert np.abs(got[:, 2:] - ref.u).max() <= 1e-6 * np.abs(ref.u).max()
