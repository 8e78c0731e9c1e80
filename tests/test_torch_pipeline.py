"""The port's sharded pipeline (magnetite_tpu_torch/parallel/pipeline.py:
`compile_sharded_problem`, `solve_system(device_mesh=)`, the CLI's
`--shard`) against the JAX package's (magnetite_tpu/parallel/pipeline.py)
and against the port's own single-device path.

The JAX side shards over the tests' virtual CPU devices; the port stands
opposite with the same shard count on one repeated CPU device.

Bars (tests/test_golden.py:48-55): displacements within 1e-6 of max|u|,
forces, stress tensors, scalar stress and von Mises within 1e-5 of their
max. Iterations within +-1 where both packages run the same scheme
(refine="on": f64 CG around the f32 V(3,3)-cycle); a default f64 run is
the port's f64 V(1,1)-cycle against the JAX package's f32 V(3,3), the
same answer in other iteration counts.
"""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest

import magnetite_tpu
from magnetite_tpu.parallel.pipeline import compile_sharded_problem as jax_compile_sharded
from magnetite_tpu_torch import SolverOptions
from magnetite_tpu_torch.errors import InputError, SolverError
from magnetite_tpu_torch.fem.solve import compile_problem, solve_system
from magnetite_tpu_torch.parallel.pipeline import (
    DeviceMesh,
    DeviceMesh2D,
    compile_sharded_problem,
    parse_device_mesh,
)
from tests.torch_cases import jax_plate, shuffled, to_port, write_case
from tests.torch_cases import one_thread  # noqa: F401  (autouse)

H = 0.04  # 2,179 nodes: the AMG hierarchy coarsens
FIELDS = (("u", 1e-6), ("f", 1e-5), ("sigma", 1e-5), ("stress", 1e-5), ("von_mises", 1e-5))


@functools.lru_cache(maxsize=None)
def _plate(h=H):
    mesh, bca, md = jax_plate(h)
    return (mesh, bca, md), to_port(mesh, bca, h)


def _cpu_mesh(s):
    return DeviceMesh(("cpu",) * s)


def _golden(got, want):
    for name, tol in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= tol * np.abs(b).max(), name


@functools.lru_cache(maxsize=None)
def _jax_sharded(s, h=H, **kw):
    mesh, bca, md = _plate(h)[0]
    opts = magnetite_tpu.SolverOptions(cg_rtol=1e-10, **kw)
    dm = jax.make_mesh((s,), ("shard",), devices=jax.devices()[:s])
    return jax_compile_sharded(mesh, bca, md, opts, device_mesh=dm).solve()


def test_compile_sharded_problem_matches_jax():
    s = 8
    _, (pmesh, pbca, pmd) = _plate()
    compiled = compile_sharded_problem(pmesh, pbca, pmd, SolverOptions(cg_rtol=1e-10),
                                       device_mesh=_cpu_mesh(s))
    assert compiled.mode == "dia" and compiled.preconditioner == "amg"
    assert not compiled.refine and compiled.timings["shards"] == s
    assert compiled.timings["operator"] == "dia-sharded"
    got = compiled.solve()
    assert got.residual_rel <= 1e-10 and got.converged
    _golden(got, _jax_sharded(s))
    # the port's f64 sharded solve runs the single-device scheme: the same
    # iterations as the single-device f64 AMG solve
    single = compile_problem(pmesh, pbca, pmd,
                             SolverOptions(cg_rtol=1e-10, preconditioner="amg"),
                             device="cpu").solve()
    assert abs(got.iterations - single.iterations) <= 1
    _golden(got, single)


def test_solve_system_device_mesh_matches_jax_refined():
    s = 2
    (mesh, bca, md), (pmesh, pbca, pmd) = _plate()
    want = _jax_sharded(s, dtype="float32", refine="on")
    got = solve_system(pmesh, pbca, pmd, SolverOptions(cg_rtol=1e-10, dtype="float32",
                                                       refine="on"),
                       device_mesh=_cpu_mesh(s))
    assert abs(got.iterations - want.iterations) <= 1
    _golden(got, want)


def test_shuffled_mesh_is_unpermuted():
    s = 4
    (mesh, bca, md), _ = _plate()
    smesh, sbca = shuffled(mesh, bca)
    pmesh, pbca, pmd = to_port(smesh, sbca, H)
    opts = SolverOptions(cg_rtol=1e-10, preconditioner="amg")
    compiled = compile_sharded_problem(pmesh, pbca, pmd, opts, device_mesh=_cpu_mesh(s))
    assert compiled.perm is not None
    got = compiled.solve()
    want = compile_problem(pmesh, pbca, pmd, opts, device="cpu").solve()
    _golden(got, want)


def test_halving_retry_when_the_halo_does_not_fit(capsys):
    h = 0.1  # 431 nodes: 8 shards of 54 nodes cannot hold the band halo
    _, (pmesh, pbca, pmd) = _plate(h)
    opts = SolverOptions(cg_rtol=1e-10)
    compiled = compile_sharded_problem(pmesh, pbca, pmd, opts, device_mesh=_cpu_mesh(8))
    err = capsys.readouterr().err
    assert "warning: mesh too small for 8 shards" in err
    s = compiled.timings["shards"]
    assert s < 8 and compiled.problem.local_n >= compiled.problem.halo
    assert f"retrying on {s}" in err
    got = compiled.solve()
    want = compile_sharded_problem(pmesh, pbca, pmd, opts, device_mesh=_cpu_mesh(1)).solve()
    _golden(got, want)


@pytest.mark.parametrize("operator", ["ell", "hybrid"])
def test_ell_and_hybrid_operators_are_refused(operator):
    _, (pmesh, pbca, pmd) = _plate(0.1)
    with pytest.raises(SolverError, match="no sharded pipeline"):
        compile_sharded_problem(pmesh, pbca, pmd, SolverOptions(operator=operator),
                                device_mesh=_cpu_mesh(2))


@pytest.mark.parametrize("precond", ["none", "multigrid"])
def test_unsupported_preconditioner_is_refused(precond):
    _, (pmesh, pbca, pmd) = _plate(0.1)
    with pytest.raises(SolverError, match="support preconditioner="):
        compile_sharded_problem(pmesh, pbca, pmd, SolverOptions(preconditioner=precond),
                                device_mesh=_cpu_mesh(2))


def test_block_jacobi_matches_jax():
    s, h = 2, 0.1
    _, (pmesh, pbca, pmd) = _plate(h)
    compiled = compile_sharded_problem(
        pmesh, pbca, pmd, SolverOptions(cg_rtol=1e-10, preconditioner="block_jacobi"),
        device_mesh=_cpu_mesh(s),
    )
    assert compiled.preconditioner == "block_jacobi" and compiled.amg_setup is None
    _golden(compiled.solve(), _jax_sharded(s, h, preconditioner="block_jacobi"))


def test_residual_history_is_the_global_norm():
    s = 2
    _, (pmesh, pbca, pmd) = _plate()
    opts = SolverOptions(cg_rtol=1e-10, dtype="float32", refine="on", residual_history=64)
    got = compile_sharded_problem(pmesh, pbca, pmd, opts, device_mesh=_cpu_mesh(s)).solve()
    want = _jax_sharded(s, dtype="float32", refine="on", residual_history=64)
    hist = got.residual_history
    assert hist.shape == (got.iterations,) and np.all(hist > 0)
    assert hist[-1] == pytest.approx(got.residual_norm, rel=1e-12)
    # the first iterations' norms: the f32 V-cycles of the three runs
    # differ in f32 rounding (the single-device cycle applies the factored
    # level-0 transfer, the sharded ones the host's smoothed P; measured
    # 1.4e-5 apart), so 1e-4
    k = min(got.iterations, want.iterations, 4)
    np.testing.assert_allclose(hist[:k], np.asarray(want.residual_history)[:k], rtol=1e-4)
    single = compile_problem(pmesh, pbca, pmd, dataclasses.replace(opts, preconditioner="amg"),
                             device="cpu").solve()
    np.testing.assert_allclose(hist[:k], single.residual_history[:k], rtol=1e-4)


def test_grid_local_mesh_raises_not_yet_ported():
    """A grid-local mesh under operator auto / stencil takes the row-sharded
    stencil path, on the golden bars against the JAX package's kind
    "stencil" over as many virtual devices; operator="dia" still shards it
    as an unstructured mesh."""
    from magnetite_tpu.meshing import generators as jgen
    from magnetite_tpu_torch.config import ModelMetadata
    from magnetite_tpu_torch.meshing.generators import rect_mesh, tensile_bcs_for_rect

    mesh = rect_mesh(24, 12, width=2.0, height=1.0)  # 13 x 25: block-Jacobi
    bca = tensile_bcs_for_rect(mesh.coords)
    md = ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.05)
    jmesh = jgen.rect_mesh(24, 12, width=2.0, height=1.0)
    jbca = jgen.tensile_bcs_for_rect(jmesh.coords)
    jmd = magnetite_tpu.config.ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.05)
    jopts = magnetite_tpu.SolverOptions(cg_rtol=1e-10, dtype="float64")
    jc = jax_compile_sharded(jmesh, jbca, jmd, jopts,
                             device_mesh=jax.make_mesh((2,), ("shard",),
                                                       devices=jax.devices()[:2]))
    assert jc.kind == "stencil"
    want = jc.solve()
    for operator in ("auto", "stencil"):
        compiled = compile_sharded_problem(
            mesh, bca, md, SolverOptions(operator=operator, cg_rtol=1e-10),
            device_mesh=_cpu_mesh(2))
        assert (compiled.kind, compiled.mode, compiled.preconditioner) == (
            "stencil", "stencil", "block_jacobi")
        assert compiled.timings["operator"] == "stencil-sharded"
        got = compiled.solve()
        assert got.iterations == want.iterations
        _golden(got, want)
    # operator="dia" shards the same grid as an unstructured mesh
    got = compile_sharded_problem(mesh, bca, md, SolverOptions(operator="dia", cg_rtol=1e-10),
                                  device_mesh=_cpu_mesh(2)).solve()
    want = compile_problem(mesh, bca, md, SolverOptions(operator="dia", cg_rtol=1e-10),
                           device="cpu").solve()
    _golden(got, want)


def test_device_mesh_layouts():
    assert parse_device_mesh("auto", device="cpu").devices == (DeviceMesh(("cpu",)).devices)
    assert parse_device_mesh("1d", device="cpu").size == 1
    for layout, msg in (("2x", "R and C must be integers"), ("0x1", "must be >= 1"),
                        ("2-4", "expected 'auto' or 'RxC'"),
                        ("2x4", "needs 8 devices but 1 are visible")):
        with pytest.raises(InputError, match=msg):
            parse_device_mesh(layout, device="cpu")
    grid = parse_device_mesh("1x1", device="cpu")
    assert isinstance(grid, DeviceMesh2D) and grid.shape == (1, 1)
    assert grid.axis_names == ("rows", "cols") and grid.devices == DeviceMesh(("cpu",)).devices
    assert DeviceMesh2D(("cpu",) * 6, (2, 3)).row(1) == DeviceMesh(("cpu",) * 3).devices
    with pytest.raises(InputError, match="needs 4 devices"):
        DeviceMesh2D(("cpu",) * 3, (2, 2))
    with pytest.raises(InputError, match="one type"):
        DeviceMesh(("cpu", "cuda:0"))
    _, (pmesh, pbca, pmd) = _plate(0.1)
    with pytest.raises(SolverError, match="DeviceMesh2D"):
        compile_sharded_problem(pmesh, pbca, pmd,
                                device_mesh=jax.make_mesh((2, 2), ("rows", "cols")))
    # the JAX package's typed error: a 2-D mesh shards only the stencil operator
    with pytest.raises(SolverError, match="a 2D device mesh shards the structured stencil"):
        compile_sharded_problem(pmesh, pbca, pmd, device_mesh=DeviceMesh2D(("cpu",) * 4, (2, 2)))
    assert DeviceMesh(("cpu",) * 5).halved().size == 2


def test_cli_shard_matches_the_unsharded_cli(tmp_path, capsys):
    """`--shard --device cpu` writes CSVs on the golden bars against the
    unsharded CLI; --save-case carries the AMG hierarchy (and no operator
    cache), and a --shard --load-case run reuses it."""
    from magnetite_tpu_torch import cli

    paths = write_case(str(tmp_path), H)
    runs = {}
    case = str(tmp_path / "case.npz")
    for name, argv in (("single", paths),
                       ("shard", paths + ["--shard", "--save-case", case]),
                       ("resumed", [paths[0], "--load-case", case, "--shard-layout", "auto"])):
        out = tmp_path / name
        out.mkdir()
        assert cli.main(argv + ["--device", "cpu", "--skip", "--out-dir", str(out)]) == 0
        runs[name] = (capsys.readouterr().out,
                      np.loadtxt(out / "nodes.csv", delimiter=",", skiprows=1),
                      np.loadtxt(out / "elements.csv", delimiter=",", skiprows=1))
    assert "sharding the solve over 1 device(s)" in runs["shard"][0]
    assert os.path.exists(case + ".amg.npz") and not os.path.exists(case + ".op.npz")
    assert "info: loaded AMG hierarchy cache" in runs["resumed"][0]
    _, nodes1, elems1 = runs["single"]
    for name in ("shard", "resumed"):
        _, nodes, elems = runs[name]
        assert np.array_equal(nodes[:, :2], nodes1[:, :2])
        assert np.abs(nodes[:, 2:] - nodes1[:, 2:]).max() <= 1e-6 * np.abs(nodes1[:, 2:]).max()
        assert np.abs(elems[:, 3] - elems1[:, 3]).max() <= 1e-5 * np.abs(elems1[:, 3]).max()


def test_cli_rxc_layout_exits_typed(tmp_path, capsys):
    from magnetite_tpu_torch import cli

    paths = write_case(str(tmp_path), 0.1)
    rc = cli.main(paths + ["--device", "cpu", "--skip", "--shard-layout", "1x1",
                           "--out-dir", str(tmp_path)])
    assert rc == 1
    err = capsys.readouterr().err
    assert "Received error: Solver error: a 2D device mesh shards the structured stencil" in err
