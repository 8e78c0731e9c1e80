"""The port's two integration points, counterparts of the JAX package's
`__graft_entry__.entry` and `dryrun_multichip`.

`entry()` returns `(fn, example_args)`: the single-device solve of the
48x96 plate with a hole (structured stencil operator, geometric-multigrid
PCG in f32, force and stress recovery), compiled once; `fn(*example_args)`
runs the device solve alone.

`dryrun_multichip(n)` runs every sharded path once at tiny shapes over an
n-shard mesh, each held to its bar.

    from magnetite_tpu_torch.dryrun import dryrun_multichip, entry
    fn, args = entry()                      # on the card
    u, f, sigma, stress, vm, iters, *_ = fn(*args)
    dryrun_multichip(4, device="cpu")       # four shards on the CPU
    dryrun_multichip(4)                     # four shards of cuda:0

In `dryrun_multichip`, `device` is one device, repeated n times (a mesh may
repeat a device), or a sequence of n devices.
"""

from __future__ import annotations

import numpy as np

from .errors import SolverError


def _metadata():
    from .config import ModelMetadata

    return ModelMetadata(youngs_modulus=69e9, poisson_ratio=0.33, part_thickness=0.5,
                         characteristic_length_min=0.0, characteristic_length_max=0.2)


def _plate_case(n_radial: int, n_tangential: int):
    """The plate with a hole in tension: the left edge clamped, the right
    edge pulled 0.01 in x. Returns (mesh, BCArrays)."""
    from .bc import BCArrays
    from .meshing.generators import plate_with_hole_mesh

    mesh = plate_with_hole_mesh(n_radial, n_tangential)
    n, c = mesh.num_nodes, mesh.coords
    u_known = np.zeros((n, 2), dtype=bool)
    u_value = np.zeros((n, 2))
    left = np.isclose(c[:, 0], c[:, 0].min())
    right = np.isclose(c[:, 0], c[:, 0].max())
    u_known[left] = True
    u_known[right, 0] = True
    u_value[right, 0] = 0.01
    return mesh, BCArrays(u_known=u_known, u_value=u_value, f_value=np.zeros((n, 2)))


def entry(device="cuda"):
    """Returns (fn, example_args): one single-device FEA forward step on the
    48x96 plate with a hole in tension, the case and options of the JAX
    package's `__graft_entry__.entry` (f32, cg_rtol 1e-6, at most 2,000 CG
    iterations; structured assembly, the BC-reduced 9-point block stencil,
    geometric-multigrid PCG, force and stress recovery).

    The form: `fn` is `CompiledProblem.solve_device` and `example_args` is
    `(problem,)`, the problem compiled on `device` (meshing, assembly, the
    hierarchy build and the upload all happen here, once). `fn(*args)`
    runs the device solve alone and returns the ten device tensors in the
    JAX core's order: u, f, sigma, stress, von Mises, iterations, residual
    norm, converged, ||b|| and the residual history. On the card it
    launches `stencil_matvec` and the fused `mg_presmooth` /
    `mg_postsmooth` pair; device="cuda" without a card raises (it never
    falls back to the CPU)."""
    from .config import ModelMetadata, SolverOptions
    from .fem.solve import CompiledProblem, compile_problem

    metadata = ModelMetadata(youngs_modulus=69e9, poisson_ratio=0.33, part_thickness=0.5,
                             characteristic_length_min=0.0, characteristic_length_max=0.1)
    mesh, bca = _plate_case(48, 96)
    problem = compile_problem(
        mesh, bca, metadata,
        SolverOptions(dtype="float32", cg_rtol=1e-6, max_cg_iters=2000),
        device=device,
    )
    return CompiledProblem.solve_device, (problem,)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise SolverError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run, over an n_devices mesh: the all-gather ELL PCG and its batch x
    rows sweep, the row-sharded stencil PCG with the sharded multigrid, the
    2-D (rows x cols) pipeline where the count splits as 2 x n/2, the
    sharded f64 / f32 refinement, the node-sharded DIA + AMG solve, the
    sharded pipeline against the single-device solve on the golden bars,
    and a lane-sharded structured sweep. Raises SolverError on any bar;
    returns each path's iterations or residuals."""
    import torch

    from .bc import apply_boundary_conditions
    from .config import BoundaryRegion, BoundaryRule, BoundaryTarget, SolverOptions
    from .fem.solve import solve_system
    from .meshing.delaunay_backend import triangulate
    from .parallel.dia_shard import prepare_sharded_dia_problem, sharded_dia_pcg_solve
    from .parallel.pipeline import DeviceMesh, DeviceMesh2D, compile_sharded_problem
    from .parallel.sharding import (
        prepare_sharded_problem, sharded_batch_pcg_solve, sharded_pcg_solve,
    )
    from .parallel.stencil_shard import (
        prepare_sharded_stencil_problem, sharded_stencil_pcg_solve,
        sharded_stencil_refined_solve,
    )
    from .parallel.sweep import compile_sweep

    n = int(n_devices)
    devices = (tuple(device) if isinstance(device, (list, tuple)) else (device,) * n)
    _check(len(devices) == n, f"{len(devices)} devices given for {n} shards")
    md = _metadata()
    out = {}

    # the all-gather ELL path: one adaptive solve, then lanes x rows
    batch, rows = (2, n // 2) if n >= 4 and n % 2 == 0 else (1, n)
    mesh2d = DeviceMesh2D(devices, (batch, rows), ("batch", "rows"))
    mesh, bca = _plate_case(8, 16)
    problem = prepare_sharded_problem(mesh, bca, md, mesh2d, axis="rows", dtype=np.float32)
    result = sharded_pcg_solve(problem, rtol=1e-4, maxiter=2000)
    _check(bool(result.converged), "sharded ELL PCG failed to converge")
    out["ell"] = int(result.iterations)
    b_lanes = 2 * batch
    u_fixed = np.tile(problem.u_fixed.gather().T[None], (b_lanes, 1, 1))
    u_fixed *= (1.0 + np.arange(b_lanes))[:, None, None]
    u_batch = sharded_batch_pcg_solve(problem, u_fixed, np.zeros_like(u_fixed), iterations=50)
    _check(tuple(u_batch.shape) == (b_lanes, problem.n_pad, 2), "batch solve's shape")
    _check(bool(torch.isfinite(u_batch).all()), "batch solve not finite")

    # the row-sharded stencil operator with the halo exchange
    rows_mesh = DeviceMesh(devices, "rows")
    st_mesh, st_bca = _plate_case(16, 16)  # 17 rows: coarsenable
    st_problem = prepare_sharded_stencil_problem(st_mesh, st_bca, md, rows_mesh,
                                                 dtype=np.float32)
    st_result, _ = sharded_stencil_pcg_solve(st_problem, rtol=1e-4, maxiter=2000)
    _check(bool(st_result.converged), "sharded stencil PCG failed to converge")
    _check(all(bool(torch.isfinite(s).all()) for s in st_result.x.shards),
           "sharded stencil PCG not finite")
    out["stencil"] = int(st_result.iterations)

    # the 2-D layout end to end: 16 wrapped cols must divide over the col shards
    if n >= 4 and n % 2 == 0 and 16 % (n // 2) == 0:
        g2 = compile_sharded_problem(st_mesh, st_bca, md,
                                     SolverOptions(dtype="float32", cg_rtol=1e-4),
                                     device_mesh=DeviceMesh2D(devices, (2, n // 2)))
        g2_res = g2.solve()
        _check(g2_res.converged, "2D sharded pipeline failed to converge")
        _check(g2_res.iterations < 60,
               f"2D multigrid out of the MG iteration regime: {g2_res.iterations}")
        _check(np.isfinite(g2_res.f).all() and np.isfinite(g2_res.stress).all(),
               "2D sharded pipeline not finite")
        out["stencil 2d"] = g2_res.iterations

    # sharded f64 / f32 refinement to 1e-8
    ref_problem = prepare_sharded_stencil_problem(st_mesh, st_bca, md, rows_mesh,
                                                  dtype=np.float64)
    ref_result, _ = sharded_stencil_refined_solve(ref_problem, rtol=1e-8)
    _check(bool(ref_result.converged), "sharded refined solve did not converge")
    out["refined"] = int(ref_result.iterations)

    # node-sharded unstructured: a tall Delaunay plate (short lattice rows
    # keep the band halo below the shard size), f64 CG with the f32 V-cycle
    outer = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 2.0], [0.0, 2.0]])
    dmesh = triangulate([outer], 0.0, 0.08)
    rules = (
        BoundaryRule("bottom", BoundaryRegion(y_max=1e-6), BoundaryTarget(ux=0.0, uy=0.0)),
        BoundaryRule("top", BoundaryRegion(y_min=2.0 - 1e-6),
                     BoundaryTarget(uy=0.01, fx=0.0)),
    )
    dbca = apply_boundary_conditions(dmesh.coords, rules)
    nodes_mesh = DeviceMesh(devices, "nodes")
    dia_problem = prepare_sharded_dia_problem(dmesh, dbca, md, nodes_mesh, dtype=np.float64)
    dia_result, _, _ = sharded_dia_pcg_solve(dia_problem, rtol=1e-8, refined=True)
    _check(bool(dia_result.converged), "sharded unstructured solve failed")
    out["dia"] = int(dia_result.iterations)

    # the sharded pipeline against the single-device solve, golden bars
    opts = SolverOptions(cg_rtol=1e-8)
    pipe = compile_sharded_problem(dmesh, dbca, md, opts, device_mesh=DeviceMesh(devices))
    pipe_result = pipe.solve()
    _check(pipe_result.converged and pipe_result.residual_rel < 1e-7,
           f"sharded pipeline residual {pipe_result.residual_rel:.2e}")
    single = solve_system(dmesh, dbca, md, opts, device=devices[0])
    for name in ("u", "f", "sigma", "stress", "von_mises"):
        a, b = getattr(pipe_result, name), getattr(single, name)
        scale = max(float(np.abs(b).max()), 1e-30)
        _check(np.allclose(a, b, atol=1e-6 * scale),
               f"sharded pipeline {name} diverges from the single-device solve")
    out["pipeline"] = pipe_result.iterations

    # a lane-sharded structured sweep: 2 lanes per device
    sweep = compile_sweep(st_mesh, st_bca, md, iterations=20, dtype=np.float32,
                          device_mesh=DeviceMesh(devices, "lanes"))
    b_sweep = 2 * n
    sw = sweep.solve(np.tile(np.asarray(st_bca.u_value)[None], (b_sweep, 1, 1)),
                     np.zeros((b_sweep, st_mesh.num_nodes, 2)), np.linspace(0.5, 2.0, b_sweep))
    rel = (sw.residual_norm / torch.clamp(sw.rhs_norm, min=1e-30)).cpu().numpy()
    _check(bool((rel < 1e-4).all()), f"lane-sharded sweep residuals: {rel}")
    out["sweep residual"] = float(rel.max())
    return out
