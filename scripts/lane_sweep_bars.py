"""The JAX package's own accuracy on its block-Jacobi sweep routes, on the
CPU: the bars that chip_smoke.py's phases 18-19 hold the port to (10x
each of these, LANE_BARS there).

The sweep plate of the JAX package's sweep benchmark (bench.py: the plate
with a hole, Delaunay h = 0.03, 3,774 nodes) through `sweep_solve(impl=
"auto")` at its default budget of 200 iterations, f32 and f64, --lanes
lanes of pulls U(0.005, 0.02) on the right edge and k U(0.5, 2): as meshed
(the DIA block-Jacobi lanes) and with its nodes shuffled by numpy seed 7
(no band structure: the vmap route). For each route and dtype:
  - "residual": the max per-lane true relative residual ||b - A u|| / ||b||,
    recomputed in f64 with the f64 operator;
  - "single": max|u - u_single| / max|u_single| of lanes 0, 1 and the last
    against converged f64 single solves (solve_system, rtol 1e-10) of the
    same variant;
and per dtype "routes": max|u_lanes - u_vmap| / max|u_lanes|, the vmap
answer mapped back to the meshed order (the same arithmetic in another
order).

Usage: JAX_PLATFORMS=cpu python scripts/lane_sweep_bars.py [--lanes 128]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUTER = [[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]]
HOLE = [[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=128)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--h", type=float, default=0.03)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from magnetite_tpu.bc import BCArrays, apply_boundary_conditions
    from magnetite_tpu.config import (
        BoundaryRegion, BoundaryRule, BoundaryTarget, ModelMetadata, SolverOptions,
    )
    from magnetite_tpu.fem.assembly import build_ell_structure
    from magnetite_tpu.fem.element import element_stiffness_matrices
    from magnetite_tpu.fem.operator import ell_matvec
    from magnetite_tpu.fem.solve import assemble_ell_arrays, solve_system
    from magnetite_tpu.meshing.core import Mesh
    from magnetite_tpu.meshing.runner import mesh_loops
    from magnetite_tpu.parallel.sweep import sweep_solve

    # chip_smoke.plate_case: the CLI's meshing stage on the plate's loops
    mesh = mesh_loops([np.array(OUTER), np.array(HOLE)], 0.0, args.h, backend="delaunay",
                      log=lambda msg: None)
    rules = (
        BoundaryRule("left", BoundaryRegion(x_max=1e-6), BoundaryTarget(ux=0.0, uy=0.0)),
        BoundaryRule("right", BoundaryRegion(x_min=3.0 - 1e-6),
                     BoundaryTarget(ux=0.01, fy=0.0)),
    )
    bca = apply_boundary_conditions(mesh.coords, rules)
    md = ModelMetadata(69e9, 0.33, 0.5, 0.0, args.h)
    n, b = mesh.num_nodes, args.lanes
    perm = np.random.default_rng(7).permutation(n)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    smesh = Mesh(coords=mesh.coords[perm], tris=inv[mesh.tris].astype(np.int32))
    sbca = BCArrays(u_known=bca.u_known[perm], u_value=bca.u_value[perm],
                    f_value=bca.f_value[perm])

    rng = np.random.default_rng(0)
    right = np.isclose(mesh.coords[:, 0], 3.0)
    u_values = np.tile(bca.u_value[None], (b, 1, 1))
    u_values[:, right, 0] = rng.uniform(0.005, 0.02, b)[:, None]
    f_values = np.zeros_like(u_values)
    k_scales = rng.uniform(0.5, 2.0, b)

    # the f64 operator of the meshed order
    st = build_ell_structure(mesh.tris, n)
    ke = element_stiffness_matrices(jnp.asarray(mesh.coords), jnp.asarray(mesh.tris),
                                    md.youngs_modulus, md.poisson_ratio, md.part_thickness)
    ell = assemble_ell_arrays(ke, jnp.asarray(st.slot_ids), n, st.width)
    cols = jnp.asarray(st.cols)
    kmv = jax.jit(jax.vmap(lambda v: ell_matvec(ell, cols, v)))
    free = (~bca.u_known).astype(np.float64)[None]  # [1, N, 2]
    ks = k_scales[:, None, None]

    def residual(u):  # [B, N, 2] meshed order -> max per-lane relative residual
        rhs = free * (f_values - ks * np.asarray(kmv(u_values))) + (1 - free) * u_values
        au = free * ks * np.asarray(kmv(free * u)) + (1 - free) * u
        r = rhs - au
        return float((np.sqrt((r ** 2).sum(axis=(1, 2))) / np.sqrt((rhs ** 2).sum(axis=(1, 2))))
                     .max())

    singles = {}
    for lane in (0, 1, b - 1):
        bca_b = BCArrays(u_known=bca.u_known, u_value=u_values[lane], f_value=f_values[lane])
        md_b = ModelMetadata(md.youngs_modulus * k_scales[lane], md.poisson_ratio,
                             md.part_thickness, 0.0, args.h)
        singles[lane] = np.asarray(solve_system(
            mesh, bca_b, md_b, SolverOptions(dtype="float64", cg_rtol=1e-10)).u)

    out = {"mesh": f"plate with a hole, Delaunay h={args.h}", "nodes": n, "lanes": b,
           "iterations": args.iters}
    for dtype in (np.float32, np.float64):
        name = np.dtype(dtype).name
        got = {}
        for route, m, bc, order in (("lanes", mesh, bca, None), ("vmap", smesh, sbca, perm)):
            uv = u_values if order is None else u_values[:, order]
            fv = f_values if order is None else f_values[:, order]
            res = sweep_solve(m, bc, md, uv, fv, k_scales, iterations=args.iters, dtype=dtype)
            u = np.asarray(res.u, np.float64)
            got[route] = u if order is None else u[:, inv]
            out[f"{route} {name}"] = {
                "residual": residual(got[route]),
                "single": max(float(np.abs(got[route][lane] - s).max() / np.abs(s).max())
                              for lane, s in singles.items()),
            }
        out[f"routes {name}"] = float(np.abs(got["lanes"] - got["vmap"]).max()
                                      / np.abs(got["lanes"]).max())
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
