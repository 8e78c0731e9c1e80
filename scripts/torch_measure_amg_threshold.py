"""Measure the AMG-vs-block-Jacobi crossover of the PyTorch / CUDA port on
small and mid unstructured meshes (the port's counterpart of
scripts/measure_amg_threshold.py; imports nothing of JAX).

`SolverOptions.amg_auto_min_nodes` (config.py) decides which
preconditioner every unstructured solve gets under preconditioner="auto".
For a ladder of Delaunay plate sizes (the 3x1 plate with a 0.4x0.3 hole,
left edge fixed, right edge pulled 0.01) this records, for block-Jacobi
and for AMG, the compile time (meshing excluded: structure, assembly, the
AMG build, the upload), the warm device solve time (`timings["solve_s"]`,
up to the device sync; the median of --reps warm solves after one
untimed), the iterations and the relative residual, in two
configurations:

  refined: dtype float32, refine "on", cg_rtol 1e-8 (f64 CG around the
           f32 preconditioner), as the JAX script measures;
  f32:     dtype float32, refine "off", cg_rtol at the port's f32 floor
           (50 x float32 eps), the f32 serving configuration.

It prints one JSON line per mesh size, then one line naming each
configuration's crossover: the smallest node count of the ladder from
which AMG wins at every larger size (its warm solve is faster than
block-Jacobi's, or block-Jacobi did not converge within its iteration
budget). An error in any row, a solve that did not converge included
(recorded in it under "<config> <precond> error"), makes the script exit
1 after the ladder.

    python scripts/torch_measure_amg_threshold.py              # on the card
    python scripts/torch_measure_amg_threshold.py --device cpu --h 0.08 0.06
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

LADDER = (0.045, 0.032, 0.026, 0.02, 0.016, 0.013, 0.011)
PRECONDS = ("block_jacobi", "amg")


def configs():
    from magnetite_tpu_torch.config import SolverOptions

    common = dict(amg_auto_min_nodes=0, max_cg_iters=40_000)
    f32_floor = 50 * float(np.finfo(np.float32).eps)
    return {
        "refined": lambda p: SolverOptions(dtype="float32", cg_rtol=1e-8, refine="on",
                                           preconditioner=p, **common),
        "f32": lambda p: SolverOptions(dtype="float32", cg_rtol=f32_floor, refine="off",
                                       preconditioner=p, **common),
    }


def amg_wins(row, config) -> bool:
    """AMG's warm solve is faster than block-Jacobi's, or block-Jacobi did
    not converge within its iteration budget where AMG did."""
    amg = row.get(f"{config} amg_solve_s")
    if amg is None:
        return False
    bj = row.get(f"{config} block_jacobi_solve_s")
    if bj is None:
        return "failed to converge" in row.get(f"{config} block_jacobi error", "")
    return amg < bj


def crossover(rows, config):
    """The smallest node count from which AMG wins (amg_wins) at every
    larger size of the ladder, or None."""
    at = None
    for row in sorted(rows, key=lambda r: r["nodes"], reverse=True):
        if not amg_wins(row, config):
            break
        at = row["nodes"]
    return at


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--h", type=float, nargs="+", default=LADDER,
                    help="the mesh sizes of the ladder")
    ap.add_argument("--reps", type=int, default=3, help="warm solves timed per case")
    args = ap.parse_args(argv)

    from magnetite_tpu_torch.bc import apply_boundary_conditions
    from magnetite_tpu_torch.config import (
        BoundaryRegion, BoundaryRule, BoundaryTarget, ModelMetadata,
    )
    from magnetite_tpu_torch.fem.solve import compile_problem
    from magnetite_tpu_torch.meshing.delaunay_backend import triangulate

    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    rules = (
        BoundaryRule("left", BoundaryRegion(x_max=1e-6), BoundaryTarget(ux=0.0, uy=0.0)),
        BoundaryRule("right", BoundaryRegion(x_min=3.0 - 1e-6),
                     BoundaryTarget(ux=0.01, fy=0.0)),
    )
    rows, failed = [], False
    for h in args.h:
        mesh = triangulate([outer, hole], 0.0, h)
        bca = apply_boundary_conditions(mesh.coords, rules)
        md = ModelMetadata(69e9, 0.33, 0.5, 0.0, h)
        row = {"h": h, "nodes": mesh.num_nodes, "elements": mesh.num_elements}
        for config, options in configs().items():
            for precond in PRECONDS:
                key = f"{config} {precond}"
                try:
                    t0 = time.perf_counter()
                    problem = compile_problem(mesh, bca, md, options(precond),
                                              device=args.device)
                    row[f"{key}_compile_s"] = time.perf_counter() - t0
                    if precond == "amg" and problem.amg_setup is not None:
                        row["amg_levels"] = problem.amg_setup.level_sizes
                    problem.solve()  # the first launches
                    times = []
                    for _ in range(args.reps):
                        res = problem.solve()
                        times.append(res.timings["solve_s"])
                    row[f"{key}_solve_s"] = statistics.median(times)
                    row[f"{key}_solve_s_spread"] = [min(times), max(times)]
                    row[f"{key}_iters"] = int(res.iterations)
                    row[f"{key}_rel"] = float(res.residual_rel)
                except Exception as err:  # recorded; the exit code says so
                    row[f"{key} error"] = f"{type(err).__name__}: {err}"
                    failed = True
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"crossover_nodes": {c: crossover(rows, c) for c in configs()},
                      "device": args.device}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
