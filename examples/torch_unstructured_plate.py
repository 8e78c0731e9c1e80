"""Arbitrary-geometry plate at scale: Delaunay mesh + AMG to 1e-8 relative
(the PyTorch / CUDA port's version of examples/unstructured_plate.py).

The reference's core use case (any SVG/CSV geometry -> mesh -> solve,
src/mesher.rs:939-974) pushed to 1M elements: the built-in Delaunay mesher
triangulates a plate-with-hole, the solver auto-selects the banded DIA
operator, and smoothed-aggregation AMG (fem/amg.py) holds CG at ~15
iterations regardless of mesh size. With --precision mixed semantics
(refine="on"), f64 CG runs with the f32 V-cycle preconditioner for
1e-8-grade residuals at f32 speed. Runs on one CUDA card (`--device cpu`
runs the plain PyTorch versions of the kernels); imports nothing of JAX.
Run:

    python examples/torch_unstructured_plate.py [h] [--device cuda|cpu]

h is the characteristic mesh length (default 0.00258 -> ~1M elements;
try 0.01 for a quick ~66k-element run).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(argv=None):
    from magnetite_tpu_torch.bc import apply_boundary_conditions
    from magnetite_tpu_torch.config import (
        BoundaryRegion,
        BoundaryRule,
        BoundaryTarget,
        ModelMetadata,
        SolverOptions,
    )
    from magnetite_tpu_torch.fem.solve import compile_problem
    from magnetite_tpu_torch.meshing.delaunay_backend import triangulate

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("h", type=float, nargs="?", default=0.00258)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    h = args.h

    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    t0 = time.perf_counter()
    mesh = triangulate([outer, hole], 0.0, h)
    print(
        f"meshed {mesh.num_nodes:,} nodes / {mesh.num_elements:,} elements "
        f"in {time.perf_counter() - t0:.1f}s"
    )

    rules = (
        BoundaryRule(
            "left", BoundaryRegion(x_max=1e-6), BoundaryTarget(ux=0.0, uy=0.0)
        ),
        BoundaryRule(
            "right",
            BoundaryRegion(x_min=3.0 - 1e-6),
            BoundaryTarget(ux=0.01, fy=0.0),
        ),
    )
    bca = apply_boundary_conditions(mesh.coords, rules)
    metadata = ModelMetadata(69e9, 0.33, 0.5, 0.0, h)

    t0 = time.perf_counter()
    problem = compile_problem(
        mesh,
        bca,
        metadata,
        SolverOptions(
            dtype="float32",
            cg_rtol=1e-8,
            refine="on",
            # force AMG even below the auto threshold so small demo runs
            # (h=0.01+) still show the mesh-independent convergence
            preconditioner="amg",
        ),
        device=args.device,
    )
    print(
        f"prepared in {time.perf_counter() - t0:.1f}s "
        f"(operator={problem.mode}, preconditioner={problem.preconditioner}, "
        f"amg levels={problem.timings.get('amg_levels')})"
    )

    result = problem.solve()  # first call: the kernels' first launches
    t0 = time.perf_counter()
    result = problem.solve()  # syncs the device before it copies the answer
    wall = time.perf_counter() - t0
    print(
        f"warm solve: {wall:.3f}s (device {result.timings['solve_s']:.4f}s), "
        f"{result.iterations} CG iterations, "
        f"relative residual {result.residual_rel:.2e}"
    )
    print(
        f"max |u| = {np.abs(result.u).max():.4e}, "
        f"max von Mises = {result.von_mises.max():.4e}"
    )


if __name__ == "__main__":
    main()
