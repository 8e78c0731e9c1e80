"""1M-element plate-with-hole: assemble + solve to 1e-8 relative residual
(the PyTorch / CUDA port's version of examples/plate_benchmark.py).

The scale showcase: a structured 512x1024-cell annulus grid (1,048,576 CST
elements), solved with the stencil operator + geometric multigrid + f64/f32
mixed-precision refinement, on one CUDA card (`--device cpu` runs the
plain PyTorch versions of the kernels). Imports nothing of JAX. Run:

    python examples/torch_plate_benchmark.py [n_radial n_tangential] [--device cuda|cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from magnetite_tpu_torch.bc import BCArrays
from magnetite_tpu_torch.config import ModelMetadata, SolverOptions
from magnetite_tpu_torch.fem.solve import compile_problem
from magnetite_tpu_torch.meshing.generators import plate_with_hole_mesh


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_radial", type=int, nargs="?", default=512)
    ap.add_argument("n_tangential", type=int, nargs="?", default=1024)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    mesh = plate_with_hole_mesh(args.n_radial, args.n_tangential)
    print(f"mesh: {mesh.num_elements} elements, {mesh.num_nodes} nodes "
          f"({time.perf_counter() - t0:.2f}s)")

    # clamp the left edge, pull the right edge 0.01 in +x
    c = mesh.coords
    n = mesh.num_nodes
    u_known = np.zeros((n, 2), dtype=bool)
    u_value = np.zeros((n, 2))
    u_known[np.isclose(c[:, 0], c[:, 0].min())] = True
    right = np.isclose(c[:, 0], c[:, 0].max())
    u_known[right, 0] = True
    u_value[right, 0] = 0.01
    bca = BCArrays(u_known=u_known, u_value=u_value, f_value=np.zeros((n, 2)))

    metadata = ModelMetadata(
        youngs_modulus=69e9, poisson_ratio=0.33, part_thickness=0.5,
        characteristic_length_min=0.0, characteristic_length_max=0.01,
    )
    t0 = time.perf_counter()
    problem = compile_problem(
        mesh, bca, metadata, SolverOptions(dtype="float32", cg_rtol=1e-8),
        device=args.device,
    )
    print(f"prep: {time.perf_counter() - t0:.2f}s "
          f"(operator={problem.mode}, preconditioner={problem.preconditioner}, "
          f"refine={problem.refine})")

    t0 = time.perf_counter()
    result = problem.solve()  # first call: the kernels' first launches
    print(f"first solve: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    result = problem.solve()  # syncs the device before it copies the answer
    print(f"solve: {time.perf_counter() - t0:.3f}s "
          f"(device {result.timings['solve_s']:.4f}s), "
          f"{result.iterations} inner iterations, "
          f"relative residual {result.residual_rel:.2e}")
    print(f"max |u| = {np.abs(result.u).max():.4e}, "
          f"max von Mises = {result.von_mises.max():.4e}")


if __name__ == "__main__":
    main()
