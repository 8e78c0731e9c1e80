"""End-to-end FEA pipeline sharded over a device mesh (the PyTorch / CUDA
port's version of examples/multichip_pipeline.py).

The complete reference-equivalent run — solve, force recovery, stress
recovery — on every visible GPU at once: a plate-with-hole is Delaunay
meshed, node-sharded over a `parallel.pipeline.DeviceMesh`, solved with
halo-exchange PCG (sharded AMG preconditioner), and the recovered
`SolveResult` is cross-checked against the single-device `solve_system` on
the same problem. Reference bar: kyle-tennison/Magnetite src/main.rs:53-76
+ src/solver.rs:412-535 (one command does everything — here on N cards).
Imports nothing of JAX. Run:

    python examples/torch_multichip_pipeline.py                  # every visible GPU
    python examples/torch_multichip_pipeline.py --shards 4       # 4 shards of one card
    python examples/torch_multichip_pipeline.py --device cpu --shards 4 [h]

`--shards N` repeats the one device (cuda:0, or the CPU) N times, as a
mesh may; h is the characteristic mesh length (default 0.02). The CLI
equivalent is `python -m magnetite_tpu_torch.cli ... --shard`.
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
    from magnetite_tpu_torch.fem.solve import solve_system
    from magnetite_tpu_torch.meshing.delaunay_backend import triangulate
    from magnetite_tpu_torch.parallel.pipeline import (
        DeviceMesh,
        compile_sharded_problem,
        default_device_mesh,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("h", type=float, nargs="?", default=0.02)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--shards", type=int, default=None,
                    help="shards over the one device, repeated (default: one "
                    "shard per visible GPU)")
    args = ap.parse_args(argv)

    if args.shards is None:
        device_mesh = default_device_mesh(args.device)
    else:
        device_mesh = DeviceMesh((args.device,) * args.shards)
    print(f"device mesh: {device_mesh.size} x {device_mesh.devices[0].type}")

    # plate with a rectangular hole, pulled 1% on the right edge
    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    mesh = triangulate([outer, hole], 0.0, args.h)
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
    metadata = ModelMetadata(69e9, 0.33, 0.5, 0.0, args.h)
    opts = SolverOptions(cg_rtol=1e-8)  # f64: the 1e-6 parity needs it
    print(f"mesh: {mesh.num_nodes} nodes, {len(mesh.tris)} elements")

    t0 = time.perf_counter()
    problem = compile_sharded_problem(
        mesh, bca, metadata, opts, device_mesh=device_mesh
    )
    t1 = time.perf_counter()
    result = problem.solve()  # syncs every shard's device before it returns
    t2 = time.perf_counter()
    print(
        f"sharded pipeline: prep {t1 - t0:.2f} s, solve+recovery "
        f"{t2 - t1:.2f} s, {result.iterations} iterations, "
        f"relative residual {result.residual_rel:.2e}"
    )

    # parity vs the single-device pipeline
    single = solve_system(mesh, bca, metadata, opts, device=device_mesh.devices[0])
    for field in ("u", "f", "sigma", "stress", "von_mises"):
        a = np.asarray(getattr(result, field))
        b = np.asarray(getattr(single, field))
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max()) / scale
        status = "ok" if err < 1e-6 else "DIVERGED"
        print(f"  {field:>10}: max relative diff {err:.2e}  {status}")
        assert err < 1e-6, field

    vm = np.asarray(result.von_mises)
    print(f"peak von Mises: {vm.max():.3e} Pa (hole corners)")


if __name__ == "__main__":
    main()
