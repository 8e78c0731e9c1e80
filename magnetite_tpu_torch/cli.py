"""Command-line interface of the PyTorch port.

    python -m magnetite_tpu_torch.cli <input.json> <geometry files...>
        [--device {cuda,cpu}] [--precision {f32,f64}] [--cmap CMAP] [--skip]

Same flags, output files (nodes.csv, elements.csv) and error format
(``Received error: <stage> error: <msg>``, exit 1) as magnetite_tpu/cli.py,
plus --device (default cuda; a missing card is an error, never a silent
CPU run). The default precision is f64 on both devices; --precision mixed
is f32 storage with f64 refinement (f64 CG around the f32 AMG V-cycle on
the meshes this CLI produces). Flags of the JAX CLI that this slice does
not carry (--shard, --shard-layout, --save-case, --load-case, --profile,
--cg-progress) raise a typed "not yet ported" error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="magnetite-torch",
        description="2D linear-elastic FEA solver (PyTorch / CUDA port)",
    )
    parser.add_argument(
        "input_file", metavar="FILE", help="Input Json with boundary conditions"
    )
    parser.add_argument(
        "geometry_files", metavar="FILE", nargs="*", help="Geometry SVG or CSVs"
    )
    parser.add_argument(
        "-c", "--cmap", default="coolwarm", help="cmap for plot (default: coolwarm)"
    )
    parser.add_argument("-s", "--skip", action="store_true", help="skip plot")
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="device for the solve (default: cuda; the kernels run there, "
        "cpu runs their plain PyTorch versions)",
    )
    parser.add_argument(
        "--backend",
        choices=["auto", "gmsh", "delaunay"],
        default="auto",
        help="meshing backend (auto: gmsh if installed, else built-in)",
    )
    parser.add_argument(
        "--precision",
        choices=["f32", "f64", "mixed"],
        default="f64",
        help="solve precision (default: f64; 'mixed': f32 storage with f64 "
        "refinement)",
    )
    parser.add_argument("--save-plot", default=None, help="save the figure to this path")
    parser.add_argument(
        "--out-dir", default=".", help="directory for nodes.csv/elements.csv"
    )
    parser.add_argument(
        "--von-mises",
        action="store_true",
        help="write true von Mises stress instead of the legacy scalar",
    )
    parser.add_argument("--rtol", type=float, default=None, help="CG relative tolerance")
    parser.add_argument(
        "--operator",
        choices=["auto", "stencil", "dia", "hybrid", "ell"],
        default=None,
        help="sparse operator format (default: auto; ell is not yet ported)",
    )
    parser.add_argument(
        "--preconditioner",
        choices=["auto", "none", "jacobi", "block_jacobi", "multigrid", "amg"],
        default=None,
        help="CG preconditioner (default: auto -- smoothed-aggregation AMG "
        "on large meshes)",
    )
    # accepted for flag parity with the JAX CLI; each raises "not yet ported"
    parser.add_argument("--profile", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--cg-progress", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--shard", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--shard-layout", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--save-case", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--load-case", default=None, help=argparse.SUPPRESS)
    return parser


_NOT_PORTED = (
    ("profile", "--profile"),
    ("cg_progress", "--cg-progress"),
    ("shard", "--shard"),
    ("shard_layout", "--shard-layout"),
    ("save_case", "--save-case"),
    ("load_case", "--load-case"),
)


def entry(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from .errors import InputError

    for attr, flag in _NOT_PORTED:
        if getattr(args, attr):
            raise InputError(f"{flag} is not yet ported to the PyTorch package")
    import torch

    from .config import SolverOptions, load_simulation_input
    from .fem.solve import compile_problem, resolve_device

    resolve_device(args.device)  # fail before meshing, never fall back
    # full-precision float32 products (TF32 keeps ~3 decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from .meshing import runner
    from .post.csv_out import write_results
    from .utils.logging import log, stage

    sim = load_simulation_input(args.input_file)
    opt_kwargs = {"dtype": "float64" if args.precision == "f64" else "float32"}
    if args.precision == "mixed":
        opt_kwargs["refine"] = "on"
    if args.rtol is not None:
        opt_kwargs["cg_rtol"] = args.rtol
    if args.operator is not None:
        opt_kwargs["operator"] = args.operator
    if args.preconditioner is not None:
        opt_kwargs["preconditioner"] = args.preconditioner
    options = SolverOptions(**opt_kwargs)

    if not args.geometry_files:
        raise InputError("no geometry files given")
    with stage("mesh"):
        mesh, bca = runner.run(
            args.geometry_files, sim, backend=args.backend, options=options, log=log
        )
    with stage("solve"):
        problem = compile_problem(
            mesh, bca, sim.metadata, options, device=args.device
        )
        result = problem.solve()
    log(
        f"info: operator={problem.mode} preconditioner={problem.preconditioner} "
        f"device={args.device} dtype={str(problem.dtype).replace('torch.', '')} "
        f"refine={problem.refine}"
    )
    log(
        f"info: finished conjugate gradient in {result.iterations} "
        f"iterations (residual {result.residual_norm:.3e})"
    )
    log(f"info: solved system in {result.timings['solve_s']:.3f} seconds")
    log("info: timings " + json.dumps(
        {k: v for k, v in result.timings.items() if k.endswith("_s")}
    ))
    if args.von_mises:
        result.stress = result.von_mises
    nodes_path = os.path.join(args.out_dir, "nodes.csv")
    elements_path = os.path.join(args.out_dir, "elements.csv")
    with stage("output"):
        write_results(mesh, result, nodes_path, elements_path, log=log)
    if not args.skip or args.save_plot:
        from .post.plot import plot_results

        with stage("plot"):
            plot_results(
                mesh, result, cmap=args.cmap, show=not args.skip,
                save_path=args.save_plot,
            )


def main(argv=None) -> int:
    from .errors import MagnetiteError

    try:
        entry(argv)
    except MagnetiteError as err:
        print(f"Received error: {err}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
