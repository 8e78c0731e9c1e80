"""Command-line interface of the PyTorch port.

    python -m magnetite_tpu_torch.cli <input.json> <geometry files...>
        [--device {cuda,cpu}] [--precision {f32,f64}] [--cmap CMAP] [--skip]

Same flags, output files (nodes.csv, elements.csv) and error format
(``Received error: <stage> error: <msg>``, exit 1) as magnetite_tpu/cli.py,
plus --device (default cuda; a missing card is an error, never a silent
CPU run). The default precision is f64 on both devices; --precision mixed
is f32 storage with f64 refinement (f64 CG around the f32 AMG V-cycle on
the meshes this CLI produces). --save-case / --load-case checkpoint the
meshed case with its AMG hierarchy and assembled operator beside it
(`<case>.npz.amg.npz`, `<case>.npz.op.npz`; the JAX CLI's files, either
CLI reads the other's), --cg-progress N logs the CG residual every N
iterations and --profile DIR writes a torch.profiler Chrome trace there.
--shard runs the solve and the recovery sharded over every visible GPU
(--device cpu: the one CPU device): a structured grid case (--load-case of
a case saved from a generated grid) by grid rows, any other mesh by nodes;
--shard-layout auto | 1d names that layout, and RxC (R * C visible
devices) the 2-D rows x cols layout of the structured path, which any
other mesh refuses with a typed error.
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
        "geometry_files", metavar="FILE", nargs="*",
        help="Geometry SVG or CSVs (omit when using --load-case)",
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
        help="sparse operator format (default: auto-select per mesh)",
    )
    parser.add_argument(
        "--preconditioner",
        choices=["auto", "none", "jacobi", "block_jacobi", "multigrid", "amg"],
        default=None,
        help="CG preconditioner (default: auto -- smoothed-aggregation AMG "
        "on large meshes)",
    )
    parser.add_argument(
        "--profile",
        default=None,
        help="write a torch.profiler Chrome trace to this directory",
    )
    parser.add_argument(
        "--cg-progress",
        type=int,
        default=0,
        metavar="N",
        help="log CG iteration/residual every N iterations during the solve",
    )
    parser.add_argument(
        "--save-case",
        default=None,
        help="checkpoint mesh+BCs to this npz after meshing",
    )
    parser.add_argument(
        "--load-case",
        default=None,
        help="resume from an npz checkpoint instead of meshing",
    )
    parser.add_argument(
        "--shard",
        action="store_true",
        help="run the solve + recovery sharded over every visible device "
        "(structured grids by rows, other meshes node-sharded DIA + AMG)",
    )
    parser.add_argument(
        "--shard-layout",
        default=None,
        help="device-mesh layout for --shard (implies it): 'auto' or '1d' is "
        "the 1D mesh over every visible device; 'RxC' (e.g. '2x4') a 2D rows x "
        "cols mesh for structured grids (R*C must equal the device count)",
    )
    return parser


def _start_profile(args):
    """A torch.profiler session (CPU activities, and CUDA on the card)
    entered before loading or meshing; None without --profile."""
    if not args.profile:
        return None
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if args.device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def _stop_profile(prof, trace_dir: str) -> None:
    from .utils.logging import log

    prof.__exit__(None, None, None)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    log(f"info: wrote profiler trace to {path}")


def entry(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.shard_layout is not None:
        args.shard = True
    import torch

    from .config import SolverOptions, load_simulation_input
    from .fem.solve import resolve_device

    resolve_device(args.device)  # fail before meshing, never fall back
    # full-precision float32 products (TF32 keeps ~3 decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from .post.csv_out import write_results
    from .utils.logging import log, stage

    sim = load_simulation_input(args.input_file)
    opt_kwargs = {"dtype": "float64" if args.precision == "f64" else "float32"}
    if args.precision == "mixed":
        opt_kwargs["refine"] = "on"
    if args.rtol is not None:
        opt_kwargs["cg_rtol"] = args.rtol
    if args.cg_progress > 0:
        opt_kwargs["cg_progress_every"] = args.cg_progress
    if args.operator is not None:
        opt_kwargs["operator"] = args.operator
    if args.preconditioner is not None:
        opt_kwargs["preconditioner"] = args.preconditioner
    # the host copy of the assembled operator exists to feed
    # persist.save_operator; skip it unless saving
    opt_kwargs["keep_operator_host"] = bool(args.save_case)
    options = SolverOptions(**opt_kwargs)

    prof = _start_profile(args)
    try:
        mesh, result = _run(args, sim, options)
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
    finally:
        if prof is not None:
            _stop_profile(prof, args.profile)


def _load_caches(case: str, operator: bool = True):
    """The AMG hierarchy and (unless `operator` is false) the assembled
    operator saved beside a case, each None when absent or unreadable (a
    cache is an optimisation: an unreadable one is a warning and a
    rebuild, never a failed run)."""
    from .errors import InputError
    from .persist import load_amg, load_operator
    from .utils.logging import log, stage

    amg_setup = operator_cache = None
    if os.path.exists(case + ".amg.npz"):
        try:
            with stage("load-amg"):
                amg_setup = load_amg(case + ".amg.npz")
            log("info: loaded AMG hierarchy cache")
        except InputError as err:
            log(f"warning: ignoring unreadable AMG cache ({err})")
    if operator and os.path.exists(case + ".op.npz"):
        try:
            with stage("load-operator"):
                operator_cache = load_operator(case + ".op.npz")
            log("info: loaded assembled-operator cache")
        except InputError as err:
            log(f"warning: ignoring unreadable operator cache ({err})")
    return amg_setup, operator_cache


def _save_caches(args, problem, amg_setup) -> None:
    """Write the AMG hierarchy and the assembled operator beside the saved
    case; a cache loaded from that same case and reused unchanged is not
    rewritten."""
    from .persist import save_amg, save_operator
    from .utils.logging import log, stage

    # np.savez appends .npz to the case path; the siblings follow it, so
    # `--load-case <case>.npz` finds <case>.npz.amg.npz / .op.npz
    case = args.save_case if args.save_case.endswith(".npz") else args.save_case + ".npz"
    resumed_same_case = bool(args.load_case) and case == args.load_case
    if problem.amg_setup is not None:
        if resumed_same_case and problem.amg_setup is amg_setup:
            log("info: AMG hierarchy cache is current; not rewriting")
        else:
            with stage("save-amg"):
                save_amg(case + ".amg.npz", problem.amg_setup)
            log(f"info: cached AMG hierarchy to {case}.amg.npz")
    if problem.operator_host is not None:
        if resumed_same_case and problem.timings.get("operator_cache") == "hit":
            log("info: assembled-operator cache is current; not rewriting")
        else:
            with stage("save-operator"):
                save_operator(case + ".op.npz", problem)
            log(f"info: cached assembled operator to {case}.op.npz")


def _run(args, sim, options):
    """Load or mesh the case, save it when asked, compile and solve:
    (mesh, SolveResult)."""
    from .errors import InputError
    from .fem.solve import compile_problem
    from .meshing import runner
    from .persist import load_case, save_case
    from .utils.logging import log, stage

    structure = None
    if args.load_case:
        with stage("load-case"):
            mesh, bca, case_md, structure = load_case(args.load_case)
        log(
            f"info: resumed case from {args.load_case} "
            f"({mesh.num_nodes} nodes, {mesh.num_elements} elements)"
        )
        if case_md is not None and case_md != sim.metadata:
            log(
                "warning: checkpoint metadata differs from the input "
                "JSON; solving with the input JSON's material properties"
            )
    else:
        if not args.geometry_files:
            raise InputError("no geometry files given (or pass --load-case)")
        with stage("mesh"):
            mesh, bca = runner.run(
                args.geometry_files, sim, backend=args.backend, options=options, log=log
            )
    if args.save_case:
        with stage("save-case"):
            save_case(args.save_case, mesh, bca, metadata=sim.metadata)
        log(f"info: checkpointed case to {args.save_case}")
    amg_setup = operator_cache = None
    if args.load_case:
        # the sharded pipeline assembles its own shard-local operator: the
        # single-device assembly cache would be loaded only to be ignored
        amg_setup, operator_cache = _load_caches(args.load_case, operator=not args.shard)
    with stage("solve"):
        if args.shard:
            from .parallel.pipeline import compile_sharded_problem, parse_device_mesh

            device_mesh = parse_device_mesh(args.shard_layout or "auto", device=args.device)
            log(
                f"info: sharding the solve over {device_mesh.size} device(s) "
                f"({'x'.join(str(n) for n in device_mesh.shape)})"
            )
            problem = compile_sharded_problem(
                mesh, bca, sim.metadata, options, device_mesh=device_mesh,
                amg_setup=amg_setup,
            )
        else:
            problem = compile_problem(
                mesh, bca, sim.metadata, options, structure=structure,
                amg_setup=amg_setup, operator_cache=operator_cache, device=args.device,
            )
        result = problem.solve()
    if args.save_case:
        _save_caches(args, problem, amg_setup)
    log(
        f"info: operator={problem.mode} preconditioner={problem.preconditioner} "
        f"device={args.device} dtype={str(problem.dtype).replace('torch.', '')} "
        f"refine={problem.refine}"
    )
    if "shards" in problem.timings:
        t = problem.timings
        log(f"info: shards={t['shards']} halo={t['halo']} shard_size={t['shard_size']}")
    if "operator_cache" in problem.timings:
        log(f"info: operator cache {problem.timings['operator_cache']}")
    log(
        f"info: finished conjugate gradient in {result.iterations} "
        f"iterations (residual {result.residual_norm:.3e})"
    )
    log(f"info: solved system in {result.timings['solve_s']:.3f} seconds")
    log("info: timings " + json.dumps(
        {k: v for k, v in result.timings.items() if k.endswith("_s")}
    ))
    return mesh, result


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
