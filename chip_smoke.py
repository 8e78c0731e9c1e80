#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (magnetite_tpu_torch) on one GPU.

    python3 chip_smoke.py            # the 1M-element plate, about a minute
    python3 chip_smoke.py --h 0.01   # a quick rehearsal at ~66k elements

Phases (any failure exits non-zero; no phase is wrapped in a catch):
  0. environment: torch / CUDA versions, the card's name and power limit;
     exits non-zero at once when no CUDA device is available;
  1. build: the CUDA kernels (nvcc, sm_90a) and the C++ host library (g++);
  2. the band-matvec kernel against its plain PyTorch version on the card,
     at the plate's level-0 operator (2x2 blocks) and a banded coarse AMG
     level (3x3 blocks), in f64 and f32, with timings and GB/s;
  3. the level-0 AMG transfer kernels (prolong / restrict) against their
     plain gathers, in f64 and f32, plus the adjoint identity;
  4. the main path through the CLI entry point on the plate: CSVs written,
     operator=dia, preconditioner=amg, the true relative residual recomputed
     with the plain operator, every kernel launched by that run;
  5. card against CPU (plain versions) at h = 0.01, f64, and the f32 run.
Its last lines are the card's nvidia-smi line, a JSON line of per-kernel
results, and {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

OUTER = [[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]]
HOLE = [[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]]
E_MOD, NU, THICK = 69e9, 0.33, 0.5
PEAK_GBS = 3350.0  # H100 SXM HBM3, NVIDIA data sheet
REPLACES = {
    "dia_matvec": ("magnetite_tpu_torch/csrc/dia_matvec.cu",
                   "magnetite_tpu/pallas/dia_kernel.py:146"),
    "prolong0": ("magnetite_tpu_torch/csrc/transfer.cu",
                 "magnetite_tpu/pallas/transfer_kernel.py:182"),
    "restrict0": ("magnetite_tpu_torch/csrc/transfer.cu",
                  "magnetite_tpu/pallas/transfer_kernel.py:214"),
}


def say(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def plate_case(h: float):
    """The plate with a rectangular hole: mesh, BC arrays and metadata."""
    import numpy as np
    from magnetite_tpu_torch.bc import apply_boundary_conditions
    from magnetite_tpu_torch.config import (
        BoundaryRegion, BoundaryRule, BoundaryTarget, ModelMetadata,
    )
    from magnetite_tpu_torch.meshing.runner import mesh_loops

    # the CLI's meshing stage (Delaunay + orientation fix) on the same loops
    mesh = mesh_loops([np.array(OUTER), np.array(HOLE)], 0.0, h,
                      backend="delaunay", log=lambda msg: None)
    rules = (
        BoundaryRule("left", BoundaryRegion(x_max=1e-6), BoundaryTarget(ux=0.0, uy=0.0)),
        BoundaryRule(
            "right", BoundaryRegion(x_min=3.0 - 1e-6), BoundaryTarget(ux=0.01, fy=0.0)
        ),
    )
    bca = apply_boundary_conditions(mesh.coords, rules)
    return mesh, bca, ModelMetadata(E_MOD, NU, THICK, 0.0, h)


def write_case_files(dirname: str, h: float) -> list:
    """input.json + outer.csv + hole.csv for the plate, as a user writes them."""
    case = {
        "metadata": {
            "part_thickness": THICK, "material_elasticity": E_MOD,
            "poisson_ratio": NU, "characteristic_length_min": 0.0,
            "characteristic_length_max": h,
        },
        "boundary_conditions": {
            "left": {"region": {"x_target_max": 1e-6},
                     "targets": {"ux": 0.0, "uy": 0.0}},
            "right": {"region": {"x_target_min": 3.0 - 1e-6},
                      "targets": {"ux": 0.01, "fy": 0.0}},
        },
    }
    paths = [os.path.join(dirname, n) for n in ("input.json", "outer.csv", "hole.csv")]
    with open(paths[0], "w") as f:
        json.dump(case, f)
    for path, loop in ((paths[1], OUTER), (paths[2], HOLE)):
        with open(path, "w") as f:
            f.write("x,y\n" + "".join(f"{x!r},{y!r}\n" for x, y in loop))
    return paths


def event_ms(fn, reps: int, flush) -> float:
    """Median of `reps` CUDA-event timings of one call each, L2 flushed
    before every call (the solver finds these operands cold)."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, got, ref, scale, tol):
    err = float((got - ref).abs().max())
    bound = tol * float(scale)
    say(f"  {name}: max|diff| {err:.3e} <= {bound:.3e} ({tol:g} x scale {float(scale):.3e})")
    require(err <= bound, f"{name} disagrees with its plain version")
    return err


def phase_kernels(problem, reps, flush):
    """Phases 2 and 3: every kernel against its plain version on the card."""
    import torch
    from magnetite_tpu_torch.kernels.dia_kernel import dia_matvec, dia_matvec_blocks
    from magnetite_tpu_torch.kernels.transfer_kernel import (
        prolong0, prolong0_plain, restrict0, restrict0_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float64).to(dtype)

    coarse = [
        (l, cb) for l, cb in enumerate(problem.amg.coarse_bands) if cb is not None
    ]
    require(bool(coarse), "the hierarchy has no banded coarse level")
    level, cb = coarse[0]
    say("phase 2: band matvec kernel against dia_matvec_blocks on the card")
    for label, bands64, offsets in (
        ("level-0 m=2", problem.bands, problem.offsets),
        (f"coarse level {level + 1} m=3", cb.bands, cb.offsets),
    ):
        d, m, _, n = bands64.shape
        offsets_dev = torch.tensor(offsets, dtype=torch.int32, device="cuda")
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            bands = bands64.to(dtype).contiguous()
            u = rand(m, n, dtype=dtype)
            scale = dia_matvec_blocks(bands.abs(), offsets, u.abs()).max()
            got = dia_matvec(bands, offsets, u, offsets_dev)
            ref = dia_matvec_blocks(bands, offsets, u)
            torch.cuda.synchronize()
            tag = f"dia_matvec {label} D={d} N={n} {str(dtype)[6:]}"
            err = compare(tag, got, ref, scale, tol)
            ms = event_ms(lambda: dia_matvec(bands, offsets, u, offsets_dev), reps, flush)
            plain_ms = event_ms(lambda: dia_matvec_blocks(bands, offsets, u), reps, flush)
            nbytes = (d * m * m * n + 2 * m * n) * bands.element_size()
            say(
                f"  {tag}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s, "
                f"{nbytes / ms / 1e6 / PEAK_GBS:.1%} of {PEAK_GBS:.0f} GB/s), "
                f"plain {plain_ms:.4f} ms ({nbytes / plain_ms / 1e6:.1f} GB/s)"
            )
            if label.startswith("level-0") and dtype == torch.float64:
                results["dia_matvec"] = (err, ms, plain_ms)

    say("phase 3: level-0 transfer kernels against the plain gathers on the card")
    agg, p0_64, ptc, ptv_64, _ = problem.amg.fast0
    n0, n1, w0 = agg.shape[0], ptc.shape[0], ptc.shape[1]
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        p0, ptv = p0_64.to(dtype).contiguous(), ptv_64.to(dtype).contiguous()
        ec, tmp = rand(n1, 3, dtype=dtype), rand(2, n0, dtype=dtype)
        es, name = p0.element_size(), str(dtype)[6:]
        scale_p = prolong0_plain(ec.abs(), agg, p0.abs()).max()
        uf = prolong0(ec, agg, p0)
        err_p = compare(f"prolong0 n0={n0} n1={n1} {name}", uf,
                        prolong0_plain(ec, agg, p0), scale_p, tol)
        scale_r = restrict0_plain(tmp.abs(), ptc, ptv.abs()).max()
        rc = restrict0(tmp, ptc, ptv)
        err_r = compare(f"restrict0 w0={w0} {name}", rc,
                        restrict0_plain(tmp, ptc, ptv), scale_r, tol)
        lhs, rhs = float((uf * tmp).sum()), float((ec * rc).sum())
        mag = float((prolong0(ec.abs(), agg, p0.abs()) * tmp.abs()).sum())
        say(f"  adjoint {name}: |<P0 x, y> - <x, P0^T y>| = {abs(lhs - rhs):.3e} "
            f"<= {tol:g} x {mag:.3e}")
        require(abs(lhs - rhs) <= tol * mag, "prolong0 / restrict0 are not adjoint")
        for kname, fn, plain, nbytes in (
            ("prolong0", lambda: prolong0(ec, agg, p0),
             lambda: prolong0_plain(ec, agg, p0), (8 * n0 + 3 * n1) * es + 4 * n0),
            ("restrict0", lambda: restrict0(tmp, ptc, ptv),
             lambda: restrict0_plain(tmp, ptc, ptv),
             (6 * n1 * w0 + 2 * n0 + 3 * n1) * es + 4 * n1 * w0),
        ):
            ms = event_ms(fn, reps, flush)
            plain_ms = event_ms(plain, reps, flush)
            say(f"  {kname} {name}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), "
                f"plain {plain_ms:.4f} ms ({nbytes / plain_ms / 1e6:.1f} GB/s)")
            if dtype == torch.float64:
                results[kname] = (err_p if kname == "prolong0" else err_r, ms, plain_ms)
    return results


def run_cli(argv) -> str:
    """magnetite_tpu_torch.cli.main(argv), echoing and returning its stdout."""
    from magnetite_tpu_torch import cli

    class Tee(io.StringIO):
        def write(self, s):
            sys.__stdout__.write(s)
            return super().write(s)

    buf = Tee()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    sys.stdout.flush()
    require(rc == 0, f"cli.main returned {rc}")
    return buf.getvalue()


def phase_main_path(problem, mesh, h, workdir):
    """Phase 4: the plate through the CLI; returns the kernel launch counts."""
    import numpy as np
    import torch
    from magnetite_tpu_torch.kernels.dia_kernel import dia_matvec, dia_matvec_blocks
    from magnetite_tpu_torch.kernels.transfer_kernel import prolong0, restrict0

    say(f"phase 4: main path through magnetite_tpu_torch.cli at h={h}")
    case_dir = os.path.join(workdir, "plate")
    os.makedirs(case_dir)
    argv = write_case_files(case_dir, h) + [
        "--device", "cuda", "--backend", "delaunay", "--skip", "--out-dir", case_dir,
    ]
    kernels = (dia_matvec, prolong0, restrict0)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = run_cli(argv)
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    say(f"  cli wall {wall:.2f} s; kernel launches in the run: {launches}")
    require(all(v > 0 for v in launches.values()), "a kernel of the path never launched")

    op, pre = re.search(r"info: operator=(\w+) preconditioner=(\w+)", out).groups()
    iters = int(re.search(r"finished conjugate gradient in (\d+) iterations", out).group(1))
    timings = json.loads(re.search(r"info: timings (\{.*\})", out).group(1))
    mesh_s = float(re.search(r"stage 'mesh' took ([\d.]+)s", out).group(1))
    say(f"  operator={op} preconditioner={pre} iterations={iters}")
    say("  stage timings (s): " + json.dumps({"mesh": mesh_s, **timings}))
    require(op == "dia" and pre == "amg", f"expected dia/amg, got {op}/{pre}")

    with open(os.path.join(case_dir, "nodes.csv")) as f:
        require(f.readline().strip() == "x,y,ux,uy", "nodes.csv header")
    with open(os.path.join(case_dir, "elements.csv")) as f:
        require(f.readline().strip() == "n0,n1,n2,stress", "elements.csv header")
    nodes = np.loadtxt(os.path.join(case_dir, "nodes.csv"), delimiter=",", skiprows=1)
    elems = np.loadtxt(os.path.join(case_dir, "elements.csv"), delimiter=",", skiprows=1)
    require(nodes.shape == (mesh.num_nodes, 4), f"nodes.csv rows {nodes.shape}")
    require(elems.shape == (mesh.num_elements, 4), f"elements.csv rows {elems.shape}")
    require(np.array_equal(nodes[:, :2], mesh.coords), "nodes.csv coordinates")
    require(np.array_equal(elems[:, :3].astype(np.int32), mesh.tris), "elements.csv tris")
    require(np.isfinite(nodes).all() and np.isfinite(elems).all(), "non-finite output")

    # true relative residual of the reduced system, f64, plain operator
    u = nodes[:, 2:] if problem.perm is None else nodes[problem.perm, 2:]
    u_t = torch.from_numpy(np.ascontiguousarray(u.T)).cuda()
    free_t = (~problem.u_known).double().T
    fixed_t = 1.0 - free_t
    uf_t, f_t = problem.u_value.T, problem.f_value.T

    def k_op(v):
        return dia_matvec_blocks(problem.bands, problem.offsets, v)

    b = free_t * (f_t - k_op(uf_t)) + fixed_t * uf_t
    res = b - (free_t * k_op(free_t * u_t) + fixed_t * u_t)
    rel = float(res.norm() / b.norm())
    say(f"  true relative residual ||b - K u|| / ||b|| = {rel:.3e} (<= 1e-9)")
    require(rel <= 1e-9, "true residual too large")
    return launches


def phase_card_vs_cpu(small_h):
    """Phase 5: the port on the card (kernels) against the port on the CPU
    (plain versions) in f64, and the f32 instances on the card."""
    import numpy as np
    from magnetite_tpu_torch.config import SolverOptions
    from magnetite_tpu_torch.fem.solve import solve_system

    say(f"phase 5: card against CPU at h={small_h}")
    mesh, bca, md = plate_case(small_h)
    runs = {}
    for key, device, dtype in (
        ("cuda64", "cuda", "float64"), ("cpu64", "cpu", "float64"),
        ("cuda32", "cuda", "float32"),
    ):
        t0 = time.perf_counter()
        runs[key] = solve_system(mesh, bca, md, SolverOptions(dtype=dtype), device=device)
        r = runs[key]
        say(f"  {key}: {mesh.num_nodes} nodes {mesh.num_elements} elements, "
            f"{r.iterations} iterations, residual_rel {r.residual_rel:.3e}, "
            f"solve_s {r.timings['solve_s']:.4f}, total {time.perf_counter() - t0:.2f} s")
    g, c, s = runs["cuda64"], runs["cpu64"], runs["cuda32"]
    require(abs(g.iterations - c.iterations) <= 1, "iteration counts differ by > 1")
    for name, tol in (("u", 1e-8), ("f", 1e-7), ("stress", 1e-7), ("von_mises", 1e-7)):
        a, b = getattr(g, name), getattr(c, name)
        rel = np.abs(a - b).max() / np.abs(b).max()
        say(f"  cuda f64 vs cpu f64 {name}: {rel:.3e} of max (<= {tol:g})")
        require(rel <= tol, f"{name} differs between card and CPU")
    # f32 CG stops at its clamped floor rtol = 50 eps_f32 ~ 6e-6, and the
    # f32 operator itself is perturbed by ~eps_f32: on the CPU's plain path
    # the f32 solution sits 1.9e-4 (h=0.02) and 7.7e-4 (h=0.01) of max|u|
    # from the f64 one, so 2e-3 bounds precision loss, not kernel error
    rel = np.abs(s.u - g.u).max() / np.abs(g.u).max()
    say(f"  cuda f32 vs cuda f64 u: {rel:.3e} of max (<= 2e-3)")
    require(np.isfinite(s.u).all(), "f32 run gave non-finite displacements")
    require(rel <= 2e-3, "f32 run disagrees with f64")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--h", type=float, default=0.00258,
                    help="mesh size of the main-path plate (0.00258: ~1M elements)")
    ap.add_argument("--small-h", type=float, default=0.01,
                    help="mesh size of the card-against-CPU comparison")
    ap.add_argument("--reps", type=int, default=20, help="timed launches per kernel")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    say(f"phase 0: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        say("no CUDA device available: torch.cuda.is_available() is false")
        return 2
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(f"  device: {kind}; nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from magnetite_tpu_torch import native
    from magnetite_tpu_torch.config import SolverOptions
    from magnetite_tpu_torch.fem.solve import compile_problem
    from magnetite_tpu_torch.kernels import cuda_lib

    say("phase 1: build")
    seconds, ptxas = cuda_lib.build()
    say(f"  CUDA kernels (nvcc sm_90a): {seconds:.2f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say("    " + line.strip())
    say(f"  host library (g++): {native.build():.2f} s")

    t0 = time.perf_counter()
    mesh, bca, md = plate_case(args.h)
    problem = compile_problem(mesh, bca, md, SolverOptions(), device="cuda")
    say(f"  plate h={args.h}: {mesh.num_nodes} nodes, {mesh.num_elements} elements, "
        f"{len(problem.offsets)} offsets, AMG levels {problem.timings['amg_levels']}, "
        f"prepared in {time.perf_counter() - t0:.2f} s")
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    results = phase_kernels(problem, args.reps, flush)
    del flush

    with tempfile.TemporaryDirectory() as workdir:
        launches = phase_main_path(problem, mesh, args.h, workdir)
    del problem
    torch.cuda.empty_cache()
    phase_card_vs_cpu(args.small_h)

    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    kernels = [
        {
            "name": name, "route": "cuda", "source": REPLACES[name][0],
            "replaces": REPLACES[name][1], "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        }
        for name, (err, ms, plain_ms) in results.items()
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
