#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (magnetite_tpu_torch) on one GPU.

    python3 chip_smoke.py              # full size: 1M-element plates, ~2 minutes
    python3 chip_smoke.py --h 0.01 --small-h 0.02 --plate 64 128 --big 128 256 --reps 3
                                       # a quick rehearsal
    python3 chip_smoke.py --profile    # also trace one 1M structured solve

Phases (any failure exits non-zero; no phase is wrapped in a catch):
  0. environment: torch / CUDA versions, the card's name and power limit;
     exits non-zero at once when no CUDA device is available;
  1. build: the CUDA kernels (nvcc, sm_90a) and the C++ host library (g++);
  2. the band-matvec kernel against its plain version on the card, at the
     Delaunay plate's level-0 operator (2x2 blocks) and a banded coarse AMG
     level (3x3 blocks), in f64 and f32;
  3. the level-0 AMG transfer kernels (prolong / restrict) against their
     plain gathers, in f64 and f32, plus the adjoint identity;
  4. the double-float band kernel against its plain version and against
     the exact f64 product, timed beside dia_matvec<double>;
  5. the f64 main path through the CLI entry point on the Delaunay plate:
     CSVs written, operator=dia, preconditioner=amg, the true relative
     residual recomputed with the plain operator;
  6. the mixed main path: the CLI with --precision mixed (f64 CG around the
     f32 V(3,3)-cycle), then solve_system with df_matvec="on" reusing the
     AMG hierarchy (the double-float kernel runs the CG's matvec);
  7. the structured main path: the 1M-element plate with a hole through
     compile_problem / solve (stencil operator, geometric multigrid, f32
     storage + f64 refinement to rtol 1e-8), and the same plate in f64;
  8. the stencil kernel against its plain version at the 1M plate's
     reduced level-0 stencil, the 4M plate's grid, and a non-wrapped grid
     whose cols are not a multiple of 32, in f64 and f32;
  9. card against CPU (plain versions): the Delaunay plate at --small-h in
     f64 and mixed precision, the structured 64x128 plate in f64 and f32
     refined.
Every kernel is timed with CUDA events (median of --reps launches, L2
flushed before each) beside its plain version, its bound (the larger of
bytes moved once over 3.35 TB/s and operations over the peak rate of their
type) and one PyTorch call computing the same function (a cuSPARSE CSR
SpMV of the same operator). Each main path runs with every launch counter
set to 0 just before it and read just after. The last lines are the card's
nvidia-smi line, a JSON line of per-kernel results, and
{"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
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
# NVIDIA H100 SXM data sheet: HBM3 bandwidth; FP32 and FP64 rates outside
# the tensor cores
PEAK_GBS = 3350.0
PEAK_TFLOPS = {"float32": 67.0, "float64": 34.0}
DEV = "cuda"
KERNELS = {
    # name: (source, replaced TPU kernel)
    "dia_matvec": ("magnetite_tpu_torch/csrc/dia_matvec.cu",
                   "magnetite_tpu/pallas/dia_kernel.py:146"),
    "prolong0": ("magnetite_tpu_torch/csrc/transfer.cu",
                 "magnetite_tpu/pallas/transfer_kernel.py:182"),
    "restrict0": ("magnetite_tpu_torch/csrc/transfer.cu",
                  "magnetite_tpu/pallas/transfer_kernel.py:214"),
    # also replaces the row-blocked variant, stencil_kernel.py:191
    "stencil_matvec": ("magnetite_tpu_torch/csrc/stencil_matvec.cu",
                       "magnetite_tpu/pallas/stencil_kernel.py:91"),
    "df_dia_matvec": ("magnetite_tpu_torch/csrc/df_dia_matvec.cu",
                      "magnetite_tpu/pallas/dia_kernel.py:330"),
}


def say(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def counters():
    """The five kernel wrappers, each carrying its `.launches` count."""
    from magnetite_tpu_torch.kernels.df_kernel import df_dia_matvec
    from magnetite_tpu_torch.kernels.dia_kernel import dia_matvec
    from magnetite_tpu_torch.kernels.stencil_kernel import stencil_matvec
    from magnetite_tpu_torch.kernels.transfer_kernel import prolong0, restrict0

    return (dia_matvec, prolong0, restrict0, stencil_matvec, df_dia_matvec)


@contextlib.contextmanager
def main_path(name: str, totals: dict, expect: tuple):
    """Counts set to 0 just before the path, read just after; every kernel
    in `expect` must have launched."""
    ks = counters()
    for k in ks:
        k.launches = 0
    yield
    got = {k.__name__: k.launches for k in ks}
    say(f"  kernel launches in {name}: {got}")
    for k, v in got.items():
        totals[k] = totals.get(k, 0) + v
    missing = [k for k in expect if got[k] == 0]
    require(not missing, f"{name}: kernels of the path never launched: {missing}")


def plate_case(h: float):
    """The Delaunay plate with a rectangular hole: mesh, BC arrays, metadata."""
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


def structured_case(nr: int, nt: int):
    """The structured plate with a circular hole of the JAX package's
    benchmark: left edge fixed, right edge ux = 0.01."""
    from magnetite_tpu_torch.config import ModelMetadata
    from magnetite_tpu_torch.meshing.generators import (
        plate_with_hole_mesh, tensile_bcs_for_rect,
    )

    mesh = plate_with_hole_mesh(nr, nt)
    return mesh, tensile_bcs_for_rect(mesh.coords), ModelMetadata(E_MOD, NU, THICK, 0.0, 0.01)


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


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(least ms the card could take, what bounds it)."""
    t_bytes = nbytes / (PEAK_GBS * 1e9) * 1e3
    t_ops = flops / (PEAK_TFLOPS[str(dtype).replace("torch.", "")] * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, got, ref, scale, tol):
    err = float((got - ref).abs().max())
    lim = tol * float(scale)
    say(f"  {name}: max|diff| {err:.3e} <= {lim:.3e} ({tol:g} x scale {float(scale):.3e})")
    require(err <= lim, f"{name} disagrees with its reference")
    return err


def csr(rows, cols, vals, shape):
    """A CSR matrix from COO pieces (the library yardstick's operand)."""
    import torch

    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    coo = torch.sparse_coo_tensor(idx, torch.cat(vals), shape)
    return coo.coalesce().to_sparse_csr()


def csr_of_bands(bands, offsets):
    """K of bands [D, m, m, N] on the flattened [m, N] layout."""
    import torch

    d, m, _, n = bands.shape
    node = torch.arange(n, device=bands.device)
    rows, cols, vals = [], [], []
    for k, off in enumerate(offsets):
        ok = (node + off >= 0) & (node + off < n)
        src = node[ok]
        for i in range(m):
            for j in range(m):
                rows.append(i * n + src)
                cols.append(j * n + src + off)
                vals.append(bands[k, i, j][ok])
    return csr(rows, cols, vals, (m * n, m * n))


def csr_of_stencil(st, wrap):
    """K of a stencil [9, 2, 2, R, C] on the flattened [2, R, C] layout."""
    import torch

    _, _, _, rr, cc = st.shape
    r = torch.arange(rr, device=st.device)[:, None].expand(rr, cc)
    c = torch.arange(cc, device=st.device)[None, :].expand(rr, cc)
    rows, cols, vals = [], [], []
    for s in range(9):
        dr, dt = s // 3 - 1, s % 3 - 1
        r2, c2 = r + dr, c + dt
        ok = (r2 >= 0) & (r2 < rr)
        if wrap:
            c2 = c2 % cc
        else:
            ok = ok & (c2 >= 0) & (c2 < cc)
        src, dst = (r * cc + c)[ok], (r2 * cc + c2)[ok]
        for i in range(2):
            for j in range(2):
                rows.append(i * rr * cc + src)
                cols.append(j * rr * cc + dst)
                vals.append(st[s, i, j][ok])
    return csr(rows, cols, vals, (2 * rr * cc, 2 * rr * cc))


def time_kernel(tag, fn, plain, library, reps, flush, nbytes, flops, dtype):
    """Kernel, plain and library times beside the bound; returns the row."""
    ms = event_ms(fn, reps, flush)
    plain_ms = event_ms(plain, reps, flush)
    library_ms = event_ms(library, reps, flush) if library is not None else None
    b_ms, b_by = bound(nbytes, flops, dtype)
    lib = f"{library_ms:.4f}" if library_ms is not None else "none"
    say(f"  {tag}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s, "
        f"{b_ms / ms:.1%} of bound {b_ms:.4f} ms by {b_by}), plain {plain_ms:.4f} ms, "
        f"library {lib} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def phase_band_and_transfer(problem, reps, flush, rand):
    """Phases 2 and 3: the band and transfer kernels against their plain
    versions on the card."""
    import torch
    from magnetite_tpu_torch.kernels.dia_kernel import dia_matvec, dia_matvec_blocks
    from magnetite_tpu_torch.kernels.transfer_kernel import (
        prolong0, prolong0_plain, restrict0, restrict0_plain,
    )

    results = {}
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
        offsets_dev = torch.tensor(offsets, dtype=torch.int32, device=DEV)
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            bands = bands64.to(dtype).contiguous()
            u = rand(m, n, dtype=dtype)
            scale = dia_matvec_blocks(bands.abs(), offsets, u.abs()).max()
            ref = dia_matvec_blocks(bands, offsets, u)
            tag = f"dia_matvec {label} D={d} N={n} {str(dtype)[6:]}"
            err = compare(tag, dia_matvec(bands, offsets, u, offsets_dev), ref, scale, tol)
            a = csr_of_bands(bands, offsets)
            x = u.reshape(-1)
            compare(f"library CSR SpMV {tag}", torch.mv(a, x).reshape(m, n), ref, scale, tol)
            row = time_kernel(
                tag, lambda: dia_matvec(bands, offsets, u, offsets_dev),
                lambda: dia_matvec_blocks(bands, offsets, u), lambda: torch.mv(a, x),
                reps, flush, (d * m * m * n + 2 * m * n) * bands.element_size() + 4 * d,
                2 * d * m * m * n, dtype,
            )
            del a
            if label.startswith("level-0") and dtype == torch.float64:
                results["dia_matvec"] = dict(max_abs_err=err, **row)

    say("phase 3: level-0 transfer kernels against the plain gathers on the card")
    agg, p0_64, ptc, ptv_64, _ = problem.amg.fast0
    n0, n1, w0 = agg.shape[0], ptc.shape[0], ptc.shape[1]
    node = torch.arange(n0, device=DEV)
    agg64 = agg.long()
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        p0, ptv = p0_64.to(dtype).contiguous(), ptv_64.to(dtype).contiguous()
        ec, tmp = rand(n1, 3, dtype=dtype), rand(2, n0, dtype=dtype)
        es, name = p0.element_size(), str(dtype)[6:]
        # P0 as a CSR on the flattened layouts: uf [2, n0] <- ec [n1, 3]
        prow = [c * n0 + node for c in range(2) for k in range(3)]
        pcol = [agg64 * 3 + k for c in range(2) for k in range(3)]
        pval = [p0[:, c, k] for c in range(2) for k in range(3)]
        p_csr = csr(prow, pcol, pval, (2 * n0, 3 * n1))
        pt_csr = csr(pcol, prow, pval, (3 * n1, 2 * n0))
        scale_p = prolong0_plain(ec.abs(), agg, p0.abs()).max()
        uf = prolong0(ec, agg, p0)
        ref_p = prolong0_plain(ec, agg, p0)
        err_p = compare(f"prolong0 n0={n0} n1={n1} {name}", uf, ref_p, scale_p, tol)
        compare(f"library CSR prolong {name}", torch.mv(p_csr, ec.reshape(-1)).reshape(2, n0),
                ref_p, scale_p, tol)
        scale_r = restrict0_plain(tmp.abs(), ptc, ptv.abs()).max()
        rc = restrict0(tmp, ptc, ptv)
        ref_r = restrict0_plain(tmp, ptc, ptv)
        err_r = compare(f"restrict0 w0={w0} {name}", rc, ref_r, scale_r, tol)
        compare(f"library CSR restrict {name}", torch.mv(pt_csr, tmp.reshape(-1)).reshape(n1, 3),
                ref_r, scale_r, tol)
        lhs, rhs = float((uf * tmp).sum()), float((ec * rc).sum())
        mag = float((prolong0(ec.abs(), agg, p0.abs()) * tmp.abs()).sum())
        say(f"  adjoint {name}: |<P0 x, y> - <x, P0^T y>| = {abs(lhs - rhs):.3e} "
            f"<= {tol:g} x {mag:.3e}")
        require(abs(lhs - rhs) <= tol * mag, "prolong0 / restrict0 are not adjoint")
        for kname, fn, plain, lib, nbytes, err in (
            ("prolong0", lambda: prolong0(ec, agg, p0), lambda: prolong0_plain(ec, agg, p0),
             lambda: torch.mv(p_csr, ec.reshape(-1)), (8 * n0 + 3 * n1) * es + 4 * n0, err_p),
            ("restrict0", lambda: restrict0(tmp, ptc, ptv),
             lambda: restrict0_plain(tmp, ptc, ptv), lambda: torch.mv(pt_csr, tmp.reshape(-1)),
             (6 * n1 * w0 + 2 * n0 + 3 * n1) * es + 4 * n1 * w0, err_r),
        ):
            row = time_kernel(f"{kname} {name}", fn, plain, lib, reps, flush,
                              nbytes, 12 * n0, dtype)
            if dtype == torch.float64:
                results[kname] = dict(max_abs_err=err, **row)
        del p_csr, pt_csr
    return results


def phase_df(problem, reps, flush, rand):
    """Phase 4: the double-float kernel on the Delaunay plate's level-0 bands."""
    import torch
    from magnetite_tpu_torch.kernels.df_kernel import (
        df_dia_matvec, df_dia_matvec_plain, split_bands,
    )
    from magnetite_tpu_torch.kernels.dia_kernel import dia_matvec, dia_matvec_blocks

    say("phase 4: double-float band kernel against its plain version and exact f64")
    bands, offsets = problem.bands, problem.offsets
    d, _, _, n = bands.shape
    offsets_dev = torch.tensor(offsets, dtype=torch.int32, device=DEV)
    hl = split_bands(bands)
    u = rand(2, n, dtype=torch.float64)
    scale = dia_matvec_blocks(bands.abs(), offsets, u.abs()).max()
    got = df_dia_matvec(hl, offsets, u, offsets_dev)
    # the kernel repeats its plain version's f32 operations one for one
    # (no FMA contraction): a broken Veltkamp split or two-sum would show
    # as ~1e-8 of the scale
    compare("df_dia_matvec vs its plain version", got,
            df_dia_matvec_plain(hl, offsets, u), scale, 1e-14)
    # the pairs' accuracy: ~2^-46 per term, 2-4e-14 of the scale on these
    # fields; tests/test_pallas_kernel.py holds the TPU kernel to 1e-13
    exact = dia_matvec_blocks(bands, offsets, u)
    err = compare("df_dia_matvec vs exact f64", got, exact, scale, 1e-13)
    f32 = dia_matvec_blocks(bands.float(), offsets, u.float()).double()
    say(f"  (plain f32 for contrast: max|diff| {float((f32 - exact).abs().max()):.3e})")
    a = csr_of_bands(bands, offsets)
    x = u.reshape(-1)
    tag = f"df_dia_matvec D={d} N={n}"
    # f64 and df in turns: f64, df, df, f64
    f64_a = event_ms(lambda: dia_matvec(bands, offsets, u, offsets_dev), reps, flush)
    row = time_kernel(
        tag, lambda: df_dia_matvec(hl, offsets, u, offsets_dev),
        lambda: df_dia_matvec_plain(hl, offsets, u), lambda: torch.mv(a, x),
        reps, flush, (d * 8 * n) * 4 + 2 * 2 * n * 8 + 4 * d, 150 * d * n, torch.float32,
    )
    df_b = event_ms(lambda: df_dia_matvec(hl, offsets, u, offsets_dev), reps, flush)
    f64_b = event_ms(lambda: dia_matvec(bands, offsets, u, offsets_dev), reps, flush)
    say(f"  df vs f64 in turns: dia_matvec<double> {f64_a:.4f} / {f64_b:.4f} ms, "
        f"df_dia_matvec {row['ms']:.4f} / {df_b:.4f} ms "
        f"(df / f64 = {(row['ms'] + df_b) / (f64_a + f64_b):.3f})")
    del a, hl
    return {"df_dia_matvec": dict(max_abs_err=err, **row)}


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


def true_residual_banded(problem, u):
    """||b - K u|| / ||b|| of the reduced system, f64, plain band operator;
    u [N, 2] in the problem's (renumbered) node order."""
    import torch
    from magnetite_tpu_torch.kernels.dia_kernel import dia_matvec_blocks

    u_t = torch.from_numpy(u.T.copy()).to(DEV, torch.float64)
    free_t = (~problem.u_known).double().T
    fixed_t = 1.0 - free_t
    uf_t, f_t = problem.u_value.double().T, problem.f_value.double().T
    bands = problem.bands.double()

    def k_op(v):
        return dia_matvec_blocks(bands, problem.offsets, v)

    b = free_t * (f_t - k_op(uf_t)) + fixed_t * uf_t
    res = b - (free_t * k_op(free_t * u_t) + fixed_t * u_t)
    return float(res.norm() / b.norm())


def cli_path(name, problem, mesh, h, workdir, extra, tol, totals):
    """The Delaunay plate through the CLI; checks the CSVs and the true
    residual against `tol`."""
    import numpy as np

    case_dir = os.path.join(workdir, name)
    os.makedirs(case_dir)
    argv = write_case_files(case_dir, h) + [
        "--device", DEV, "--backend", "delaunay", "--skip", "--out-dir", case_dir,
    ] + extra
    t0 = time.perf_counter()
    with main_path(name, totals, ("dia_matvec", "prolong0", "restrict0")):
        out = run_cli(argv)
    wall = time.perf_counter() - t0
    op, pre = re.search(r"info: operator=(\w+) preconditioner=(\w+)", out).groups()
    refine = re.search(r"refine=(\w+)", out).group(1)
    iters = int(re.search(r"finished conjugate gradient in (\d+) iterations", out).group(1))
    timings = json.loads(re.search(r"info: timings (\{.*\})", out).group(1))
    mesh_s = float(re.search(r"stage 'mesh' took ([\d.]+)s", out).group(1))
    say(f"  cli wall {wall:.2f} s; operator={op} preconditioner={pre} refine={refine} "
        f"iterations={iters}")
    say("  stage timings (s): " + json.dumps({"mesh": mesh_s, **timings}))
    require(op == "dia" and pre == "amg", f"expected dia/amg, got {op}/{pre}")
    require(refine == str("--precision" in extra), f"refine={refine}")

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
    u = nodes[:, 2:] if problem.perm is None else nodes[problem.perm, 2:]
    rel = true_residual_banded(problem, u)
    say(f"  true relative residual ||b - K u|| / ||b|| = {rel:.3e} (<= {tol:g})")
    require(rel <= tol, "true residual too large")
    return nodes


def phase_mixed_df(problem, mesh, bca, md, totals):
    """Phase 6b: refined AMG with the double-float CG matvec, reusing the
    hierarchy built for the f64 problem."""
    from magnetite_tpu_torch.config import SolverOptions
    from magnetite_tpu_torch.fem.solve import compile_problem

    opts = SolverOptions(dtype="float32", refine="on", cg_rtol=1e-8, df_matvec="on")
    with main_path("the df_matvec='on' solve", totals, ("df_dia_matvec", "prolong0")):
        t0 = time.perf_counter()
        prob = compile_problem(mesh, bca, md, opts, amg_setup=problem.amg_setup, device=DEV)
        prep = time.perf_counter() - t0
        res = prob.solve()
    require(prob.df64 == "kernel" and prob.refine, f"df64={prob.df64!r} refine={prob.refine}")
    u = res.u if prob.perm is None else res.u[prob.perm]
    rel = true_residual_banded(problem, u)
    say(f"  df run: prep {prep:.2f} s, solve_s {res.timings['solve_s']:.4f}, "
        f"{res.iterations} iterations, reported residual_rel {res.residual_rel:.3e}, "
        f"true relative residual {rel:.3e} (<= 2e-08)")
    require(rel <= 2e-8, "df run: true residual too large")
    warm = [prob.solve().timings["solve_s"] for _ in range(2)]
    say(f"  df run warm solve_s: {warm}")


def true_residual_stencil(problem, res):
    """||b - K u|| / ||b|| of the reduced grid system, f64, plain stencil."""
    import torch
    from magnetite_tpu_torch.fem.stencil import stencil_matvec_plain

    rows, cols, wrap, _ = problem.grid
    raw, red = problem.stencil.double(), problem.reduced.double()

    def grid(a):
        return torch.from_numpy(a.T.copy()).to(DEV, torch.float64).reshape(2, rows, cols)

    free = (~problem.u_known).double().T.reshape(2, rows, cols)
    fixed = 1.0 - free
    uf = problem.u_value.double().T.reshape(2, rows, cols)
    f = problem.f_value.double().T.reshape(2, rows, cols)
    b = free * (f - stencil_matvec_plain(raw, fixed * uf, wrap)) + fixed * uf
    r = b - stencil_matvec_plain(red, grid(res.u), wrap)
    return float(r.norm() / b.norm())


def vcycles(inner_per_pass, maxiter):
    """V-cycles one classic-refinement solve launched: each inner PCG
    applies the preconditioner once up front and once per loop step, and
    its loop runs in chunks of cg.CHECK_EVERY steps."""
    from magnetite_tpu_torch.fem.cg import CHECK_EVERY

    return sum(
        1 + min(maxiter, CHECK_EVERY * max(1, math.ceil(k / CHECK_EVERY)))
        for k in inner_per_pass
    )


def phase_structured(nr, nt, totals, profile):
    """Phase 7: the structured plate, f32 storage + refinement, and f64."""
    import torch
    from magnetite_tpu_torch.config import SolverOptions
    from magnetite_tpu_torch.fem.solve import compile_problem

    mesh, bca, md = structured_case(nr, nt)
    say(f"phase 7: structured plate {nr}x{nt}: {mesh.num_nodes} nodes, "
        f"{mesh.num_elements} elements, grid {mesh.grid_shape}")
    keep = None
    for key, opts, refine in (
        ("f32 refined", SolverOptions(dtype="float32", cg_rtol=1e-8), True),
        ("f64", SolverOptions(dtype="float64", cg_rtol=1e-8), False),
    ):
        with main_path(f"the structured {key} solve", totals, ("stencil_matvec",)):
            t0 = time.perf_counter()
            problem = compile_problem(mesh, bca, md, opts, device=DEV)
            prep = time.perf_counter() - t0
            res = problem.solve()
        require(
            (problem.mode, problem.preconditioner, problem.refine)
            == ("stencil", "multigrid", refine),
            f"{key}: {problem.mode}/{problem.preconditioner}/refine={problem.refine}",
        )
        t = res.timings
        rel = true_residual_stencil(problem, res)
        warm = [problem.solve().timings["solve_s"] for _ in range(3)]
        say(f"  {key}: prep {prep:.3f} s (upload {t['upload_s']:.4f}, assemble "
            f"{t['assemble_s']:.4f}, multigrid build {t['mg_build_s']:.4f}; levels "
            f"{t['mg_levels']}), first solve_s {t['solve_s']:.4f}, warm {warm}")
        extra = ""
        if refine:
            inner = t["refine_inner"]
            extra = (f", outer passes {t['refine_outer']}, inner iterations per pass "
                     f"{inner}, V-cycles launched {vcycles(inner, problem.refine_inner_iters)}")
        say(f"  {key}: {res.iterations} iterations{extra}; reported residual_rel "
            f"{res.residual_rel:.3e}; true relative residual {rel:.3e} (<= 1e-08)")
        require(rel <= 1e-8, f"structured {key}: true residual too large")
        if profile and refine:
            profile_solve(problem)
        if refine:
            keep = problem.reduced
        del problem
        torch.cuda.empty_cache()
    return keep


def profile_solve(problem):
    """One warm solve under torch.profiler: kernel time by name and the
    device's idle share of the solve's wall time; then one V-cycle's host
    enqueue time against its device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from magnetite_tpu_torch.fem.multigrid import vcycle_preconditioner

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        problem.solve()
        wall = time.perf_counter() - t0
    # device-side events only (kernels and copies): the aten rows would
    # count the same kernels a second time
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    say(f"  profiled solve: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms in "
        f"{len(dev)} device events, idle {1 - busy / (wall * 1e3):.1%}")
    by_name: dict = {}
    for e in dev:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        say(f"    {ms:9.3f} ms  {n:6d}x  {name[:90]}")

    apply = vcycle_preconditioner(problem.mg_levels, problem.grid.wrap)
    r = torch.randn(2, problem.grid.rows, problem.grid.cols, device=DEV)
    for _ in range(3):
        apply(r)
    torch.cuda.synchronize()
    host, device = [], []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # the device spins while the host enqueues the whole cycle, so the
        # events time the device's work and not the host's pace
        torch.cuda._sleep(200_000_000)
        start.record()
        t0 = time.perf_counter()
        apply(r)
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end))
    say(f"  one V-cycle ({len(problem.mg_levels)} levels, f32): host enqueue "
        f"{statistics.median(host):.3f} ms, device {statistics.median(device):.3f} ms "
        "(median of 10)")


def phase_stencil_kernel(reduced_1m, big, rect_cells, reps, flush, rand):
    """Phase 8: the stencil kernel against its plain version at three shapes."""
    import torch
    from magnetite_tpu_torch.fem.stencil import assemble_stencil_structured
    from magnetite_tpu_torch.kernels.stencil_kernel import (
        stencil_matvec, stencil_matvec_plain,
    )
    from magnetite_tpu_torch.meshing.generators import rect_mesh

    say("phase 8: stencil kernel against stencil_matvec_plain on the card")
    mesh4m, _, _ = structured_case(*big)
    rect = rect_mesh(*rect_cells, width=3.0, height=1.0)
    require(rect.grid_shape[1] % 32 != 0, "the non-wrapped grid must exercise edge masking")

    def assembled(mesh):
        rows, cols = mesh.grid_shape
        coords = torch.from_numpy(mesh.coords).to(DEV)
        return assemble_stencil_structured(
            coords, E_MOD, NU, THICK, rows, cols, mesh.wrap_cols
        )

    results = {}
    for label, st64, wrap in (
        ("1M plate reduced level 0", reduced_1m, True),
        (f"{big[0]}x{big[1]} plate", assembled(mesh4m), True),
        ("rect, no wrap", assembled(rect), False),
    ):
        _, _, _, rr, cc = st64.shape
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            st = st64.to(dtype).contiguous()
            u = rand(2, rr, cc, dtype=dtype)
            scale = stencil_matvec_plain(st.abs(), u.abs(), wrap).max()
            ref = stencil_matvec_plain(st, u, wrap)
            tag = f"stencil_matvec {label} {rr}x{cc} wrap={wrap} {str(dtype)[6:]}"
            err = compare(tag, stencil_matvec(st, u, wrap), ref, scale, tol)
            a = csr_of_stencil(st, wrap)
            x = u.reshape(-1)
            compare(f"library CSR SpMV {tag}", torch.mv(a, x).reshape(2, rr, cc),
                    ref, scale, tol)
            row = time_kernel(
                tag, lambda: stencil_matvec(st, u, wrap),
                lambda: stencil_matvec_plain(st, u, wrap), lambda: torch.mv(a, x),
                reps, flush, (36 + 4) * rr * cc * st.element_size(), 72 * rr * cc, dtype,
            )
            del a
            # the main path's hot call: the f32 inner solves at the 1M grid
            if label.startswith("1M") and dtype == torch.float32:
                results["stencil_matvec"] = dict(max_abs_err=err, **row)
        del st64
        torch.cuda.empty_cache()
    return results


def phase_card_vs_cpu(small_h, small_plate):
    """Phase 9: the port on the card (kernels) against the port on the CPU
    (plain versions), and mixed precision against f64."""
    import numpy as np
    from magnetite_tpu_torch.config import SolverOptions
    from magnetite_tpu_torch.fem.solve import solve_system

    def agree(label, a_run, b_run, u_tol, tol, iters=True):
        if iters:
            require(abs(a_run.iterations - b_run.iterations) <= 1,
                    f"{label}: iteration counts differ by > 1")
        for name, t in (("u", u_tol), ("f", tol), ("stress", tol), ("von_mises", tol)):
            a, b = getattr(a_run, name), getattr(b_run, name)
            rel = np.abs(a - b).max() / np.abs(b).max()
            say(f"  {label} {name}: {rel:.3e} of max (<= {t:g})")
            require(np.isfinite(a).all() and rel <= t, f"{label}: {name} differs")

    def run(key, case, device, **kw):
        t0 = time.perf_counter()
        r = solve_system(*case, SolverOptions(**kw), device=device)
        extra = f", refine passes {r.timings['refine_outer']}" if "refine_outer" in r.timings else ""
        say(f"  {key}: {r.iterations} iterations{extra}, residual_rel {r.residual_rel:.3e}, "
            f"solve_s {r.timings['solve_s']:.4f}, total {time.perf_counter() - t0:.2f} s")
        return r

    say(f"phase 9: card against CPU, Delaunay plate h={small_h}")
    case = plate_case(small_h)
    say(f"  {case[0].num_nodes} nodes, {case[0].num_elements} elements")
    g = run("cuda f64", case, DEV, dtype="float64")
    c = run("cpu f64", case, "cpu", dtype="float64")
    m = run("cuda mixed", case, DEV, dtype="float32", refine="on")
    agree("cuda f64 vs cpu f64", g, c, 1e-8, 1e-7)
    # f64 CG around the f32 V-cycle reaches rtol 1e-10: the golden bars
    agree("cuda mixed vs cuda f64", m, g, 1e-6, 1e-5, iters=False)

    say(f"phase 9: card against CPU, structured plate {small_plate[0]}x{small_plate[1]}")
    case = structured_case(*small_plate)
    g = run("cuda f64", case, DEV, dtype="float64")
    c = run("cpu f64", case, "cpu", dtype="float64")
    gr = run("cuda f32 refined", case, DEV, dtype="float32")
    cr = run("cpu f32 refined", case, "cpu", dtype="float32")
    agree("cuda f64 vs cpu f64", g, c, 1e-8, 1e-7)
    agree("cuda f32 refined vs cpu f32 refined", gr, cr, 1e-6, 1e-5, iters=False)
    agree("cuda f32 refined vs cuda f64", gr, g, 1e-6, 1e-5, iters=False)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--h", type=float, default=0.00258,
                    help="mesh size of the Delaunay plate (0.00258: ~1M elements)")
    ap.add_argument("--small-h", type=float, default=0.01,
                    help="mesh size of the card-against-CPU Delaunay plate")
    ap.add_argument("--plate", type=int, nargs=2, default=(512, 1024),
                    help="radial x tangential cells of the structured plate (1M elements)")
    ap.add_argument("--big", type=int, nargs=2, default=(1024, 2048),
                    help="the larger structured grid of the stencil kernel phase (4M)")
    ap.add_argument("--rect", type=int, nargs=2, default=(1000, 600),
                    help="x and y cells of the non-wrapped grid of the stencil kernel "
                    "phase (1001 cols: not a multiple of 32)")
    ap.add_argument("--small-plate", type=int, nargs=2, default=(64, 128),
                    help="the structured plate of the card-against-CPU phase")
    ap.add_argument("--reps", type=int, default=20, help="timed launches per kernel")
    ap.add_argument("--profile", action="store_true",
                    help="trace one structured f32-refined solve with torch.profiler")
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

    gen = torch.Generator(device=DEV).manual_seed(0)

    def rand(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=DEV, dtype=torch.float64).to(dtype)

    t0 = time.perf_counter()
    mesh, bca, md = plate_case(args.h)
    problem = compile_problem(mesh, bca, md, SolverOptions(), device=DEV)
    say(f"  Delaunay plate h={args.h}: {mesh.num_nodes} nodes, {mesh.num_elements} "
        f"elements, {len(problem.offsets)} offsets, AMG levels "
        f"{problem.timings['amg_levels']}, prepared in {time.perf_counter() - t0:.2f} s")
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=DEV)
    results = phase_band_and_transfer(problem, args.reps, flush, rand)
    results.update(phase_df(problem, args.reps, flush, rand))
    torch.cuda.empty_cache()

    totals: dict = {}
    with tempfile.TemporaryDirectory() as workdir:
        say(f"phase 5: f64 main path through magnetite_tpu_torch.cli at h={args.h}")
        cli_path("the f64 CLI run", problem, mesh, args.h, workdir, [], 1e-9, totals)
        say(f"phase 6: mixed main path through the CLI (--precision mixed) at h={args.h}")
        cli_path("the mixed CLI run", problem, mesh, args.h, workdir,
                 ["--precision", "mixed"], 1e-9, totals)
    phase_mixed_df(problem, mesh, bca, md, totals)
    del problem
    torch.cuda.empty_cache()

    reduced_1m = phase_structured(*args.plate, totals, args.profile)
    results.update(
        phase_stencil_kernel(reduced_1m, args.big, args.rect, args.reps, flush, rand)
    )
    del reduced_1m, flush
    torch.cuda.empty_cache()
    phase_card_vs_cpu(args.small_h, args.small_plate)

    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    kernels = [
        {
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": totals[name],
            **{k: results[name][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            )},
        }
        for name in KERNELS
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
