"""Structured-grid stencil PCG over a device mesh, sharded by grid rows (1-D)
or by rows x cols tiles (2-D): halo exchange, not gather (port of
magnetite_tpu/parallel/stencil_shard.py).

A grid field [2, R, C] is split into contiguous row bands, one per shard
(1-D), or into an R x C array of tiles in row-major shard order (2-D). One
9-point matvec needs one row of halo from each row neighbour, and on a 2-D
mesh one column from each column neighbour: the exchange runs rows first,
then columns on the row-extended block, so the corners come along. Grid
rows are never periodic (shards at the top and bottom receive zeros, the
zero padding of the single-device operator); a wrapped column axis is a
ring, and a single column shard with wrap is its own neighbour.

Per shard the stencil kernel (`stencil_matvec`, K5) runs on the
halo-extended block [2, rl + 2, cl + 2] with the local stencil zero-padded
once when the operator is made: in 1-D it keeps the grid's column wrap, in
2-D it never wraps (periodicity lives in the exchange). The rows and
columns that pad the grid up to a multiple of the shard counts carry
identity stencil rows (free = 0), so the operator stays SPD.

One controller drives every shard (parallel/dia_shard.py): a shard's
tensors live on its device, a mesh may repeat a device, and the solve runs
the port's one CG (fem/cg.py) on `ShardVec`s with the sum over shards as
its inner product. The multigrid preconditioner smooths the fine level on
the shards and gathers the fine residual once per V-cycle onto each
DISTINCT device of the mesh, where the levels below run as the port's
single-device V-cycle (fem/multigrid.py, the fused smoothing kernels),
replicated; each shard takes its rows (and columns) of the prolonged
correction. As in the JAX package the replicated levels carry no dense
coarse inverse: the coarsest level smooths (48 sweeps).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..bc import BCArrays
from ..config import ModelMetadata
from ..errors import SolverError
from ..fem.blocks import apply_blocks, guarded_inv2
from ..fem.cg import CGResult, pcg
from ..fem.stencil import CENTER
from ..kernels.mg_smooth_kernel import OMEGA, SWEEPS
from ..kernels.stencil_kernel import stencil_matvec
from ..meshing.core import Mesh as FemMesh
from .dia_shard import ShardVec, distinct_devices, exchange_halo, shard_dot


@dataclass
class ShardedStencilProblem:
    """Device-ready sharded structured-grid FEA system.

    Grid arrays are padded to rows divisible by the row shards (and, on a
    2-D mesh, unwrapped cols divisible by the col shards); pad rows and
    cols carry identity stencil rows (free = 0). Per shard, in row-major
    shard order: `reduced` / `raw` [9, 2, 2, rl, cl], `diag_inv` [2, 2, rl,
    cl]; `free_g`, `u_fixed_g`, `f_g`: ShardVecs of [2, rl, cl] fields.
    `col_axis` is set by the 2-D prepare (None: 1-D, rows only). `cache`
    keeps what the solves make once: the padded stencils and center
    inverses per dtype and the replicated coarse levels."""

    device_mesh: object  # parallel.pipeline.DeviceMesh or DeviceMesh2D
    reduced: list
    raw: list
    free_g: ShardVec
    u_fixed_g: ShardVec
    f_g: ShardVec
    diag_inv: list
    rows: int  # un-padded grid rows
    cols: int
    wrap_cols: bool
    col_axis: Optional[str] = None
    cache: dict = field(default_factory=dict, repr=False)

    @property
    def devices(self) -> tuple:
        return tuple(self.device_mesh.devices)

    @property
    def dtype(self) -> torch.dtype:
        return self.reduced[0].dtype

    @property
    def shape(self) -> tuple:
        """(row shards, col shards)."""
        return (len(self.reduced), 1) if self.col_axis is None else tuple(self.device_mesh.shape)


def _build_host_arrays(fem_mesh, bca, metadata, rows_pad, cols_pad, dtype, device):
    """Assemble and BC-reduce on `device`, then pad: (raw, reduced,
    diag_inv, free_g, u_fixed_g, f_g) as whole padded grids; pad rows and
    cols carry identity stencil rows. Shared by the 1-D and 2-D prepares."""
    from ..fem.solve import _grid, _reduce_stencil
    from ..fem.stencil import assemble_stencil_fused, assemble_stencil_structured

    rows, cols = fem_mesh.grid_shape
    wrap = bool(fem_mesh.wrap_cols)
    md = metadata
    mat = (md.youngs_modulus, md.poisson_ratio, md.part_thickness)
    # copies: the arrays of a loaded case are read-only
    coords = torch.from_numpy(np.array(fem_mesh.coords, np.float64)).to(device, dtype)
    if fem_mesh.canonical_grid:
        raw = assemble_stencil_structured(coords, *mat, rows, cols, wrap)
    else:
        tris = torch.from_numpy(np.array(fem_mesh.tris, np.int64)).to(device)
        raw = assemble_stencil_fused(coords, tris, *mat, rows, cols, wrap)

    def field_(a):
        return _grid(torch.from_numpy(np.array(a, np.float64)).to(device, dtype), rows, cols)

    free_g = field_((~bca.u_known).astype(np.float64))
    reduced = _reduce_stencil(raw, free_g, wrap)
    diag_inv = guarded_inv2(reduced[CENTER])

    def pad(a):
        return F.pad(a, (0, cols_pad - cols, 0, rows_pad - rows))

    raw, reduced, diag_inv = pad(raw), pad(reduced), pad(diag_inv)
    for i in range(2):
        reduced[CENTER, i, i, rows:, :] = 1.0
        reduced[CENTER, i, i, :, cols:] = 1.0
        diag_inv[i, i, rows:, :] = 1.0
        diag_inv[i, i, :, cols:] = 1.0
    return (raw, reduced, diag_inv, pad(free_g), pad(field_(bca.u_value)),
            pad(field_(bca.f_value)))


def _tiles(a: torch.Tensor, nr: int, nc: int, devices) -> list:
    """A padded grid array [..., Rp, Cp] cut into nr x nc tiles, row-major,
    each a contiguous tensor on its shard's device."""
    rl, cl = a.shape[-2] // nr, a.shape[-1] // nc
    return [
        a[..., i * rl:(i + 1) * rl, j * cl:(j + 1) * cl].contiguous().to(devices[i * nc + j])
        for i in range(nr) for j in range(nc)
    ]


def _layout(fem_mesh, bca, metadata, device_mesh, nr, nc, cols_pad, dtype, col_axis):
    rows = fem_mesh.grid_shape[0]
    rows_pad = math.ceil(rows / nr) * nr
    devices = tuple(device_mesh.devices)
    tdtype = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    arrays = _build_host_arrays(fem_mesh, bca, metadata, rows_pad, cols_pad, tdtype, devices[0])
    raw, reduced, diag_inv, free_g, u_fixed_g, f_g = (_tiles(a, nr, nc, devices) for a in arrays)
    return ShardedStencilProblem(
        device_mesh=device_mesh, reduced=reduced, raw=raw, free_g=ShardVec(free_g),
        u_fixed_g=ShardVec(u_fixed_g), f_g=ShardVec(f_g), diag_inv=diag_inv,
        rows=int(rows), cols=int(fem_mesh.grid_shape[1]), wrap_cols=bool(fem_mesh.wrap_cols),
        col_axis=col_axis,
    )


def prepare_sharded_stencil_problem(
    fem_mesh: FemMesh,
    bca: BCArrays,
    metadata: ModelMetadata,
    device_mesh,
    dtype=np.float32,
) -> ShardedStencilProblem:
    """Assemble the BC-reduced stencil on the mesh's first device and lay it
    out row-sharded over the 1-D `device_mesh` (parallel.pipeline.
    DeviceMesh)."""
    if fem_mesh.grid_shape is None:
        raise SolverError("sharded stencil solve needs a structured grid mesh")
    cols = fem_mesh.grid_shape[1]
    return _layout(fem_mesh, bca, metadata, device_mesh, device_mesh.size, 1, cols, dtype,
                   None)


# the zero padding of a local stencil for its halo-extended block: one row
# above and below (1-D), one ring (2-D)
_HALO_PAD = {False: (0, 0, 1, 1), True: (1, 1, 1, 1)}


def exchange_halo_rows(u_locals) -> list:
    """[2, rl, cl] per shard of one column of shards -> [2, rl + 2, cl]: the
    last row of the shard above and the first of the shard below; the edge
    shards get zeros (the single-device operator's zero row padding). A
    shard flattened row-major is [2, rl * cl] and one halo row cl
    contiguous entries, so this is dia_shard's exchange with halo cl."""
    rl, cl = u_locals[0].shape[-2:]
    flat = exchange_halo([u.reshape(2, rl * cl) for u in u_locals], cl)
    return [v.reshape(2, rl + 2, cl) for v in flat]


def _row_halo_op(st_ext, wrap_cols: bool):
    """1-D op over stencils already padded by one zero row above and below."""

    def op(u: ShardVec) -> ShardVec:
        rl = u.shards[0].shape[1]
        ext = exchange_halo_rows(u.shards)
        return ShardVec(stencil_matvec(s, v, wrap_cols)[:, 1:1 + rl]
                        for s, v in zip(st_ext, ext))

    return op


def make_halo_stencil_operator(st_locals, wrap_cols: bool):
    """1-D op(u: ShardVec) = K u: one row-halo exchange, then the stencil
    kernel on each shard's [2, rl + 2, C] block with its stencil padded by
    one zero row above and below (once, here) and the grid's column wrap;
    output rows 0 and rl + 1 are sliced off."""
    return _row_halo_op([F.pad(st, _HALO_PAD[False]) for st in st_locals], wrap_cols)


def halo_stencil_matvec(st_locals, u: ShardVec, wrap_cols: bool) -> ShardVec:
    """One-shot row-sharded y = K u; loops hold a make_halo_stencil_operator."""
    return make_halo_stencil_operator(st_locals, wrap_cols)(u)


# ------------------------- 2-D (rows x cols) sharding ------------------------


def _ring_pairs(n: int, forward: bool, wrap: bool) -> list:
    """(source, destination) shard pairs of one step along an axis of n
    shards: forward sends shard j to j + 1; a wrapped axis closes the ring."""
    pairs = ([(j, j + 1) for j in range(n - 1)] if forward
             else [(j + 1, j) for j in range(n - 1)])
    if wrap and n > 1:
        pairs.append((n - 1, 0) if forward else (0, n - 1))
    return pairs


def exchange_halo_2d(u_locals, shape: tuple, wrap_cols: bool) -> list:
    """[2, rl, cl] per tile (row-major over the (nr, nc) mesh) -> [2, rl + 2,
    cl + 2] with all 8 neighbour halos: rows first within each column of
    tiles, then columns on the row-extended blocks, so the corners come
    along. Row edges get zeros; column edges get zeros unless the column
    axis wraps, where a single column shard is its own neighbour."""
    nr, nc = shape
    ext = [None] * (nr * nc)
    for j in range(nc):
        for i, v in enumerate(exchange_halo_rows([u_locals[i * nc + j] for i in range(nr)])):
            ext[i * nc + j] = v
    left = [None] * nc  # left[j]: the tile column whose last column is j's left halo
    right = [None] * nc
    for src, dst in _ring_pairs(nc, True, wrap_cols):
        left[dst] = src
    for src, dst in _ring_pairs(nc, False, wrap_cols):
        right[dst] = src
    if wrap_cols and nc == 1:
        left, right = [0], [0]
    out = []
    for i in range(nr):
        for j in range(nc):
            v = ext[i * nc + j]
            dev = v.device
            edge = torch.zeros((2, v.shape[1], 1), dtype=v.dtype, device=dev)
            lo = (ext[i * nc + left[j]][:, :, -1:].to(dev, non_blocking=True)
                  if left[j] is not None else edge)
            hi = (ext[i * nc + right[j]][:, :, :1].to(dev, non_blocking=True)
                  if right[j] is not None else edge)
            out.append(torch.cat([lo, v, hi], dim=2))
    return out


def _tile_halo_op(st_ext, shape: tuple, wrap_cols: bool):
    """2-D op over stencils already padded by one zero ring."""

    def op(u: ShardVec) -> ShardVec:
        rl, cl = u.shards[0].shape[1:]
        ext = exchange_halo_2d(u.shards, shape, wrap_cols)
        return ShardVec(stencil_matvec(s, v, False)[:, 1:1 + rl, 1:1 + cl]
                        for s, v in zip(st_ext, ext))

    return op


def make_halo_stencil_operator_2d(st_locals, shape: tuple, wrap_cols: bool):
    """2-D op(u: ShardVec) = K u: one 8-neighbour exchange, then the stencil
    kernel on each [2, rl + 2, cl + 2] block with the local stencil padded
    by one zero ring (once, here) and no wrap: periodicity lives entirely
    in the exchange."""
    return _tile_halo_op([F.pad(st, _HALO_PAD[True]) for st in st_locals], shape, wrap_cols)


def prepare_sharded_stencil_problem_2d(
    fem_mesh: FemMesh,
    bca: BCArrays,
    metadata: ModelMetadata,
    device_mesh,
    dtype=np.float32,
) -> ShardedStencilProblem:
    """Assemble and lay out over a 2-D (rows x cols) device mesh
    (parallel.pipeline.DeviceMesh2D). Rows pad to a multiple of the row
    shards (identity pad rows, free = 0); unwrapped cols pad like rows;
    wrapped cols must divide evenly (padding would break periodicity)."""
    if fem_mesh.grid_shape is None:
        raise SolverError("sharded stencil solve needs a structured grid mesh")
    nr, nc = device_mesh.shape
    cols = fem_mesh.grid_shape[1]
    if fem_mesh.wrap_cols:
        if cols % nc:
            raise SolverError(
                f"wrapped cols ({cols}) must divide evenly over {nc} col shards "
                "(padding breaks periodicity)"
            )
        cols_pad = cols
    else:
        cols_pad = math.ceil(cols / nc) * nc
    return _layout(fem_mesh, bca, metadata, device_mesh, nr, nc, cols_pad, dtype,
                   device_mesh.axis_names[1])


# ------------------------------- the solves ----------------------------------


def padded_stencils(problem: ShardedStencilProblem, which: str, dtype=None) -> list:
    """Each shard's `which` ("raw" / "reduced") stencil in `dtype` (default
    the problem's), padded for its halo-extended block: made once per
    problem and kept in its cache."""
    dtype = problem.dtype if dtype is None else dtype
    key = ("padded", which, dtype)
    if key not in problem.cache:
        pad = _HALO_PAD[problem.col_axis is not None]
        problem.cache[key] = [F.pad(st.to(dtype), pad) for st in getattr(problem, which)]
    return problem.cache[key]


def halo_operator(problem: ShardedStencilProblem, which: str = "reduced", dtype=None):
    """The layout's halo operator over the problem's `which` ("raw" /
    "reduced") stencils in `dtype` (default the problem's)."""
    st_ext = padded_stencils(problem, which, dtype)
    if problem.col_axis is None:
        return _row_halo_op(st_ext, problem.wrap_cols)
    return _tile_halo_op(st_ext, problem.shape, problem.wrap_cols)


def _diag_inv(problem: ShardedStencilProblem, dtype) -> list:
    """Each shard's center-block inverse in `dtype`, cast once per problem."""
    if dtype == problem.dtype:
        return problem.diag_inv
    key = ("diag_inv", dtype)
    if key not in problem.cache:
        problem.cache[key] = [d.to(dtype) for d in problem.diag_inv]
    return problem.cache[key]


def _gather_grid(tiles, shape: tuple, devices) -> dict:
    """The whole padded grid array [..., Rp, Cp] from its row-major tiles,
    on each distinct device of `devices`: {device: array}."""
    nr, nc = shape
    out = {}
    for dev in distinct_devices(devices):
        parts = [t.to(dev, non_blocking=True) for t in tiles]
        out[dev] = torch.cat(
            [torch.cat(parts[i * nc:(i + 1) * nc], dim=-1) for i in range(nr)], dim=-2)
    return out


def _build_coarse_levels(problem: ShardedStencilProblem, dtype) -> dict:
    """The levels below the finest, replicated: {device: [MGLevel, ...]},
    one list per distinct device of the mesh, built once in the problem's
    dtype from the un-padded reduced stencil and cast to `dtype`. As in the
    JAX package they carry no dense coarse inverse."""
    from ..fem.multigrid import MGLevel, build_hierarchy

    key = ("coarse", dtype)
    if key not in problem.cache:
        devs = problem.devices
        full = _gather_grid(problem.reduced, problem.shape, devs[:1])[devs[0]]
        levels = build_hierarchy(full[..., :problem.rows, :problem.cols].contiguous(),
                                 problem.wrap_cols)[1:]
        problem.cache[key] = {
            dev: [MGLevel(stencil=lv.stencil.to(dev, dtype), diag_inv=lv.diag_inv.to(dev, dtype),
                          rows=lv.rows, cols=lv.cols) for lv in levels]
            for dev in distinct_devices(devs)
        }
    return problem.cache[key]


def _sharded_mg_preconditioner(fine_op, diag_inv_locals, coarse: dict, *, shape: tuple,
                               wrap: bool, rows: int, cols: int, sweeps: int = SWEEPS,
                               omega: float = OMEGA):
    """V-cycle with sharded fine-level smoothing and a replicated coarse
    solve (the JAX package's _sharded_mg_preconditioner and its _2d twin).

    The fine level smooths shard-locally over `fine_op` (damped
    block-Jacobi, V(sweeps, sweeps); the first sweep starts from zero and
    needs no matvec). The fine residual is gathered once per V-cycle onto
    each distinct device, restricted, and the coarse V-cycle (`coarse`:
    {device: levels}) runs there; each shard adds its tile of the prolonged
    correction and post-smooths. Without coarse levels: the smoothing."""
    from ..fem.multigrid import prolong, restrict, vcycle_preconditioner

    cycles = {dev: vcycle_preconditioner(lv, wrap) for dev, lv in coarse.items() if lv}
    nr, nc = shape

    def jac(r: ShardVec) -> ShardVec:
        return ShardVec(apply_blocks(d, x) for d, x in zip(diag_inv_locals, r.shards))

    def smooth(e, r, n):
        for _ in range(n):
            e = e + omega * jac(r - fine_op(e))
        return e

    def apply(r: ShardVec) -> ShardVec:
        e = smooth(omega * jac(r), r, sweeps - 1)
        if not cycles:
            return e
        rl, cl = r.shards[0].shape[1:]
        res_full = _gather_grid((r - fine_op(e)).shards, shape, [s.device for s in r.shards])
        corr = {}
        for dev, full in res_full.items():
            ec = cycles[dev](restrict(full[:, :rows, :cols], wrap))
            e_full = prolong(ec, wrap)
            corr[dev] = F.pad(e_full, (0, full.shape[2] - cols, 0, full.shape[1] - rows))
        e = e + ShardVec(
            corr[s.device][:, i * rl:(i + 1) * rl, j * cl:(j + 1) * cl]
            for (i, j), s in zip(((i, j) for i in range(nr) for j in range(nc)), e.shards)
        )
        return smooth(e, r, sweeps)

    return apply


def _resolve_preconditioner(problem: ShardedStencilProblem, preconditioner: str) -> str:
    from ..fem.multigrid import can_coarsen

    if preconditioner == "auto":
        return ("multigrid" if can_coarsen(problem.rows, problem.cols, problem.wrap_cols)
                else "block_jacobi")
    return preconditioner


def _preconditioner(problem, kind: str, dtype):
    """multigrid / none / block-Jacobi (every other kind) over the problem's
    reduced stencils and center inverses in `dtype`."""
    diag_inv = _diag_inv(problem, dtype)
    if kind == "multigrid":
        return _sharded_mg_preconditioner(
            halo_operator(problem, "reduced", dtype), diag_inv,
            _build_coarse_levels(problem, dtype), shape=problem.shape, wrap=problem.wrap_cols,
            rows=problem.rows, cols=problem.cols,
        )
    if kind == "none":
        return None
    return lambda r: ShardVec(apply_blocks(d, x) for d, x in zip(diag_inv, r.shards))


def _rhs(raw_mv, problem: ShardedStencilProblem) -> ShardVec:
    free, fixed = problem.free_g, 1.0 - problem.free_g
    return free * (problem.f_g - raw_mv(fixed * problem.u_fixed_g)) + fixed * problem.u_fixed_g


def _clamp_f32_rtol(problem, rtol: float, hint: str) -> float:
    from ..fem.solve import _f32_rtol_floor

    if problem.dtype == torch.float32:
        floor = _f32_rtol_floor()
        if rtol < floor:
            from ..utils.logging import log

            log(f"warning: requested rtol {rtol:.1e} is below the f32 floor; clamping to "
                f"{floor:.1e}{hint}")
            return floor
    return rtol


def _check_layout(problem: ShardedStencilProblem, two_d: bool) -> None:
    if two_d and problem.col_axis is None:
        raise SolverError("problem was prepared 1D; use prepare_sharded_stencil_problem_2d")
    if not two_d and problem.col_axis is not None:
        raise SolverError("problem was prepared 2D; use sharded_stencil_pcg_solve_2d")


def _pcg_solve(problem, rtol, maxiter, preconditioner, history, hint):
    rtol = _clamp_f32_rtol(problem, rtol, hint)
    raw_mv = halo_operator(problem, "raw")
    op = halo_operator(problem)
    precond = _preconditioner(problem, _resolve_preconditioner(problem, preconditioner),
                              problem.dtype)
    result = pcg(op, _rhs(raw_mv, problem), preconditioner=precond, x0=problem.u_fixed_g,
                 rtol=rtol, maxiter=maxiter, dot=shard_dot, history=int(history))
    return result, raw_mv(result.x)


def sharded_stencil_pcg_solve(
    problem: ShardedStencilProblem,
    rtol: float = 1e-6,
    maxiter: int = 100_000,
    preconditioner: str = "auto",
    history: int = 0,
):
    """Row-sharded PCG. preconditioner: "auto" = multigrid when the grid can
    coarsen (sharded fine smoothing + replicated coarse V-cycle), else
    block-Jacobi; "none" runs plain CG. history > 0 records the global
    ||r|| of the first `history` iterations. An f32 problem clamps a
    sub-floor rtol with a warning. Returns (CGResult with x a ShardVec of
    [2, rl, C] row bands, ku = K x)."""
    _check_layout(problem, False)
    return _pcg_solve(problem, rtol, maxiter, preconditioner, history,
                      " (prepare with dtype=np.float64 and sharded_stencil_refined_solve for "
                      "f64-grade residuals)")


def sharded_stencil_pcg_solve_2d(
    problem: ShardedStencilProblem,
    rtol: float = 1e-6,
    maxiter: int = 100_000,
    preconditioner: str = "auto",
    history: int = 0,
):
    """2-D (rows x cols) sharded PCG over a problem from
    `prepare_sharded_stencil_problem_2d`: the 8-neighbour halo operator,
    multigrid gathered over both mesh axes (iteration counts matching the
    1-D path). Returns (CGResult with x a ShardVec of [2, rl, cl] tiles,
    ku)."""
    _check_layout(problem, True)
    return _pcg_solve(problem, rtol, maxiter, preconditioner, history, "")


def _require_f64(problem: ShardedStencilProblem, what: str) -> None:
    if problem.dtype != torch.float64:
        raise SolverError(f"{what} needs an f64 problem: prepare with dtype=np.float64")


def sharded_stencil_refined_solve(
    problem: ShardedStencilProblem,
    rtol: float = 1e-8,
    inner_maxiter: int = 200,
    max_outer: int = 8,
    preconditioner: str = "auto",
    info: Optional[dict] = None,
):
    """Row-sharded f64 / f32 mixed-precision refinement (fem/refine.py):
    the f64 operator and residual checks, f32 inner halo-PCG per shard,
    every reduction over all shards. The problem must be f64. Returns
    (CGResult, ku) like `sharded_stencil_pcg_solve`, iterations the total
    f32 inner iterations; `info`, when given, receives "refine_outer" and
    "refine_inner" (each pass's inner iterations)."""
    from ..fem.refine import mixed_precision_solve

    _check_layout(problem, False)
    _require_f64(problem, "sharded refined solve")
    f32 = torch.float32
    op64 = halo_operator(problem)
    raw_mv64 = halo_operator(problem, "raw")
    op32 = halo_operator(problem, "reduced", f32)
    precond32 = _preconditioner(problem, _resolve_preconditioner(problem, preconditioner), f32)
    result = mixed_precision_solve(
        op64, op32, _rhs(raw_mv64, problem), preconditioner32=precond32,
        x0=problem.u_fixed_g, rtol=rtol, inner_maxiter=inner_maxiter, max_outer=max_outer,
        dot=shard_dot,
    )
    if info is not None:
        info["refine_outer"] = result.outer_steps
        info["refine_inner"] = result.inner_per_pass
    return (
        CGResult(x=result.x, iterations=result.inner_iterations,
                 residual_norm=result.residual_norm, converged=result.converged),
        raw_mv64(result.x),
    )


def sharded_stencil_refined_solve_2d(
    problem: ShardedStencilProblem,
    rtol: float = 1e-9,
    maxiter: int = 100_000,
    preconditioner: str = "auto",
    history: int = 0,
):
    """2-D sharded f64-accurate solve (an f64 problem): f64 CG over the 2-D
    halo operator with an f32 preconditioner (sharded multigrid when the
    grid coarsens, else block-Jacobi), as the JAX package's 2-D path runs
    it. Returns (CGResult, ku)."""
    _check_layout(problem, True)
    _require_f64(problem, "2D refined solve")
    raw_mv = halo_operator(problem, "raw")
    op = halo_operator(problem)
    inner = _preconditioner(problem, _resolve_preconditioner(problem, preconditioner),
                            torch.float32)
    precond = None if inner is None else (
        lambda r: inner(r.to(torch.float32)).to(torch.float64))
    result = pcg(op, _rhs(raw_mv, problem), preconditioner=precond, x0=problem.u_fixed_g,
                 rtol=rtol, maxiter=maxiter, dot=shard_dot, history=int(history))
    return result, raw_mv(result.x)
