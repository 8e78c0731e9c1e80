"""End-to-end device solve: host prep -> operator -> PCG -> recovery (port of
magnetite_tpu/fem/solve.py).

`compile_problem` chooses the operator format as the JAX package does and
builds that mode's operator state, one object per mode, each with
`solve(problem, info)`:

  * `StencilSystem` -- structured-grid meshes (Mesh.grid_shape): the
    stencil operator (fem/stencil.py), assembled on the device from the
    mesh, reduced by the boundary conditions, preconditioned by geometric
    multigrid (fem/multigrid.py) when the grid coarsens.
  * `BandedSystem` -- dia / hybrid, the default for unstructured meshes:
    host renumbering, band structure, C++ closed-form assembly and the AMG
    hierarchy build (numpy / native, as in the JAX package), then one
    upload of the flat assembly, relaid out to bands [D, 2, 2, N] on the
    device.
  * `EllSystem` -- operator='ell': the block-ELL structure in the mesh's
    own node order, the same host assembly into its slots, relaid out
    slot-major [K, 2, 2, N] on the device for the ELL kernel.
  * `DenseSystem` -- meshes of at most `dense_cutoff` nodes: the [2N, 2N]
    system assembled and LU-solved inside `solve`, as in the JAX package.

The operator, the preconditioner's setup (the multigrid hierarchy or the
uploaded AMG one) and the f32 / double-float copies that mixed precision
needs are made once, in `compile_problem`; `solve()` runs CG and the
recovery. On a CUDA device the stencil matvec, the band matvec, the
double-float band matvec, the ELL matvec and the level-0 AMG transfers are
hand-written kernels; on the CPU their plain PyTorch versions.

Mixed precision (`refine`), as in the JAX package: the AMG paths run ONE
f64 PCG whose preconditioner is the f32 V-cycle; every other path runs
classic refinement (fem/refine.py), f64 residuals around f32 inner PCG.
The dense mode never refines.

Persistence, as in the JAX package: `keep_operator_host` keeps the host
assembly as an `OperatorCache` (persist.save_operator writes it), and a
matching `operator_cache` given to `compile_problem` skips the structure,
renumbering and the C++ assembly; with the symmetric offsets of an
assembled banded stiffness only the d >= 0 half is kept, uploaded, and
mirrored into the negative bands on the device. `residual_history` and
`cg_progress_every` reach the PCG loops the JAX package gives them to.

Device assembly, as in the JAX package: `assembly="device"` assembles the
dia / hybrid / ell operator on the device from the uploaded mesh and the
structure's slot ids (the fused assembly kernel, kernels/assembly_kernel.py),
with no host flat: no operator cache is kept or used on that route.
`assembly="auto"` is the host C++ assembly (the port requires the native
library, so JAX's fallback to the device when it is missing has no
counterpart). `solve_system(device_mesh=)` runs the node-sharded pipeline
(parallel/pipeline.py).
"""

from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..bc import BCArrays
from ..config import ModelMetadata, SolverOptions
from ..errors import InputError, SolverError
from ..meshing.core import Mesh
from ..utils.logging import span, spanned
from .cg import PCGGraph, empty_history, pcg
from .stress import element_stress_tensors, scalar_stress, von_mises_stress


@dataclass
class SolveResult:
    """One solve's answer on the host, in the caller's node order.

    On a CUDA device the arrays that the solve did not reorder (all of them
    on a mesh kept in its own node order) are views of one page-locked host
    block from torch's caching host allocator. Dropping the answer returns
    the block to torch's cache, not to the OS: a caller that keeps k answers
    of a 1M-element part holds about k x 64 MB of pinned memory (the
    allocator rounds a ~56-59 MB answer up to a power of two)."""

    u: np.ndarray  # [N,2] nodal displacements
    f: np.ndarray  # [N,2] nodal forces (recovered where unknown)
    sigma: np.ndarray  # [E,3] stress tensors [sx, sy, txy]
    stress: np.ndarray  # [E] reference-formula scalar stress
    von_mises: np.ndarray  # [E] true von Mises stress
    iterations: int
    residual_norm: float  # absolute ||b - K u|| on the reduced system
    residual_rel: float  # residual_norm / ||b||
    converged: bool
    timings: dict
    # ||r|| per iteration for the first SolverOptions.residual_history
    # iterations (empty unless requested; zeros under classic refinement)
    residual_history: np.ndarray = field(default_factory=lambda: np.zeros(0))


_DTYPES = {"float64": torch.float64, "float32": torch.float32}


class StencilParams(NamedTuple):
    """Structured-grid stencil operator (fem/stencil.py)."""

    rows: int
    cols: int
    wrap: bool
    # canonical generator grid: scatter-free structured assembly
    canonical: bool = False


def default_dtype(options: SolverOptions) -> torch.dtype:
    """f64 unless the options ask for f32: the card has native FP64."""
    name = "float64" if options.dtype is None else str(np.dtype(options.dtype))
    if name not in _DTYPES:
        raise InputError(f"unsupported solver dtype '{options.dtype}'")
    return _DTYPES[name]


def _check_options(options: SolverOptions) -> None:
    """Typed errors for what the port does not carry, and for values no
    package knows."""
    if options.operator not in ("auto", "stencil", "dia", "hybrid", "ell"):
        raise InputError(f"unknown operator format '{options.operator}'")
    if options.assembly not in ("auto", "host", "device"):
        raise InputError(
            f"unknown assembly mode '{options.assembly}' (auto | host | device)"
        )
    if options.preconditioner not in (
        "auto", "none", "jacobi", "block_jacobi", "multigrid", "amg"
    ):
        raise InputError(f"unknown preconditioner '{options.preconditioner}'")
    if options.refine not in ("auto", "on", "off"):
        raise InputError(f"unknown refine mode '{options.refine}' (auto | on | off)")
    if options.df_matvec not in ("auto", "on", "off", "interpret"):
        raise InputError(
            f"unknown df_matvec mode '{options.df_matvec}' "
            "(auto | on | off | interpret)"
        )


def resolve_device(device) -> torch.device:
    """The torch device for "cuda" / "cpu"; a CUDA request without a card
    raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SolverError(
            "device 'cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise InputError(f"unsupported device '{device}' (cuda | cpu)")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# each answer array starts on a cache line, a multiple of every dtype's size
_HOST_ALIGN = 64


def _to_host(out, timings: dict) -> list:
    """NumPy arrays of a solve's device outputs, each with the shape, dtype
    and strides that `t.cpu()` gives, and its values bit for bit.

    On a CUDA device the outputs are copied, without blocking, into typed
    views of ONE page-locked block from torch's caching host allocator,
    then read after one sync of the current stream: a DMA at the host
    link's rate, where a pageable copy goes through the driver's staging
    buffer. The arrays own the block (their base keeps it alive); when the
    caller drops them it goes back to the allocator's cache for a later
    solve, so no solve overwrites an answer a caller still holds. Counters:
    `to_host_pinned_bytes` (the answer's bytes, 0 on the CPU) and
    `to_host_new_pinned` (the page-locked allocations this copy caused, 0
    once the cache holds a free block of the size)."""
    dev = out[0].device
    if dev.type != "cuda":
        timings["to_host_pinned_bytes"] = timings["to_host_new_pinned"] = 0
        return [t.numpy() for t in out]
    sizes = [t.numel() * t.element_size() for t in out]
    offsets, end = [], 0
    for nbytes in sizes:
        start = -(-end // _HOST_ALIGN) * _HOST_ALIGN
        offsets.append(start)
        end = start + nbytes
    allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
    block = torch.empty(end, dtype=torch.uint8, pin_memory=True)
    timings["to_host_new_pinned"] = torch.cuda.host_memory_stats()["num_host_alloc"] - allocs
    views = []
    for t, start, nbytes in zip(out, offsets, sizes):
        # `.cpu()`'s layout: t's own strides where t is dense, else contiguous
        strides = torch.empty_like(t, device="meta").stride()
        view = block[start : start + nbytes].view(t.dtype).as_strided(t.shape, strides)
        view.copy_(t, non_blocking=True)
        views.append(view)
    torch.cuda.current_stream(dev).synchronize()
    timings["to_host_pinned_bytes"] = sum(sizes)
    return [v.numpy() for v in views]


# --------------------------- stencil helpers --------------------------------


def _grid(a: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """[N, 2] nodal field -> [2, rows, cols] grid field (cols minormost)."""
    return a.T.reshape(2, rows, cols)


def _reduce_stencil(raw: torch.Tensor, free_g: torch.Tensor, wrap: bool):
    """Fold the BC mask reduction into the stencil: identity on fixed DOFs."""
    from .stencil import CENTER, OFFSETS, shift2d

    reduced = []
    for s, (dr, dt) in enumerate(OFFSETS):
        fin = shift2d(free_g, dr, dt, wrap)
        blk = raw[s] * free_g[:, None] * fin[None, :]
        if s == CENTER:
            blk[0, 0] += 1.0 - free_g[0]
            blk[1, 1] += 1.0 - free_g[1]
        reduced.append(blk)
    return torch.stack(reduced)


def _stencil_preconditioner(kind: str, reduced: torch.Tensor, levels, wrap: bool):
    """The multigrid V-cycle over prebuilt `levels`, nothing ("none"), or
    block-Jacobi on the reduced center blocks (every other kind)."""
    from .blocks import apply_blocks
    from .multigrid import _center_inverse, vcycle_preconditioner

    if kind == "multigrid":
        return vcycle_preconditioner(levels, wrap)
    if kind == "none":
        return None
    with _bj_build(kind):
        inv = _center_inverse(reduced)
    return lambda r: apply_blocks(inv, r)


def _masked(matvec, free: torch.Tensor):
    """(A, A + I on fixed DOFs) for A = free * K * free."""
    def a_op(v):
        return free * matvec(free * v)

    def op(v):
        return a_op(v) + (1.0 - free) * v

    return a_op, op


def _fields_t(p) -> tuple:
    """free, prescribed displacements and applied forces as [2, N] fields
    in the problem arrays' dtype."""
    free_t = (~p.u_known).to(p.u_value.dtype).T.contiguous()
    return free_t, p.u_value.T.contiguous(), p.f_value.T.contiguous()


def _rhs(matvec, free, u_fixed, f):
    """b = free * (f - K u_fixed) + (1 - free) * u_fixed: with it the masked
    solve returns the prescribed values exactly on fixed DOFs."""
    return free * (f - matvec(u_fixed)) + (1.0 - free) * u_fixed


# the span of one preconditioner application, by preconditioner
_PRECOND_SPANS = {"amg": "amg.vcycle", "multigrid": "mg.vcycle", "block_jacobi": "bj.apply"}


def _bj_build(preconditioner: str):
    """The span `bj.build` around the block-Jacobi preconditioner's inverse
    blocks; nothing where those blocks are AMG's smoother, or there are
    none."""
    return span("bj.build") if preconditioner == "block_jacobi" else contextlib.nullcontext()


def _linear_solve(p, info, b, x0, op, precond=None, op32=None, precond32=None, op_cg=None,
                  graph=None):
    """PCG, or under `p.refine` a mixed-precision scheme (the JAX package's
    `_run_linear_solve`): (x, iterations, residual norm, converged,
    history).

    With AMG, ONE f64 PCG whose preconditioner is the f32 V-cycle
    `precond32` (classic refinement stagnates near kappa(A) eps_f32 on
    large unstructured meshes, because its inner solve targets the cast
    operator); `op_cg`, when given, is that PCG's per-iteration operator.
    Otherwise classic refinement around f32 inner PCG on `op32`. `graph`
    (a PCGGraph, or None) replays the PCG: the outer one, or classic
    refinement's inner one.

    The call is the span `cg`; each preconditioner application,
    `amg.vcycle`, `mg.vcycle` or `bj.apply` (block-Jacobi)."""
    cg_kwargs = dict(x0=x0, rtol=p.rtol, atol=p.atol, maxiter=p.maxiter, graph=graph)
    apply_span = _PRECOND_SPANS.get(p.preconditioner)
    if p.refine and p.preconditioner == "amg":
        @spanned(apply_span)
        def precond64(r):
            # normalise before the f32 cast (extreme residual magnitudes
            # would under/overflow the f32 V-cycle); the preconditioner is
            # linear, so rescaling its output is exact
            nrm = torch.sqrt(torch.sum(r * r))
            safe = torch.where(nrm == 0, torch.ones_like(nrm), nrm)
            return precond32((r / safe).to(torch.float32)).to(r.dtype) * safe

        with span("cg"):
            result = pcg(op if op_cg is None else op_cg, b, preconditioner=precond64,
                         **cg_kwargs, **p._observe())
    elif p.refine:
        from .refine import mixed_precision_solve

        if apply_span and precond32 is not None:
            precond32 = spanned(apply_span)(precond32)
        with span("cg"):
            result = mixed_precision_solve(
                op, op32, b, preconditioner32=precond32, x0=x0,
                rtol=p.rtol, atol=p.atol,
                inner_maxiter=p.refine_inner_iters, max_outer=p.refine_max_outer,
                graph=graph,
            )
        info["refine_outer"] = result.outer_steps
        info["refine_inner"] = result.inner_per_pass
        # classic refinement reports `history` zeros, as the JAX package
        # does (its inner solves restart every pass)
        return (
            result.x, result.inner_iterations, result.residual_norm,
            result.converged, empty_history(p.history, b),
        )
    else:
        if apply_span and precond is not None:
            precond = spanned(apply_span)(precond)
        with span("cg"):
            result = pcg(op, b, preconditioner=precond, **cg_kwargs, **p._observe())
    return result.x, result.iterations, result.residual_norm, result.converged, result.history


class SolveGraphs:
    """A system's CUDA graphs of its PCG (fem/cg.PCGGraph), kept on the
    system, which every `dataclasses.replace` of a CompiledProblem shares.

    A solve replays when the system has solved before under the same
    solver settings, on a CUDA device, with no residual history or
    progress: the first solve runs eagerly (it is also the warm-up that
    cuBLAS and the allocator need), the second captures, and later ones
    replay. One-solve jobs never capture. The captured operators read the
    entry's static copies of a solve's `fields` (the tensors made from the
    supports: the free mask, the block-Jacobi inverse), which each solve
    refreshes with `copy_`; the graphs share one memory pool, freed with
    the system."""

    def __init__(self):
        self.solved = set()  # the settings solved under before
        self.entries = {}  # settings -> (static fields, operators, PCGGraph)
        self.pool = None

    def bind(self, p, fields: dict, build):
        """(PCGGraph or None, the operators) of this solve; `build(fields)`
        makes the operators over the given fields."""
        key = (p.refine, p.preconditioner, p.sweeps, p.rtol, p.atol)
        replays = (
            key in self.solved and p.device.type == "cuda"
            and not (p.history or p.progress_every)
        )
        self.solved.add(key)
        if not replays:
            return None, build(fields)
        entry = self.entries.get(key)
        if entry is None:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            static = {name: t.clone() for name, t in fields.items()}
            entry = self.entries[key] = (static, build(static), PCGGraph(self.pool))
        else:
            for name, t in fields.items():
                entry[0][name].copy_(t)
        return entry[2], entry[1]


@dataclass
class StencilSystem:
    """The stencil operator's state: the raw stencil [9, 2, 2, R, C], its
    BC-reduced copy (and that copy in f32 when refining) and the multigrid
    hierarchy (when the preconditioner is "multigrid"). The supports are
    folded into the reduced stencil, so no operator reads a per-solve
    tensor."""

    grid: StencilParams
    stencil: torch.Tensor
    reduced: torch.Tensor
    reduced32: Optional[torch.Tensor]
    mg_levels: Optional[list]
    graphs: SolveGraphs = field(default_factory=SolveGraphs, repr=False, compare=False)

    def _operators(self, p) -> dict:
        from .stencil import make_stencil_operator

        wrap = self.grid.wrap
        op = make_stencil_operator(self.reduced, wrap)
        if p.refine:
            return dict(
                op=op,
                op32=make_stencil_operator(self.reduced32, wrap),
                precond32=_stencil_preconditioner(
                    p.preconditioner, self.reduced32, self.mg_levels, wrap
                ),
            )
        return dict(op=op, precond=_stencil_preconditioner(
            p.preconditioner, self.reduced, self.mg_levels, wrap
        ))

    def solve(self, p, info: dict):
        from .stencil import make_stencil_operator

        rows, cols, wrap, _ = self.grid
        with span("solve.setup"):
            free_g = _grid((~p.u_known).to(self.stencil.dtype), rows, cols)
            fixed_g = 1.0 - free_g
            u_fixed_g = _grid(p.u_value, rows, cols)
            f_g = _grid(p.f_value, rows, cols)
            raw_op = make_stencil_operator(self.stencil, wrap)
            b = free_g * (f_g - raw_op(fixed_g * u_fixed_g)) + fixed_g * u_fixed_g
            graph, ops = self.graphs.bind(p, {}, lambda _: self._operators(p))
        x, iters, resnorm, converged, history = _linear_solve(
            p, info, b, u_fixed_g, graph=graph, **ops
        )

        def matvec_t(v):  # [2, N] <-> grid fields
            return raw_op(v.reshape(2, rows, cols)).reshape(2, -1)

        return matvec_t, x.reshape(2, -1), iters, resnorm, converged, b, history


@dataclass
class BandedSystem:
    """The dia / hybrid operator's state: bands [D, 2, 2, N] over
    `offsets`, the hybrid's COO remainder (rem_vals [R, 2, 2], rem_rows,
    rem_cols; None for dia), the uploaded AMG hierarchy (when the
    preconditioner is "amg"), and under refinement the f32 copies and, with
    the double-float matvec (`df64`: "" | "kernel" | "plain"), the hi/lo
    band pairs [D, 2, 2, 2, N]."""

    offsets: tuple
    bands: torch.Tensor
    rem: Optional[tuple]
    amg: object
    bands32: Optional[torch.Tensor] = None
    rem_vals32: Optional[torch.Tensor] = None
    df64: str = ""
    bands_hl: Optional[torch.Tensor] = None
    graphs: SolveGraphs = field(default_factory=SolveGraphs, repr=False, compare=False)

    def _matvec(self, bands, rem_vals, dia_op=None):
        """K u on [2, N] vectors (unreduced) over the given band values."""
        from .dia import make_dia_operator, make_hybrid_operator

        if self.rem is None:
            return dia_op if dia_op is not None else make_dia_operator(bands, self.offsets)
        _, rem_rows, rem_cols = self.rem
        return make_hybrid_operator(
            bands, self.offsets, rem_vals, rem_rows, rem_cols, dia_op=dia_op
        )

    def _fields(self, p, free_t) -> dict:
        """The tensors of one solve made from its supports: the free mask
        and the block-Jacobi inverse, in the precisions the solve runs."""
        from .dia import block_jacobi_blocks, dia_diag_blocks

        if p.refine:
            free32 = free_t.to(torch.float32)
            with _bj_build(p.preconditioner):
                inv32 = block_jacobi_blocks(dia_diag_blocks(self.bands32, self.offsets), free32)
            return dict(free=free_t, free32=free32, inv32=inv32)
        if p.preconditioner == "none":
            return dict(free=free_t)
        with _bj_build(p.preconditioner):
            inv = block_jacobi_blocks(dia_diag_blocks(self.bands, self.offsets), free_t)
        return dict(free=free_t, inv=inv)

    def _operators(self, p, matvec_t, fields) -> dict:
        """The CG's operators and preconditioners over `fields`."""
        from .amg import make_amg_preconditioner
        from .dia import make_df_dia_operator

        a_op, op = _masked(matvec_t, fields["free"])
        if not p.refine:
            precond = _blocks_apply(fields.get("inv"))
            if p.preconditioner == "amg":
                precond = make_amg_preconditioner(
                    self.amg, op, precond, a_op=a_op, sweeps=p.sweeps
                )
            return dict(op=op, precond=precond)
        a_op32, op32 = _masked(self._matvec(self.bands32, self.rem_vals32), fields["free32"])
        precond32 = _blocks_apply(fields["inv32"])
        op_cg = None
        if p.preconditioner == "amg":
            precond32 = make_amg_preconditioner(
                self.amg, op32, precond32, a_op=a_op32, sweeps=p.sweeps
            )
            if self.df64:
                # the CG's per-iteration matvec as compensated f32 pairs;
                # the rhs and the force recovery keep the true f64 operator
                df_op = make_df_dia_operator(self.bands_hl, self.offsets)
                rem_vals = self.rem[0] if self.rem else None
                _, op_cg = _masked(
                    self._matvec(self.bands, rem_vals, dia_op=df_op), fields["free"]
                )
        return dict(op=op, op32=op32, precond32=precond32, op_cg=op_cg)

    def solve(self, p, info: dict):
        with span("solve.setup"):
            matvec_t = self._matvec(self.bands, self.rem[0] if self.rem else None)
            free_t, u_fixed_t, f_t = _fields_t(p)
            b = _rhs(matvec_t, free_t, u_fixed_t, f_t)
            graph, ops = self.graphs.bind(
                p, self._fields(p, free_t), lambda f: self._operators(p, matvec_t, f)
            )
        x, iters, resnorm, converged, history = _linear_solve(
            p, info, b, u_fixed_t, graph=graph, **ops
        )
        return matvec_t, x, iters, resnorm, converged, b, history


def _blocks_apply(inv: Optional[torch.Tensor]):
    """r -> inv r for 2x2 blocks inv [2, 2, N] (None: no preconditioner)."""
    from .blocks import apply_blocks

    return None if inv is None else (lambda r: apply_blocks(inv, r))


def _diag_inverse(kind: str, diag: torch.Tensor, free: torch.Tensor):
    """The tensor of the JAX package's `_make_preconditioner` on [2, N]
    fields from the diagonal blocks [2, 2, N]: the reduced blocks' inverses
    ("block_jacobi", and "amg"'s smoother), the reduced diagonal [2, N]
    (scalar Jacobi) or None ("none", the identity)."""
    from .dia import block_jacobi_blocks

    if kind == "none":
        return None
    if kind == "jacobi":
        return free * torch.stack([diag[0, 0], diag[1, 1]]) + (1.0 - free)
    return block_jacobi_blocks(diag, free)


def _diag_apply(kind: str, t: Optional[torch.Tensor]):
    """The preconditioner of `_diag_inverse(kind, ...)`'s tensor t."""
    if kind == "jacobi":
        return lambda r: r / t
    return _blocks_apply(t)


@dataclass
class EllSystem:
    """The ELL operator's state: slot-major blocks data [K, 2, 2, N] and
    cols [K, N] int32 in the mesh's own node order (the ELL kernel on the
    card), the uploaded AMG hierarchy (when the preconditioner is "amg"),
    and the f32 copy of data when refining."""

    data: torch.Tensor
    cols: torch.Tensor
    amg: object
    data32: Optional[torch.Tensor] = None
    graphs: SolveGraphs = field(default_factory=SolveGraphs, repr=False, compare=False)

    def _fields(self, p, free_t) -> dict:
        """The tensors of one solve made from its supports: the free mask
        and the diagonal preconditioner's tensor, in the precisions the
        solve runs."""
        from ..kernels.ell_kernel import ell_diag_blocks

        diag = ell_diag_blocks(self.data, self.cols)
        fields = dict(free=free_t)
        free = free_t
        if p.refine:
            fields["free32"] = free = free_t.to(torch.float32)
            diag = diag.to(torch.float32)
        with _bj_build(p.preconditioner):
            inv = _diag_inverse(p.preconditioner, diag, free)
        if inv is not None:
            fields["inv"] = inv
        return fields

    def _operators(self, p, matvec_t, fields) -> dict:
        """The CG's operators and preconditioners over `fields`."""
        from ..kernels.ell_kernel import ell_matvec_t
        from .amg import make_amg_preconditioner

        a_op, op = _masked(matvec_t, fields["free"])
        precond = _diag_apply(p.preconditioner, fields.get("inv"))
        if not p.refine:
            if p.preconditioner == "amg":
                precond = make_amg_preconditioner(
                    self.amg, op, precond, a_op=a_op, sweeps=p.sweeps
                )
            return dict(op=op, precond=precond)
        a_op32, op32 = _masked(lambda v: ell_matvec_t(self.data32, self.cols, v),
                               fields["free32"])
        if p.preconditioner == "amg":
            precond = make_amg_preconditioner(
                self.amg, op32, precond, a_op=a_op32, sweeps=p.sweeps
            )
        return dict(op=op, op32=op32, precond32=precond)

    def solve(self, p, info: dict):
        from ..kernels.ell_kernel import ell_matvec_t

        def matvec_t(v):
            return ell_matvec_t(self.data, self.cols, v)

        with span("solve.setup"):
            free_t, u_fixed_t, f_t = _fields_t(p)
            b = _rhs(matvec_t, free_t, u_fixed_t, f_t)
            graph, ops = self.graphs.bind(
                p, self._fields(p, free_t), lambda f: self._operators(p, matvec_t, f)
            )
        x, iters, resnorm, converged, history = _linear_solve(
            p, info, b, u_fixed_t, graph=graph, **ops
        )
        return matvec_t, x, iters, resnorm, converged, b, history


class DenseSystem:
    """The dense mode: nothing resident beyond the problem arrays. `solve`
    assembles the [2N, 2N] stiffness from the element matrices and solves
    the masked system free (x) free * K + diag(1 - free) by LU
    (torch.linalg.solve), as the JAX package's `_solve_dense`: no
    iterations, no preconditioner, never refined."""

    def solve(self, p, info: dict):
        from .amg import ieee_f32
        from .assembly import assemble_dense
        from .element import element_stiffness_matrices

        md = p.metadata
        n = p.coords.shape[0]
        ke = element_stiffness_matrices(
            p.coords, p.tris, md.youngs_modulus, md.poisson_ratio, md.part_thickness
        )
        kmat = assemble_dense(ke, p.tris, n)
        free = (~p.u_known).to(kmat.dtype).reshape(-1)  # node-major DOFs
        u_value, f_value = p.u_value.reshape(-1), p.f_value.reshape(-1)
        with ieee_f32():
            a = kmat * (free[:, None] * free[None, :]) + torch.diag(1.0 - free)
            b = free * (f_value - kmat @ u_value) + (1.0 - free) * u_value
            u_flat = torch.linalg.solve(a, b)
            resnorm = torch.linalg.norm(free * (f_value - kmat @ u_flat))

        def matvec_t(v):  # [2, N] <-> node-major DOFs
            with ieee_f32():
                return (kmat @ v.T.reshape(-1)).reshape(n, 2).T

        return (
            matvec_t, u_flat.reshape(n, 2).T,
            torch.zeros((), dtype=torch.int64, device=b.device), resnorm,
            torch.ones((), dtype=torch.bool, device=b.device), b,
            empty_history(p.history, b),
        )


@dataclass
class CompiledProblem:
    """A mesh + BC system assembled and resident on one device.

    `solve()` runs the device pipeline and fetches the results to the host,
    in the caller's original node order (`perm[new] = old` records the
    internal renumbering, if any). `dtype` is the working precision the
    options asked for; with `refine` the operator, the CG vectors and the
    problem arrays are f64 and only the inner solves / V-cycle run in it.
    `system` holds the mode's operator state (StencilSystem, BandedSystem,
    EllSystem or DenseSystem).
    """

    mode: str  # "stencil" | "dia" | "hybrid" | "ell" | "dense"
    preconditioner: str
    timings: dict
    device: torch.device
    dtype: torch.dtype
    coords: torch.Tensor
    tris: torch.Tensor
    u_known: torch.Tensor
    u_value: torch.Tensor
    f_value: torch.Tensor
    metadata: ModelMetadata
    rtol: float
    atol: float
    maxiter: int
    sweeps: int
    stress_sign_threshold: float
    system: object
    refine: bool = False
    refine_inner_iters: int = 400
    refine_max_outer: int = 8
    perm: Optional[np.ndarray] = None
    amg_setup: object = None
    debug_nans: bool = False
    # observability (SolverOptions.residual_history / cg_progress_every)
    history: int = 0
    progress_every: int = 0
    # the host assembly kept for persist.save_operator (keep_operator_host)
    operator_host: Optional["OperatorCache"] = None

    def _observe(self) -> dict:
        """The PCG loops' observability options (never classic refinement's
        inner solves, as in the JAX package)."""
        return dict(history=self.history, progress_every=self.progress_every)

    def solve_device(self, info: Optional[dict] = None):
        """Raw device outputs (renumbered order): u, f, sigma, stress, vm,
        iterations, residual norm, converged, ||b|| and the residual history
        ([history], zeros past the iterations). `info`, when given,
        receives facts of the run: the refinement passes (an int) and each
        pass's inner iterations (device scalars)."""
        info = {} if info is None else info
        matvec_t, x, iters, resnorm, converged, b, history = self.system.solve(self, info)
        with span("solve.recover"):
            u = x.T
            # unknown forces are K u rows; known applied forces pass through
            f = torch.where(self.u_known, matvec_t(x).T, self.f_value)
            md = self.metadata
            # in the operator's dtype, f64 also when refining: the JAX
            # package recovers refined stresses in f32, ~1e-5 of max off
            # the f64 values
            sigma = element_stress_tensors(
                self.coords, self.tris, u, md.youngs_modulus, md.poisson_ratio
            )
            stress = scalar_stress(sigma, sign_threshold=self.stress_sign_threshold)
            vm = von_mises_stress(sigma)
            bnorm = torch.sqrt(torch.sum(b * b))
        return u, f, sigma, stress, vm, iters, resnorm, converged, bnorm, history

    @spanned("solve")
    def solve(self) -> SolveResult:
        timings = dict(self.timings)
        with span("solve.device", timings, "solve_s"):
            out = self.solve_device(timings)
            with span("solve.wait"):
                _sync(self.device)
        if "refine_inner" in timings:
            timings["refine_inner"] = [int(k) for k in timings["refine_inner"]]

        with span("solve.to_host"):
            u, f, sigma, stress, vm, iters, resnorm, converged, bnorm, history = _to_host(
                out, timings
            )
        if self.perm is not None:
            with span("solve.unpermute"):
                # new node i is original node perm[i]; element order is
                # unchanged
                u_o, f_o = np.empty_like(u), np.empty_like(f)
                u_o[self.perm], f_o[self.perm] = u, f
                u, f = u_o, f_o
        if self.debug_nans:
            for name, arr in (("displacements", u), ("forces", f), ("stresses", sigma)):
                if not np.isfinite(arr).all():
                    raise SolverError(
                        f"non-finite values in solved {name} "
                        "(debug_nans): check material properties, mesh "
                        "quality, and boundary conditions"
                    )
        if not bool(converged):
            raise SolverError(
                f"conjugate gradient failed to converge in {int(iters)} "
                f"iterations (residual norm {float(resnorm):.3e})"
            )
        return SolveResult(
            u=u,
            f=f,
            sigma=sigma,
            stress=stress,
            von_mises=vm,
            iterations=int(iters),
            residual_norm=float(resnorm),
            residual_rel=float(resnorm) / max(float(bnorm), 1e-300),
            converged=True,
            timings=timings,
            residual_history=history[: int(iters)],
        )


def _f32_rtol_floor() -> float:
    return 50 * float(np.finfo(np.float32).eps)


# the double-float matvec's attainable relative residual (~2^-46 of the
# term scale through the stiffness matvec's cancellation at 1M elements)
_DF_RTOL_FLOOR = 2e-9


def _permuted_bca(bca: BCArrays, perm: np.ndarray) -> BCArrays:
    return BCArrays(
        u_known=bca.u_known[perm], u_value=bca.u_value[perm], f_value=bca.f_value[perm]
    )


def _renumber_if_needed(mesh, bca, options):
    """Band-friendly renumbering (meshing/reorder.py) when the mesh's own
    order misses the DIA format; returns (mesh, bca, perm or None)."""
    from ..meshing.reorder import band_stats, renumber as _renumber
    from .dia import build_dia_structure

    n = mesh.num_nodes
    if build_dia_structure(mesh.tris, n, max_diags=options.max_diags) is not None:
        return mesh, bca, None
    orig = band_stats(mesh.tris, top_k=options.max_diags)
    mesh_r, perm_r, stats = _renumber(
        mesh, method=options.renumber, top_k=options.max_diags
    )
    if not (
        stats.n_offsets <= options.max_diags < orig.n_offsets
        or stats.remainder_frac < orig.remainder_frac
    ):
        return mesh, bca, None
    from ..utils.logging import log

    log(
        "info: renumbered nodes for banded SpMV: "
        f"{orig.n_offsets} -> {stats.n_offsets} distinct "
        "offsets, out-of-band remainder "
        f"{orig.remainder_frac:.1%} -> {stats.remainder_frac:.1%}"
    )
    return mesh_r, _permuted_bca(bca, perm_r), perm_r


def _stencil_mode(mesh: Mesh, options: SolverOptions) -> Optional[StencilParams]:
    """The stencil operator's grid when the mesh takes it, else None (an
    explicit operator='stencil' that cannot be honoured raises)."""
    if options.operator not in ("auto", "stencil"):
        return None
    if mesh.grid_shape is None:
        if options.operator == "stencil":
            raise SolverError(
                "operator='stencil' requires a structured-grid mesh "
                "(Mesh.grid_shape); this mesh has none"
            )
        return None
    rows, cols = mesh.grid_shape
    ok = mesh.grid_local
    if not ok:
        # untrusted producer: verify every coupling is grid-local
        from .stencil import build_stencil_structure

        ok = build_stencil_structure(mesh.tris, rows, cols, mesh.wrap_cols) is not None
    if ok:
        return StencilParams(int(rows), int(cols), bool(mesh.wrap_cols), bool(mesh.canonical_grid))
    if options.operator == "stencil":
        raise SolverError(
            "mesh connectivity is not grid-local; stencil operator unavailable"
        )
    return None


def _problem_arrays(mesh, bca, np_dtype, dev) -> dict:
    # copies: the arrays of a loaded case are read-only
    return dict(
        coords=torch.from_numpy(mesh.coords.astype(np_dtype)).to(dev),
        tris=torch.from_numpy(np.array(mesh.tris, np.int64)).to(dev),
        u_known=torch.from_numpy(np.array(bca.u_known, bool)).to(dev),
        u_value=torch.from_numpy(bca.u_value.astype(np_dtype)).to(dev),
        f_value=torch.from_numpy(bca.f_value.astype(np_dtype)).to(dev),
    )


def _compile_stencil(grid, mesh, bca, metadata, np_dtype, dev, refine, preconditioner, timings):
    """Upload the mesh, assemble and reduce the stencil on the device, and
    build the multigrid hierarchy (in f32 when refining): (StencilSystem,
    the problem arrays)."""
    from .multigrid import build_hierarchy
    from .stencil import assemble_stencil_fused, assemble_stencil_structured

    with span("compile.upload", timings, "upload_s"):
        arrays = _problem_arrays(mesh, bca, np_dtype, dev)
        _sync(dev)

    with span("compile.assemble", timings, "assemble_s"):
        rows, cols, wrap, canonical = grid
        md = metadata
        e, nu, t = md.youngs_modulus, md.poisson_ratio, md.part_thickness
        if canonical:
            raw = assemble_stencil_structured(arrays["coords"], e, nu, t, rows, cols, wrap)
        else:
            raw = assemble_stencil_fused(
                arrays["coords"], arrays["tris"], e, nu, t, rows, cols, wrap
            )
        free_g = _grid((~arrays["u_known"]).to(raw.dtype), rows, cols)
        reduced = _reduce_stencil(raw, free_g, wrap)
        reduced32 = reduced.to(torch.float32) if refine else None
        _sync(dev)

    levels = None
    if preconditioner == "multigrid":
        with span("compile.mg_build", timings, "mg_build_s"):
            levels = build_hierarchy(reduced32 if refine else reduced, wrap)
            _sync(dev)
        timings["mg_levels"] = [(lv.rows, lv.cols) for lv in levels]
    return StencilSystem(grid, raw, reduced, reduced32, levels), arrays


def _decide_df64(options, refine, preconditioner, mode, dev, rtol) -> str:
    """Whether the refined AMG CG's band matvec runs in double-float pairs.

    "auto" is native f64 on the card: the hi/lo f32 pairs stream the same
    8 B per band entry as f64, and the H100 has native FP64, so the df
    kernel cannot beat dia_matvec<double> on bandwidth (chip_smoke.py times
    them in turns: df / f64 = 1.007-1.021 at a 1M-element plate's level-0
    bands on an H100 SXM at 700 W). "on" forces the double-float
    operator: the df kernel on the card, its plain version on the CPU.
    "interpret" (the JAX package's interpreter mode, kept for option
    parity) follows the same rule: the device decides, never the option."""
    if not (refine and preconditioner == "amg" and mode in ("dia", "hybrid")):
        return ""
    if options.df_matvec not in ("on", "interpret"):
        return ""
    df64 = "kernel" if dev.type == "cuda" else "plain"
    if df64 and rtol < _DF_RTOL_FLOOR:
        from ..utils.logging import log

        log(
            f"warning: df_matvec with cg_rtol {rtol:.1e} is below the "
            "double-float kernel's ~2e-9 attainable relative residual; "
            "reported residuals are measured against the compensated "
            "f32-pair operator (set df_matvec='off' for true f64)"
        )
    return df64


@dataclass
class OperatorCache:
    """A persisted compile-time assembly product (persist.save_operator; the
    port of the JAX package's fem/solve.py::OperatorCache, one file format).

    Holds the slot-major flat [n_slots, 4] f64 stiffness values the banded
    and ELL formats assemble once at compile time, keyed by the INPUT-ORDER
    mesh identity (fem/amg.mesh_state_hash) + material. A resumed compile
    that matches skips the structure, renumbering and the C++ closed-form
    assembly: prep becomes one upload."""

    mesh_hash: str
    material: tuple  # (youngs_modulus, poisson_ratio, part_thickness)
    mode: str  # "dia" | "hybrid" | "ell"
    offsets: tuple  # band offsets (dia / hybrid); () for ell
    flat: np.ndarray  # [n_slots, 4] f64 slot-major assembled values
    cols: Optional[np.ndarray]  # hybrid remainder index [2, R] / ell cols [n, w]
    perm: Optional[np.ndarray]  # renumbering applied at compile, if any
    # True: `flat` holds only the d >= 0 band slots (+ hybrid remainder);
    # the negative bands are rebuilt on the device from block symmetry
    sym_half: bool = False

    def matches(self, mesh_hash: str, metadata) -> bool:
        mat = (
            float(metadata.youngs_modulus),
            float(metadata.poisson_ratio),
            float(metadata.part_thickness),
        )
        return self.mesh_hash == mesh_hash and tuple(self.material) == mat


def _operator_cache_hit(cache, mesh_hash, metadata, options, timings):
    """`cache` when this compile resumes from it, else None. A miss is
    warned about and recorded in timings["operator_cache"], as the JAX
    package does."""
    from ..utils.logging import log

    if cache is None:
        return None
    if cache.perm is not None and options.renumber == "off":
        log(
            "warning: operator cache was assembled under a renumbering "
            "but renumber='off' pins the input order; re-assembling"
        )
        timings["operator_cache"] = "miss"
        return None
    if options.operator not in ("auto", cache.mode):
        return None
    if not cache.matches(mesh_hash, metadata):
        log(
            "warning: provided operator cache does not match this "
            "problem (mesh bytes, BC mask, or material); re-assembling"
        )
        timings["operator_cache"] = "miss"
        return None
    timings["operator_cache"] = "hit"
    return cache


def _sym_half_offsets(mode: str, offsets: tuple) -> tuple:
    """The negative band offsets when every one has its mirror (the
    symmetric-half layout applies), else ()."""
    if mode not in ("dia", "hybrid"):
        return ()
    neg = tuple(o for o in offsets if o < 0)
    return neg if neg and all(-o in offsets for o in neg) else ()


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev`. A read-only array (a memory-mapped cache file)
    is only read: every tensor the compile keeps is a copy of it."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(a).to(dev)


def _upload_flat(mode, offsets, n, flat, np_dtype, dev, flat_is_half=False):
    """Upload a slot-major flat assembly and lay it out as bands [D, 2, 2, N]
    (and the hybrid remainder [R, 2, 2]) on the device.

    The unreduced stiffness is block-symmetric, band(-o)[i] =
    band(+o)[i - o]^T, and the sorted offsets put the d >= 0 band slots and
    the hybrid remainder in one contiguous tail of `flat`: only that tail is
    uploaded (the whole of `flat` when it is a cache's symmetric half), and
    the negative bands are its rolled, transposed copies, made on the
    device. Offsets without their mirrors upload everything."""
    neg = _sym_half_offsets(mode, offsets)
    if flat_is_half and not neg:
        raise InputError(
            "operator cache holds a symmetric-half assembly but the offset "
            "set is not sign-symmetric; the cache file is corrupt"
        )
    d, d0 = len(offsets), len(neg)
    host = flat if flat_is_half else flat[d0 * n :]
    flat_d = _to_device(host.astype(np_dtype, copy=False), dev)
    pos = flat_d[: (d - d0) * n].reshape(d - d0, n, 2, 2)
    bands = torch.empty((d, 2, 2, n), dtype=flat_d.dtype, device=dev)
    bands[d0:] = pos.permute(0, 2, 3, 1)
    pos_offsets = offsets[d0:]
    for i, o in enumerate(neg):
        # band(o)[i] = band(-o)[i + o]^T; rows i < -o wrap to the positive
        # band's last -o rows, which are zero (their column is past n)
        bands[i] = torch.roll(pos[pos_offsets.index(-o)], -o, dims=0).permute(2, 1, 0)
    rem_vals = None
    if mode == "hybrid":
        rem_vals = flat_d[(d - d0) * n :].reshape(-1, 2, 2).clone()
    return bands, rem_vals, int(host.shape[0] * host.shape[1] * np.dtype(np_dtype).itemsize)


def _upload_ell(n, flat, cols, np_dtype, dev):
    """Upload an ELL flat assembly [N * K, 4] and its cols [N, K], and lay
    them out slot-major on the device: (data [K, 2, 2, N], cols [K, N]
    int32, bytes of the values uploaded)."""
    from ..kernels.ell_kernel import ell_to_slot_major

    host = flat.astype(np_dtype, copy=False)
    k = cols.shape[1]
    data, cols_d = ell_to_slot_major(
        _to_device(host, dev).reshape(n, k, 2, 2),
        _to_device(np.asarray(cols, np.int32), dev),
    )
    return data, cols_d, int(host.nbytes)


def _assemble_flat(mode, offsets, cols, slot_ids, mesh, metadata, operator_cache, timings):
    """The slot-major flat [S, 4] f64 assembly: the operator cache's, or the
    host C++ closed-form assembly through the slot ids (the JAX package's
    `_assemble_host_flat`). Returns (flat, whether it is a symmetric
    half)."""
    from .. import native

    with span("compile.assemble", timings, "assemble_s"):
        if operator_cache is not None:
            return operator_cache.flat, bool(operator_cache.sym_half)
        n = mesh.num_nodes
        if mode == "ell":
            n_slots = n * cols.shape[1]
        else:
            n_slots = len(offsets) * n + (cols.shape[1] if mode == "hybrid" else 0)
        slots_pm = (
            np.asarray(slot_ids, np.int64)
            .reshape(mesh.tris.shape[0], 3, 3)
            .transpose(1, 2, 0)
            .reshape(-1)
        )
        flat = native.amg_assemble(
            mesh.coords, mesh.tris, np.ones((n, 2)),
            metadata.youngs_modulus, metadata.poisson_ratio,
            metadata.part_thickness, slots_pm, n_slots,
        )
    return flat, False


def _kept_operator(mode, offsets, n, flat, flat_is_half, cols, perm, mesh_hash, metadata):
    """The host assembly as an OperatorCache (keep_operator_host): the
    d >= 0 half of a banded operator when symmetry allows (it halves the
    host copy and the persisted file), the whole ELL flat with its cols."""
    neg = _sym_half_offsets(mode, offsets)
    return OperatorCache(
        mesh_hash=mesh_hash,
        material=(
            float(metadata.youngs_modulus),
            float(metadata.poisson_ratio),
            float(metadata.part_thickness),
        ),
        mode=mode,
        offsets=offsets,
        flat=flat if flat_is_half or not neg else flat[len(neg) * n :].copy(),
        cols=np.asarray(cols) if mode in ("hybrid", "ell") else None,
        perm=perm,
        sym_half=flat_is_half or bool(neg),
    )


def _amg_setup(mesh, bca, metadata, options, amg_setup, mesh_hash, perm, timings):
    """The AMG hierarchy of this problem: `amg_setup` when it matches, else
    a fresh build (host numpy / native)."""
    from ..utils.logging import log
    from .amg import build_amg_setup, setup_matches

    with span("compile.amg_build", timings, "amg_build_s"):
        free = (~bca.u_known).astype(np.float64)
        cell_factor = float(options.amg_cell_factor)
        # the input-order hash holds for the compiled mesh only when no
        # renumbering intervened
        amg_hash = mesh_hash if perm is None else None
        setup = amg_setup
        if setup is not None:
            with span("compile.amg_match"):
                matches = setup_matches(
                    setup, mesh.coords, mesh.tris, free, metadata, cell_factor, perm,
                    mesh_hash=amg_hash,
                )
            if not matches:
                log(
                    "warning: provided AMG hierarchy does not match this "
                    "problem (mesh ordering, BCs, material, aggregation size, "
                    "or an older cache format); rebuilding"
                )
                setup = None
        if setup is None:
            setup = build_amg_setup(
                mesh.coords, mesh.tris,
                metadata.youngs_modulus, metadata.poisson_ratio,
                metadata.part_thickness, free, cell_factor=cell_factor,
                mesh_hash=amg_hash,
            )
    timings["amg_levels"] = setup.level_sizes
    return setup


def assemble_ell_arrays_fused(coords, tris, e, nu, t, slot_ids, n_nodes: int,
                              width: int) -> torch.Tensor:
    """ELL device assembly from the closed-form pair fields (the JAX
    package's `assemble_ell_arrays_fused`): f64 coords [N, 2], int64 tris
    [E, 3], slot ids [E*9] -> [N, K, 2, 2] f64."""
    return _assemble_ell_slot_major(
        coords, tris, e, nu, t, slot_ids, n_nodes, width
    ).permute(3, 0, 1, 2).contiguous()


def _assemble_ell_slot_major(coords, tris, e, nu, t, slot_ids, n_nodes, width,
                             dtype=torch.float64):
    """The ELL device assembly laid out slot-major, [K, 2, 2, N] in `dtype`
    (summed in f64), as the ELL kernel reads it."""
    from ..kernels.assembly_kernel import assemble_pairs

    return assemble_pairs(coords, tris, slot_ids, n_nodes, width, e, nu, t, ell=True,
                          dtype=dtype)[0]


def _assemble_on_device(mode, offsets, cols, slots, arrays, metadata, n, dtype):
    """assembly="device": the operator assembled on the slot ids' device
    from the resident mesh, summed in f64 and written in `dtype`: (data,
    cols) for ell, (bands, rem) for dia / hybrid."""
    from .dia import assemble_dia_fused, assemble_hybrid_fused

    dev = slots.device
    coords = arrays["coords"].to(torch.float64)
    md = metadata
    mat = (md.youngs_modulus, md.poisson_ratio, md.part_thickness)
    if mode == "ell":
        data = _assemble_ell_slot_major(coords, arrays["tris"], *mat, slots, n, cols.shape[1],
                                        dtype)
        return data, torch.from_numpy(np.asarray(cols, np.int32).T.copy()).to(dev)
    if mode == "dia":
        return assemble_dia_fused(coords, arrays["tris"], *mat, slots, n, len(offsets),
                                  dtype), None
    bands, rem_vals = assemble_hybrid_fused(
        coords, arrays["tris"], *mat, slots, n, len(offsets), cols.shape[1], dtype
    )
    cols_d = torch.from_numpy(cols).to(dev)
    return bands, (rem_vals, cols_d[0], cols_d[1])


def _compile_assembled(mode, offsets, cols, slot_ids, mesh, bca, metadata, options,
                       operator_cache, amg_setup, mesh_hash, perm, preconditioner,
                       refine, dtype, np_dtype, dev, rtol, timings):
    """The assembled modes (dia, hybrid, ell): the host flat assembly and
    its kept copy, the AMG hierarchy, ONE upload of the flat relaid out on
    the device; or, under assembly="device", the upload of the mesh and
    the slot ids and the assembly on the device. Returns (BandedSystem or
    EllSystem, the problem arrays, the AMG setup, the kept
    OperatorCache)."""
    n = mesh.num_nodes
    on_device = options.assembly == "device"
    operator_host = None
    if not on_device:
        flat, flat_is_half = _assemble_flat(
            mode, offsets, cols, slot_ids, mesh, metadata, operator_cache, timings
        )
        if options.keep_operator_host:
            operator_host = _kept_operator(
                mode, offsets, n, flat, flat_is_half, cols, perm, mesh_hash, metadata
            )
    setup = None
    if preconditioner == "amg":
        setup = _amg_setup(mesh, bca, metadata, options, amg_setup, mesh_hash, perm, timings)

    if on_device:
        with span("compile.upload", timings, "upload_s"):
            arrays = _problem_arrays(mesh, bca, np_dtype, dev)
            slots = torch.from_numpy(np.asarray(slot_ids, np.int64)).to(dev)
            timings["upload_bytes"] = slots.numel() * slots.element_size()
            _sync(dev)
        with span("compile.assemble_device", timings, "assemble_device_s"):
            op_dtype = torch.float64 if np_dtype == np.float64 else torch.float32
            operator = _assemble_on_device(
                mode, offsets, cols, slots, arrays, metadata, n, op_dtype
            )
            if mode == "ell":
                data, cols_d = operator
            else:
                bands, rem = operator
            _sync(dev)
    else:
        with span("compile.upload", timings, "upload_s"):
            if mode == "ell":
                data, cols_d, timings["upload_bytes"] = _upload_ell(
                    n, flat, cols, np_dtype, dev
                )
            else:
                bands, rem_vals, timings["upload_bytes"] = _upload_flat(
                    mode, offsets, n, flat, np_dtype, dev, flat_is_half
                )
                rem = None
                if mode == "hybrid":
                    cols_d = torch.from_numpy(cols).to(dev)
                    rem = (rem_vals, cols_d[0], cols_d[1])
            arrays = _problem_arrays(mesh, bca, np_dtype, dev)
            _sync(dev)

    amg = None
    if setup is not None:
        from .amg import amg_device_arrays

        with span("compile.amg_upload", timings, "amg_upload_s"):
            # refinement runs the V-cycle only in f32
            amg = amg_device_arrays(setup, torch.float32 if refine else dtype, dev)
            _sync(dev)

    df64 = _decide_df64(options, refine, preconditioner, mode, dev, rtol)
    timings["df_matvec"] = df64
    if mode == "ell":
        system = EllSystem(
            data, cols_d, amg, data32=data.to(torch.float32) if refine else None
        )
    else:
        system = BandedSystem(offsets, bands, rem, amg)
        if refine:
            from .dia import split_bands

            system.bands32 = bands.to(torch.float32)
            system.rem_vals32 = rem[0].to(torch.float32) if rem else None
            # the hi/lo split happens once here, never per matvec
            system.df64 = df64
            system.bands_hl = split_bands(bands) if df64 else None
    return system, arrays, setup, operator_host


@spanned("compile_problem")
def compile_problem(
    mesh: Mesh,
    bca: BCArrays,
    metadata: ModelMetadata,
    options: SolverOptions = SolverOptions(),
    structure=None,
    amg_setup=None,
    operator_cache: Optional[OperatorCache] = None,
    device="cuda",
) -> CompiledProblem:
    """Select the operator format, assemble, build the preconditioner and
    upload everything to `device` ("cuda" or "cpu", never chosen implicitly).

    `structure`: a block-ELL sparsity (fem/assembly.EllStructure, from a
    case checkpoint) pins the node order: no renumbering, as in the JAX
    package; under operator='ell' it is the ELL operator's structure, not
    rebuilt.
    `amg_setup`: a previously built AMGSetup for THIS problem (from either
    package, see interop.py and persist.py); a mismatch is warned about and
    rebuilt.
    `operator_cache`: a persisted assembled operator for THIS mesh +
    material (persist.load_operator); skips the structure, renumbering and
    the C++ assembly; a mismatch is warned about and ignored."""
    from .. import native
    from .amg import mesh_state_hash
    from .assembly import build_ell_structure
    from .dia import build_dia_structure, build_hybrid_structure

    dev = resolve_device(device)
    _check_options(options)
    dtype = default_dtype(options)
    timings: dict = {}
    n = mesh.num_nodes

    if not bca.u_known.any():
        raise SolverError(
            "model has no prescribed displacements; stiffness system is singular"
        )

    with span("compile.structure", timings, "structure_s"):
        mode = "dense" if n <= options.dense_cutoff else None
        grid = _stencil_mode(mesh, options) if mode is None else None
        if grid is not None:
            mode = "stencil"
        perm = None
        offsets = ()
        cols = slot_ids = None
        input_mesh_hash = None
        if options.assembly == "device":
            # the device assembles from the slot ids: a host flat has no use
            operator_cache = None
        if mode is None:
            native.require()
            # the input-order identity, shared by the operator cache check, the
            # AMG fingerprint (when no renumbering intervenes) and the cache a
            # later persist.save_operator writes
            with span("compile.mesh_hash"):
                input_mesh_hash = mesh_state_hash(
                    mesh.coords, mesh.tris, (~bca.u_known).astype(np.float64)
                )
            with span("compile.cache_check"):
                operator_cache = _operator_cache_hit(
                    operator_cache, input_mesh_hash, metadata, options, timings
                )
        else:
            operator_cache = None
        if operator_cache is not None:
            mode = operator_cache.mode
            offsets = operator_cache.offsets
            if operator_cache.perm is not None:
                from ..meshing.reorder import apply_permutation

                perm = np.asarray(operator_cache.perm)
                with span("compile.renumber"):
                    mesh = apply_permutation(mesh, perm)
                    bca = _permuted_bca(bca, perm)
            if mode == "hybrid":
                cols = np.asarray(operator_cache.cols, dtype=np.int64)
            elif mode == "ell":
                cols = np.asarray(operator_cache.cols, dtype=np.int32)
        elif (
            mode is None and options.renumber != "off" and structure is None
            and options.operator in ("auto", "dia", "hybrid")
        ):
            with span("compile.renumber"):
                mesh, bca, perm = _renumber_if_needed(mesh, bca, options)
        if mode is None and options.operator in ("auto", "dia"):
            dia = build_dia_structure(mesh.tris, n, max_diags=options.max_diags)
            if dia is not None:
                mode, slot_ids, offsets = "dia", dia.slot_ids, dia.offsets
            elif options.operator == "dia":
                raise SolverError(
                    f"mesh needs more than {options.max_diags} diagonal bands; "
                    "use operator='hybrid' or 'ell', or renumber the mesh"
                )
        if mode is None and options.operator in ("auto", "hybrid"):
            hyb = build_hybrid_structure(mesh.tris, n, max_diags=options.max_diags)
            mode, slot_ids, offsets = "hybrid", hyb.slot_ids, hyb.offsets
            cols = np.stack([hyb.rem_rows, hyb.rem_cols]).astype(np.int64)
            if cols.shape[1] == 0:  # fully banded after all
                cols = np.zeros((2, 1), dtype=np.int64)
        if mode is None:
            # operator='ell': the mesh's own node order, the given structure
            mode = "ell"
            if structure is None:
                structure = build_ell_structure(mesh.tris, n)
            cols, slot_ids = structure.cols, structure.slot_ids
    timings["operator"] = mode
    if mode == "hybrid":
        timings["remainder_blocks"] = int(cols.shape[1])

    # f32 cannot reach f64-grade residuals: refinement (f64 residual, f32
    # inner solves) reaches them anyway -- "on" anywhere but the dense
    # mode, "auto" on the stencil operator -- and otherwise the tolerance
    # clamps to ~50 eps
    rtol = float(options.cg_rtol)
    refine = (options.refine == "on" and mode != "dense") or (
        mode == "stencil"
        and options.refine == "auto"
        and dtype == torch.float32
        and rtol < _f32_rtol_floor()
    )
    if not refine and dtype == torch.float32 and rtol < _f32_rtol_floor():
        from ..utils.logging import log

        floor = _f32_rtol_floor()
        log(
            f"warning: requested cg_rtol {rtol:.1e} is below the f32 "
            f"floor; clamping to {floor:.1e} (use refine='on' / CLI "
            "--precision mixed for f64-grade residuals)"
        )
        rtol = floor
    timings["refine"] = refine

    preconditioner = options.preconditioner
    if preconditioner == "auto":
        if mode == "stencil":
            from .multigrid import can_coarsen

            preconditioner = (
                "multigrid" if can_coarsen(grid.rows, grid.cols, grid.wrap)
                else "block_jacobi"
            )
        else:
            from .amg import _DENSE_COARSE_MAX_DOF

            preconditioner = (
                "amg"
                if mode in ("dia", "hybrid", "ell")
                and (n >= options.amg_auto_min_nodes or 2 * n <= _DENSE_COARSE_MAX_DOF)
                else "block_jacobi"
            )
    elif preconditioner == "multigrid" and mode != "stencil":
        raise SolverError(
            "multigrid preconditioner requires a structured-grid mesh "
            "(stencil operator)"
        )
    elif preconditioner == "amg" and mode not in ("dia", "hybrid", "ell"):
        raise SolverError(
            "amg preconditioner applies to unstructured operators "
            "(dia/hybrid/ell); structured grids use preconditioner='multigrid'"
        )
    timings["preconditioner"] = preconditioner

    # refinement computes the operator and the residual in f64
    up_dtype = torch.float64 if refine else dtype
    np_dtype = np.float64 if up_dtype == torch.float64 else np.float32
    from .amg import amg_sweep_schedule

    setup = operator_host = None
    if mode == "stencil":
        system, arrays = _compile_stencil(
            grid, mesh, bca, metadata, np_dtype, dev, refine, preconditioner, timings
        )
    elif mode == "dense":
        with span("compile.upload", timings, "upload_s"):
            system, arrays = DenseSystem(), _problem_arrays(mesh, bca, np_dtype, dev)
            _sync(dev)
    else:
        system, arrays, setup, operator_host = _compile_assembled(
            mode, tuple(int(o) for o in offsets), cols, slot_ids, mesh, bca, metadata,
            options, operator_cache, amg_setup, input_mesh_hash, perm, preconditioner,
            refine, dtype, np_dtype, dev, rtol, timings,
        )
    return CompiledProblem(
        mode=mode,
        preconditioner=preconditioner,
        timings=timings,
        device=dev,
        dtype=dtype,
        metadata=metadata,
        rtol=rtol,
        atol=float(options.cg_atol),
        maxiter=int(options.max_cg_iters),
        sweeps=amg_sweep_schedule(refine, int(options.amg_sweeps)),
        stress_sign_threshold=float(options.stress_sign_threshold),
        system=system,
        refine=refine,
        refine_inner_iters=int(options.refine_inner_iters),
        refine_max_outer=int(options.refine_max_outer),
        perm=perm,
        amg_setup=setup,
        debug_nans=bool(options.debug_nans),
        history=int(options.residual_history),
        progress_every=int(options.cg_progress_every),
        operator_host=operator_host,
        **arrays,
    )


def solve_system(
    mesh: Mesh,
    bca: BCArrays,
    metadata: ModelMetadata,
    options: SolverOptions = SolverOptions(),
    structure=None,
    amg_setup=None,
    operator_cache: Optional[OperatorCache] = None,
    device="cuda",
    device_mesh=None,
) -> SolveResult:
    """Full FEA solve of one mesh + boundary-condition set on `device`
    (`structure`, `amg_setup`, `operator_cache`: see compile_problem).

    `device_mesh`: a parallel.pipeline.DeviceMesh routes the whole pipeline
    -- solve, force recovery, stress recovery -- through the node-sharded
    path (parallel/pipeline.py) on the mesh's devices (`device`,
    `structure` and `operator_cache` are then unused, as in the JAX
    package); results match the single-device path to solver tolerance."""
    if device_mesh is not None:
        from ..parallel.pipeline import compile_sharded_problem

        return compile_sharded_problem(
            mesh, bca, metadata, options, device_mesh=device_mesh, amg_setup=amg_setup,
        ).solve()
    return compile_problem(
        mesh, bca, metadata, options, structure=structure, amg_setup=amg_setup,
        operator_cache=operator_cache, device=device,
    ).solve()
