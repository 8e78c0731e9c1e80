"""End-to-end device solve: host prep -> operator -> PCG -> recovery (port of
magnetite_tpu/fem/solve.py for the stencil, DIA and hybrid formats).

Structured-grid meshes (Mesh.grid_shape) take the stencil operator
(fem/stencil.py): assembled on the device from the mesh, reduced by the
boundary conditions, preconditioned by geometric multigrid
(fem/multigrid.py) when the grid coarsens. Unstructured meshes take the
banded formats: host renumbering, band structure, C++ closed-form assembly
and the AMG hierarchy build (numpy / native, as in the JAX package), then
one upload of the flat assembly, relaid out to bands [D, 2, 2, N] on the
device. The operator, the preconditioner's setup (the multigrid hierarchy
or the uploaded AMG one) and the f32 / double-float copies that mixed
precision needs are made once, in `compile_problem`; `solve()` runs CG and
the recovery. On a CUDA device the stencil matvec, the band matvec, the
double-float band matvec and the level-0 AMG transfers are hand-written
kernels; on the CPU their plain PyTorch versions.

Mixed precision (`refine`), as in the JAX package: the AMG path runs ONE
f64 PCG whose preconditioner is the f32 V-cycle; every other path runs
classic refinement (fem/refine.py), f64 residuals around f32 inner PCG.

What the JAX package offers beyond this slice raises a typed error naming
it (the JAX package's rule: an unhonourable combination raises, it is never
silently substituted): the ELL and dense operators, device-side assembly of
the banded formats, residual history, progress streaming and operator
persistence.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..bc import BCArrays
from ..config import ModelMetadata, SolverOptions
from ..errors import InputError, SolverError
from ..meshing.core import Mesh
from .cg import pcg
from .stress import element_stress_tensors, scalar_stress, von_mises_stress


@dataclass
class SolveResult:
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
    # residual history is not ported yet: always empty
    residual_history: np.ndarray = None


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


def _check_options(options: SolverOptions, mesh: Mesh) -> None:
    """Typed errors for what this slice of the port does not carry, and
    for values no slice knows."""
    def not_ported(what):
        raise SolverError(f"{what} is not yet ported to the PyTorch package")

    if options.operator == "ell":
        not_ported("operator='ell'")
    if options.operator not in ("auto", "stencil", "dia", "hybrid"):
        raise InputError(f"unknown operator format '{options.operator}'")
    if options.dense_cutoff > 0 and mesh.num_nodes <= options.dense_cutoff:
        not_ported("the dense direct solve (dense_cutoff)")
    if options.assembly == "device":
        not_ported("device-side assembly (assembly='device')")
    if options.assembly not in ("auto", "host"):
        raise InputError(
            f"unknown assembly mode '{options.assembly}' (auto | host | device)"
        )
    if options.residual_history:
        not_ported("residual history (residual_history)")
    if options.cg_progress_every:
        not_ported("CG progress streaming (cg_progress_every, --cg-progress)")
    if options.keep_operator_host:
        not_ported("operator persistence (keep_operator_host)")
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
    inv = _center_inverse(reduced)
    return lambda r: apply_blocks(inv, r)


def _masked(matvec, free: torch.Tensor):
    """(A, A + I on fixed DOFs) for A = free * K * free."""
    def a_op(v):
        return free * matvec(free * v)

    def op(v):
        return a_op(v) + (1.0 - free) * v

    return a_op, op


@dataclass
class CompiledProblem:
    """A mesh + BC system assembled and resident on one device.

    `solve()` runs the device pipeline and fetches the results to the host,
    in the caller's original node order (`perm[new] = old` records the
    internal renumbering, if any). `dtype` is the working precision the
    options asked for; with `refine` the operator, the CG vectors and the
    problem arrays are f64 and only the inner solves / V-cycle run in it.
    """

    mode: str  # "stencil" | "dia" | "hybrid"
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
    refine: bool = False
    refine_inner_iters: int = 400
    refine_max_outer: int = 8
    # banded formats
    offsets: tuple = ()
    bands: Optional[torch.Tensor] = None  # [D, 2, 2, N]
    rem: Optional[tuple] = None  # hybrid (rem_vals [R,2,2], rem_rows, rem_cols)
    bands32: Optional[torch.Tensor] = None  # f32 copies for the refine paths
    rem_vals32: Optional[torch.Tensor] = None
    # "" | "kernel" | "plain": the refined AMG CG's double-float band matvec
    df64: str = ""
    bands_hl: Optional[torch.Tensor] = None  # [D, 2(hi, lo), 2, 2, N] f32
    amg: object = None  # AMGDeviceArrays when preconditioner == "amg"
    perm: Optional[np.ndarray] = None
    amg_setup: object = None
    # stencil format
    grid: Optional[StencilParams] = None
    stencil: Optional[torch.Tensor] = None  # raw [9, 2, 2, R, C]
    reduced: Optional[torch.Tensor] = None  # BC-reduced
    reduced32: Optional[torch.Tensor] = None  # f32 copy when refining
    mg_levels: Optional[list] = None  # the multigrid hierarchy
    debug_nans: bool = False

    def _band_matvec(self, bands, rem_vals, dia_op=None):
        """K u on [2, N] vectors (unreduced) over the given band values."""
        from .dia import make_dia_operator, make_hybrid_operator

        if self.mode == "dia":
            return dia_op if dia_op is not None else make_dia_operator(bands, self.offsets)
        _, rem_rows, rem_cols = self.rem
        return make_hybrid_operator(
            bands, self.offsets, rem_vals, rem_rows, rem_cols, dia_op=dia_op
        )

    def _banded_solve(self, info: dict):
        from .amg import make_amg_preconditioner
        from .dia import block_jacobi_inverse_t, dia_diag_blocks, make_df_dia_operator

        bands, rem_vals = self.bands, self.rem[0] if self.rem else None
        matvec_t = self._band_matvec(bands, rem_vals)
        free_t = (~self.u_known).to(bands.dtype).T.contiguous()  # [2, N]
        fixed_t = 1.0 - free_t
        u_fixed_t = self.u_value.T.contiguous()
        f_t = self.f_value.T.contiguous()
        a_op, op = _masked(matvec_t, free_t)
        b = free_t * (f_t - matvec_t(u_fixed_t)) + fixed_t * u_fixed_t
        cg_kwargs = dict(x0=u_fixed_t, rtol=self.rtol, atol=self.atol, maxiter=self.maxiter)

        if not self.refine:
            precond = None
            if self.preconditioner != "none":
                precond = block_jacobi_inverse_t(dia_diag_blocks(bands, self.offsets), free_t)
                if self.preconditioner == "amg":
                    precond = make_amg_preconditioner(
                        self.amg, op, precond, a_op=a_op, sweeps=self.sweeps
                    )
            result = pcg(op, b, preconditioner=precond, **cg_kwargs)
            return matvec_t, result.x, result.iterations, result.residual_norm, result.converged, b

        free32 = free_t.to(torch.float32)
        a_op32, op32 = _masked(self._band_matvec(self.bands32, self.rem_vals32), free32)
        precond32 = block_jacobi_inverse_t(dia_diag_blocks(self.bands32, self.offsets), free32)
        if self.preconditioner != "amg":
            from .refine import mixed_precision_solve

            result = mixed_precision_solve(
                op, op32, b, preconditioner32=precond32, x0=u_fixed_t,
                rtol=self.rtol, atol=self.atol,
                inner_maxiter=self.refine_inner_iters, max_outer=self.refine_max_outer,
            )
            info["refine_outer"] = result.outer_steps
            info["refine_inner"] = result.inner_per_pass
            return (
                matvec_t, result.x, result.inner_iterations,
                result.residual_norm, result.converged, b,
            )

        # ONE f64 PCG preconditioned by the f32 V-cycle: classic refinement
        # stagnates near kappa(A) eps_f32 on large unstructured meshes,
        # because its inner solve targets the cast operator
        precond32 = make_amg_preconditioner(
            self.amg, op32, precond32, a_op=a_op32, sweeps=self.sweeps
        )

        def precond64(r):
            # normalise before the f32 cast (extreme residual magnitudes
            # would under/overflow the f32 V-cycle); the preconditioner is
            # linear, so rescaling its output is exact
            nrm = torch.sqrt(torch.sum(r * r))
            safe = torch.where(nrm == 0, torch.ones_like(nrm), nrm)
            return precond32((r / safe).to(torch.float32)).to(r.dtype) * safe

        op_cg = op
        if self.df64:
            # the CG's per-iteration matvec as compensated f32 pairs; the
            # rhs and the force recovery keep the true f64 operator
            df_op = make_df_dia_operator(self.bands_hl, self.offsets)
            _, op_cg = _masked(self._band_matvec(bands, rem_vals, dia_op=df_op), free_t)
        result = pcg(op_cg, b, preconditioner=precond64, **cg_kwargs)
        return matvec_t, result.x, result.iterations, result.residual_norm, result.converged, b

    def _stencil_solve(self, info: dict):
        from .stencil import make_stencil_operator

        rows, cols, wrap, _ = self.grid
        free_g = _grid((~self.u_known).to(self.stencil.dtype), rows, cols)
        fixed_g = 1.0 - free_g
        u_fixed_g = _grid(self.u_value, rows, cols)
        f_g = _grid(self.f_value, rows, cols)
        raw_op = make_stencil_operator(self.stencil, wrap)
        b = free_g * (f_g - raw_op(fixed_g * u_fixed_g)) + fixed_g * u_fixed_g
        op = make_stencil_operator(self.reduced, wrap)

        if self.refine:
            from .refine import mixed_precision_solve

            result = mixed_precision_solve(
                op,
                make_stencil_operator(self.reduced32, wrap),
                b,
                preconditioner32=_stencil_preconditioner(
                    self.preconditioner, self.reduced32, self.mg_levels, wrap
                ),
                x0=u_fixed_g,
                rtol=self.rtol,
                atol=self.atol,
                inner_maxiter=self.refine_inner_iters,
                max_outer=self.refine_max_outer,
            )
            info["refine_outer"] = result.outer_steps
            info["refine_inner"] = result.inner_per_pass
            iters = result.inner_iterations
        else:
            result = pcg(
                op, b,
                preconditioner=_stencil_preconditioner(
                    self.preconditioner, self.reduced, self.mg_levels, wrap
                ),
                x0=u_fixed_g, rtol=self.rtol, atol=self.atol, maxiter=self.maxiter,
            )
            iters = result.iterations

        def matvec_t(v):  # [2, N] <-> grid fields
            return raw_op(v.reshape(2, rows, cols)).reshape(2, -1)

        return (
            matvec_t, result.x.reshape(2, -1), iters,
            result.residual_norm, result.converged, b,
        )

    def solve_device(self, info: Optional[dict] = None):
        """Raw device outputs (renumbered order): u, f, sigma, stress, vm,
        iterations, residual norm, converged, ||b||. `info`, when given,
        receives facts of the run: the refinement passes (an int) and each
        pass's inner iterations (device scalars)."""
        info = {} if info is None else info
        solve = self._stencil_solve if self.mode == "stencil" else self._banded_solve
        matvec_t, x, iters, resnorm, converged, b = solve(info)
        u = x.T
        # unknown forces are K u rows; known applied forces pass through
        f = torch.where(self.u_known, matvec_t(x).T, self.f_value)
        md = self.metadata
        # in the operator's dtype, f64 also when refining: the JAX package
        # recovers refined stresses in f32, ~1e-5 of max off the f64 values
        sigma = element_stress_tensors(
            self.coords, self.tris, u, md.youngs_modulus, md.poisson_ratio
        )
        stress = scalar_stress(sigma, sign_threshold=self.stress_sign_threshold)
        vm = von_mises_stress(sigma)
        bnorm = torch.sqrt(torch.sum(b * b))
        return u, f, sigma, stress, vm, iters, resnorm, converged, bnorm

    def solve(self) -> SolveResult:
        timings = dict(self.timings)
        t0 = time.perf_counter()
        out = self.solve_device(timings)
        _sync(self.device)
        timings["solve_s"] = time.perf_counter() - t0
        if "refine_inner" in timings:
            timings["refine_inner"] = [int(k) for k in timings["refine_inner"]]

        u, f, sigma, stress, vm, iters, resnorm, converged, bnorm = (
            t.cpu().numpy() for t in out
        )
        if self.perm is not None:
            # new node i is original node perm[i]; element order is unchanged
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
            residual_history=np.zeros(0),
        )


def _f32_rtol_floor() -> float:
    return 50 * float(np.finfo(np.float32).eps)


# the double-float matvec's attainable relative residual (~2^-46 of the
# term scale through the stiffness matvec's cancellation at 1M elements)
_DF_RTOL_FLOOR = 2e-9


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
    bca = BCArrays(
        u_known=bca.u_known[perm_r],
        u_value=bca.u_value[perm_r],
        f_value=bca.f_value[perm_r],
    )
    return mesh_r, bca, perm_r


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
    return dict(
        coords=torch.from_numpy(mesh.coords.astype(np_dtype)).to(dev),
        tris=torch.from_numpy(np.asarray(mesh.tris, np.int64)).to(dev),
        u_known=torch.from_numpy(np.asarray(bca.u_known, bool)).to(dev),
        u_value=torch.from_numpy(bca.u_value.astype(np_dtype)).to(dev),
        f_value=torch.from_numpy(bca.f_value.astype(np_dtype)).to(dev),
    )


def _compile_stencil(grid, mesh, bca, metadata, np_dtype, dev, refine, preconditioner, timings):
    """Upload the mesh, assemble and reduce the stencil on the device, and
    build the multigrid hierarchy (in f32 when refining)."""
    from .multigrid import build_hierarchy
    from .stencil import assemble_stencil_fused, assemble_stencil_structured

    t0 = time.perf_counter()
    arrays = _problem_arrays(mesh, bca, np_dtype, dev)
    _sync(dev)
    timings["upload_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
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
    timings["assemble_s"] = time.perf_counter() - t0

    levels = None
    if preconditioner == "multigrid":
        t0 = time.perf_counter()
        levels = build_hierarchy(reduced32 if refine else reduced, wrap)
        _sync(dev)
        timings["mg_build_s"] = time.perf_counter() - t0
        timings["mg_levels"] = [(lv.rows, lv.cols) for lv in levels]
    return dict(
        grid=grid, stencil=raw, reduced=reduced, reduced32=reduced32,
        mg_levels=levels, **arrays,
    )


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


def compile_problem(
    mesh: Mesh,
    bca: BCArrays,
    metadata: ModelMetadata,
    options: SolverOptions = SolverOptions(),
    amg_setup=None,
    device="cuda",
) -> CompiledProblem:
    """Select the operator format, assemble, build the preconditioner and
    upload everything to `device` ("cuda" or "cpu", never chosen implicitly).

    `amg_setup`: a previously built AMGSetup for THIS problem (from either
    package, see interop.py); a mismatch is warned about and rebuilt."""
    from .. import native
    from .dia import build_dia_structure, build_hybrid_structure

    dev = resolve_device(device)
    _check_options(options, mesh)
    dtype = default_dtype(options)
    timings: dict = {}
    n = mesh.num_nodes

    if not bca.u_known.any():
        raise SolverError(
            "model has no prescribed displacements; stiffness system is singular"
        )

    t0 = time.perf_counter()
    grid = _stencil_mode(mesh, options)
    mode = "stencil" if grid is not None else None
    perm = None
    cols = None
    if mode is None:
        native.require()
        if options.renumber != "off":
            mesh, bca, perm = _renumber_if_needed(mesh, bca, options)
    if mode is None and options.operator in ("auto", "dia"):
        dia = build_dia_structure(mesh.tris, n, max_diags=options.max_diags)
        if dia is not None:
            mode, slot_ids, offsets = "dia", dia.slot_ids, dia.offsets
        elif options.operator == "dia":
            raise SolverError(
                f"mesh needs more than {options.max_diags} diagonal bands; "
                "use operator='hybrid' or renumber the mesh"
            )
    if mode is None:
        hyb = build_hybrid_structure(mesh.tris, n, max_diags=options.max_diags)
        mode, slot_ids, offsets = "hybrid", hyb.slot_ids, hyb.offsets
        cols = np.stack([hyb.rem_rows, hyb.rem_cols]).astype(np.int64)
        if cols.shape[1] == 0:  # fully banded after all
            cols = np.zeros((2, 1), dtype=np.int64)
    timings["structure_s"] = time.perf_counter() - t0
    timings["operator"] = mode

    # f32 cannot reach f64-grade residuals: refinement (f64 residual, f32
    # inner solves) reaches them anyway -- "on" anywhere, "auto" on the
    # stencil operator -- and otherwise the tolerance clamps to ~50 eps
    rtol = float(options.cg_rtol)
    refine = options.refine == "on" or (
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
                if n >= options.amg_auto_min_nodes or 2 * n <= _DENSE_COARSE_MAX_DOF
                else "block_jacobi"
            )
    elif preconditioner == "multigrid" and mode != "stencil":
        raise SolverError(
            "multigrid preconditioner requires a structured-grid mesh "
            "(stencil operator)"
        )
    elif preconditioner == "amg" and mode == "stencil":
        raise SolverError(
            "amg preconditioner applies to unstructured operators "
            "(dia/hybrid); structured grids use preconditioner='multigrid'"
        )
    timings["preconditioner"] = preconditioner

    # refinement computes the operator and the residual in f64
    up_dtype = torch.float64 if refine else dtype
    np_dtype = np.float64 if up_dtype == torch.float64 else np.float32
    from .amg import amg_sweep_schedule

    common = dict(
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
        refine=refine,
        refine_inner_iters=int(options.refine_inner_iters),
        refine_max_outer=int(options.refine_max_outer),
        perm=perm,
        debug_nans=bool(options.debug_nans),
    )
    if mode == "stencil":
        return CompiledProblem(
            **common,
            **_compile_stencil(
                grid, mesh, bca, metadata, np_dtype, dev, refine,
                preconditioner, timings,
            ),
        )

    offsets = tuple(int(o) for o in offsets)
    # host C++ closed-form assembly, slot-major flat [S, 4]
    t0 = time.perf_counter()
    d = len(offsets)
    n_slots = d * n + (cols.shape[1] if mode == "hybrid" else 0)
    e_count = mesh.tris.shape[0]
    slots_pm = (
        np.asarray(slot_ids, np.int64)
        .reshape(e_count, 3, 3)
        .transpose(1, 2, 0)
        .reshape(-1)
    )
    flat = native.amg_assemble(
        mesh.coords, mesh.tris, np.ones((n, 2)),
        metadata.youngs_modulus, metadata.poisson_ratio,
        metadata.part_thickness, slots_pm, n_slots,
    )
    timings["assemble_s"] = time.perf_counter() - t0

    setup = None
    if preconditioner == "amg":
        from ..utils.logging import log
        from .amg import build_amg_setup, setup_matches

        t0 = time.perf_counter()
        free = (~bca.u_known).astype(np.float64)
        cell_factor = float(options.amg_cell_factor)
        setup = amg_setup
        if setup is not None and not setup_matches(
            setup, mesh.coords, mesh.tris, free, metadata, cell_factor, perm
        ):
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
            )
        timings["amg_build_s"] = time.perf_counter() - t0
        timings["amg_levels"] = setup.level_sizes

    # ONE upload of the flat assembly, relaid out to bands on the device
    t0 = time.perf_counter()
    flat_d = torch.from_numpy(flat.astype(np_dtype, copy=False)).to(dev)
    bands = flat_d[: d * n].reshape(d, n, 2, 2).permute(0, 2, 3, 1).contiguous()
    rem = None
    if mode == "hybrid":
        cols_d = torch.from_numpy(cols).to(dev)
        rem = (flat_d[d * n :].reshape(-1, 2, 2).clone(), cols_d[0], cols_d[1])
    del flat_d  # the bands and the remainder are copies: free the flat upload
    arrays = _problem_arrays(mesh, bca, np_dtype, dev)
    _sync(dev)
    timings["upload_s"] = time.perf_counter() - t0
    timings["upload_bytes"] = int(flat.size * np.dtype(np_dtype).itemsize)

    amg = None
    if setup is not None:
        from .amg import amg_device_arrays

        t0 = time.perf_counter()
        # refinement runs the V-cycle only in f32
        amg = amg_device_arrays(setup, torch.float32 if refine else dtype, dev)
        _sync(dev)
        timings["amg_upload_s"] = time.perf_counter() - t0

    df64 = _decide_df64(options, refine, preconditioner, mode, dev, rtol)
    timings["df_matvec"] = df64
    extra = {}
    if refine:
        from .dia import split_bands

        extra["bands32"] = bands.to(torch.float32)
        extra["rem_vals32"] = rem[0].to(torch.float32) if rem else None
        # the hi/lo split happens once here, never per matvec
        extra["bands_hl"] = split_bands(bands) if df64 else None

    return CompiledProblem(
        **common,
        offsets=offsets,
        bands=bands,
        rem=rem,
        df64=df64,
        amg=amg,
        amg_setup=setup,
        **extra,
        **arrays,
    )


def solve_system(
    mesh: Mesh,
    bca: BCArrays,
    metadata: ModelMetadata,
    options: SolverOptions = SolverOptions(),
    amg_setup=None,
    device="cuda",
) -> SolveResult:
    """Full FEA solve of one mesh + boundary-condition set on `device`."""
    return compile_problem(
        mesh, bca, metadata, options, amg_setup=amg_setup, device=device
    ).solve()
