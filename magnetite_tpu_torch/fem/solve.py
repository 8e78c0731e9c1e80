"""End-to-end device solve: host prep -> banded operator -> PCG -> recovery
(port of magnetite_tpu/fem/solve.py for the DIA and hybrid formats).

Host: renumbering, band structure, C++ closed-form assembly and the AMG
hierarchy build (all numpy / native, as in the JAX package). Device: the
flat assembly is uploaded once with `torch.from_numpy(...).to(device)` and
relaid out to bands [D, 2, 2, N] there; CG, the V-cycle, force recovery and
stress run on the device. On a CUDA device the band matvec and the level-0
AMG transfers are the hand-written kernels; on the CPU their plain PyTorch
versions.

What the JAX package offers beyond this slice raises a typed error naming
it (the JAX package's rule: an unhonourable combination raises, it is never
silently substituted): the stencil, ELL and dense operators, mixed
precision / refinement, device-side assembly, residual history, progress
streaming and operator persistence.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

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


def default_dtype(options: SolverOptions) -> torch.dtype:
    """f64 unless the options ask for f32: the card has native FP64."""
    name = "float64" if options.dtype is None else str(np.dtype(options.dtype))
    if name not in _DTYPES:
        raise InputError(f"unsupported solver dtype '{options.dtype}'")
    return _DTYPES[name]


def _check_options(options: SolverOptions, mesh: Mesh) -> None:
    """Typed errors for what this slice of the port does not carry."""
    def not_ported(what):
        raise SolverError(f"{what} is not yet ported to the PyTorch package")

    if options.operator in ("stencil", "ell"):
        not_ported(f"operator='{options.operator}'")
    if options.operator not in ("auto", "dia", "hybrid"):
        raise InputError(f"unknown operator format '{options.operator}'")
    if options.operator == "auto" and mesh.grid_shape is not None:
        not_ported(
            "the stencil operator (chosen for structured-grid meshes under "
            "operator='auto'; pass operator='dia' or 'hybrid')"
        )
    if options.dense_cutoff > 0 and mesh.num_nodes <= options.dense_cutoff:
        not_ported("the dense direct solve (dense_cutoff)")
    if options.refine == "on":
        not_ported("mixed-precision refinement (refine='on', --precision mixed)")
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
    if options.preconditioner == "multigrid":
        raise SolverError(
            "multigrid preconditioner requires a structured-grid mesh "
            "(stencil operator)"
        )
    if options.preconditioner not in (
        "auto", "none", "jacobi", "block_jacobi", "amg"
    ):
        raise InputError(f"unknown preconditioner '{options.preconditioner}'")


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


@dataclass
class CompiledProblem:
    """A mesh + BC system assembled and resident on one device.

    `solve()` runs the device pipeline and fetches the results to the host,
    in the caller's original node order (`perm[new] = old` records the
    internal renumbering, if any).
    """

    mode: str  # "dia" | "hybrid"
    preconditioner: str
    timings: dict
    device: torch.device
    dtype: torch.dtype
    offsets: tuple
    bands: torch.Tensor  # [D, 2, 2, N]
    rem: Optional[tuple]  # hybrid (rem_vals [R,2,2], rem_rows, rem_cols)
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
    amg: object = None  # AMGDeviceArrays when preconditioner == "amg"
    perm: Optional[np.ndarray] = None
    amg_setup: object = None
    debug_nans: bool = False

    def matvec_t(self):
        """K u on [2, N] vectors (unreduced operator)."""
        from .dia import make_dia_operator, make_hybrid_operator

        if self.mode == "dia":
            return make_dia_operator(self.bands, self.offsets)
        rem_vals, rem_rows, rem_cols = self.rem
        return make_hybrid_operator(
            self.bands, self.offsets, rem_vals, rem_rows, rem_cols
        )

    def _linear_solve(self):
        from .dia import block_jacobi_inverse_t, dia_diag_blocks

        matvec_t = self.matvec_t()
        free_t = (~self.u_known).to(self.dtype).T.contiguous()  # [2, N]
        fixed_t = 1.0 - free_t
        u_fixed_t = self.u_value.T.contiguous()
        f_t = self.f_value.T.contiguous()

        def a_op(v):
            return free_t * matvec_t(free_t * v)

        def op(v):
            return a_op(v) + fixed_t * v

        if self.preconditioner == "none":
            precond = None
        else:
            precond = block_jacobi_inverse_t(
                dia_diag_blocks(self.bands, self.offsets), free_t
            )
            if self.preconditioner == "amg":
                from .amg import make_amg_preconditioner

                precond = make_amg_preconditioner(
                    self.amg, op, precond, a_op=a_op, sweeps=self.sweeps
                )
        b = free_t * (f_t - matvec_t(u_fixed_t)) + fixed_t * u_fixed_t
        result = pcg(
            op, b, preconditioner=precond, x0=u_fixed_t,
            rtol=self.rtol, atol=self.atol, maxiter=self.maxiter,
        )
        x = result.x
        return (
            x.T, matvec_t(x).T, result.iterations, result.residual_norm,
            result.converged, torch.sqrt(torch.sum(b * b)),
        )

    def solve_device(self):
        """Raw device outputs (renumbered order): u, f, sigma, stress, vm,
        iterations, residual norm, converged, ||b||."""
        u, ku, iters, resnorm, converged, bnorm = self._linear_solve()
        # unknown forces are K u rows; known applied forces pass through
        f = torch.where(self.u_known, ku, self.f_value)
        md = self.metadata
        sigma = element_stress_tensors(
            self.coords, self.tris, u, md.youngs_modulus, md.poisson_ratio
        )
        stress = scalar_stress(sigma, sign_threshold=self.stress_sign_threshold)
        vm = von_mises_stress(sigma)
        return u, f, sigma, stress, vm, iters, resnorm, converged, bnorm

    def solve(self) -> SolveResult:
        timings = dict(self.timings)
        t0 = time.perf_counter()
        out = self.solve_device()
        _sync(self.device)
        timings["solve_s"] = time.perf_counter() - t0

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


def compile_problem(
    mesh: Mesh,
    bca: BCArrays,
    metadata: ModelMetadata,
    options: SolverOptions = SolverOptions(),
    amg_setup=None,
    device="cuda",
) -> CompiledProblem:
    """Select the band format, assemble, build the preconditioner and upload
    everything to `device` ("cuda" or "cpu", never chosen implicitly).

    `amg_setup`: a previously built AMGSetup for THIS problem (from either
    package, see interop.py); a mismatch is warned about and rebuilt."""
    from .. import native
    from .dia import build_dia_structure, build_hybrid_structure

    dev = resolve_device(device)
    _check_options(options, mesh)
    native.require()
    dtype = default_dtype(options)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    timings: dict = {}
    n = mesh.num_nodes

    if not bca.u_known.any():
        raise SolverError(
            "model has no prescribed displacements; stiffness system is singular"
        )

    t0 = time.perf_counter()
    perm = None
    if options.renumber != "off":
        mesh, bca, perm = _renumber_if_needed(mesh, bca, options)

    mode = None
    cols = None
    if options.operator in ("auto", "dia"):
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
    offsets = tuple(int(o) for o in offsets)
    timings["structure_s"] = time.perf_counter() - t0
    timings["operator"] = mode

    rtol = float(options.cg_rtol)
    if dtype == torch.float32 and rtol < _f32_rtol_floor():
        from ..utils.logging import log

        floor = _f32_rtol_floor()
        log(
            f"warning: requested cg_rtol {rtol:.1e} is below the f32 "
            f"floor; clamping to {floor:.1e} (mixed precision is not yet "
            "ported to the PyTorch package)"
        )
        rtol = floor

    preconditioner = options.preconditioner
    if preconditioner == "auto":
        from .amg import _DENSE_COARSE_MAX_DOF

        preconditioner = (
            "amg"
            if n >= options.amg_auto_min_nodes or 2 * n <= _DENSE_COARSE_MAX_DOF
            else "block_jacobi"
        )
    timings["preconditioner"] = preconditioner

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
    problem_arrays = dict(
        coords=torch.from_numpy(mesh.coords.astype(np_dtype)).to(dev),
        tris=torch.from_numpy(np.asarray(mesh.tris, np.int64)).to(dev),
        u_known=torch.from_numpy(np.asarray(bca.u_known, bool)).to(dev),
        u_value=torch.from_numpy(bca.u_value.astype(np_dtype)).to(dev),
        f_value=torch.from_numpy(bca.f_value.astype(np_dtype)).to(dev),
    )
    _sync(dev)
    timings["upload_s"] = time.perf_counter() - t0
    timings["upload_bytes"] = int(flat.size * np.dtype(np_dtype).itemsize)

    amg = None
    if setup is not None:
        from .amg import amg_device_arrays

        t0 = time.perf_counter()
        amg = amg_device_arrays(setup, dtype, dev)
        _sync(dev)
        timings["amg_upload_s"] = time.perf_counter() - t0

    return CompiledProblem(
        mode=mode,
        preconditioner=preconditioner,
        timings=timings,
        device=dev,
        dtype=dtype,
        offsets=offsets,
        bands=bands,
        rem=rem,
        metadata=metadata,
        rtol=rtol,
        atol=float(options.cg_atol),
        maxiter=int(options.max_cg_iters),
        # V(1,1) unless pinned (V(3,3) is the mixed-precision schedule)
        sweeps=int(options.amg_sweeps) if options.amg_sweeps > 0 else 1,
        stress_sign_threshold=float(options.stress_sign_threshold),
        amg=amg,
        perm=perm,
        amg_setup=setup,
        debug_nans=bool(options.debug_nans),
        **problem_arrays,
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
