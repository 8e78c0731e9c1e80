"""End-to-end sharded FEA pipeline: the node-sharded solve with force and
stress recovery (port of magnetite_tpu/parallel/pipeline.py, its
unstructured half).

The sharded solver (parallel/dia_shard.py) covers the linear solve over a
device mesh; this module carries the rest of the pipeline across the same
mesh, so a sharded run returns the same `fem.solve.SolveResult` a
single-device `solve_system` does:

  * force recovery is elementwise on the node-sharded fields (f = K u on
    constrained DOFs);
  * stress recovery (sigma = D B u_e per element) is shard-local: each
    shard owns the elements whose smallest node lies in its node range,
    and one halo exchange of the solution makes all three nodes of every
    owned element locally addressable (fem/stress.py's math per shard).

Operator dispatch follows the single-device auto rules: grid-local
structured meshes take the stencil path (parallel/stencil_shard.py: grid
rows sharded over a 1-D mesh, or rows x cols tiles over a 2-D one, halo
matvecs and the sharded multigrid), everything else the node-sharded DIA
+ AMG path (parallel/dia_shard.py). On the structured path stress recovery
is shard-local too: node ids are row-major on the grid, so a row band's
elements reach one grid row past it (1-D), and a tile's elements one ring
of halo, the operator's own exchange (2-D).

The device mesh is one controller's: `DeviceMesh` holds an ordered tuple
of `torch.device`s, one per shard, and `DeviceMesh2D` an (R, C) array of
them in row-major shard order; a device may repeat (S shards on one card,
or on the CPU in the tests). `default_device_mesh()` takes every visible
CUDA device, as the JAX package takes every visible device, and
`parse_device_mesh("RxC")` lays them out as a 2-D mesh.

Entry points: `compile_sharded_problem` -> `.solve()`,
`fem.solve.solve_system(..., device_mesh=...)`, or the CLI's `--shard` /
`--shard-layout`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..bc import BCArrays
from ..config import ModelMetadata, SolverOptions
from ..errors import InputError, SolverError
from ..meshing.core import Mesh as FemMesh
from ..utils.logging import span
from .dia_shard import ShardVec, exchange_halo

AXIS = "shard"


@dataclass(frozen=True)
class DeviceMesh:
    """A 1-D device mesh: one `torch.device` per shard, in shard order
    (repeats allowed), and its axis name."""

    devices: tuple
    axis: str = AXIS

    def __post_init__(self):
        devs = tuple(_normalised(d) for d in self.devices)
        if not devs:
            raise InputError("a device mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise InputError(
                f"a device mesh holds devices of one type; got {[str(d) for d in devs]}"
            )
        if devs[0].type not in ("cuda", "cpu"):
            raise InputError(f"unsupported device '{devs[0]}' (cuda | cpu)")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def axis_names(self) -> tuple:
        return (self.axis,)

    @property
    def shape(self) -> tuple:
        return (self.size,)

    def halved(self) -> "DeviceMesh":
        return DeviceMesh(self.devices[: max(self.size // 2, 1)], self.axis)


@dataclass(frozen=True)
class DeviceMesh2D:
    """A 2-D device mesh: `shape` (R, C) and R * C devices in row-major
    shard order (repeats allowed); `axis_names` names the two axes, ("rows",
    "cols") for the structured grid, ("batch", "rows") for
    parallel/sharding.py's batch solve."""

    devices: tuple
    shape: tuple
    axis_names: tuple = ("rows", "cols")

    def __post_init__(self):
        shape = tuple(int(n) for n in self.shape)
        if len(shape) != 2 or min(shape) < 1:
            raise InputError(f"a 2-D device mesh needs a shape (R, C) >= 1; got {self.shape}")
        devs = DeviceMesh(tuple(self.devices)).devices
        if len(devs) != shape[0] * shape[1]:
            raise InputError(
                f"a {shape[0]}x{shape[1]} device mesh needs {shape[0] * shape[1]} devices; "
                f"got {len(devs)}"
            )
        if len(self.axis_names) != 2:
            raise InputError(f"a 2-D device mesh has two axis names; got {self.axis_names}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def size(self) -> int:
        return len(self.devices)

    def row(self, i: int) -> tuple:
        """The devices of row i of the mesh."""
        return self.devices[i * self.shape[1]:(i + 1) * self.shape[1]]


def _normalised(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    if dev.type == "cpu":  # a CPU tensor's device carries no index
        return torch.device("cpu")
    return dev


def default_device_mesh(device="cuda") -> DeviceMesh:
    """The 1-D mesh over every visible CUDA device (the CLI's --shard
    layout); a missing card raises. device="cpu" gives the one CPU device,
    only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SolverError(
                "device 'cuda' requested but torch.cuda.is_available() is false; "
                "pass device='cpu' to run the plain PyTorch path"
            )
        return DeviceMesh(tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count())))
    if dev.type == "cpu":
        return DeviceMesh((torch.device("cpu"),))
    raise InputError(f"unsupported device '{device}' (cuda | cpu)")


def parse_device_mesh(layout: str, device="cuda") -> DeviceMesh:
    """A device mesh from a CLI layout string: "auto" (or "" / "1d") is the
    1-D mesh over every visible device; "RxC" (e.g. "2x4") the 2-D rows x
    cols mesh of the structured sharded path over them. R * C must equal
    the visible device count."""
    layout = (layout or "auto").strip().lower()
    if layout in ("auto", "1d"):
        return default_device_mesh(device)
    parts = layout.split("x")
    if len(parts) != 2:
        raise InputError(
            f"invalid --shard layout {layout!r}: expected 'auto' or 'RxC' (e.g. '2x4')"
        )
    try:
        n_r, n_c = int(parts[0]), int(parts[1])
    except ValueError:
        raise InputError(
            f"invalid --shard layout {layout!r}: R and C must be integers"
        ) from None
    if n_r < 1 or n_c < 1:
        raise InputError(f"invalid --shard layout {layout!r}: R and C must be >= 1")
    n_dev = default_device_mesh(device).size
    if n_r * n_c != n_dev:
        raise InputError(
            f"--shard layout {layout!r} needs {n_r * n_c} devices but {n_dev} are visible"
        )
    return DeviceMesh2D(default_device_mesh(device).devices, (n_r, n_c))


# ------------------------- sharded stress recovery --------------------------


def _build_recovery(tris, coords, n_shards: int, local_n: int):
    """Bucket elements by owning shard; return host arrays for the
    shard-local sigma = D B u_e gather.

    Element e belongs to the shard owning min(tris[e]). Returns (eids
    [S, Emax], valid [S, Emax], lidx [S, Emax, 3], ecoords [S, Emax, 3, 2],
    halo): lidx indexes the halo-extended local solution [2, local_n + 2
    halo], and halo is the smallest exchange width that makes every owned
    element's nodes locally addressable."""
    e_count = tris.shape[0]
    tris64 = tris.astype(np.int64)
    emin = tris64.min(axis=1)
    etop = tris64.max(axis=1)
    owner = emin // local_n
    # upper overhang only: emin >= owner * local_n by construction
    halo = int(max(1, (etop - (owner + 1) * local_n + 1).max())) if e_count else 1
    if halo > local_n:
        raise SolverError(
            f"stress-recovery halo {halo} exceeds the shard size {local_n}; "
            "use fewer shards for this mesh"
        )
    lflat = tris64 - (owner * local_n)[:, None] + halo
    return _bucket_elements(owner, lflat, tris, coords, n_shards) + (halo,)


def _bucket_elements(owner, lflat, tris, coords, n_shards: int):
    """Group elements by owning shard into padded [S, Emax] arrays: (eids,
    valid, lidx, ecoords). Pad elements point at local node 0 with a unit
    right triangle (a nonzero area keeps B finite); their outputs are
    dropped on the host."""
    counts = np.bincount(owner, minlength=n_shards)
    emax = max(int(counts.max()), 1)
    order = np.argsort(owner, kind="stable")
    eids = np.zeros((n_shards, emax), dtype=np.int64)
    valid = np.zeros((n_shards, emax), dtype=bool)
    lidx = np.zeros((n_shards, emax, 3), dtype=np.int32)
    ecoords = np.zeros((n_shards, emax, 3, 2))
    ecoords[..., 1, 0] = 1.0
    ecoords[..., 2, 1] = 1.0
    pos = 0
    for s in range(n_shards):
        c = int(counts[s])
        ids = order[pos:pos + c]
        pos += c
        eids[s, :c] = ids
        valid[s, :c] = True
        lidx[s, :c] = lflat[ids].astype(np.int32)
        ecoords[s, :c] = coords[tris[ids]]
    return eids, valid, lidx, ecoords


def _local_sigma(u_ext, lidx, ecoords, e, nu, sign_threshold):
    """One shard's element stresses from its halo-extended solution u_ext
    [2, nl + 2h]; lidx [Emax, 3] int64, ecoords [Emax, 3, 2]. The math of
    fem/stress.py."""
    from ..fem.stress import element_stress_from, scalar_stress, von_mises_stress

    ue = u_ext.T[lidx].reshape(lidx.shape[0], 6)  # [x0, y0, x1, y1, x2, y2]
    sigma = element_stress_from(ecoords, ue, e, nu)
    return sigma, scalar_stress(sigma, sign_threshold=sign_threshold), von_mises_stress(sigma)


def _dia_recover_local(x: ShardVec, ku: ShardVec, free: ShardVec, f_app: ShardVec,
                       lidx, ecoords, rec_halo: int, e, nu, sign_threshold):
    """Forces (applied where free, K u where constrained) and each shard's
    element stresses: (f, [(sigma, stress, vm)] per shard)."""
    f = free * f_app + (1.0 - free) * ku
    u_ext = exchange_halo(x.shards, rec_halo)
    return f, [
        _local_sigma(u, li, ec, e, nu, sign_threshold)
        for u, li, ec in zip(u_ext, lidx, ecoords)
    ]


def _stencil_rhs_norm(problem) -> torch.Tensor:
    """||b|| of the sharded structured system."""
    from .dia_shard import shard_dot
    from .stencil_shard import _rhs, halo_operator

    b = _rhs(halo_operator(problem, "raw"), problem)
    return torch.sqrt(shard_dot(b, b))


def _stencil_recover_local(problem, x: ShardVec, ku: ShardVec, lidx, ecoords, rec_halo: int,
                           e, nu, sign_threshold):
    """Row-sharded recovery: (f, [(sigma, stress, vm)] per shard, ||b||).
    Each row band flattened row-major is its nodes in order, so dia_shard's
    exchange of `rec_halo` nodes makes every owned element's nodes local."""
    bnorm = _stencil_rhs_norm(problem)
    free = problem.free_g
    f = free * problem.f_g + (1.0 - free) * ku
    u_ext = exchange_halo([u.reshape(2, -1) for u in x.shards], rec_halo)
    return f, [_local_sigma(u, li, ec, e, nu, sign_threshold)
               for u, li, ec in zip(u_ext, lidx, ecoords)], bnorm


def _build_recovery_2d(tris, coords, rows, cols, wrap, n_r, n_c, rl, cl):
    """Bucket elements by owning (row, col) tile; host arrays for the
    shard-local sigma = D B u_e gather over the 2-D halo block.

    Grid node ids are row-major (id = r * cols + c) and every element spans
    at most 2 adjacent grid rows / cols (a wrapped one spans {cols - 1, 0}),
    so one halo ring -- what exchange_halo_2d provides -- makes all three
    nodes of every owned element local. Returns (eids [S, Emax], valid,
    lidx [S, Emax, 3], ecoords [S, Emax, 3, 2]), S = n_r * n_c row-major,
    lidx indexing the flattened [2, (rl + 2) * (cl + 2)] extended tile."""
    t64 = tris.astype(np.int64)
    er = t64 // cols
    ec = t64 % cols
    anchor_r = er.min(axis=1)
    if wrap:
        spans = ec.max(axis=1) - ec.min(axis=1) > 1  # wrap-crossing elements
        # anchored at cols - 1: their c = 0 nodes sit one step to the right
        anchor_c = np.where(spans, cols - 1, ec.min(axis=1))
        dc = np.where(spans[:, None] & (ec == 0), anchor_c[:, None] + 1, ec) - anchor_c[:, None]
    else:
        anchor_c = ec.min(axis=1)
        dc = ec - anchor_c[:, None]
    owner_r = anchor_r // rl
    owner_c = anchor_c // cl
    owner = owner_r * n_c + owner_c
    lr = er - (owner_r * rl)[:, None] + 1
    lc = (anchor_c - owner_c * cl)[:, None] + dc + 1
    return _bucket_elements(owner, lr * (cl + 2) + lc, tris, coords, n_r * n_c)


def _stencil_recover_local_2d(problem, x: ShardVec, ku: ShardVec, lidx, ecoords, e, nu,
                              sign_threshold):
    """The 2-D tiles' recovery: (f, [(sigma, stress, vm)] per tile, ||b||)."""
    from .stencil_shard import exchange_halo_2d

    bnorm = _stencil_rhs_norm(problem)
    free = problem.free_g
    f = free * problem.f_g + (1.0 - free) * ku
    u_ext = exchange_halo_2d(x.shards, problem.shape, problem.wrap_cols)
    return f, [_local_sigma(u.reshape(2, -1), li, ec, e, nu, sign_threshold)
               for u, li, ec in zip(u_ext, lidx, ecoords)], bnorm


# ------------------------------ compiled problem ----------------------------


@dataclass
class CompiledShardedProblem:
    """A mesh + BC system laid out over a device mesh, solve-ready.

    `solve()` runs the sharded solve and the sharded force / stress
    recovery and returns the same `fem.solve.SolveResult` as the
    single-device path, in the caller's node order. `mode` is the operator
    kind ("dia", or "ell" for the block-ELL fallback); `dtype` and `refine`
    the options' working precision, as on `CompiledProblem`."""

    mode: str
    problem: object  # ShardedDiaProblem
    preconditioner: str
    dtype: torch.dtype
    refine: bool
    rtol: float
    maxiter: int
    amg_sweeps: int
    df_matvec: str
    lidx: list  # per shard [Emax, 3] int64 on the shard's device
    ecoords: list  # per shard [Emax, 3, 2]
    rec_halo: int
    eids: np.ndarray  # [S, Emax]
    valid: np.ndarray  # [S, Emax]
    n_nodes: int
    n_elements: int
    metadata: ModelMetadata
    stress_sign_threshold: float
    perm: Optional[np.ndarray]
    timings: dict
    debug_nans: bool = False
    history: int = 0
    progress_every: int = 0
    amg_setup: object = None
    # the single-device path's kept host assembly; the sharded one keeps none
    operator_host: None = field(default=None, repr=False)

    def solve(self):
        from .dia_shard import sharded_dia_pcg_solve

        p = self.problem
        timings = dict(self.timings)
        with span("solve.device", timings, "solve_s"):
            result, ku, bnorm = sharded_dia_pcg_solve(
                p, rtol=self.rtol, maxiter=self.maxiter, refined=self.refine,
                amg_sweeps=self.amg_sweeps, history=self.history, df_matvec=self.df_matvec,
                progress_every=self.progress_every,
            )
            md = self.metadata
            f_d, per_shard = _dia_recover_local(
                result.x, ku, p.free, p.f, self.lidx, self.ecoords, self.rec_halo,
                md.youngs_modulus, md.poisson_ratio, self.stress_sign_threshold,
            )
            with span("solve.wait"):
                _sync(p.devices)

        n = self.n_nodes
        return _solve_result(result, result.x.gather(n).T, f_d.gather(n).T, per_shard, bnorm,
                             self, timings)


def _solve_result(result, u, f, per_shard, bnorm, compiled, timings):
    """The SolveResult of a sharded solve: u, f [N, 2] host arrays in the
    sharded node order, the per-shard element stresses scattered back by
    element id, the renumbering undone, the debug_nans and convergence
    checks."""
    from ..fem.solve import SolveResult

    n_e = compiled.n_elements
    sigma = np.zeros((n_e, 3), dtype=u.dtype)
    stress = np.zeros(n_e, dtype=u.dtype)
    vm = np.zeros(n_e, dtype=u.dtype)
    for s, (sg, st, v) in enumerate(per_shard):
        ok = compiled.valid[s]
        ids = compiled.eids[s][ok]
        sigma[ids] = sg.cpu().numpy()[ok]
        stress[ids] = st.cpu().numpy()[ok]
        vm[ids] = v.cpu().numpy()[ok]
    if compiled.perm is not None:
        u_o, f_o = np.empty_like(u), np.empty_like(f)
        u_o[compiled.perm], f_o[compiled.perm] = u, f
        u, f = u_o, f_o
    if compiled.debug_nans:
        for name, arr in (("displacements", u), ("forces", f), ("stresses", sigma)):
            if not np.isfinite(arr).all():
                raise SolverError(
                    f"non-finite values in solved {name} (debug_nans): check "
                    "material properties, mesh quality, and boundary conditions"
                )
    iters = int(result.iterations)
    resnorm = float(result.residual_norm)
    if not bool(result.converged):
        raise SolverError(
            f"conjugate gradient failed to converge in {iters} iterations "
            f"(residual norm {resnorm:.3e})"
        )
    # classic refinement reports an empty history (its inner solves restart
    # every pass), as on one device
    hist = result.history
    return SolveResult(
        u=u, f=f, sigma=sigma, stress=stress, von_mises=vm,
        iterations=iters, residual_norm=resnorm,
        residual_rel=resnorm / max(float(bnorm), 1e-300), converged=True,
        timings=timings,
        residual_history=np.zeros(0) if hist is None else hist.cpu().numpy()[:iters],
    )


@dataclass
class CompiledShardedStencilProblem:
    """A structured grid laid out over a device mesh by rows (`kind`
    "stencil", a 1-D mesh) or by rows x cols tiles ("stencil2d", a 2-D
    mesh), solve-ready; `solve()` returns the single-device SolveResult.
    `mode` is "stencil", `dtype` / `refine` the options' working precision,
    as on CompiledProblem."""

    kind: str
    problem: object  # stencil_shard.ShardedStencilProblem
    preconditioner: str
    dtype: torch.dtype
    refine: bool
    rtol: float
    maxiter: int
    refine_inner_iters: int
    refine_max_outer: int
    lidx: list
    ecoords: list
    rec_halo: int  # 1-D only (the 2-D halo is one ring)
    eids: np.ndarray
    valid: np.ndarray
    n_nodes: int
    n_elements: int
    metadata: ModelMetadata
    stress_sign_threshold: float
    timings: dict
    debug_nans: bool = False
    history: int = 0
    perm: None = None
    mode: str = "stencil"
    amg_setup: None = None
    operator_host: None = field(default=None, repr=False)

    def solve(self):
        from .stencil_shard import (
            sharded_stencil_pcg_solve, sharded_stencil_pcg_solve_2d,
            sharded_stencil_refined_solve, sharded_stencil_refined_solve_2d,
        )

        p = self.problem
        timings = dict(self.timings)
        two_d = self.kind == "stencil2d"
        with span("solve.device", timings, "solve_s"):
            if self.refine and two_d:
                result, ku = sharded_stencil_refined_solve_2d(
                    p, rtol=self.rtol, maxiter=self.maxiter,
                    preconditioner=self.preconditioner, history=self.history)
            elif self.refine:
                result, ku = sharded_stencil_refined_solve(
                    p, rtol=self.rtol, inner_maxiter=self.refine_inner_iters,
                    max_outer=self.refine_max_outer, preconditioner=self.preconditioner,
                    info=timings)
            else:
                solve = sharded_stencil_pcg_solve_2d if two_d else sharded_stencil_pcg_solve
                result, ku = solve(p, rtol=self.rtol, maxiter=self.maxiter,
                                   preconditioner=self.preconditioner, history=self.history)
            md = self.metadata
            mat = (md.youngs_modulus, md.poisson_ratio, self.stress_sign_threshold)
            if two_d:
                f_d, per_shard, bnorm = _stencil_recover_local_2d(
                    p, result.x, ku, self.lidx, self.ecoords, *mat)
            else:
                f_d, per_shard, bnorm = _stencil_recover_local(
                    p, result.x, ku, self.lidx, self.ecoords, self.rec_halo, *mat)
            with span("solve.wait"):
                _sync(p.devices)
        return _solve_result(result, self._nodal(result.x), self._nodal(f_d), per_shard, bnorm,
                             self, timings)

    def _nodal(self, v: ShardVec) -> np.ndarray:
        """A tiled grid field on the host as [N, 2] (padding dropped)."""
        from .stencil_shard import _gather_grid

        cpu = torch.device("cpu")
        full = _gather_grid(v.shards, self.problem.shape, [cpu])[cpu]
        return full[:, :self.problem.rows, :self.problem.cols].reshape(2, -1).T.numpy()


def _sync(devices) -> None:
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _require_constraints(bca: BCArrays) -> None:
    if not bca.u_known.any():
        raise SolverError(
            "model has no prescribed displacements; stiffness system is singular"
        )


def _precision_plan(options: SolverOptions, use_stencil: bool = False):
    """(rtol, refined, prep dtype) of a sharded solve, by the port's
    single-device rules (fem/solve.py): refine="on" refines; "auto" refines
    only the stencil operator, in f32 with an rtol below the f32 floor;
    otherwise the options' dtype (f64 by default) throughout. Refined
    problems are prepared in f64. The f32 solvers clamp a sub-floor rtol
    themselves, with the warning."""
    from ..fem.solve import _f32_rtol_floor, default_dtype

    dtype = default_dtype(options)
    rtol = float(options.cg_rtol)
    refined = options.refine == "on" or (
        options.refine == "auto" and use_stencil and dtype == torch.float32
        and rtol < _f32_rtol_floor()
    )
    prep = np.float64 if (refined or dtype == torch.float64) else np.float32
    return rtol, refined, prep


def _stencil_precond(options: SolverOptions) -> str:
    """The preconditioner flag of a sharded stencil solve (1-D and 2-D):
    'amg' is refused, 'jacobi' becomes block_jacobi with the warning the
    single-device path logs."""
    precond = options.preconditioner
    if precond == "amg":
        raise SolverError(
            "amg preconditioner applies to unstructured operators; structured sharded "
            "solves use 'multigrid'"
        )
    if precond == "jacobi":
        from ..utils.logging import log

        log("warning: sharded stencil solves do not implement preconditioner='jacobi'; "
            "using block_jacobi")
        precond = "block_jacobi"
    return precond


def _is_grid_local(mesh: FemMesh) -> bool:
    if mesh.grid_shape is None:
        return False
    if mesh.grid_local:
        return True
    from ..fem.stencil import build_stencil_structure

    rows, cols = mesh.grid_shape
    return build_stencil_structure(mesh.tris, rows, cols, mesh.wrap_cols) is not None


def compile_sharded_problem(
    mesh: FemMesh,
    bca: BCArrays,
    metadata: ModelMetadata,
    options: SolverOptions = SolverOptions(),
    device_mesh: Optional[DeviceMesh] = None,
    amg_setup=None,
) -> CompiledShardedProblem:
    """Lay one FEA problem out over a device mesh (default: every visible
    CUDA device), end to end. Operator dispatch follows the single-device
    auto rules: a grid-local structured mesh under operator "auto" /
    "stencil" shards by grid rows (the stencil operator and the sharded
    multigrid), everything else by nodes (DIA bands + AMG, renumbering
    band-hostile meshes first, the block-ELL fallback where the bands do
    not fit `max_diags`). A DeviceMesh2D lays a structured grid out in rows
    x cols tiles; other meshes need a 1-D one.

    On a 1-D mesh, meshes too small for the requested shard count (the
    band or stress halo must fit inside one shard) retry on half the
    devices with a warning, down to one. (A 2-D mesh does not retry: its
    stress halo is always one ring, and wrapped cols that do not divide
    need another layout, not fewer devices.)"""
    if device_mesh is None:
        device_mesh = default_device_mesh()
    if isinstance(device_mesh, DeviceMesh2D):
        return _compile_sharded_stencil(mesh, bca, metadata, options, device_mesh)
    if not isinstance(device_mesh, DeviceMesh):
        raise SolverError(
            "the sharded pipeline takes a parallel.pipeline.DeviceMesh (1-D) or "
            f"DeviceMesh2D (rows x cols); got {type(device_mesh).__name__}"
        )
    while True:
        try:
            return _compile_sharded(mesh, bca, metadata, options, device_mesh, amg_setup)
        except SolverError as err:
            n = device_mesh.size
            shard_bound = (
                "smaller than the band halo" in str(err) or "exceeds the shard size" in str(err)
            )
            if n <= 1 or not shard_bound:
                raise
            from ..utils.logging import log

            device_mesh = device_mesh.halved()
            log(f"warning: mesh too small for {n} shards ({err}); retrying on "
                f"{device_mesh.size}")


def _compile_sharded(mesh, bca, metadata, options, device_mesh, amg_setup):
    from ..fem.solve import _check_options, default_dtype
    from ..meshing.reorder import apply_permutation
    from .dia_shard import prepare_sharded_dia_problem

    _check_options(options)
    n_shards = device_mesh.size
    timings: dict = {}
    _require_constraints(bca)
    if options.operator in ("ell", "hybrid"):
        raise SolverError(
            f"operator='{options.operator}' has no sharded pipeline; use 'auto', "
            "'stencil', or 'dia' (band-hostile meshes are renumbered automatically)"
        )
    use_stencil = options.operator in ("auto", "stencil") and _is_grid_local(mesh)
    if options.operator == "stencil" and not use_stencil:
        raise SolverError(
            "mesh connectivity is not grid-local; stencil operator unavailable"
        )
    if use_stencil:
        return _compile_sharded_stencil(mesh, bca, metadata, options, device_mesh)
    rtol, refined, prep_dtype = _precision_plan(options)

    # the single-device path honours this flag; silently solving with AMG
    # would make identical flags mean different solvers
    precond = {
        "auto": "amg", "amg": "amg", "block_jacobi": "block_jacobi", "jacobi": "block_jacobi",
    }.get(options.preconditioner)
    if precond is None:
        raise SolverError(
            "sharded unstructured solves support preconditioner='amg'/'block_jacobi' "
            f"(or 'auto'); got '{options.preconditioner}' -- drop --shard or the "
            "preconditioner override"
        )
    if options.preconditioner == "jacobi":
        from ..utils.logging import log

        log("warning: sharded unstructured solves do not implement "
            "preconditioner='jacobi'; using block_jacobi")

    # the sharded layout prefers a wider band budget than the single-device
    # default (its ELL fallback pays a gather per matvec); an explicit
    # max_diags is honoured
    max_diags = int(options.max_diags)
    if max_diags == SolverOptions.max_diags:
        max_diags = max(max_diags, 64)

    with span("compile.prepare", timings, "prepare_s"):
        problem = prepare_sharded_dia_problem(
            mesh, bca, metadata, device_mesh, dtype=prep_dtype, amg_setup=amg_setup,
            max_diags=max_diags, cell_factor=float(options.amg_cell_factor),
            preconditioner=precond, assembly=options.assembly, timings=timings,
        )
        # the solve's copies (the V-cycle's dtype, the double-float pairs)
        # and the hierarchy's upload belong to the compile, not to the first
        # solve
        with span("compile.amg_upload", timings, "amg_upload_s"):
            vdtype = torch.float32 if refined else problem.dtype
            problem.bands_in(vdtype)
            problem.amg_in(vdtype)
            if refined and problem.kind == "dia" and options.df_matvec in ("on", "interpret"):
                problem.bands_hl()
            _sync(problem.devices)
    timings["operator"] = "dia-sharded" if problem.kind == "dia" else "ell-sharded"
    timings["preconditioner"] = precond
    timings["shards"] = n_shards
    timings["halo"] = problem.halo
    timings["shard_size"] = problem.local_n

    mesh_r = apply_permutation(mesh, problem.perm) if problem.perm is not None else mesh
    eids, valid, lidx, ecoords, rec_halo = _build_recovery(
        mesh_r.tris, mesh_r.coords, n_shards, problem.local_n
    )
    tdtype = problem.dtype
    return CompiledShardedProblem(
        mode=problem.kind, problem=problem, preconditioner=precond,
        dtype=default_dtype(options), refine=refined, rtol=rtol,
        maxiter=int(options.max_cg_iters), amg_sweeps=int(options.amg_sweeps),
        df_matvec=options.df_matvec,
        lidx=[torch.from_numpy(li.astype(np.int64)).to(d)
              for li, d in zip(lidx, device_mesh.devices)],
        ecoords=[torch.from_numpy(ec).to(d).to(tdtype)
                 for ec, d in zip(ecoords, device_mesh.devices)],
        rec_halo=rec_halo, eids=eids, valid=valid, n_nodes=mesh.num_nodes,
        n_elements=mesh.num_elements, metadata=metadata,
        stress_sign_threshold=float(options.stress_sign_threshold), perm=problem.perm,
        timings=timings, debug_nans=bool(options.debug_nans),
        history=int(options.residual_history), progress_every=int(options.cg_progress_every),
        amg_setup=problem.amg_setup,
    )


def _compile_sharded_stencil(mesh, bca, metadata, options, device_mesh):
    """The structured route: rows over a 1-D mesh, rows x cols tiles over a
    DeviceMesh2D (the device mesh's first axis shards grid rows, the
    second grid cols)."""
    from ..fem.solve import _check_options, default_dtype
    from .stencil_shard import (
        _resolve_preconditioner, prepare_sharded_stencil_problem,
        prepare_sharded_stencil_problem_2d,
    )

    two_d = isinstance(device_mesh, DeviceMesh2D)
    _check_options(options)
    _require_constraints(bca)
    if two_d and (options.operator not in ("auto", "stencil") or not _is_grid_local(mesh)):
        raise SolverError(
            "a 2D device mesh shards the structured stencil operator; this mesh/operator "
            "combination needs a 1D device mesh (node-sharded DIA/AMG)"
        )
    rtol, refined, prep_dtype = _precision_plan(options, use_stencil=True)
    precond = _stencil_precond(options)
    timings: dict = {}
    with span("compile.prepare", timings, "prepare_s"):
        prepare = prepare_sharded_stencil_problem_2d if two_d else prepare_sharded_stencil_problem
        problem = prepare(mesh, bca, metadata, device_mesh, dtype=prep_dtype)
        _sync(problem.devices)
    timings["operator"] = "stencil-sharded-2d" if two_d else "stencil-sharded"
    precond = _resolve_preconditioner(problem, precond)
    timings["preconditioner"] = precond
    timings["shards"] = device_mesh.size
    timings["shard_layout"] = "x".join(str(n) for n in problem.shape)
    rows, cols = mesh.grid_shape
    nr, nc = problem.shape
    rl, cl = problem.reduced[0].shape[-2:]
    if two_d:
        eids, valid, lidx, ecoords = _build_recovery_2d(
            mesh.tris, mesh.coords, rows, cols, mesh.wrap_cols, nr, nc, rl, cl)
        rec_halo = 1
    else:
        eids, valid, lidx, ecoords, rec_halo = _build_recovery(
            mesh.tris, mesh.coords, nr, rl * cols)
    timings["halo"] = rec_halo
    timings["shard_size"] = rl * cl
    devices = problem.devices
    return CompiledShardedStencilProblem(
        kind="stencil2d" if two_d else "stencil", problem=problem, preconditioner=precond,
        dtype=default_dtype(options), refine=refined, rtol=rtol,
        maxiter=int(options.max_cg_iters), refine_inner_iters=int(options.refine_inner_iters),
        refine_max_outer=int(options.refine_max_outer),
        lidx=[torch.from_numpy(li.astype(np.int64)).to(d) for li, d in zip(lidx, devices)],
        ecoords=[torch.from_numpy(ec).to(d).to(problem.dtype) for ec, d in zip(ecoords, devices)],
        rec_halo=rec_halo, eids=eids, valid=valid, n_nodes=mesh.num_nodes,
        n_elements=mesh.num_elements, metadata=metadata,
        stress_sign_threshold=float(options.stress_sign_threshold), timings=timings,
        debug_nans=bool(options.debug_nans), history=int(options.residual_history),
    )
