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

The device mesh is one controller's: `DeviceMesh` holds an ordered tuple
of `torch.device`s, one per shard, and a device may repeat (S shards on
one card, or on the CPU in the tests). `default_device_mesh()` takes
every visible CUDA device, as the JAX package takes every visible device.

Entry points: `compile_sharded_problem` -> `CompiledShardedProblem.solve()`,
`fem.solve.solve_system(..., device_mesh=...)`, or the CLI's `--shard`.
Not yet ported, each a typed error and never another solver: the
structured (stencil) sharded path that grid-local meshes take under
operator="auto" / "stencil", and the 2-D ("RxC") device-mesh layout.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..bc import BCArrays
from ..config import ModelMetadata, SolverOptions
from ..errors import InputError, SolverError
from ..meshing.core import Mesh as FemMesh
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

    def halved(self) -> "DeviceMesh":
        return DeviceMesh(self.devices[: max(self.size // 2, 1)], self.axis)


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
    1-D mesh over every visible device. "RxC", the 2-D layout of the
    structured sharded path, is validated as the JAX package does and then
    refused: not yet ported."""
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
    raise InputError(
        f"--shard layout {layout!r}: the 2-D (structured, rows x cols) device-mesh "
        "layout is not yet ported to the PyTorch package; use 'auto' or '1d'"
    )


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
        from ..fem.solve import SolveResult
        from .dia_shard import sharded_dia_pcg_solve

        p = self.problem
        timings = dict(self.timings)
        t0 = time.perf_counter()
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
        _sync(p.devices)
        timings["solve_s"] = time.perf_counter() - t0

        n = self.n_nodes
        u = result.x.gather(n).T
        f = f_d.gather(n).T
        sigma = np.zeros((self.n_elements, 3), dtype=u.dtype)
        stress = np.zeros(self.n_elements, dtype=u.dtype)
        vm = np.zeros(self.n_elements, dtype=u.dtype)
        for s, (sg, st, v) in enumerate(per_shard):
            ok = self.valid[s]
            ids = self.eids[s][ok]
            sigma[ids] = sg.cpu().numpy()[ok]
            stress[ids] = st.cpu().numpy()[ok]
            vm[ids] = v.cpu().numpy()[ok]
        if self.perm is not None:
            u_o, f_o = np.empty_like(u), np.empty_like(f)
            u_o[self.perm], f_o[self.perm] = u, f
            u, f = u_o, f_o
        if self.debug_nans:
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
        return SolveResult(
            u=u, f=f, sigma=sigma, stress=stress, von_mises=vm,
            iterations=iters, residual_norm=resnorm,
            residual_rel=resnorm / max(float(bnorm), 1e-300), converged=True,
            timings=timings, residual_history=result.history.cpu().numpy()[:iters],
        )


def _sync(devices) -> None:
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _require_constraints(bca: BCArrays) -> None:
    if not bca.u_known.any():
        raise SolverError(
            "model has no prescribed displacements; stiffness system is singular"
        )


def _precision_plan(options: SolverOptions):
    """(rtol, refined, prep dtype) of a sharded solve, by the port's
    single-device rules (fem/solve.py): refine="on" is f64 CG around the
    f32 V-cycle; otherwise the options' dtype (f64 by default) throughout.
    The f32 solver clamps a sub-floor rtol itself, with the warning."""
    from ..fem.solve import default_dtype

    dtype = default_dtype(options)
    refined = options.refine == "on"
    prep = np.float64 if (refined or dtype == torch.float64) else np.float32
    return float(options.cg_rtol), refined, prep


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
    CUDA device), end to end: node-sharded DIA bands + AMG, renumbering
    band-hostile meshes first, the block-ELL fallback where the bands do
    not fit `max_diags`.

    Meshes too small for the requested shard count (the band or stress
    halo must fit inside one shard) retry on half the devices with a
    warning, down to one."""
    if device_mesh is None:
        device_mesh = default_device_mesh()
    if not isinstance(device_mesh, DeviceMesh):
        raise SolverError(
            "the sharded pipeline takes a 1-D parallel.pipeline.DeviceMesh; a 2-D "
            "(structured, rows x cols) device mesh is not yet ported to the PyTorch "
            "package"
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
        raise SolverError(
            "the sharded stencil path (a grid-local structured mesh under "
            f"operator='{options.operator}') is not yet ported to the PyTorch "
            "package; pass operator='dia' to shard it as an unstructured mesh, "
            "or drop device_mesh / --shard"
        )
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

    t0 = time.perf_counter()
    problem = prepare_sharded_dia_problem(
        mesh, bca, metadata, device_mesh, dtype=prep_dtype, amg_setup=amg_setup,
        max_diags=max_diags, cell_factor=float(options.amg_cell_factor),
        preconditioner=precond, assembly=options.assembly, timings=timings,
    )
    # the solve's copies (the V-cycle's dtype, the double-float pairs) and
    # the hierarchy's upload belong to the compile, not to the first solve
    t1 = time.perf_counter()
    vdtype = torch.float32 if refined else problem.dtype
    problem.bands_in(vdtype)
    problem.amg_in(vdtype)
    if refined and problem.kind == "dia" and options.df_matvec in ("on", "interpret"):
        problem.bands_hl()
    _sync(problem.devices)
    timings["amg_upload_s"] = time.perf_counter() - t1
    timings["prepare_s"] = time.perf_counter() - t0
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
