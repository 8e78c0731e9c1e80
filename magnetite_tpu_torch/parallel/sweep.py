"""Lane-batched design sweeps: one assembled system, thousands of solves
(port of magnetite_tpu/parallel/sweep.py).

A batch axis turns the solve into a design sweep. Fields carry the BATCH as
the minormost (lane) axis, the operator is shared by every lane, and ONE
multigrid hierarchy preconditions all of them with a fixed-iteration PCG
(fem/cg.py), so every lane runs in lockstep and no iteration reads the
host. The routes, picked per mesh as the JAX package picks them:

  * structured grids (`compile_sweep`, `compile_material_sweep`; canonical
    generator grids, fields [2, R, C, B]): the stencil operator and one
    geometric-multigrid hierarchy (fem/multigrid.py) whose coarsest level is
    a dense inverse when small. The lane stencil matvec is the hand-written
    kernel of kernels/lane_stencil_kernel.py (one instance for the shared
    stencil, one for three basis stencils weighted per lane), on stencils
    packed once when the sweep compiles; the material sweep's coarsest
    level is one launch of kernels/lane_coarse_kernel.py where it fits; the
    transfers and the other block-Jacobi steps are torch ops.
  * arbitrary meshes (`compile_unstructured_sweep`,
    `compile_unstructured_material_sweep`; fields [2, N, B]): the DIA band
    operator and one smoothed-aggregation AMG hierarchy (fem/amg.py), the
    band matvecs the lane kernels K7 / K8 (kernels/lane_dia_kernel.py).
  * small meshes as given (`_sweep_lanes`, `impl="lanes"`): the DIA band
    operator through K7 with block-Jacobi, no renumbering, no hierarchy.
  * band-hostile meshes (`_sweep_vmap`, `impl="vmap"`): the block-ELL
    operator (fem/assembly.py, fem/operator.py) through the lane ELL kernel
    (kernels/lane_ell_kernel.py) with block-Jacobi. The JAX package runs
    this route as a `jax.vmap` of its single solve; the port keeps the
    name and runs every lane at once in the [2, N, B] lane layout.

Load sweeps vary the prescribed displacements, applied forces and a
stiffness scale s_b per lane (Young's modulus x thickness at fixed Poisson
ratio); the V-cycle is linear, so V((s_b K))^-1 = (1/s_b) V(K)^-1 and the
shared hierarchy is every lane's exact preconditioner. Material sweeps vary
(E, nu, t): the stiffness is linear in the plane-stress D coefficients and
in t, so three basis operators span every material, K(E, nu, t) = wa*Ka +
wb*Kb + wc*Kc, and the basis hierarchy gives each lane the exact V-cycle of
its own operator.

On a CUDA device the lane matvecs are the kernels; on the CPU their plain
PyTorch versions. The tensors' device alone picks which.

Lane sharding (`device_mesh=` of the four compiled sweeps): every lane is
independent (per-lane dots, a shared operator and hierarchy), so the batch
splits into one contiguous chunk of lanes per device of a
parallel.pipeline.DeviceMesh (or, row-major, a DeviceMesh2D), with no
communication during the solve. The sweep compiles on the mesh's first
device and its setup is replicated once per distinct device; each chunk
runs the lane kernels on its own device, and the results come back in
lane order on the first device. The JAX package turns its Pallas lane
kernels off under a mesh (a limitation of Pallas under `shard_map`); the
port keeps its kernels on.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..bc import BCArrays
from ..config import ModelMetadata
from ..errors import InputError, SolverError
from ..fem.amg import (
    COARSE_SWEEPS,
    OMEGA,
    _block_ell_matvec,
    amg_sweep_schedule,
    ieee_f32,
)
from ..fem.assembly import assemble_ell, build_ell_structure, extract_block_diagonal
from ..fem.blocks import apply_blocks, guarded_inv2, reduce_diag_blocks, solve2
from ..fem.cg import pcg_fixed_iterations
from ..fem.multigrid import COARSE_SWEEPS as MG_COARSE_SWEEPS
from ..fem.operator import block_jacobi_inverse, make_constrained_operator, reduced_rhs
from ..fem.solve import resolve_device
from ..kernels.lane_dia_kernel import lane_dia_matvec, lane_dia_matvec3, offsets_tensor
from ..kernels.lane_ell_kernel import lane_ell_matvec
from ..kernels.lane_coarse_kernel import lane_coarse_smooth3
from ..kernels.lane_stencil_kernel import (
    lane_stencil_matvec, lane_stencil_matvec3, pack_lane_stencils,
)
from ..kernels.mg_smooth_kernel import OMEGA as MG_OMEGA
from ..meshing.core import Mesh

_LANE_KERNEL_MODES = ("auto", "interpret", "off")


class SweepResult(NamedTuple):
    u: torch.Tensor  # [B, N, 2]
    residual_norm: torch.Tensor  # [B] absolute ||b - K u|| per lane
    von_mises: torch.Tensor  # [B, E]
    rhs_norm: torch.Tensor = None  # [B] ||b|| per lane (relative-residual scale)


# ----------------------------- lane helpers ---------------------------------


def _lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane inner product: [2, N, B] x [2, N, B] -> [B]."""
    return torch.sum(a * b, dim=(0, 1))


def _factor_fields(u_base, f_base, u_factors, f_factors):
    """[N, 2] base BC values x per-lane [B] load factors -> [B, N, 2] lane
    fields, built on the device (three [B] uploads instead of two dense
    [B, N, 2] batches)."""
    u = u_base[None] * u_factors[:, None, None]
    f = f_base[None] * f_factors[:, None, None]
    return u, f


def _perm_nodes(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Device-side node permutation of a [B, N, 2] lane batch."""
    return x[:, perm, :]


def _perm_arrays(perm, device):
    """(perm_dev, iperm_dev) index tensors for _perm_nodes, or (None, None).
    iperm inverts perm: iperm[perm[i]] = i, so u_orig = u_new[:, iperm, :]."""
    if perm is None:
        return None, None
    perm = np.asarray(perm)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return (
        torch.from_numpy(perm.astype(np.int64)).to(device),
        torch.from_numpy(iperm.astype(np.int64)).to(device),
    )


def _chunked_lane_vm(u, tris, b_mat, sigma_fn, chunk: int = 512):
    """Per-lane von Mises [E, B] WITHOUT materializing the full [E, 6, B]
    gather: a loop over element chunks bounds the transient at [C, 6, B].

    u [2, N, B]; sigma_fn(strain [C, 3, B]) -> (s0, s1, s2) per-lane stress
    components."""
    out = []
    for s in range(0, tris.shape[0], chunk):
        t_c, b_c = tris[s : s + chunk], b_mat[s : s + chunk]
        ue = u[:, t_c, :]  # [2, C, 3, B]
        ue = ue.permute(1, 2, 0, 3).reshape(t_c.shape[0], 6, -1)
        with ieee_f32():
            strain = torch.einsum("erj,ejb->erb", b_c.to(u.dtype), ue)
        s0, s1, s2 = sigma_fn(strain)
        out.append(torch.sqrt(s0 * s0 - s0 * s1 + s1 * s1 + 3.0 * s2 * s2))
    return torch.cat(out)


def _lane_vm(u, tris, b_mat, d_mat, k_scales=None):
    """Per-lane von Mises [E, B] of sigma = D B u_b, each stress component
    scaled by k_scales [B] (before the root) when given."""
    ks = None if k_scales is None else k_scales[None, :]

    def sigma_fn(strain):  # [C, 3, B] -> per-lane stress components
        s = [d_mat[r, 0] * strain[:, 0] + d_mat[r, 1] * strain[:, 1] + d_mat[r, 2] * strain[:, 2]
             for r in range(3)]
        return tuple(s) if ks is None else (s[0] * ks, s[1] * ks, s[2] * ks)

    return _chunked_lane_vm(u, tris, b_mat, sigma_fn)


def _banded_mesh_or_raise(mesh, base_bca, max_diags: int, fallback_hint: str):
    """Band structure for an arbitrary mesh, renumbering when needed.

    Returns (mesh, bca, dia, perm); raises SolverError (with the caller's
    suggested fallback) when the mesh stays band-hostile."""
    from ..fem.dia import build_dia_structure
    from ..meshing.reorder import renumber

    n = mesh.num_nodes
    perm = None
    bca = base_bca
    dia = build_dia_structure(mesh.tris, n, max_diags=max_diags)
    if dia is None:
        mesh_r, perm_r, _stats = renumber(mesh)
        dia = build_dia_structure(mesh_r.tris, n, max_diags=max_diags)
        if dia is None:
            raise SolverError(
                "mesh is band-hostile even after renumbering; use " + fallback_hint
            )
        mesh, perm = mesh_r, perm_r
        bca = BCArrays(
            u_known=base_bca.u_known[perm],
            u_value=base_bca.u_value[perm],
            f_value=base_bca.f_value[perm],
        )
    return mesh, bca, dia, perm


def _bands_from_flat(flat: np.ndarray, n_diags: int, n: int) -> torch.Tensor:
    """Slot-flat [D*N, 2, 2] (or [D*N, 4]) host assembly -> bands [D, 2, 2, N]."""
    return torch.from_numpy(
        np.ascontiguousarray(flat.reshape(n_diags, n, 2, 2).transpose(0, 2, 3, 1))
    )


def _assembled_bands(mesh, metadata, dia) -> torch.Tensor:
    """Unmasked DIA bands [D, 2, 2, N] (f64, host): the C++ closed-form
    element blocks scattered into the band slots (as compile_problem)."""
    from .. import native

    n, e_count = mesh.num_nodes, mesh.tris.shape[0]
    slots_pm = (  # the native assembly takes the slots pair-major: [3, 3, E]
        np.asarray(dia.slot_ids, np.int64).reshape(e_count, 3, 3)
        .transpose(1, 2, 0).reshape(-1)
    )
    flat = native.amg_assemble(
        mesh.coords, mesh.tris, np.ones((n, 2)), metadata.youngs_modulus,
        metadata.poisson_ratio, metadata.part_thickness, slots_pm, dia.n_diags * n,
    )
    return _bands_from_flat(flat, dia.n_diags, n)


def _element_arrays(mesh, sm_dtype, dev):
    """(tris [E, 3] int64, B matrices [E, 3, 6]) on the device; B from f64
    coordinates, stored in the V-cycle dtype."""
    from ..fem.element import element_areas, gather_element_coords, strain_displacement_matrices

    coords = torch.from_numpy(np.asarray(mesh.coords, np.float64)).to(dev)
    tris = torch.from_numpy(np.asarray(mesh.tris, np.int64)).to(dev)
    ecoords = gather_element_coords(coords, tris)
    b_mat = strain_displacement_matrices(ecoords, element_areas(ecoords))
    return tris, b_mat.to(sm_dtype)


def _dtypes(dtype, refined):
    """(user dtype, CG dtype) as torch dtypes; the V-cycle runs in the user
    dtype. `refined=None` is on for f32: f64 CG over the f32 V-cycle (the
    JAX package's default under x64)."""
    name = np.dtype(dtype).name
    if name not in ("float32", "float64"):
        raise InputError(f"unsupported sweep dtype '{dtype}' (float32 | float64)")
    user = getattr(torch, name)
    if refined is None:
        refined = user == torch.float32
    return user, torch.float64 if refined else user


def _check_common(lane_kernel, dev):
    """`lane_kernel` is the JAX package's switch, kept for its API: "auto"
    and "interpret" launch the lane kernels on a CUDA device (JAX's
    "interpret" runs its kernel's own semantics off the TPU); "off" asks for
    the plain versions, which the port runs on the CPU only."""
    if lane_kernel not in _LANE_KERNEL_MODES:
        raise InputError(f"unknown lane_kernel mode '{lane_kernel}' (auto | interpret | off)")
    if lane_kernel == "off" and dev.type == "cuda":
        raise InputError(
            "lane_kernel='off' runs the plain lane matvecs, which the port "
            "runs on the CPU only: pass device='cpu' or lane_kernel='auto'"
        )


def _batch_on(arr, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(arr).to(dev, dtype)


# ------------------------------ lane sharding --------------------------------


def _compile_device(device_mesh, device) -> torch.device:
    """The device a sweep compiles on: the first device of `device_mesh`
    when one is given (`device` is then unused), else `device`."""
    if device_mesh is None:
        return resolve_device(device)
    from .pipeline import DeviceMesh, DeviceMesh2D

    if not isinstance(device_mesh, (DeviceMesh, DeviceMesh2D)):
        raise InputError(
            "device_mesh must be a parallel.pipeline.DeviceMesh or DeviceMesh2D (the "
            f"lanes split over its devices, row-major); got {type(device_mesh).__name__}"
        )
    return resolve_device(device_mesh.devices[0])


def _to_device(obj, dev):
    """`obj` with every tensor it holds copied to `dev`, through tuples,
    named tuples and dataclasses (the compiled sweeps' containers);
    anything else is shared."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, tuple):
        items = [_to_device(v, dev) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to_device(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj) if f.init
        })
    return obj


def _replica(sweep, dev: torch.device):
    """The sweep on `dev`, without a mesh: made once per distinct device
    (the setup replicated), the compiled tensors shared on the first."""
    if dev not in sweep.replicas:
        base = dataclasses.replace(sweep, device_mesh=None, replicas={})
        sweep.replicas[dev] = base if dev == sweep.device else dataclasses.replace(
            _to_device(base, dev), device=dev)
    return sweep.replicas[dev]


def _over_lanes(sweep, method: str, *lane_args) -> SweepResult:
    """`sweep.method(*lane_args)` split over the lanes: one contiguous chunk
    of the [B, ...] batch arguments per device of sweep.device_mesh
    (row-major), each solved by the sweep's replica there; the results
    concatenated in lane order on the mesh's first device."""
    devices = sweep.device_mesh.devices
    n = len(devices)
    args = [a if isinstance(a, torch.Tensor) else np.asarray(a) for a in lane_args]
    b = args[0].shape[0]
    if b % n:
        raise InputError(
            f"sweep batch of {b} lanes does not divide over {n} devices; pad the batch "
            "to a multiple (repeating a variant is free)"
        )
    c = b // n
    parts = [getattr(_replica(sweep, dev), method)(*(a[i * c:(i + 1) * c] for a in args))
             for i, dev in enumerate(devices)]
    first = devices[0]
    return SweepResult(*(torch.cat([getattr(p, name).to(first) for p in parts])
                         for name in SweepResult._fields))


# --------------------- unstructured load sweeps (K7) ------------------------


def _dia_amg_lanes_core(
    bands, bands_sm, offsets, offsets_dev, amg, d_mat, b_mat, free, u_fixed,
    f_applied, k_scales, tris, iterations, amg_sweeps=0,
):
    """bands: CG-precision DIA bands (f64 when refined: the kappa*eps_f32
    true-residual wall caps pure-f32 force-driven lanes at ~1e-3 relative).
    bands_sm: the V-cycle's bands for the level-0 smoothing."""
    from ..fem.amg import make_amg_preconditioner

    cgt, smt = bands.dtype, bands_sm.dtype
    u_fixed = u_fixed.permute(2, 1, 0).to(cgt).contiguous()  # [2, N, B]
    f_applied = f_applied.permute(2, 1, 0).to(cgt).contiguous()
    free_b = free.to(cgt)[:, :, None]
    free_sm = free.to(smt)[:, :, None]
    k_scales = k_scales.to(cgt)

    def band_matvec(bk, u):  # UNSCALED K u on [2, N, B] lane fields
        return lane_dia_matvec(bk, offsets, u, offsets_dev)

    def op_sm(v):  # reduced base operator (the hierarchy's level 0)
        return free_sm * band_matvec(bands_sm, free_sm * v) + (1.0 - free_sm) * v

    def op(v):  # per-lane CG operator K_b = s_b K
        return free_b * (band_matvec(bands, free_b * v) * k_scales) + (1.0 - free_b) * v

    # unscaled reduced block-Jacobi inverse: the level-0 smoother
    d = reduce_diag_blocks(bands_sm[offsets.index(0)], free_sm[:, :, 0])
    inv_b = guarded_inv2(d)[:, :, :, None]

    def jac0(r):
        return apply_blocks(inv_b, r)

    # one shared V-cycle, un-scaled per lane on the way out (exact:
    # V((s K))^-1 = (1/s) V(K)^-1 on free DOFs, identity on fixed); the
    # residual is normalized per lane before the V-cycle's cast. A fixed
    # budget cannot harvest an iteration cut, so auto stays V(1, 1)
    vcycle = make_amg_preconditioner(
        amg, op_sm, jac0,
        a_op=lambda v: free_sm * band_matvec(bands_sm, free_sm * v),
        sweeps=amg_sweep_schedule(False, amg_sweeps),
    )
    inv_scale = free_b / k_scales + (1.0 - free_b)

    def precond(r):
        nrm = torch.sqrt(_lane_dot(r, r))  # [B]
        safe = torch.where(nrm == 0, torch.ones_like(nrm), nrm)
        z = vcycle((r / safe).to(smt)).to(cgt) * safe
        return z * inv_scale

    rhs = (
        free_b * (f_applied - band_matvec(bands, u_fixed) * k_scales)
        + (1.0 - free_b) * u_fixed
    )
    result = pcg_fixed_iterations(
        op, rhs, preconditioner=precond, x0=u_fixed, iterations=iterations,
        dot=_lane_dot,
    )
    u = result.x  # [2, N, B]

    vm = _lane_vm(u, tris, b_mat, d_mat.to(cgt), k_scales)
    return (
        u.permute(2, 1, 0),  # [B, N, 2]
        result.residual_norm,  # [B]
        vm.T,  # [B, E]
        torch.sqrt(_lane_dot(rhs, rhs)),  # [B]
    )


@dataclass
class CompiledUnstructuredSweep:
    """An arbitrary mesh compiled for repeated AMG-preconditioned sweeps.

    Setup (band renumbering, DIA assembly, the AMG hierarchy build and its
    upload) runs once; `solve(u_values, f_values, k_scales)` and
    `solve_factors(u_factors, f_factors, k_scales)` run only the
    lane-batched PCG. Results are tensors on `device`, in the caller's node
    order. `amg_setup` is the host hierarchy (reusable by compile_problem
    on the same mesh, and by the JAX package through interop)."""

    bands: torch.Tensor  # CG precision (f64 when refined)
    bands_sm: torch.Tensor  # V-cycle precision (the same tensor when not refined)
    offsets: tuple
    offsets_dev: torch.Tensor  # int32 copy of `offsets` for the kernels
    amg: object  # AMGDeviceArrays, coarse levels block-ELL
    d_mat: torch.Tensor
    b_mat: torch.Tensor
    free: torch.Tensor  # [2, N]
    tris: torch.Tensor  # renumbered
    perm: object  # perm[new] = old, or None
    iterations: int
    dtype: torch.dtype
    amg_setup: object
    n_nodes: int
    device: torch.device
    amg_sweeps: int = 0
    perm_dev: Optional[torch.Tensor] = None
    iperm_dev: Optional[torch.Tensor] = None
    # compile-time base BC values in the RENUMBERED node order
    u_base: Optional[torch.Tensor] = None
    f_base: Optional[torch.Tensor] = None
    # lane sharding: the mesh, and the replicas per device (_replica)
    device_mesh: object = None
    replicas: dict = field(default_factory=dict, repr=False)

    def _batch(self, arr) -> torch.Tensor:
        return _batch_on(arr, self.dtype, self.device)

    def _run(self, u_fixed, f_applied, k_scales) -> SweepResult:
        u, res, vm, rhs_norm = _dia_amg_lanes_core(
            self.bands, self.bands_sm, self.offsets, self.offsets_dev, self.amg,
            self.d_mat, self.b_mat, self.free, u_fixed, f_applied,
            self._batch(k_scales), self.tris, self.iterations, self.amg_sweeps,
        )
        u = _perm_nodes(u, self.iperm_dev) if self.iperm_dev is not None else u.contiguous()
        return SweepResult(u=u, residual_norm=res, von_mises=vm, rhs_norm=rhs_norm)

    def solve_factors(self, u_factors, f_factors, k_scales) -> SweepResult:
        """Load-factor sweep: lane b solves the compile-time BCs scaled by
        (u_factors[b], f_factors[b]) -- u_fixed = u_factors[b] * u_base,
        f_applied = f_factors[b] * f_base, built on the device; identical
        to the equivalent dense solve()."""
        if self.device_mesh is not None:
            return _over_lanes(self, "solve_factors", u_factors, f_factors, k_scales)
        u_fixed, f_applied = _factor_fields(
            self.u_base, self.f_base, self._batch(u_factors), self._batch(f_factors)
        )
        return self._run(u_fixed, f_applied, k_scales)

    def solve(self, u_values, f_values, k_scales) -> SweepResult:
        """Dense sweep: u_values / f_values [B, N, 2] per-lane prescribed
        displacements and applied forces, k_scales [B] stiffness scales."""
        if self.device_mesh is not None:
            return _over_lanes(self, "solve", u_values, f_values, k_scales)
        up, fp = self._batch(u_values), self._batch(f_values)
        if self.perm_dev is not None:
            up, fp = _perm_nodes(up, self.perm_dev), _perm_nodes(fp, self.perm_dev)
        return self._run(up, fp, k_scales)


def _dense_inverse_amg(mesh, metadata, free_np, sm_dtype, dev):
    """The EXACT dense inverse of the reduced operator as a one-level
    hierarchy: for meshes too small to coarsen (2N <= the dense-coarse
    threshold) the V-cycle would degenerate to block-Jacobi."""
    from ..fem.amg import AMGDeviceArrays, _assemble_block_coo

    n = mesh.num_nodes
    ar, ac, av = _assemble_block_coo(
        mesh.coords, mesh.tris, float(metadata.youngs_modulus),
        float(metadata.poisson_ratio), float(metadata.part_thickness), free_np,
    )
    dense = np.zeros((n, 2, n, 2))
    np.add.at(dense, (ar, slice(None), ac, slice(None)), av)
    dense = dense.reshape(2 * n, 2 * n)
    dense[np.arange(2 * n), np.arange(2 * n)] += (1.0 - free_np).reshape(-1)
    ci = torch.from_numpy(np.linalg.inv(dense)).to(dev, sm_dtype)
    return AMGDeviceArrays(
        n_levels=1, transfers=(), coarse=(), coarse_bands=(), ci=ci, fast0=None
    )


def compile_unstructured_sweep(
    mesh: Mesh,
    base_bca: BCArrays,
    metadata: ModelMetadata,
    iterations: int = 30,
    dtype=np.float32,
    amg_setup=None,
    cell_factor: float = 3.0,
    max_diags: int = 96,
    refined=None,
    device_mesh=None,
    amg_sweeps: int = 0,
    lane_kernel: str = "auto",
    device="cuda",
) -> CompiledUnstructuredSweep:
    """Compile an arbitrary (Delaunay / gmsh) mesh for AMG-lane sweeps on
    `device` ("cuda" or "cpu", never chosen implicitly).

    Band-renumbers band-hostile meshes (meshing/reorder.py), assembles the
    DIA operator once, and builds (or validates a provided) AMG hierarchy.
    Raises SolverError when the mesh stays band-hostile after renumbering.

    `refined` (None: on for f32): f64 CG over f64 bands with the f32 V-cycle
    preconditioner -- pure-f32 lanes hit the kappa*eps_f32 true-residual
    wall (~1e-3 relative on force-driven cases); mixed precision restores
    ~1e-7. `amg_sweeps` pins the V-cycle schedule (0 = auto V(1, 1)).
    `lane_kernel` ("auto" | "interpret" | "off"): the JAX package's switch;
    the lane kernel runs on a CUDA device and its plain version on the CPU
    whatever it says, and "off" with a CUDA device raises InputError.
    `device_mesh` (a parallel.pipeline.DeviceMesh or DeviceMesh2D) shards
    the lanes over its devices: the sweep compiles on its first device
    (`device` is then unused), B must divide by the device count."""
    from .. import native
    from ..fem.amg import amg_device_arrays, build_amg_setup, setup_matches
    from ..fem.element import stress_strain_matrix

    dev = _compile_device(device_mesh, device)
    _check_common(lane_kernel, dev)
    native.require()
    user_t, cg_t = _dtypes(dtype, refined)
    sm_t = user_t
    n = mesh.num_nodes
    mesh, bca, dia, perm = _banded_mesh_or_raise(
        mesh, base_bca, max_diags, "sweep_solve's vmap route (impl='vmap')"
    )

    free_np = (~bca.u_known).astype(np.float64)
    if amg_setup is None or not setup_matches(
        amg_setup, mesh.coords, mesh.tris, free_np, metadata, cell_factor, perm,
    ):
        amg_setup = build_amg_setup(
            mesh.coords, mesh.tris, metadata.youngs_modulus,
            metadata.poisson_ratio, metadata.part_thickness, free_np,
            cell_factor=cell_factor,
        )
    if amg_setup.transfers:
        # the lane-batched V-cycle: gather-form level-0 transfers and
        # coarse levels in block-ELL
        amg = amg_device_arrays(amg_setup, sm_t, dev, coarse_max_diags=0)
    else:
        amg = _dense_inverse_amg(mesh, metadata, free_np, sm_t, dev)

    bands64 = _assembled_bands(mesh, metadata, dia).to(dev)
    bands = bands64.to(cg_t)
    bands_sm = bands if cg_t == sm_t else bands64.to(sm_t)
    tris, b_mat = _element_arrays(mesh, sm_t, dev)
    offsets = tuple(int(o) for o in dia.offsets)
    perm_dev, iperm_dev = _perm_arrays(perm, dev)
    return CompiledUnstructuredSweep(
        bands=bands,
        bands_sm=bands_sm,
        offsets=offsets,
        offsets_dev=offsets_tensor(offsets, dev),
        amg=amg,
        d_mat=stress_strain_matrix(
            metadata.youngs_modulus, metadata.poisson_ratio, sm_t, dev
        ),
        b_mat=b_mat,
        free=torch.from_numpy((~bca.u_known).T.astype(np.float64)).to(dev, sm_t),
        tris=tris,
        perm=perm,
        iterations=int(iterations),
        dtype=user_t,
        amg_setup=amg_setup,
        n_nodes=n,
        device=dev,
        amg_sweeps=int(amg_sweeps),
        perm_dev=perm_dev,
        iperm_dev=iperm_dev,
        u_base=torch.from_numpy(np.asarray(bca.u_value, np.float64)).to(dev, user_t),
        f_base=torch.from_numpy(np.asarray(bca.f_value, np.float64)).to(dev, user_t),
        device_mesh=device_mesh,
    )


# -------------- DIA block-Jacobi lanes and the vmap fallback -----------------


def _block_jacobi_lanes(base_matvec, inv_b, free, ks, u_fixed, f_applied, iterations,
                        von_mises) -> SweepResult:
    """Fixed-iteration PCG of every lane at once ([2, N, B] fields) on the
    masked operator of `base_matvec` (K_b u = s_b K u), preconditioned by
    the unscaled block-Jacobi inverse inv_b [2, 2, N, 1] un-scaled per lane:
    M_b^-1 = (1/s_b) M^-1 on free DOFs, identity on fixed ones.
    `von_mises(u)` -> [E, B]. Results in the caller's [B, N, 2]."""
    free_b = free[:, :, None]  # broadcast over lanes
    inv_scale = free_b / ks + (1.0 - free_b)
    rhs = reduced_rhs(base_matvec, free_b, u_fixed, f_applied)
    result = pcg_fixed_iterations(
        make_constrained_operator(base_matvec, free_b), rhs,
        preconditioner=lambda r: apply_blocks(inv_b, r) * inv_scale, x0=u_fixed,
        iterations=iterations, dot=_lane_dot,
    )
    return SweepResult(
        u=result.x.permute(2, 1, 0).contiguous(),
        residual_norm=result.residual_norm,
        von_mises=von_mises(result.x).T,
        rhs_norm=torch.sqrt(_lane_dot(rhs, rhs)),
    )


def _route_operands(mesh, base_bca, metadata, u_values, f_values, k_scales, dtype, device):
    """(dtype, device, free [2, N], tris, B matrices, D matrix, u_fixed,
    f_applied [2, N, B], k_scales [B]) of the block-Jacobi routes, all in
    the sweep's dtype (these routes have no refinement)."""
    from ..fem.element import stress_strain_matrix

    dev = resolve_device(device)
    t = _dtypes(dtype, False)[0]
    tris, b_mat = _element_arrays(mesh, t, dev)
    d_mat = stress_strain_matrix(metadata.youngs_modulus, metadata.poisson_ratio, t, dev)
    free = torch.from_numpy((~base_bca.u_known).T.astype(np.float64)).to(dev, t)

    def lanes(x):  # [B, N, 2] -> [2, N, B]
        return _batch_on(x, t, dev).permute(2, 1, 0).contiguous()

    return (t, dev, free, tris, b_mat, d_mat, lanes(u_values), lanes(f_values),
            _batch_on(k_scales, t, dev))


def _sweep_lanes(
    mesh, base_bca, metadata, u_values, f_values, k_scales, iterations, dtype, dia,
    device="cuda",
) -> SweepResult:
    """The DIA block-Jacobi lanes (port of the JAX package's _sweep_lanes /
    _lanes_core) on the mesh AS GIVEN (`dia` its band structure; no
    renumbering): K_b = s_b K through K7, the reduced block-Jacobi inverse
    (det == 0 guarded) un-scaled per lane, everything in `dtype`."""
    t, dev, free, tris, b_mat, d_mat, u_fixed, f_applied, ks = _route_operands(
        mesh, base_bca, metadata, u_values, f_values, k_scales, dtype, device)
    bands = _assembled_bands(mesh, metadata, dia).to(dev, t)
    offsets = tuple(int(o) for o in dia.offsets)
    offsets_dev = offsets_tensor(offsets, dev)

    def base_matvec(u):  # K_b u = s_b K u
        return lane_dia_matvec(bands, offsets, u, offsets_dev) * ks

    inv_b = guarded_inv2(reduce_diag_blocks(bands[offsets.index(0)], free))[..., None]
    return _block_jacobi_lanes(
        base_matvec, inv_b, free, ks, u_fixed, f_applied, int(iterations),
        lambda u: _lane_vm(u, tris, b_mat, d_mat, ks),
    )


def _sweep_vmap(
    mesh, base_bca, metadata, u_values, f_values, k_scales, iterations, dtype,
    structure=None, device="cuda",
) -> SweepResult:
    """The fallback for band-hostile meshes (port of the JAX package's
    _sweep_vmap): the block-ELL operator of `structure` (built from the mesh
    as given when None) through the lane ELL kernel, K_b = s_b K; block-
    Jacobi from its diagonal blocks (no det guard, as the JAX package's
    single solve), un-scaled per lane. The JAX package vmaps its single
    solve over the lanes; every lane here runs at once in [2, N, B]."""
    t, dev, free, tris, b_mat, d_mat, u_fixed, f_applied, ks = _route_operands(
        mesh, base_bca, metadata, u_values, f_values, k_scales, dtype, device)
    if structure is None:
        structure = build_ell_structure(mesh.tris, mesh.num_nodes)
    ell = assemble_ell(
        mesh.coords, mesh.tris, metadata.youngs_modulus, metadata.poisson_ratio,
        metadata.part_thickness, structure,
    ).to(dev, t)
    cols = torch.from_numpy(np.ascontiguousarray(structure.cols, np.int32)).to(dev)

    def base_matvec(u):  # K_b u = s_b K u
        return lane_ell_matvec(ell, cols, u) * ks

    inv = block_jacobi_inverse(extract_block_diagonal(ell, cols), free.T)  # [N, 2, 2]
    return _block_jacobi_lanes(
        base_matvec, inv.permute(1, 2, 0)[..., None], free, ks, u_fixed, f_applied,
        int(iterations),
        lambda u: _lane_vm(u, tris, b_mat, d_mat) * ks[None, :],  # scaled after the root
    )


def _amg_sweep_min_nodes() -> int:
    """Auto-dispatch threshold for the AMG lanes, shared with the solver's
    AMG auto-engage rule (config.SolverOptions.amg_auto_min_nodes)."""
    from ..config import SolverOptions

    return int(SolverOptions().amg_auto_min_nodes)


def sweep_solve(
    mesh: Mesh,
    base_bca: BCArrays,
    metadata: ModelMetadata,
    u_values,  # [B, N, 2] prescribed displacement per variant
    f_values,  # [B, N, 2] applied force per variant
    k_scales,  # [B] Young's-modulus scale per variant
    iterations: int = 200,
    dtype=np.float32,
    structure=None,
    impl: str = "auto",
    device="cuda",
) -> SweepResult:
    """Batched solve over B variants sharing one sparsity + base operator.

    impl: "auto" | "stencil" (grid + shared multigrid -- compile_sweep) |
    "amg" (arbitrary meshes, shared AMG hierarchy --
    compile_unstructured_sweep) | "lanes" (DIA block-Jacobi on the mesh as
    given) | "vmap" (block-ELL block-Jacobi, any mesh; `structure`, an
    EllStructure, when given). As in the JAX package, "auto" takes the
    stencil lanes on every coarsenable canonical grid (with the caller's
    iteration budget), the AMG lanes on a mesh without a grid at AMG scale
    (budget capped at 40; a mesh still band-hostile after renumbering
    falls through), then the DIA lanes where the mesh as given has at most
    48 band offsets, else the vmap route."""
    from ..fem.dia import build_dia_structure
    from ..utils.logging import log

    if impl not in ("auto", "amg", "stencil", "lanes", "vmap"):
        raise InputError(f"unknown sweep impl '{impl}' (auto | amg | stencil | lanes | vmap)")
    if impl == "stencil" and mesh.grid_shape is None:
        raise SolverError("mesh has no grid_shape; stencil sweep unavailable")
    structured = _grid_sweep_applies(mesh)
    if impl == "stencil" or (impl == "auto" and structured):
        if not structured:
            raise SolverError("mesh is not a coarsenable canonical grid; stencil sweep unavailable")
        return _sweep_stencil_lanes(
            mesh, base_bca, metadata, u_values, f_values, k_scales, iterations, dtype, device
        )
    if impl == "amg" or (
        impl == "auto" and mesh.grid_shape is None
        and mesh.num_nodes >= _amg_sweep_min_nodes()
    ):
        amg_iters = iterations if impl == "amg" else min(int(iterations), 40)
        if amg_iters != iterations:
            log(
                "info: sweep auto-selected AMG lanes; translating the iteration "
                f"budget {iterations} -> {amg_iters} AMG iterations (pass "
                "impl='amg' to run the budget verbatim; check "
                "result.residual_norm for per-lane quality)"
            )
        # auto must not run out of memory: refined mode (f64 CG over the f32
        # V-cycle) doubles the [2, N, B] lane state; estimate it (~8 live
        # state vectors) against the card's memory and drop to f32 CG when it
        # would not fit
        refined = None
        dev = resolve_device(device)
        if impl == "auto" and np.dtype(dtype) == np.float32 and dev.type == "cuda":
            b_lanes = int(np.asarray(k_scales).shape[0])
            est_f64 = 8 * 2 * mesh.num_nodes * max(b_lanes, 1) * 8
            budget = torch.cuda.mem_get_info(dev)[1]
            if est_f64 > 0.6 * budget:
                refined = False
                log(
                    "info: sweep AMG lanes: f64 refined CG state "
                    f"(~{est_f64 / 1e9:.1f} GB for {b_lanes} lanes) exceeds the "
                    "device memory budget; running f32 CG (residuals floor near "
                    "the f32 wall ~6e-6 relative)"
                )
        try:
            compiled = compile_unstructured_sweep(
                mesh, base_bca, metadata, amg_iters, dtype, refined=refined, device=dev
            )
        except SolverError:
            if impl == "amg":
                raise
        else:
            return compiled.solve(u_values, f_values, k_scales)
    if impl in ("auto", "lanes"):
        dia = build_dia_structure(mesh.tris, mesh.num_nodes)
        if dia is not None:
            return _sweep_lanes(
                mesh, base_bca, metadata, u_values, f_values, k_scales, iterations, dtype, dia,
                device,
            )
        if impl == "lanes":
            raise SolverError("mesh is not DIA-compatible; lanes sweep unavailable")
    return _sweep_vmap(
        mesh, base_bca, metadata, u_values, f_values, k_scales, iterations, dtype, structure,
        device,
    )


def _grid_sweep_applies(mesh: Mesh) -> bool:
    """Would the JAX package route this mesh to its structured-grid sweep?"""
    if mesh.grid_shape is None:
        return False
    from ..fem.multigrid import can_coarsen
    from ..fem.stencil import build_stencil_structure

    rows, cols = mesh.grid_shape
    grid_ok = mesh.grid_local or (
        build_stencil_structure(mesh.tris, rows, cols, mesh.wrap_cols) is not None
    )
    return bool(grid_ok and mesh.canonical_grid and can_coarsen(rows, cols, mesh.wrap_cols))


# ------------------- unstructured material sweeps (K8) ----------------------


def material_weights(e_moduli, poisson_ratios, thicknesses):
    """Per-lane basis weights (wa, wb, wc), each [B]."""
    wa = thicknesses * e_moduli / (1.0 - poisson_ratios * poisson_ratios)
    return wa, wa * poisson_ratios, wa * (1.0 - poisson_ratios) / 2.0


def _basis_bands(mesh, dia, dcoef) -> torch.Tensor:
    """DIA bands [D, 2, 2, N] (f64, host) of one unit D-basis (d0, d1, d2)
    = dcoef at t = 1: the closed-form pair blocks scattered into the band
    slots of `dia`."""
    from ..fem.amg import pair_block_fields, scatter_pair_blocks

    n = mesh.num_nodes
    fields = pair_block_fields(
        np.asarray(mesh.coords, np.float64), np.asarray(mesh.tris), 1.0,
        np.ones((n, 2)), *dcoef,
    )
    flat = scatter_pair_blocks(fields, dia.slot_ids, dia.n_diags * n)
    return _bands_from_flat(flat, dia.n_diags, n)


def _lane_inv3_apply(d, r):
    """Per-lane guarded 3x3 solve: d [n,3,3,B], r [n,3,B] -> d^-1 r.

    Closed-form adjugate (inverse = cof^T / det); rows whose det is tiny
    relative to the block scale solve to 0 (degenerate aggregates), the
    _guarded_inverse semantics carried per lane."""
    c00 = d[:, 1, 1] * d[:, 2, 2] - d[:, 1, 2] * d[:, 2, 1]
    c01 = d[:, 1, 2] * d[:, 2, 0] - d[:, 1, 0] * d[:, 2, 2]
    c02 = d[:, 1, 0] * d[:, 2, 1] - d[:, 1, 1] * d[:, 2, 0]
    c10 = d[:, 0, 2] * d[:, 2, 1] - d[:, 0, 1] * d[:, 2, 2]
    c11 = d[:, 0, 0] * d[:, 2, 2] - d[:, 0, 2] * d[:, 2, 0]
    c12 = d[:, 0, 1] * d[:, 2, 0] - d[:, 0, 0] * d[:, 2, 1]
    c20 = d[:, 0, 1] * d[:, 1, 2] - d[:, 0, 2] * d[:, 1, 1]
    c21 = d[:, 0, 2] * d[:, 1, 0] - d[:, 0, 0] * d[:, 1, 2]
    c22 = d[:, 0, 0] * d[:, 1, 1] - d[:, 0, 1] * d[:, 1, 0]
    det = d[:, 0, 0] * c00 + d[:, 0, 1] * c01 + d[:, 0, 2] * c02
    scale = torch.amax(torch.abs(d), dim=(1, 2))
    bad = torch.abs(det) <= 1e-12 * torch.clamp(scale, min=1e-30) ** 3
    safe = torch.where(bad, torch.ones_like(det), det)
    x0 = (c00 * r[:, 0] + c01 * r[:, 1] + c02 * r[:, 2]) / safe
    x1 = (c10 * r[:, 0] + c11 * r[:, 1] + c12 * r[:, 2]) / safe
    x2 = (c20 * r[:, 0] + c21 * r[:, 1] + c22 * r[:, 2]) / safe
    zero = torch.zeros_like(x0)
    x0 = torch.where(bad, zero, x0)
    x1 = torch.where(bad, zero, x1)
    x2 = torch.where(bad, zero, x2)
    return torch.stack([x0, x1, x2], dim=1)


def _material_amg_vcycle(mamg, op0, jac0, wa, wb, wc, *, sweeps: int = 1):
    """V(sweeps, sweeps)-cycle over the basis hierarchy, exact per lane.

    mamg: (transfers, coarse) from fem.amg.material_amg_device_arrays.
    op0 / jac0: the lane-weighted level-0 operator and diagonal-inverse
    apply in the [2, N, B] band layout. wa / wb / wc [B] in the hierarchy's
    dtype. Every level's operator and diagonal is combined per lane on the
    fly; the coarsest level smooths (its dense inverse would depend on the
    material)."""
    transfers, coarse = mamg
    n_coarse = len(coarse)

    def mv(l, x):  # x [n, m, B]
        a_cols, (av_a, av_b, av_c), _ = coarse[l]
        xg = x[a_cols]  # [n, w, m, B] -- ONE gather feeds all three bases
        with ieee_f32():
            ya = torch.einsum("nwij,nwjb->nib", av_a, xg)
            yb = torch.einsum("nwij,nwjb->nib", av_b, xg)
            yc = torch.einsum("nwij,nwjb->nib", av_c, xg)
        return ya * wa + yb * wb + yc * wc

    def dinv(l, r):  # r [n, 3, B]
        _, _, (d_a, d_b, d_c) = coarse[l]
        d = d_a[..., None] * wa + d_b[..., None] * wb + d_c[..., None] * wc
        return _lane_inv3_apply(d, r)

    def cycle(l, r):
        if l == n_coarse - 1:
            e = torch.zeros_like(r)
            for _ in range(COARSE_SWEEPS):
                e = e + OMEGA * dinv(l, r - mv(l, e))
            return e
        e = OMEGA * dinv(l, r)
        for _ in range(sweeps - 1):
            e = e + OMEGA * dinv(l, r - mv(l, e))
        res = r - mv(l, e)
        tp_cols, tp_vals, tpt_cols, tpt_vals = transfers[l + 1]
        ec = cycle(l + 1, _block_ell_matvec(tpt_cols, tpt_vals, res))
        e = e + _block_ell_matvec(tp_cols, tp_vals, ec)
        for _ in range(sweeps):
            e = e + OMEGA * dinv(l, r - mv(l, e))
        return e

    def apply(r):  # r [2, N, B]
        e = OMEGA * jac0(r)
        if not transfers:
            return e
        for _ in range(sweeps - 1):
            e = e + OMEGA * jac0(r - op0(e))
        res = (r - op0(e)).transpose(0, 1)  # [N, 2, B]
        p_cols, p_vals, pt_cols, pt_vals = transfers[0]
        ec = cycle(0, _block_ell_matvec(pt_cols, pt_vals, res))
        e = e + _block_ell_matvec(p_cols, p_vals, ec).transpose(0, 1)
        for _ in range(sweeps):
            e = e + OMEGA * jac0(r - op0(e))
        return e

    return apply


def _material_dia_amg_lanes_core(
    bands3, bands3_sm, offsets, offsets_dev, mamg, b_mat, free, u_fixed,
    f_applied, e_mods, nus, ts, tris, iterations, amg_sweeps=0,
):
    cgt, smt = bands3[0].dtype, bands3_sm[0].dtype
    u_fixed = u_fixed.permute(2, 1, 0).to(cgt).contiguous()  # [2, N, B]
    f_applied = f_applied.permute(2, 1, 0).to(cgt).contiguous()
    free_b = free.to(cgt)[:, :, None]
    free_sm = free.to(smt)[:, :, None]
    wa, wb, wc = material_weights(e_mods.to(cgt), nus.to(cgt), ts.to(cgt))
    w_sm = tuple(w.to(smt) for w in (wa, wb, wc))

    def weighted_mv(b3, w3, u):
        return lane_dia_matvec3(b3, w3, offsets, u, offsets_dev)

    def op(v):
        y = weighted_mv(bands3, (wa, wb, wc), free_b * v)
        return free_b * y + (1.0 - free_b) * v

    def op_sm(v):
        y = weighted_mv(bands3_sm, w_sm, free_sm * v)
        return free_sm * y + (1.0 - free_sm) * v

    # level-0 per-lane reduced diagonal (V-cycle dtype): basis diagonals
    # combined by lane weights, BC-reduced, 2x2 Cramer per (node, lane)
    zero_idx = offsets.index(0)
    d3 = tuple(b[zero_idx] for b in bands3_sm)  # 3 x [2, 2, N]
    dd = reduce_diag_blocks(
        d3[0][..., None] * w_sm[0] + d3[1][..., None] * w_sm[1]
        + d3[2][..., None] * w_sm[2],
        free_sm,  # [2, N, 1] broadcasts over the lane axis
    )

    def jac0(r):
        return solve2(dd, r)

    vcycle = _material_amg_vcycle(
        mamg, op_sm, jac0, *w_sm, sweeps=amg_sweep_schedule(False, amg_sweeps)
    )

    def precond(r):
        nrm = torch.sqrt(_lane_dot(r, r))  # [B]
        safe = torch.where(nrm == 0, torch.ones_like(nrm), nrm)
        return vcycle((r / safe).to(smt)).to(cgt) * safe

    rhs = (
        free_b * (f_applied - weighted_mv(bands3, (wa, wb, wc), u_fixed))
        + (1.0 - free_b) * u_fixed
    )
    result = pcg_fixed_iterations(
        op, rhs, preconditioner=precond, x0=u_fixed, iterations=iterations,
        dot=_lane_dot,
    )
    u = result.x  # [2, N, B]

    # per-lane stress: sigma = D(E_b, nu_b) B u_b (thickness cancels)
    t_cg = ts.to(cgt)
    sa, sb, sc = wa / t_cg, wb / t_cg, wc / t_cg

    def sigma_fn(strain):  # [C, 3, B]
        s0 = sa * strain[:, 0] + sb * strain[:, 1]
        s1 = sb * strain[:, 0] + sa * strain[:, 1]
        s2 = sc * strain[:, 2]
        return s0, s1, s2

    vm = _chunked_lane_vm(u, tris, b_mat, sigma_fn)
    return (
        u.permute(2, 1, 0),
        result.residual_norm,
        vm.T,
        torch.sqrt(_lane_dot(rhs, rhs)),
    )


@dataclass
class CompiledUnstructuredMaterialSweep:
    """An arbitrary mesh compiled for (E, nu, t)-per-lane sweeps."""

    bands3: tuple  # 3 x [D, 2, 2, N] basis band sets, CG precision
    bands3_sm: tuple  # V-cycle copies (the same tuple when not refined)
    offsets: tuple
    offsets_dev: torch.Tensor  # int32 copy of `offsets` for the kernels
    mamg: tuple
    b_mat: torch.Tensor
    free: torch.Tensor
    tris: torch.Tensor
    perm: object
    iterations: int
    dtype: torch.dtype
    material_setup: object
    n_nodes: int
    device: torch.device
    amg_sweeps: int = 0
    perm_dev: Optional[torch.Tensor] = None
    iperm_dev: Optional[torch.Tensor] = None
    u_base: Optional[torch.Tensor] = None
    f_base: Optional[torch.Tensor] = None
    # lane sharding: the mesh, and the replicas per device (_replica)
    device_mesh: object = None
    replicas: dict = field(default_factory=dict, repr=False)

    def _batch(self, arr) -> torch.Tensor:
        return _batch_on(arr, self.dtype, self.device)

    def _run(self, u_fixed, f_applied, e_moduli, poisson_ratios, thicknesses):
        u, res, vm, rhs_norm = _material_dia_amg_lanes_core(
            self.bands3, self.bands3_sm, self.offsets, self.offsets_dev, self.mamg,
            self.b_mat, self.free, u_fixed, f_applied, self._batch(e_moduli),
            self._batch(poisson_ratios), self._batch(thicknesses), self.tris,
            self.iterations, self.amg_sweeps,
        )
        u = _perm_nodes(u, self.iperm_dev) if self.iperm_dev is not None else u.contiguous()
        return SweepResult(u=u, residual_norm=res, von_mises=vm, rhs_norm=rhs_norm)

    def solve_factors(
        self, u_factors, f_factors, e_moduli, poisson_ratios, thicknesses
    ) -> SweepResult:
        """Load-factor material sweep: per-lane (E, nu, t) plus per-lane
        scalings of the compile-time BC values, built on the device."""
        if self.device_mesh is not None:
            return _over_lanes(self, "solve_factors", u_factors, f_factors, e_moduli,
                               poisson_ratios, thicknesses)
        u_fixed, f_applied = _factor_fields(
            self.u_base, self.f_base, self._batch(u_factors), self._batch(f_factors)
        )
        return self._run(u_fixed, f_applied, e_moduli, poisson_ratios, thicknesses)

    def solve(
        self, u_values, f_values, e_moduli, poisson_ratios, thicknesses
    ) -> SweepResult:
        if self.device_mesh is not None:
            return _over_lanes(self, "solve", u_values, f_values, e_moduli, poisson_ratios,
                               thicknesses)
        up, fp = self._batch(u_values), self._batch(f_values)
        if self.perm_dev is not None:
            up, fp = _perm_nodes(up, self.perm_dev), _perm_nodes(fp, self.perm_dev)
        return self._run(up, fp, e_moduli, poisson_ratios, thicknesses)


def compile_unstructured_material_sweep(
    mesh: Mesh,
    base_bca: BCArrays,
    iterations: int = 35,
    dtype=np.float32,
    nu_ref: float = 0.3,
    cell_factor: float = 3.0,
    max_diags: int = 96,
    refined=None,
    device_mesh=None,
    amg_sweeps: int = 0,
    lane_kernel: str = "auto",
    device="cuda",
    material_setup=None,
) -> CompiledUnstructuredMaterialSweep:
    """Compile an arbitrary mesh for TRUE material sweeps on `device`.

    Three basis DIA band sets + the basis AMG hierarchy
    (fem/amg.build_amg_material_setup) give every lane the exact V-cycle
    of its own (E, nu, t) operator; transfers are built once at `nu_ref`.
    Band-hostile meshes renumber first; raises SolverError when the mesh
    stays band-hostile. `refined`, `amg_sweeps`, `lane_kernel` and
    `device_mesh` as in compile_unstructured_sweep. `material_setup`: a basis hierarchy built
    before for THIS mesh (either package's, interop.
    material_setup_from_arrays); one whose fingerprint does not match is
    rebuilt."""
    from .. import native
    from ..fem.amg import (
        _UNIT_DCOEFS,
        build_amg_material_setup,
        material_amg_device_arrays,
        setup_fingerprint,
    )

    dev = _compile_device(device_mesh, device)
    _check_common(lane_kernel, dev)
    native.require()
    user_t, cg_t = _dtypes(dtype, refined)
    sm_t = user_t
    n = mesh.num_nodes
    mesh, bca, dia, perm = _banded_mesh_or_raise(
        mesh, base_bca, max_diags, "per-variant solve_system"
    )
    free_np = (~bca.u_known).astype(np.float64)
    if material_setup is None or material_setup.fingerprint != setup_fingerprint(
        mesh.coords, mesh.tris, free_np, 0.0, float(nu_ref), 1.0, float(cell_factor)
    ):
        material_setup = build_amg_material_setup(
            mesh.coords, mesh.tris, free_np, nu_ref=nu_ref, cell_factor=cell_factor,
        )
    mamg = material_amg_device_arrays(material_setup, sm_t, dev)

    bands64 = tuple(_basis_bands(mesh, dia, dc).to(dev) for dc in _UNIT_DCOEFS)
    bands3 = tuple(b.to(cg_t) for b in bands64)
    bands3_sm = bands3 if cg_t == sm_t else tuple(b.to(sm_t) for b in bands64)
    tris, b_mat = _element_arrays(mesh, sm_t, dev)
    offsets = tuple(int(o) for o in dia.offsets)
    perm_dev, iperm_dev = _perm_arrays(perm, dev)
    return CompiledUnstructuredMaterialSweep(
        bands3=bands3,
        bands3_sm=bands3_sm,
        offsets=offsets,
        offsets_dev=offsets_tensor(offsets, dev),
        mamg=mamg,
        b_mat=b_mat,
        free=torch.from_numpy((~bca.u_known).T.astype(np.float64)).to(dev, sm_t),
        tris=tris,
        perm=perm,
        iterations=int(iterations),
        dtype=user_t,
        material_setup=material_setup,
        n_nodes=n,
        device=dev,
        amg_sweeps=int(amg_sweeps),
        perm_dev=perm_dev,
        iperm_dev=iperm_dev,
        u_base=torch.from_numpy(np.asarray(bca.u_value, np.float64)).to(dev, user_t),
        f_base=torch.from_numpy(np.asarray(bca.f_value, np.float64)).to(dev, user_t),
        device_mesh=device_mesh,
    )


# ------------------- structured-grid lanes (stencil + MG) -------------------
#
# Canonical generator grids: fields [2, R, C, B], the stencil operator
# applied by the lane stencil kernel, and ONE geometric-multigrid hierarchy
# shared by every lane. The V-cycles follow the JAX package's
# (_lane_vcycle / _lane_material_vcycle): V(2, 2) damped block-Jacobi,
# omega = 0.7, a dense inverse on a small coarsest level, else 48 sweeps
# there. The first sweep of a smoothing run starts from e = 0, where
# K e = 0: it is applied as e = omega * D^-1 r without the matvec, which
# gives the same values as the JAX package's sweep from zero.


class _LaneLevel(NamedTuple):
    """One level of the shared hierarchy."""

    stencil: torch.Tensor  # [9, 2, 2, R, C] BC-reduced (or packed, _pack_load_setup)
    diag_inv: torch.Tensor  # [2, 2, R, C]
    dense_inv: Optional[torch.Tensor] = None  # [2RC, 2RC] node-major, coarsest only


def _lane_prolong(uc: torch.Tensor, wrap: bool) -> torch.Tensor:
    """Bilinear coarse -> fine on [..., Rc, Cc, B] (lane-batched
    fem/multigrid.prolong: col axis -2, row axis -3)."""
    if wrap:
        mid = 0.5 * (uc + torch.roll(uc, -1, dims=-2))
        x = torch.stack([uc, mid], dim=-2).reshape(*uc.shape[:-2], -1, uc.shape[-1])
    else:
        a = uc[..., :-1, :]
        mid = 0.5 * (uc[..., :-1, :] + uc[..., 1:, :])
        body = torch.stack([a, mid], dim=-2).reshape(
            *uc.shape[:-3], uc.shape[-3], -1, uc.shape[-1]
        )
        x = torch.cat([body, uc[..., -1:, :]], dim=-2)
    a = x[..., :-1, :, :]
    mid = 0.5 * (x[..., :-1, :, :] + x[..., 1:, :, :])
    body = torch.stack([a, mid], dim=-3).reshape(*x.shape[:-3], -1, x.shape[-2], x.shape[-1])
    return torch.cat([body, x[..., -1:, :, :]], dim=-3)


def _lane_restrict(rf: torch.Tensor, wrap: bool) -> torch.Tensor:
    """Exact adjoint of _lane_prolong, fine -> coarse on [..., R, C, B]."""
    even = rf[..., ::2, :, :]
    odd = rf[..., 1::2, :, :]
    up = F.pad(odd, (0, 0, 0, 0, 1, 0))[..., : even.shape[-3], :, :]
    down = F.pad(odd, (0, 0, 0, 0, 0, 1))[..., : even.shape[-3], :, :]
    x = even + 0.5 * (up + down)
    even = x[..., ::2, :]
    odd = x[..., 1::2, :]
    if wrap:
        left = torch.roll(odd, 1, dims=-2)
        return even + 0.5 * (odd + left)
    up = F.pad(odd, (0, 0, 1, 0))[..., : even.shape[-2], :]
    down = F.pad(odd, (0, 0, 0, 1))[..., : even.shape[-2], :]
    return even + 0.5 * (up + down)


def _lane_dense_coarse(dense_inv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Exact coarse solve for all lanes at once: one matrix product
    [2RC, 2RC] x [2RC, B] (node-major flattening)."""
    _, rows, cols, b = r.shape
    r_flat = r.permute(1, 2, 0, 3).reshape(rows * cols * 2, b)
    with ieee_f32():
        e = torch.matmul(dense_inv, r_flat)
    return e.reshape(rows, cols, 2, b).permute(2, 0, 1, 3)


def _lane_vcycle(levels, wrap: bool, pre: int = 2, post: int = 2,
                 coarse_sweeps: int = MG_COARSE_SWEEPS, omega: float = MG_OMEGA):
    """V-cycle over lane fields sharing ONE hierarchy: the variants differ
    only by the scale s_b, and V(s_b K) = (1/s_b) V(K) exactly. The coarsest
    level solves exactly through its dense inverse when it has one."""

    def smooth(level, e, r, sweeps):
        for _ in range(sweeps):
            res = r if e is None else r - lane_stencil_matvec(level.stencil, e, wrap)
            step = omega * apply_blocks(level.diag_inv[..., None], res)
            e = step if e is None else e + step
        return e

    def cycle(l, r):
        level = levels[l]
        if l == len(levels) - 1:
            if level.dense_inv is not None:
                return _lane_dense_coarse(level.dense_inv, r)
            return smooth(level, None, r, coarse_sweeps)
        e = smooth(level, None, r, pre)
        res = r - lane_stencil_matvec(level.stencil, e, wrap)
        ec = cycle(l + 1, _lane_restrict(res, wrap))
        e = e + _lane_prolong(ec, wrap)
        return smooth(level, e, r, post)

    return lambda r: cycle(0, r)


def _lane_grid_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane inner product on [2, R, C, B] -> [B]."""
    return torch.sum(a * b, dim=(0, 1, 2))


def _grid_mesh_or_raise(mesh: Mesh, what: str):
    if mesh.grid_shape is None or not mesh.canonical_grid:
        raise SolverError(f"{what} needs a canonical grid mesh")
    rows, cols = mesh.grid_shape
    return int(rows), int(cols), bool(mesh.wrap_cols)


def _grid_arrays(mesh, base_bca, rows, cols, dev):
    """(coords [N, 2], tris [E, 3] int64, free_g [2, R, C]) on dev; f64."""
    from ..fem.solve import _grid

    coords = torch.from_numpy(np.asarray(mesh.coords, np.float64)).to(dev)
    tris = torch.from_numpy(np.asarray(mesh.tris, np.int64)).to(dev)
    free = torch.from_numpy((~np.asarray(base_bca.u_known)).astype(np.float64)).to(dev)
    return coords, tris, _grid(free, rows, cols)


def _setup_to(setup, dtype, dev, rows: int, cols: int, what: str):
    """A setup tuple (tensors, nested tuples, None) on `dev` in `dtype`,
    checked against the mesh's grid."""
    first = setup[0]
    while isinstance(first, tuple):
        first = first[0]
    if tuple(first.shape[-2:]) != (rows, cols):
        raise InputError(
            f"{what} setup is for a {tuple(first.shape[-2:])} grid, the mesh is {(rows, cols)}"
        )

    def conv(x):
        if x is None:
            return None
        if isinstance(x, tuple):
            return type(x)(*(conv(v) for v in x)) if hasattr(x, "_fields") else tuple(
                conv(v) for v in x)
        return torch.as_tensor(x).to(dev, dtype)

    return conv(tuple(setup))


def _stencil_sweep_setup(coords, tris, free_g, e_mod, nu, t, rows, cols, wrap):
    """One-time per-mesh work, in the dtype of `coords`: assembly, BC
    reduction, the multigrid hierarchy (with the dense coarse inverse) and
    the stress-recovery matrices -> (raw, reduced, levels, b_mat, d_mat)."""
    from ..fem.element import (
        element_areas, gather_element_coords, strain_displacement_matrices,
        stress_strain_matrix,
    )
    from ..fem.multigrid import build_hierarchy
    from ..fem.solve import _reduce_stencil
    from ..fem.stencil import assemble_stencil_structured

    raw = assemble_stencil_structured(coords, e_mod, nu, t, rows, cols, wrap)
    reduced = _reduce_stencil(raw, free_g, wrap)
    levels = tuple(
        _LaneLevel(lv.stencil, lv.diag_inv, lv.dense_inv) for lv in build_hierarchy(reduced, wrap)
    )
    ecoords = gather_element_coords(coords, tris)
    b_mat = strain_displacement_matrices(ecoords, element_areas(ecoords))
    d_mat = stress_strain_matrix(e_mod, nu, coords.dtype, coords.device)
    return raw, reduced, levels, b_mat, d_mat


def _lane_fields(values: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """[B, N, 2] -> [2, R, C, B] on the device."""
    return values.permute(2, 1, 0).reshape(2, rows, cols, values.shape[0])


def _pack_load_setup(setup) -> tuple:
    """The load setup's stencils packed for the lane stencil kernel: (raw,
    reduced, levels with packed stencils)."""
    raw, reduced, levels, _, _ = setup
    return (pack_lane_stencils(raw), pack_lane_stencils(reduced),
            tuple(lv._replace(stencil=pack_lane_stencils(lv.stencil)) for lv in levels))


def _stencil_lanes(setup, packed, tris, free_g, u_values, f_values, k_scales, rows, cols, wrap,
                   iterations):
    """The batched solve of CompiledSweep (the JAX package's
    _stencil_lanes_jit); `packed` = _pack_load_setup(setup)."""
    _, _, _, b_mat, d_mat = setup
    raw, reduced, levels = packed
    b = u_values.shape[0]
    u_fixed = _lane_fields(u_values, rows, cols)
    f_applied = _lane_fields(f_values, rows, cols)
    free_b = free_g[..., None]  # [2, R, C, 1]
    inv_scale = free_b / k_scales + (1.0 - free_b)

    def op(v):  # lanes of s_b * K_reduced
        y = lane_stencil_matvec(reduced, v, wrap)
        return free_b * y * k_scales + (1.0 - free_b) * v

    vcycle = _lane_vcycle(levels, wrap)

    def precond(r):  # V(s_b K)^-1 = (1/s_b) V(K)^-1, identity on fixed DOFs
        return vcycle(r) * inv_scale

    rhs = free_b * (f_applied - lane_stencil_matvec(raw, u_fixed, wrap) * k_scales) + (
        1.0 - free_b
    ) * u_fixed
    # residual_norm is the TRUE residual ||rhs - op(x)|| per lane, recomputed
    # with op after the last iteration (the recursion's r drifts below the
    # f32 floor and would over-report convergence)
    result = pcg_fixed_iterations(
        op, rhs, preconditioner=precond, x0=u_fixed, iterations=iterations, dot=_lane_grid_dot,
    )
    u_flat = result.x.reshape(2, rows * cols, b)

    vm = _lane_vm(u_flat, tris, b_mat, d_mat) * k_scales[None, :]  # scaled after the root
    return (
        u_flat.permute(2, 1, 0).contiguous(),  # [B, N, 2]
        result.residual_norm,
        vm.T,  # [B, E]
        torch.sqrt(_lane_grid_dot(rhs, rhs)),
    )


@dataclass
class CompiledSweep:
    """A canonical-grid mesh compiled for repeated design-sweep batches.

    Setup (assembly, BC reduction, the multigrid hierarchy with its dense
    coarse inverse, stress matrices) runs once and stays on `device`;
    `solve(u_values, f_values, k_scales)` runs only the batched CG. Results
    are tensors on `device`."""

    setup: tuple  # (raw, reduced, levels, b_mat, d_mat)
    packed: tuple  # _pack_load_setup(setup)
    tris: torch.Tensor
    free_g: torch.Tensor  # [2, R, C]
    rows: int
    cols: int
    wrap: bool
    iterations: int
    dtype: torch.dtype
    device: torch.device
    # lane sharding: the mesh, and the replicas per device (_replica)
    device_mesh: object = None
    replicas: dict = field(default_factory=dict, repr=False)

    def _batch(self, arr) -> torch.Tensor:
        return _batch_on(arr, self.dtype, self.device)

    def solve(self, u_values, f_values, k_scales) -> SweepResult:
        """u_values / f_values [B, N, 2] per-lane prescribed displacements and
        applied forces, k_scales [B] stiffness scales."""
        if self.device_mesh is not None:
            return _over_lanes(self, "solve", u_values, f_values, k_scales)
        u, res, vm, rhs_norm = _stencil_lanes(
            self.setup, self.packed, self.tris, self.free_g, self._batch(u_values),
            self._batch(f_values), self._batch(k_scales), self.rows, self.cols, self.wrap,
            self.iterations,
        )
        return SweepResult(u=u, residual_norm=res, von_mises=vm, rhs_norm=rhs_norm)


def compile_sweep(
    mesh: Mesh,
    base_bca: BCArrays,
    metadata: ModelMetadata,
    iterations: int = 20,
    dtype=np.float32,
    device_mesh=None,
    device="cuda",
    setup=None,
) -> CompiledSweep:
    """Build a CompiledSweep for a coarsenable canonical-grid mesh on
    `device` ("cuda" or "cpu", never chosen implicitly).

    The setup is computed in `dtype`, the precision of the whole batched
    solve, from the coordinates rounded to it (as the JAX package does).
    `setup`: one built before for THIS mesh (either package's,
    interop.stencil_sweep_setup_from_arrays), used instead. `device_mesh`
    shards the lanes, as in compile_unstructured_sweep."""
    from ..fem.multigrid import can_coarsen

    dev = _compile_device(device_mesh, device)
    user_t = _dtypes(dtype, False)[0]
    rows, cols, wrap = _grid_mesh_or_raise(mesh, "compile_sweep")
    if not can_coarsen(rows, cols, wrap):
        raise SolverError("grid cannot coarsen; use sweep_solve's DIA path")
    coords, tris, free_g = _grid_arrays(mesh, base_bca, rows, cols, dev)
    free_g = free_g.to(user_t)
    if setup is None:
        setup = _stencil_sweep_setup(
            coords.to(user_t), tris, free_g, float(metadata.youngs_modulus),
            float(metadata.poisson_ratio), float(metadata.part_thickness), rows, cols, wrap,
        )
    setup = _setup_to(setup, user_t, dev, rows, cols, "compile_sweep")
    return CompiledSweep(
        setup=setup,
        packed=_pack_load_setup(setup),
        tris=tris,
        free_g=free_g,
        rows=rows,
        cols=cols,
        wrap=wrap,
        iterations=int(iterations),
        dtype=user_t,
        device=dev,
        device_mesh=device_mesh,
    )


def _sweep_stencil_lanes(
    mesh, base_bca, metadata, u_values, f_values, k_scales, iterations, dtype, device
):
    """Lane-batched sweep on the stencil operator with a SHARED multigrid
    hierarchy: one V-cycle preconditions every variant at once."""
    compiled = compile_sweep(mesh, base_bca, metadata, iterations, dtype, device=device)
    return compiled.solve(u_values, f_values, k_scales)


# ------------------- structured-grid material sweeps (E, nu, t) -------------
#
# Three basis stencils (unit d0 / d1 / d2, t = 1) assembled once span every
# material; Galerkin coarsening is linear in the operator, so the hierarchy
# carries the decomposition down every level -- one 4-stencil hierarchy (3
# masked material bases + the fixed-DOF identity part) gives every lane its
# EXACT coarse operators.


class _MaterialLevel(NamedTuple):
    """One hierarchy level: masked material bases + fixed-DOF identity."""

    sa: torch.Tensor  # [9, 2, 2, R, C]
    sb: torch.Tensor
    sc: torch.Tensor
    sfix: torch.Tensor


def _mask_stencil(raw: torch.Tensor, free_g: torch.Tensor, wrap: bool) -> torch.Tensor:
    """BC mask WITHOUT the fixed-DOF identity (that part is lane-invariant
    and lives in its own stencil, so lane scaling stays exact)."""
    from ..fem.stencil import OFFSETS, shift2d

    out = []
    for s, (dr, dt) in enumerate(OFFSETS):
        fin = shift2d(free_g, dr, dt, wrap)
        out.append(raw[s] * free_g[:, None] * fin[None, :])
    return torch.stack(out)


def _fixed_identity_stencil(free_g: torch.Tensor) -> torch.Tensor:
    from ..fem.stencil import CENTER

    _, rows, cols = free_g.shape
    sfix = torch.zeros((9, 2, 2, rows, cols), dtype=free_g.dtype, device=free_g.device)
    sfix[CENTER, 0, 0] = 1.0 - free_g[0]
    sfix[CENTER, 1, 1] = 1.0 - free_g[1]
    return sfix


def _material_sweep_setup(coords, tris, free_g, rows, cols, wrap):
    """One-time per-mesh work, in the dtype of `coords`: 3 raw + 4 masked
    basis stencils, the 4-stencil Galerkin hierarchy (probed through the
    plain stencil matvec) and the B matrices -> (basis_raw, levels, b_mat)."""
    from ..fem.amg import _UNIT_DCOEFS
    from ..fem.element import element_areas, gather_element_coords, strain_displacement_matrices
    from ..fem.multigrid import can_coarsen, coarse_shape, galerkin_coarse_stencil
    from ..fem.stencil import assemble_stencil_structured, stencil_matvec_plain

    basis_raw = tuple(
        assemble_stencil_structured(coords, 0.0, 0.0, 1.0, rows, cols, wrap, dcoefs=dc)
        for dc in _UNIT_DCOEFS
    )
    levels = [_MaterialLevel(*(_mask_stencil(raw, free_g, wrap) for raw in basis_raw),
                             _fixed_identity_stencil(free_g))]
    r, c = rows, cols
    while can_coarsen(r, c, wrap):
        rc, cc = coarse_shape(r, c, wrap)
        levels.append(_MaterialLevel(*(
            galerkin_coarse_stencil(
                lambda v, st=st: stencil_matvec_plain(st, v, wrap), rc, cc, wrap,
                coords.dtype, coords.device,
            )
            for st in levels[-1]
        )))
        r, c = rc, cc
    ecoords = gather_element_coords(coords, tris)
    b_mat = strain_displacement_matrices(ecoords, element_areas(ecoords))
    return basis_raw, tuple(levels), b_mat


def _pack_material_setup(setup) -> tuple:
    """The material setup's stencils packed for the lane stencil kernels:
    (the three raw bases, one packed 4-stencil set per level)."""
    basis_raw, levels, _ = setup
    return (tuple(pack_lane_stencils(st) for st in basis_raw),
            tuple(pack_lane_stencils(lv) for lv in levels))


def _lane_material_matvec(level, wa, wb, wc, u, wrap):
    """Per-lane y = K(w) u on [2, R, C, B] lane fields (the S = 3 kernel);
    level a _MaterialLevel or its packed stencils."""
    return lane_stencil_matvec3(level, (wa, wb, wc), u, wrap)


def _lane_material_center_inv(level: _MaterialLevel, wa, wb, wc) -> torch.Tensor:
    """Per-lane inverse center blocks [2, 2, R, C, B] (built once per batch;
    det = 0 -> 1, as the JAX package guards it)."""
    from ..fem.stencil import CENTER

    return guarded_inv2(
        level.sa[CENTER][..., None] * wa + level.sb[CENTER][..., None] * wb
        + level.sc[CENTER][..., None] * wc + level.sfix[CENTER][..., None]
    )


def _lane_material_vcycle(levels, dinvs, wa, wb, wc, wrap, pre: int = 2, post: int = 2,
                          coarse_sweeps: int = MG_COARSE_SWEEPS, omega: float = MG_OMEGA):
    """Lane V-cycle with EXACT per-lane operators at every level (the basis
    decomposition survives Galerkin coarsening); the coarsest level smooths
    (its dense inverse would depend on the material), `coarse_sweeps`
    sweeps in one lane_coarse_smooth3 call. `levels`: _MaterialLevels or
    their packed stencils."""

    def smooth(l, e, r, sweeps):
        for _ in range(sweeps):
            res = r if e is None else r - _lane_material_matvec(levels[l], wa, wb, wc, e, wrap)
            step = omega * apply_blocks(dinvs[l], res)
            e = step if e is None else e + step
        return e

    def cycle(l, r):
        if l == len(levels) - 1:
            return lane_coarse_smooth3(levels[l], dinvs[l], (wa, wb, wc), r, wrap,
                                       coarse_sweeps, omega)
        e = smooth(l, None, r, pre)
        res = r - _lane_material_matvec(levels[l], wa, wb, wc, e, wrap)
        ec = cycle(l + 1, _lane_restrict(res, wrap))
        e = e + _lane_prolong(ec, wrap)
        return smooth(l, e, r, post)

    return lambda r: cycle(0, r)


def _material_lanes(setup, packed, tris, free_g, u_values, f_values, e_moduli, poisson_ratios,
                    thicknesses, rows, cols, wrap, iterations):
    """The batched solve of CompiledMaterialSweep (the JAX package's
    _material_lanes_jit); `packed` = _pack_material_setup(setup)."""
    _, levels, b_mat = setup
    basis_raw, packed_levels = packed
    wa, wb, wc = material_weights(e_moduli, poisson_ratios, thicknesses)
    b = u_values.shape[0]
    u_fixed = _lane_fields(u_values, rows, cols)
    f_applied = _lane_fields(f_values, rows, cols)
    free_b = free_g[..., None]

    # per-level per-lane center inverses, built once per batch
    dinvs = tuple(_lane_material_center_inv(lv, wa, wb, wc) for lv in levels)

    def op(v):  # masked bases + fixed identity = the reduced operator
        return _lane_material_matvec(packed_levels[0], wa, wb, wc, v, wrap)

    def raw_mv(v):
        ya, yb, yc = (lane_stencil_matvec(st, v, wrap) for st in basis_raw)
        return ya * wa + yb * wb + yc * wc

    precond = _lane_material_vcycle(packed_levels, dinvs, wa, wb, wc, wrap)
    rhs = free_b * (f_applied - raw_mv(u_fixed)) + (1.0 - free_b) * u_fixed
    result = pcg_fixed_iterations(
        op, rhs, preconditioner=precond, x0=u_fixed, iterations=iterations, dot=_lane_grid_dot,
    )
    u_flat = result.x.reshape(2, rows * cols, b)

    # per-lane stress: sigma = D(E_b, nu_b) B u_b (thickness-free)
    d0 = e_moduli / (1.0 - poisson_ratios * poisson_ratios)
    d1 = d0 * poisson_ratios
    d2 = d0 * (1.0 - poisson_ratios) / 2.0

    def sigma_fn(strain):  # [C, 3, B]
        return (d0 * strain[:, 0] + d1 * strain[:, 1], d1 * strain[:, 0] + d0 * strain[:, 1],
                d2 * strain[:, 2])

    vm = _chunked_lane_vm(u_flat, tris, b_mat, sigma_fn)
    return (
        u_flat.permute(2, 1, 0).contiguous(),
        result.residual_norm,
        vm.T,
        torch.sqrt(_lane_grid_dot(rhs, rhs)),
    )


@dataclass
class CompiledMaterialSweep:
    """A canonical-grid mesh compiled for repeated (E, nu, t) material-sweep
    batches."""

    setup: tuple  # (basis_raw, levels, b_mat)
    packed: tuple  # _pack_material_setup(setup)
    tris: torch.Tensor
    free_g: torch.Tensor
    rows: int
    cols: int
    wrap: bool
    iterations: int
    dtype: torch.dtype
    device: torch.device
    # lane sharding: the mesh, and the replicas per device (_replica)
    device_mesh: object = None
    replicas: dict = field(default_factory=dict, repr=False)

    def _batch(self, arr) -> torch.Tensor:
        return _batch_on(arr, self.dtype, self.device)

    def solve(self, u_values, f_values, e_moduli, poisson_ratios, thicknesses) -> SweepResult:
        if self.device_mesh is not None:
            return _over_lanes(self, "solve", u_values, f_values, e_moduli, poisson_ratios,
                               thicknesses)
        u, res, vm, rhs_norm = _material_lanes(
            self.setup, self.packed, self.tris, self.free_g, self._batch(u_values),
            self._batch(f_values), self._batch(e_moduli), self._batch(poisson_ratios),
            self._batch(thicknesses), self.rows, self.cols, self.wrap, self.iterations,
        )
        return SweepResult(u=u, residual_norm=res, von_mises=vm, rhs_norm=rhs_norm)


def compile_material_sweep(
    mesh: Mesh,
    base_bca: BCArrays,
    iterations: int = 30,
    dtype=np.float32,
    device_mesh=None,
    device="cuda",
    setup=None,
) -> CompiledMaterialSweep:
    """Compile a canonical-grid mesh for true material sweeps on `device`.

    Every lane gets its own (E, nu, t): three basis stencils are assembled
    once and combined per lane with scalar weights, and the multigrid
    hierarchy carries the decomposition down exactly. The setup is computed
    in `dtype`, as compile_sweep's. Memory: the per-level per-lane center
    inverses are [2, 2, R, C, B] -- at 4096 lanes on a 33x65 grid ~140 MB in
    f32, shrinking 4x per level. `setup`: one built before for THIS mesh
    (interop.material_grid_sweep_setup_from_arrays), used instead.
    `device_mesh` shards the lanes, as in compile_unstructured_sweep."""
    dev = _compile_device(device_mesh, device)
    user_t = _dtypes(dtype, False)[0]
    rows, cols, wrap = _grid_mesh_or_raise(mesh, "compile_material_sweep")
    coords, tris, free_g = _grid_arrays(mesh, base_bca, rows, cols, dev)
    free_g = free_g.to(user_t)
    if setup is None:
        setup = _material_sweep_setup(coords.to(user_t), tris, free_g, rows, cols, wrap)
    setup = _setup_to(setup, user_t, dev, rows, cols, "compile_material_sweep")
    return CompiledMaterialSweep(
        setup=setup,
        packed=_pack_material_setup(setup),
        tris=tris,
        free_g=free_g,
        rows=rows,
        cols=cols,
        wrap=wrap,
        iterations=int(iterations),
        dtype=user_t,
        device=dev,
        device_mesh=device_mesh,
    )


def material_sweep_solve(
    mesh: Mesh,
    base_bca: BCArrays,
    u_values,  # [B, N, 2]
    f_values,  # [B, N, 2]
    e_moduli,  # [B] Young's modulus per variant
    poisson_ratios,  # [B]
    thicknesses,  # [B]
    iterations: int = 30,
    dtype=np.float32,
    device="cuda",
) -> SweepResult:
    """One-shot material sweep (see compile_material_sweep for serving)."""
    compiled = compile_material_sweep(mesh, base_bca, iterations, dtype, device=device)
    return compiled.solve(u_values, f_values, e_moduli, poisson_ratios, thicknesses)
