"""Row-sharded block-ELL solves over a device mesh, with an all-gather per
matvec (port of magnetite_tpu/parallel/sharding.py).

The rows of the block-ELL operator are split in contiguous blocks, one per
shard of the mesh's row axis, and the CG runs on `ShardVec`s (parallel/
dia_shard.py) with the sum over shards as its inner product. The only
communication per iteration is one all-gather of the displacement field
(each distinct device receives the whole [2, Np] field) and the scalar
sums of the CG's dots. A shard's matvec runs the ELL kernel
(`ell_matvec_t`, csrc/ell_matvec.cu) on the shard's rows, whose cols are
global node ids, against the whole gathered field: the kernel takes u
longer than its rows, so the shard's rows are never padded out to N.

Rows are padded to a multiple of the shard count with rows that only
reference themselves (zero blocks, free = 0), which the masked operator
treats as solved DOFs. Unlike the node-sharded DIA path this needs no band
structure, at the price of gathering the whole field every matvec.

One controller drives every shard; a mesh may repeat a device. The batch
solve takes a 2-D mesh (parallel.pipeline.DeviceMesh2D) whose axes shard
the lanes and the rows: each chunk of lanes runs one fixed-iteration PCG
on [2, nl, B] lane fields over its row of devices, every lane with its own
alpha and beta (the JAX package vmaps the lanes); its matvec is the lane
ELL kernel (`lane_ell_matvec`, csrc/lane_ell_matvec.cu) on the shard's rows
against the gathered lane fields.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..bc import BCArrays
from ..config import ModelMetadata
from ..errors import InputError
from ..fem.assembly import EllStructure, assemble_ell, build_ell_structure
from ..fem.blocks import apply_blocks, guarded_inv2, reduce_diag_blocks
from ..fem.cg import CGResult, pcg, pcg_fixed_iterations
from ..fem.operator import make_constrained_operator, reduced_rhs
from ..kernels.ell_kernel import ell_matvec_t
from ..kernels.lane_ell_kernel import lane_ell_matvec
from ..meshing.core import Mesh as FemMesh
from .dia_shard import ShardVec, distinct_devices, shard_dot, shard_sum


@dataclass
class ShardedProblem:
    """Device-ready row-sharded FEA system. Per row shard, on the devices
    of the mesh's first batch index: `ell_data` slot-major [K, 2, 2, nl],
    `cols` [K, nl] int32 (global padded node ids), `diag_inv` [2, 2, nl]
    (the reduced block-Jacobi inverse); `free`, `u_fixed`, `f_applied`:
    ShardVecs of [2, nl] fields."""

    mesh_axis: object  # parallel.pipeline.DeviceMesh or DeviceMesh2D
    ell_data: list
    cols: list
    free: ShardVec
    u_fixed: ShardVec
    f_applied: ShardVec
    diag_inv: list
    n_nodes: int  # un-padded node count
    # the operator's copies on other devices (the batch solve's other rows)
    cache: dict = field(default_factory=dict, repr=False)

    @property
    def n_pad(self) -> int:
        return self.free.shards[0].shape[1] * len(self.free.shards)


def _mesh_rows(device_mesh, axis: str) -> list:
    """The row shards' devices for each index of the mesh's other axis:
    [[device of row shard j] for each batch index]. A 1-D mesh shards
    rows over all its devices."""
    from .pipeline import DeviceMesh, DeviceMesh2D

    if isinstance(device_mesh, DeviceMesh):
        return [list(device_mesh.devices)]
    if not isinstance(device_mesh, DeviceMesh2D):
        raise InputError(
            "device_mesh must be a parallel.pipeline.DeviceMesh or DeviceMesh2D; got "
            f"{type(device_mesh).__name__}"
        )
    if axis not in device_mesh.axis_names:
        raise InputError(f"axis {axis!r} is not an axis of the mesh {device_mesh.axis_names}")
    nr, nc = device_mesh.shape
    grid = [list(device_mesh.row(i)) for i in range(nr)]
    if device_mesh.axis_names.index(axis) == 0:  # rows down the mesh's first axis
        return [[grid[i][j] for i in range(nr)] for j in range(nc)]
    return grid


def prepare_sharded_problem(
    fem_mesh: FemMesh,
    bca: BCArrays,
    metadata: ModelMetadata,
    device_mesh,
    axis: str = "rows",
    dtype=np.float32,
    structure: EllStructure | None = None,
) -> ShardedProblem:
    """Assemble (host C++, f64, cast to `dtype`) and lay the system out
    row-sharded over the mesh's `axis` (any axis name of a 1-D mesh)."""
    devices = _mesh_rows(device_mesh, axis)[0]
    n = fem_mesh.num_nodes
    n_shards = len(devices)
    n_pad = math.ceil(n / n_shards) * n_shards
    nl = n_pad // n_shards
    if structure is None:
        structure = build_ell_structure(fem_mesh.tris, n)
    md = metadata
    ell = assemble_ell(fem_mesh.coords, fem_mesh.tris, md.youngs_modulus, md.poisson_ratio,
                       md.part_thickness, structure).numpy()  # [N, K, 2, 2] f64
    k = structure.cols.shape[1]
    cols = np.tile(np.arange(n_pad, dtype=np.int64)[:, None], (1, k))
    cols[:n] = structure.cols  # padded rows reference themselves
    data = np.zeros((n_pad, k, 2, 2))
    data[:n] = ell
    tdtype = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32

    def field_(a):
        padded = np.zeros((2, n_pad))
        padded[:, :n] = np.asarray(a, np.float64).T
        return torch.from_numpy(padded).to(tdtype)

    free = field_((~bca.u_known).astype(np.float64))
    own = cols == np.arange(n_pad)[:, None]
    diag = torch.from_numpy(np.einsum("nk,nkij->ijn", own.astype(np.float64), data)).to(tdtype)
    diag_inv = guarded_inv2(reduce_diag_blocks(diag, free))
    data_t = torch.from_numpy(data.transpose(1, 2, 3, 0).copy()).to(tdtype)
    cols_t = torch.from_numpy(cols.T.astype(np.int32).copy())

    def shards(a):
        return [a[..., s * nl:(s + 1) * nl].contiguous().to(dev) for s, dev in enumerate(devices)]

    return ShardedProblem(
        mesh_axis=device_mesh, ell_data=shards(data_t), cols=shards(cols_t),
        free=ShardVec(shards(free)), u_fixed=ShardVec(shards(field_(bca.u_value))),
        f_applied=ShardVec(shards(field_(bca.f_value))), diag_inv=shards(diag_inv),
        n_nodes=n,
    )


def _on(problem: ShardedProblem, devices) -> tuple:
    """(ell_data, cols, free, diag_inv) of the row shards on `devices` (one
    per row shard), copied once per device set."""
    key = tuple(devices)
    if key == tuple(s.device for s in problem.free.shards):
        return problem.ell_data, problem.cols, problem.free, problem.diag_inv
    if key not in problem.cache:
        def moved(ts):
            return [t.to(d) for t, d in zip(ts, devices)]

        problem.cache[key] = (moved(problem.ell_data), moved(problem.cols),
                              ShardVec(moved(problem.free.shards)), moved(problem.diag_inv))
    return problem.cache[key]


def _lanes_on(problem: ShardedProblem, devices) -> tuple:
    """(ell [nl, K, 2, 2], cols [nl, K], free [2, nl, 1], diag_inv [2, 2,
    nl, 1]) of the row shards on `devices`, node-major as the lane ELL
    kernel takes them, made once per device set."""
    key = ("lanes", tuple(devices))
    if key not in problem.cache:
        ell_data, cols, free, diag_inv = _on(problem, devices)
        problem.cache[key] = (
            [d.permute(3, 0, 1, 2).contiguous() for d in ell_data],
            [c.T.contiguous() for c in cols],
            ShardVec(f[:, :, None] for f in free.shards),
            [d[..., None] for d in diag_inv],
        )
    return problem.cache[key]


def _gathered(u: ShardVec) -> dict:
    """The whole field (or lane fields) of a row-sharded ShardVec, gathered
    once onto each distinct device of its shards: {device: tensor}."""
    return {dev: torch.cat([s.to(dev, non_blocking=True) for s in u.shards], dim=1)
            for dev in distinct_devices([s.device for s in u.shards])}


def _gather_matvec(ell_data, cols):
    """K u on ShardVecs: the whole field gathered once per distinct device,
    then the ELL kernel on each shard's rows against it."""

    def matvec(u: ShardVec) -> ShardVec:
        full = _gathered(u)
        return ShardVec(ell_matvec_t(d, c, full[d.device]) for d, c in zip(ell_data, cols))

    return matvec


def _gather_lane_matvec(ell_nodes, cols_nodes):
    """K u on ShardVecs of [2, nl, B] lane fields: the lane fields gathered
    once per distinct device, then the lane ELL kernel on each shard's rows
    against them."""

    def matvec(u: ShardVec) -> ShardVec:
        full = _gathered(u)
        return ShardVec(lane_ell_matvec(e, c, full[e.device])
                        for e, c in zip(ell_nodes, cols_nodes))

    return matvec


def _lane_dot(a: ShardVec, b: ShardVec) -> torch.Tensor:
    """Per-lane sum(a * b) over every shard of [2, nl, B] lane fields: [B]
    on a.device."""
    parts = [torch.sum(x * y, dim=(0, 1)) for x, y in zip(a.shards, b.shards)]
    return shard_sum(parts, [a.device])[a.device]


def _block_jacobi(diag_inv):
    """r -> D^-1 r shard by shard (fields or lane fields)."""

    def precond(r: ShardVec) -> ShardVec:
        return ShardVec(apply_blocks(d, x) for d, x in zip(diag_inv, r.shards))

    return precond


def _local_pcg(ell_data, cols, free, u_fixed, f_applied, diag_inv, rtol, maxiter):
    """The row-sharded block-Jacobi PCG."""
    matvec = _gather_matvec(ell_data, cols)
    b = reduced_rhs(matvec, free, u_fixed, f_applied)
    return pcg(make_constrained_operator(matvec, free), b,
               preconditioner=_block_jacobi(diag_inv), x0=u_fixed, rtol=rtol,
               maxiter=maxiter, dot=shard_dot)


def sharded_pcg_solve(
    problem: ShardedProblem,
    rtol: float = 1e-6,
    maxiter: int = 100_000,
) -> CGResult:
    """Run the row-sharded PCG. Returns CGResult with x a ShardVec of the
    row shards' [2, nl] fields (`x.gather(n)` is the [2, N] field)."""
    p = problem
    return _local_pcg(p.ell_data, p.cols, p.free, p.u_fixed, p.f_applied, p.diag_inv, rtol,
                      maxiter)


def sharded_batch_pcg_solve(
    problem: ShardedProblem,
    u_fixed_batch,  # [B, Np, 2]
    f_applied_batch,  # [B, Np, 2]
    axis_rows: str = "rows",
    axis_batch: str = "batch",
    iterations: int = 200,
) -> torch.Tensor:
    """A design sweep over a 2-D mesh: lanes split in contiguous chunks over
    the mesh's `axis_batch`, operator rows over `axis_rows` (a 1-D mesh:
    one chunk). Each chunk runs one fixed-iteration PCG on its lanes at
    once (per-lane alpha and beta), so lanes stay in lockstep. Returns u
    [B, Np, 2] on the mesh's first device."""
    rows_of = _mesh_rows(problem.mesh_axis, axis_rows)
    if len(rows_of) > 1 and axis_batch not in problem.mesh_axis.axis_names:
        raise InputError(
            f"axis {axis_batch!r} is not an axis of the mesh {problem.mesh_axis.axis_names}")
    u_b, f_b = torch.as_tensor(u_fixed_batch), torch.as_tensor(f_applied_batch)
    n_lanes, n_chunks = u_b.shape[0], len(rows_of)
    if n_lanes % n_chunks:
        raise InputError(
            f"batch of {n_lanes} lanes does not divide over {n_chunks} batch shards")
    chunk = n_lanes // n_chunks
    nl = problem.free.shards[0].shape[1]
    dtype = problem.free.dtype
    first = rows_of[0][0]
    out = []
    for c, devices in enumerate(rows_of):
        ell, cols, free, diag_inv = _lanes_on(problem, devices)

        def lane_fields(a):  # [Bc, Np, 2] -> ShardVec of [2, nl, Bc]
            t = a.permute(2, 1, 0)
            return ShardVec(t[:, s * nl:(s + 1) * nl].to(d, dtype).contiguous()
                            for s, d in enumerate(devices))

        lanes = slice(c * chunk, (c + 1) * chunk)
        u_fixed = lane_fields(u_b[lanes])
        matvec = _gather_lane_matvec(ell, cols)
        b = reduced_rhs(matvec, free, u_fixed, lane_fields(f_b[lanes]))
        res = pcg_fixed_iterations(make_constrained_operator(matvec, free), b,
                                   preconditioner=_block_jacobi(diag_inv), x0=u_fixed,
                                   iterations=int(iterations), dot=_lane_dot)
        out.append(torch.cat([s.to(first) for s in res.x.shards], dim=1).permute(2, 1, 0))
    return torch.cat(out)
