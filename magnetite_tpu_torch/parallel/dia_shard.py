"""Node-sharded unstructured solves: DIA bands + AMG over a device mesh (port
of magnetite_tpu/parallel/dia_shard.py).

After the band-friendly renumbering (meshing/reorder.py) every stiffness
coupling lies within max|col - row| = H of the diagonal, so sharding the
nodes in contiguous blocks makes the operator's communication a halo of H
nodes on each side: per matvec, each shard receives [2, H] slabs from its
two neighbours (`exchange_halo`, JAX's `ppermute` pair) and the CG's inner
products are summed over the shards (`shard_dot`, JAX's `psum`).

One controller drives every shard, as the JAX package's `shard_map` does
(there is no process per GPU). A shard is a contiguous block of
`local_n` nodes whose tensors live on the shard's `torch.device`; a mesh
may repeat a device, so S shards can run on one card (or on the CPU in the
tests), the halo slabs then being real copies between the shards'
tensors. `ShardVec` carries a node-sharded [2, Np] field as its shards'
[2, local_n] tensors with the arithmetic fem/cg.py::pcg uses, so the
sharded solve runs the port's one CG with the sum over shards as its
`dot`.

Per shard the band operator runs on the halo-extended vector [2, nl + 2H]
with its bands zero-padded by H on each side (K1, `dia_matvec` with m = 2:
the kernel on the card); the double-float operator (K4) and the ELL
fallback (the ELL kernel) the same way; only the kept rows [H, H + nl) are
used. The AMG V-cycle smooths level 0 shard-locally, restricts through
each shard's rows of the smoothed prolongator into partial coarse
residuals that are summed over the shards (restrict0, K3, on the shard's
rows of P transposed once at prepare time), and prolongs shard-locally
(a gather, as in the JAX package: K2 takes one tentative block per node,
not the smoothed P's rows). Everything below level 0 is replicated: it
runs once per DISTINCT device of the mesh (the port's coarse V-cycle,
fem/amg.py::make_coarse_cycle, K1 with m = 3), never once per shard.

Precision, as the port's single-device solve (fem/solve.py): `refined`
runs f64 CG around the f32 V-cycle (V(3, 3) by default), the global
residual norm scaling the f32 cast; otherwise CG and V-cycle run in the
arrays' dtype, V(1, 1). The JAX package's sharded path runs its f32
V-cycle for f64 arrays too; the port's f64 path keeps the f64 V-cycle it
runs on one device.
"""

from __future__ import annotations

import functools
import math
import operator
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..bc import BCArrays
from ..config import ModelMetadata
from ..errors import SolverError
from ..fem.cg import pcg
from ..meshing.core import Mesh as FemMesh
from ..utils.logging import span

# -------------------------- the sharded vector -------------------------------


# what fem/cg.py::pcg hands a ShardVec through torch: `torch.where`,
# `torch.zeros_like` (x0 None) and a 0-d tensor times the vector
_ELEMENTWISE = frozenset((torch.where, torch.zeros_like, torch.Tensor.mul))


class ShardVec:
    """A node-sharded field: one tensor per shard, in mesh order, each on
    its shard's device. Elementwise arithmetic with another ShardVec, a
    Python number or a 0-d tensor (moved to each shard's device) maps over
    the shards; `torch.where` and `torch.zeros_like` do too. Scalars the CG
    makes live on `device`, the first shard's."""

    __slots__ = ("shards",)

    def __init__(self, shards):
        self.shards = tuple(shards)

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @classmethod
    def map(cls, fn, *args, **kwargs) -> "ShardVec":
        """fn applied shard by shard; ShardVec arguments give their shard,
        tensors on another device are copied to the shard's once per call."""
        ref = next(a for a in (*args, *kwargs.values()) if isinstance(a, ShardVec))
        moved: dict = {}

        def pick(a, i, dev):
            if isinstance(a, ShardVec):
                return a.shards[i]
            if isinstance(a, torch.Tensor) and a.device != dev:
                key = (id(a), dev)
                if key not in moved:
                    moved[key] = a.to(dev, non_blocking=True)
                return moved[key]
            return a

        return cls(
            fn(*(pick(a, i, s.device) for a in args),
               **{k: pick(v, i, s.device) for k, v in kwargs.items()})
            for i, s in enumerate(ref.shards)
        )

    def __add__(self, o):
        return ShardVec.map(operator.add, self, o)

    def __radd__(self, o):
        return ShardVec.map(operator.add, o, self)

    def __sub__(self, o):
        return ShardVec.map(operator.sub, self, o)

    def __rsub__(self, o):
        return ShardVec.map(operator.sub, o, self)

    def __mul__(self, o):
        return ShardVec.map(operator.mul, self, o)

    def __rmul__(self, o):
        return ShardVec.map(operator.mul, o, self)

    def __truediv__(self, o):
        return ShardVec.map(operator.truediv, self, o)

    def to(self, *args, **kwargs) -> "ShardVec":
        return ShardVec.map(lambda t: t.to(*args, **kwargs), self)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in _ELEMENTWISE:
            return cls.map(func, *args, **(kwargs or {}))
        return NotImplemented

    def gather(self, n: Optional[int] = None) -> np.ndarray:
        """The whole field on the host, [2, Np] (or its first n nodes)."""
        full = torch.cat([s.detach().cpu() for s in self.shards], dim=1)
        return full.numpy() if n is None else full[:, :n].numpy()


def distinct_devices(devices) -> list:
    """The devices of a mesh, each once, in mesh order."""
    return list(dict.fromkeys(devices))


def exchange_halo(u_locals, halo: int) -> list:
    """[2, nl] per shard -> [2, nl + 2 halo]: `halo` boundary entries from
    each neighbour (copied to the shard's device), zeros at the two outer
    edges (band entries reaching outside the global index range are zero
    by construction). Needs halo <= nl."""
    n = len(u_locals)
    out = []
    for s, u in enumerate(u_locals):
        dev = u.device
        edge = torch.zeros((u.shape[0], halo), dtype=u.dtype, device=dev)
        above = u_locals[s - 1][:, -halo:].to(dev, non_blocking=True) if s > 0 else edge
        below = u_locals[s + 1][:, :halo].to(dev, non_blocking=True) if s < n - 1 else edge
        out.append(torch.cat([above, u, below], dim=1))
    return out


def shard_sum(parts, devices) -> dict:
    """The sum of per-shard tensors (JAX's psum), on each distinct device of
    `devices`: {device: total}. Summed in shard order, with no host read."""
    out = {}
    for dev in distinct_devices(devices):
        total = parts[0].to(dev, non_blocking=True)
        for part in parts[1:]:
            total = total + part.to(dev, non_blocking=True)
        out[dev] = total
    return out


def shard_dot(a: ShardVec, b: ShardVec) -> torch.Tensor:
    """sum(a * b) over every shard, a 0-d tensor on a.device."""
    parts = [torch.sum(x * y) for x, y in zip(a.shards, b.shards)]
    return shard_sum(parts, [a.device])[a.device]


# ------------------------------ the problem ----------------------------------


@dataclass
class ShardedAMG:
    """The AMG hierarchy as the sharded V-cycle applies it, in one dtype.

    p_cols / p_vals: each shard's rows of the level-0 smoothed prolongator
    P ([nl, wp] int64, [nl, wp, 2, 3]); rows / pt_cols / pt_vals: the same
    rows transposed, per shard, over the coarse rows they touch ([m] int64,
    [m, w] int32 local fine indices, [m, w, 3, 2]), for restrict0; coarse:
    the levels below, one fem.amg.AMGDeviceArrays per distinct device
    (level0=False); n1: level 1's node count."""

    p_cols: list
    p_vals: list
    rows: list
    pt_cols: list
    pt_vals: list
    coarse: dict
    n1: int


@dataclass
class ShardedDiaProblem:
    """Device-ready node-sharded unstructured FEA system.

    Node arrays are padded to a multiple of the shard count; pad nodes carry
    identity diagonal blocks (free = 0), so the operator stays SPD. `perm`
    (perm[new] = old) is set when the mesh was renumbered for bandedness.

    bands: per shard, the halo-extended operator values: kind "dia"
    [D, 2, 2, nl + 2 halo] (zero outside the kept rows [halo, halo + nl));
    kind "ell" slot-major [W, 2, 2, nl + 2 halo] with `ell_cols` [W, nl +
    2 halo] int32 indices into the extended vector (halo rows and padding
    slots point at their own row and hold zero blocks). free / u_fixed / f:
    ShardVecs of [2, nl] fields."""

    device_mesh: object  # parallel.pipeline.DeviceMesh
    offsets: tuple
    halo: int
    bands: list
    free: ShardVec
    u_fixed: ShardVec
    f: ShardVec
    n_nodes: int
    local_n: int
    dtype: torch.dtype
    perm: Optional[np.ndarray] = None
    kind: str = "dia"
    ell_cols: Optional[list] = None
    # the host-side AMG hierarchy (None under block_jacobi): persist.save_amg
    # writes it, as CompiledProblem.amg_setup
    amg_setup: object = None
    # lazily made copies per dtype: bands, the double-float pairs, the AMG
    cache: dict = field(default_factory=dict, repr=False)

    @property
    def devices(self) -> tuple:
        return tuple(self.device_mesh.devices)

    def bands_in(self, dtype) -> list:
        if dtype == self.dtype:
            return self.bands
        key = ("bands", dtype)
        if key not in self.cache:
            self.cache[key] = [b.to(dtype) for b in self.bands]
        return self.cache[key]

    def bands_hl(self) -> list:
        from ..kernels.df_kernel import split_bands

        if "bands_hl" not in self.cache:
            self.cache["bands_hl"] = [split_bands(b) for b in self.bands]
        return self.cache["bands_hl"]

    def amg_in(self, dtype) -> Optional[ShardedAMG]:
        key = ("amg", dtype)
        if key not in self.cache:
            self.cache[key] = _sharded_amg(self.amg_setup, self, dtype)
        return self.cache[key]


def _halo_operator(shard_ops, halo: int):
    """op(u: ShardVec): one halo exchange, then shard s's operator on its
    halo-extended vector [2, nl + 2 halo]; the kept rows are returned."""

    def op(u: ShardVec) -> ShardVec:
        nl = u.shards[0].shape[-1]
        ext = exchange_halo(u.shards, halo)
        return ShardVec(o(v)[:, halo:halo + nl] for o, v in zip(shard_ops, ext))

    return op


def make_halo_dia_operator(bands_ext, offsets: tuple, halo: int):
    """K u through the band kernel (`dia_matvec`, m = 2) on each shard's
    halo-extended vector and extended bands. Needs halo <= nl."""
    from ..fem.dia import make_dia_operator

    return _halo_operator([make_dia_operator(b, offsets) for b in bands_ext], halo)


def make_halo_df_dia_operator(bands_hl_ext, offsets: tuple, halo: int):
    """The f64-grade double-float K u (K4, `df_dia_matvec`) from hi/lo
    pairs of each shard's extended bands (kernels.df_kernel.split_bands)."""
    from ..fem.dia import make_df_dia_operator

    return _halo_operator([make_df_dia_operator(b, offsets) for b in bands_hl_ext], halo)


def make_halo_ell_operator(data_ext, cols_ext, halo: int):
    """The block-ELL fallback: the ELL kernel (`ell_matvec_t`) over each
    shard's halo-extended rows, whose cols index the extended vector."""
    from ..kernels.ell_kernel import ell_matvec_t

    return _halo_operator(
        [functools.partial(ell_matvec_t, d, c) for d, c in zip(data_ext, cols_ext)], halo
    )


def _ell_diag_t(data_ext, cols_ext, halo: int, nl: int) -> torch.Tensor:
    """[2, 2, nl] raw diagonal blocks of one shard's kept ELL rows."""
    from ..kernels.ell_kernel import ell_diag_blocks

    return ell_diag_blocks(data_ext, cols_ext)[..., halo:halo + nl]


def _inv_reduced_diag(d0, free_local) -> torch.Tensor:
    """Closed-form inverse of free * d0 * free + (1 - free) * I, [2, 2, nl]
    (fem/blocks.py, the JAX package's parallel/blocks.py)."""
    from ..fem.blocks import guarded_inv2, reduce_diag_blocks

    return guarded_inv2(reduce_diag_blocks(d0, free_local))


def _jacobi_inverse(bands_ext, offsets: tuple, free_local, halo: int) -> torch.Tensor:
    nl = free_local.shape[-1]
    return _inv_reduced_diag(bands_ext[offsets.index(0)][..., halo:halo + nl], free_local)


def _shard_transpose(p_cols, p_vals):
    """One shard's rows of P as the restriction reads them: (rows [m]
    coarse ids touched, pt_cols [m, w] local fine rows, pt_vals [m, w, 3,
    2] = P blocks transposed), padding slots at fine row 0 with zero
    values. P's own padding (zero blocks at coarse id 0) is left out: it
    adds exact zeros, and kept it would widen coarse row 0 to every row."""
    nl, wp = p_cols.shape
    a = p_cols.reshape(-1).astype(np.int64)
    fine = np.repeat(np.arange(nl, dtype=np.int64), wp)
    vals = p_vals.reshape(-1, 2, 3).transpose(0, 2, 1)
    keep = np.any(vals != 0, axis=(1, 2))
    keep[0] = True  # at least one entry, so every shard has a row
    a, fine, vals = a[keep], fine[keep], vals[keep]
    rows, inv = np.unique(a, return_inverse=True)
    counts = np.bincount(inv, minlength=rows.size)
    width = max(int(counts.max()), 1)
    order = np.argsort(inv, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ranks = np.empty_like(inv)
    ranks[order] = np.arange(inv.size) - starts[inv[order]]
    pt_cols = np.zeros((rows.size, width), dtype=np.int32)
    pt_vals = np.zeros((rows.size, width, 3, 2))
    pt_cols[inv, ranks] = fine
    pt_vals[inv, ranks] = vals
    return rows, pt_cols, pt_vals


def _sharded_amg(setup, problem: ShardedDiaProblem, dtype) -> Optional[ShardedAMG]:
    """Upload `setup` for the sharded V-cycle in `dtype` (None without a
    hierarchy or when it never coarsened)."""
    from ..fem.amg import amg_device_arrays

    if setup is None or not setup.transfers:
        return None
    n, nl, devs = problem.n_nodes, problem.local_n, problem.devices
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    pc, pv, _, _ = setup.transfers[0]
    n_pad = nl * len(devs)
    p_cols = np.zeros((n_pad, pc.shape[1]), dtype=np.int64)
    p_cols[:n] = pc
    p_vals = np.zeros((n_pad,) + pv.shape[1:])
    p_vals[:n] = pv
    out = ShardedAMG([], [], [], [], [], {}, int(setup.level_sizes[1][0]))
    for s, dev in enumerate(devs):
        cols_s, vals_s = p_cols[s * nl:(s + 1) * nl], p_vals[s * nl:(s + 1) * nl]
        rows, pt_cols, pt_vals = _shard_transpose(cols_s, vals_s)
        out.p_cols.append(torch.from_numpy(cols_s.copy()).to(dev))
        out.p_vals.append(torch.from_numpy(vals_s.astype(np_dtype)).to(dev))
        out.rows.append(torch.from_numpy(rows).to(dev))
        out.pt_cols.append(torch.from_numpy(pt_cols).to(dev))
        out.pt_vals.append(torch.from_numpy(pt_vals.astype(np_dtype)).to(dev))
    for dev in distinct_devices(devs):
        out.coarse[dev] = amg_device_arrays(setup, dtype, dev, level0=False)
    return out


def make_sharded_amg_preconditioner(amg: Optional[ShardedAMG], op0, jac0, devices, *,
                                    pre_sweeps: int = 1, post_sweeps: int = 1):
    """Sharded V-cycle: shard-local level-0 smoothing (`op0`, `jac0` on
    ShardVecs), restriction into partial coarse residuals summed over the
    shards, the coarse levels' V(1, 1)-cycle once per distinct device, and
    shard-local prolongation. Without coarse levels: damped block-Jacobi."""
    from ..fem.amg import OMEGA, _block_ell_matvec, make_coarse_cycle
    from ..kernels.transfer_kernel import restrict0

    if amg is None:
        return lambda r: OMEGA * jac0(r)
    cycles = {
        dev: make_coarse_cycle(a.transfers, a.coarse, a.ci, a.coarse_bands)
        for dev, a in amg.coarse.items()
    }

    def restrict(res: ShardVec) -> dict:  # -> {device: [n1, 3]}
        parts = []
        for i, tmp in enumerate(res.shards):
            part = torch.zeros((amg.n1, 3), dtype=tmp.dtype, device=tmp.device)
            part.index_copy_(0, amg.rows[i], restrict0(tmp, amg.pt_cols[i], amg.pt_vals[i]))
            parts.append(part)
        return shard_sum(parts, devices)

    def prolong(ec: dict) -> ShardVec:
        return ShardVec(
            _block_ell_matvec(pc, pv, ec[pc.device]).T
            for pc, pv in zip(amg.p_cols, amg.p_vals)
        )

    def apply(r: ShardVec) -> ShardVec:
        e = OMEGA * jac0(r)
        for _ in range(pre_sweeps - 1):
            e = e + OMEGA * jac0(r - op0(e))
        rc = restrict(r - op0(e))
        e = e + prolong({dev: cycles[dev](0, v) for dev, v in rc.items()})
        for _ in range(post_sweeps):
            e = e + OMEGA * jac0(r - op0(e))
        return e

    return apply


def _assembled_operator(kind, mesh, dia, ell_struct, metadata, assembly, dev0, timings):
    """The global operator, f64: host C++ assembly (the default) or the
    fused device assembly on `dev0` (assembly="device"). kind "dia": bands
    [D, 2, 2, N]; kind "ell": [N, K, 2, 2]."""
    n = mesh.num_nodes
    if assembly == "device":
        with span("compile.assemble_device", timings, "assemble_device_s"):
            from ..fem.dia import assemble_dia_fused
            from ..fem.solve import assemble_ell_arrays_fused

            coords = torch.from_numpy(np.asarray(mesh.coords, np.float64)).to(dev0)
            tris = torch.from_numpy(np.asarray(mesh.tris, np.int64)).to(dev0)
            md = metadata
            mat = (md.youngs_modulus, md.poisson_ratio, md.part_thickness)
            if kind == "dia":
                slots = torch.from_numpy(np.asarray(dia.slot_ids, np.int64)).to(dev0)
                out = assemble_dia_fused(coords, tris, *mat, slots, n, len(dia.offsets))
            else:
                slots = torch.from_numpy(np.asarray(ell_struct.slot_ids, np.int64)).to(dev0)
                out = assemble_ell_arrays_fused(coords, tris, *mat, slots, n,
                                                ell_struct.cols.shape[1])
            if dev0.type == "cuda":
                torch.cuda.synchronize(dev0)
        return out
    from ..fem.solve import _assemble_flat

    if kind == "dia":
        flat, _ = _assemble_flat("dia", tuple(int(o) for o in dia.offsets), None,
                                 dia.slot_ids, mesh, metadata, None, timings)
        return torch.from_numpy(flat.reshape(len(dia.offsets), n, 2, 2).transpose(0, 2, 3, 1))
    cols = ell_struct.cols
    flat, _ = _assemble_flat("ell", (), cols, ell_struct.slot_ids, mesh, metadata, None, timings)
    return torch.from_numpy(flat.reshape(n, cols.shape[1], 2, 2))


def prepare_sharded_dia_problem(
    fem_mesh: FemMesh,
    bca: BCArrays,
    metadata: ModelMetadata,
    device_mesh,
    dtype=np.float32,
    amg_setup=None,
    max_diags: int = 64,
    cell_factor: float = 3.0,
    preconditioner: str = "amg",
    assembly: str = "auto",
    timings: Optional[dict] = None,
) -> ShardedDiaProblem:
    """Host prep: band structure (renumbering when the mesh's own order
    misses it), the halo check, the assembly (host C++, or on the first
    device under assembly="device"), the AMG hierarchy, and the node-sharded
    layout on the mesh's devices.

    preconditioner: "amg" builds (or reuses a matching `amg_setup`) the SA
    hierarchy; "block_jacobi" skips it, and the V-cycle degrades to damped
    block-Jacobi. `timings`, when given, receives the stage times."""
    from ..fem.amg import build_amg_setup, setup_matches
    from ..fem.dia import build_dia_structure
    from ..utils.logging import log

    timings = {} if timings is None else timings
    if preconditioner not in ("amg", "block_jacobi"):
        raise SolverError(
            "sharded unstructured solves support preconditioner='amg' or "
            f"'block_jacobi'; got '{preconditioner}'"
        )
    with span("compile.structure", timings, "structure_s"):
        mesh, perm = fem_mesh, None
        dia = build_dia_structure(mesh.tris, mesh.num_nodes, max_diags=max_diags)
        if dia is None:
            from ..meshing.reorder import renumber

            mesh, perm, _ = renumber(mesh)
            bca = BCArrays(u_known=bca.u_known[perm], u_value=bca.u_value[perm],
                           f_value=bca.f_value[perm])
            dia = build_dia_structure(mesh.tris, mesh.num_nodes, max_diags=max_diags)
        n = mesh.num_nodes
        ell_struct = None
        if dia is not None:
            kind = "dia"
            offsets = tuple(int(o) for o in dia.offsets)
            halo = max(-min(offsets), max(offsets))
        else:
            # bandwidth bounded after renumbering, but more DISTINCT offsets
            # than max_diags (coarse / graded meshes): the block-ELL fallback
            # over the same halo exchange
            from ..fem.assembly import build_ell_structure

            kind, offsets = "ell", ()
            ell_struct = build_ell_structure(mesh.tris, n)
            halo = max(1, int(np.abs(
                ell_struct.cols.astype(np.int64) - np.arange(n, dtype=np.int64)[:, None]
            ).max()))
            log(
                "info: mesh has too many distinct band offsets for the DIA "
                f"operator; sharding with the block-ELL gather (halo {halo})"
            )
        devices = tuple(device_mesh.devices)
        n_shards = len(devices)
        np_pad = math.ceil(n / n_shards) * n_shards
        nl = np_pad // n_shards
        if nl < halo:
            raise SolverError(
                f"shard size {nl} smaller than the band halo {halo}; use fewer "
                "shards for this mesh"
            )

    tdtype = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    full = _assembled_operator(kind, mesh, dia, ell_struct, metadata, assembly,
                               devices[0], timings)

    with span("compile.upload", timings, "upload_s"):
        width = 2 * halo + nl
        bands, ell_cols = [], None
        if kind == "dia":
            zero = offsets.index(0)
            for s, dev in enumerate(devices):
                ext = torch.zeros((len(offsets), 2, 2, width), dtype=tdtype, device=dev)
                lo, hi = s * nl, min((s + 1) * nl, n)
                if hi > lo:
                    ext[..., halo:halo + hi - lo] = full[..., lo:hi].to(dev).to(tdtype)
                pad = torch.arange(halo + max(hi - lo, 0), halo + nl, device=dev)
                ext[zero, 0, 0, pad] = 1.0  # pad rows: identity diagonal blocks
                ext[zero, 1, 1, pad] = 1.0
                bands.append(ext)
        else:
            k = ell_struct.cols.shape[1]
            cols_pad = np.tile(np.arange(np_pad, dtype=np.int64)[:, None], (1, k))
            cols_pad[:n] = ell_struct.cols
            owner = np.arange(np_pad, dtype=np.int64) // nl
            lidx = cols_pad - owner[:, None] * nl + halo  # into the extended vector
            ell_cols = []
            for s, dev in enumerate(devices):
                ext = torch.zeros((k, 2, 2, width), dtype=tdtype, device=dev)
                lo, hi = s * nl, min((s + 1) * nl, n)
                if hi > lo:
                    ext[..., halo:halo + hi - lo] = (
                        full[lo:hi].to(dev).permute(1, 2, 3, 0).to(tdtype)
                    )
                pad = torch.arange(halo + max(hi - lo, 0), halo + nl, device=dev)
                ext[0, 0, 0, pad] = 1.0  # pad rows: identity on their self slot
                ext[0, 1, 1, pad] = 1.0
                cols = np.tile(np.arange(width, dtype=np.int64), (k, 1))
                cols[:, halo:halo + nl] = lidx[s * nl:(s + 1) * nl].T
                bands.append(ext)
                ell_cols.append(torch.from_numpy(cols.astype(np.int32)).to(dev))
        del full

        def sharded(a) -> ShardVec:  # [N, 2] host array -> padded [2, nl] shards
            padded = np.zeros((2, np_pad))
            padded[:, :n] = np.asarray(a, np.float64).T
            return ShardVec(
                torch.from_numpy(padded[:, s * nl:(s + 1) * nl].copy()).to(dev).to(tdtype)
                for s, dev in enumerate(devices)
            )

        free = sharded((~bca.u_known).astype(np.float64))
        u_fixed, f = sharded(bca.u_value), sharded(bca.f_value)

    with span("compile.amg_build", timings, "amg_build_s"):
        free_host = (~bca.u_known).astype(np.float64)
        if preconditioner == "block_jacobi":
            amg_setup = None
        if amg_setup is not None and not setup_matches(
            amg_setup, mesh.coords, mesh.tris, free_host, metadata, float(cell_factor), perm
        ):
            log(
                "warning: provided AMG hierarchy does not match the sharded "
                "problem (mesh ordering, BCs, material, or an older cache "
                "format); rebuilding"
            )
            amg_setup = None
        if amg_setup is None and preconditioner == "amg":
            amg_setup = build_amg_setup(
                mesh.coords, mesh.tris, metadata.youngs_modulus, metadata.poisson_ratio,
                metadata.part_thickness, free_host, cell_factor=float(cell_factor),
            )
    if amg_setup is not None:
        timings["amg_levels"] = amg_setup.level_sizes
    return ShardedDiaProblem(
        device_mesh=device_mesh, offsets=offsets, halo=int(halo), bands=bands,
        free=free, u_fixed=u_fixed, f=f, n_nodes=n, local_n=nl, dtype=tdtype,
        perm=perm, kind=kind, ell_cols=ell_cols, amg_setup=amg_setup,
    )


def raw_operator(problem: ShardedDiaProblem, dtype=None):
    """The unreduced halo operator K over the problem's bands in `dtype`
    (default: the problem's)."""
    bands = problem.bands_in(problem.dtype if dtype is None else dtype)
    if problem.kind == "ell":
        return make_halo_ell_operator(bands, problem.ell_cols, problem.halo)
    return make_halo_dia_operator(bands, problem.offsets, problem.halo)


def _reduced(mv, free: ShardVec):
    fixed = 1.0 - free

    def op(v):
        return free * mv(free * v) + fixed * v

    return op


def resolve_df_impl(problem: ShardedDiaProblem, refined: bool, rtol: float,
                    df_matvec: str) -> str:
    """Which double-float matvec the refined sharded CG runs: "" (native
    f64), "kernel" (K4 on the card) or "plain" (its plain version on the
    CPU). The port's gate (fem/solve.py::_decide_df64): only "on" (and
    "interpret", kept for option parity) engage it, and the shards' device
    type decides kernel or plain version."""
    from ..fem.solve import _DF_RTOL_FLOOR

    if not refined or problem.kind != "dia" or df_matvec not in ("on", "interpret"):
        return ""
    if rtol < _DF_RTOL_FLOOR:
        from ..utils.logging import log

        log(
            f"warning: df_matvec with cg_rtol {rtol:.1e} is below the "
            "double-float kernel's ~2e-9 attainable relative residual; "
            "reported residuals are measured against the compensated "
            "f32-pair operator (set df_matvec='off' for true f64)"
        )
    return "kernel" if problem.devices[0].type == "cuda" else "plain"


def sharded_dia_pcg_solve(
    problem: ShardedDiaProblem,
    rtol: float = 1e-6,
    maxiter: int = 100_000,
    refined: bool = False,
    amg_sweeps: int = 0,
    history: int = 0,
    df_matvec: str = "auto",
    progress_every: int = 0,
):
    """Node-sharded AMG-PCG through fem/cg.py::pcg with the sum over shards
    as its inner product. refined=True needs f64 arrays (f64 CG around the
    f32 V-cycle). amg_sweeps pins the V-cycle schedule (0 = auto,
    fem.amg.amg_sweep_schedule). history > 0 records the global ||r|| of
    the first `history` iterations; progress_every > 0 logs it. df_matvec
    "on" runs the refined CG's band matvec in double-float pairs (K4 on the
    card). Returns (CGResult with x a ShardVec, ku = K x a ShardVec, ||b||
    a 0-d tensor)."""
    from ..fem.amg import amg_sweep_schedule
    from ..fem.blocks import apply_blocks
    from ..fem.solve import _f32_rtol_floor

    dtype = problem.dtype
    if refined and dtype != torch.float64:
        raise SolverError("refined sharded solve needs dtype=np.float64 problem arrays")
    if not refined and dtype == torch.float32:
        floor = _f32_rtol_floor()
        if rtol < floor:
            from ..utils.logging import log

            log(
                f"warning: requested rtol {rtol:.1e} is below the f32 floor;"
                f" clamping to {floor:.1e} (prepare with dtype=np.float64 and"
                " refined=True for f64-grade residuals)"
            )
            rtol = floor
    df_impl = resolve_df_impl(problem, refined, rtol, df_matvec)
    free = problem.free
    raw_mv = raw_operator(problem)
    op = _reduced(raw_mv, free)
    op_cg = op
    if df_impl:
        # the CG's matvec as compensated f32 pairs; the rhs and the force
        # recovery keep the true f64 operator
        op_cg = _reduced(
            make_halo_df_dia_operator(problem.bands_hl(), problem.offsets, problem.halo), free
        )
    vdtype = torch.float32 if refined else dtype
    free_v = free.to(vdtype)
    op_v = _reduced(raw_operator(problem, vdtype), free_v)
    bands_v, h = problem.bands_in(vdtype), problem.halo
    if problem.kind == "ell":
        invs = [_inv_reduced_diag(_ell_diag_t(d, c, h, fr.shape[-1]), fr)
                for d, c, fr in zip(bands_v, problem.ell_cols, free_v.shards)]
    else:
        invs = [_jacobi_inverse(b, problem.offsets, fr, h)
                for b, fr in zip(bands_v, free_v.shards)]

    def jac(r: ShardVec) -> ShardVec:
        return ShardVec(apply_blocks(inv, x) for inv, x in zip(invs, r.shards))

    sweeps = amg_sweep_schedule(refined, amg_sweeps)
    vcycle = make_sharded_amg_preconditioner(
        problem.amg_in(vdtype), op_v, jac, problem.devices,
        pre_sweeps=sweeps, post_sweeps=sweeps,
    )
    if refined:
        def precond(r: ShardVec) -> ShardVec:
            # the global norm scales the f32 cast (extreme magnitudes would
            # under/overflow the f32 V-cycle); the cycle is linear
            nrm = torch.sqrt(shard_dot(r, r))
            safe = torch.where(nrm == 0, torch.ones_like(nrm), nrm)
            return vcycle((r / safe).to(torch.float32)).to(r.dtype) * safe
    else:
        precond = vcycle
    fixed = 1.0 - free
    b = free * (problem.f - raw_mv(fixed * problem.u_fixed)) + fixed * problem.u_fixed
    result = pcg(op_cg, b, preconditioner=precond, x0=problem.u_fixed, rtol=rtol,
                 maxiter=maxiter, history=history, progress_every=progress_every,
                 dot=shard_dot)
    return result, raw_mv(result.x), torch.sqrt(shard_dot(b, b))
