"""Smoothed-aggregation algebraic multigrid (port of magnetite_tpu/fem/amg.py).

Host half: the hierarchy build, copied from the JAX package with its native
C++ paths required (the numpy fallbacks behind them are not ported). A
hierarchy built by either package runs in the other (interop.py).

Device half: the V-cycle apply over PyTorch tensors, in the [2, N] band
layout ("t") or the lane-batched [2, N, B] layout ("tl") of design sweeps.
Level 0 smooths on the injected band operator (the CUDA DIA kernel on the
card; the lane DIA kernel for sweeps) and moves between levels through the
factored transfers P = (I - omega D^-1 A) P0, whose P0 / P0^T pair is the
CUDA transfer kernel pair on the card for single vectors and a gather for
lane fields (as in the JAX package). Banded coarse levels run the DIA
kernel with 3x3 blocks; band-hostile ones (and every coarse level of a lane
hierarchy) a gather + block-contraction ELL matvec. The coarsest dense
inverse is a plain `torch.matmul`, as the JAX package leaves it to XLA.
Every contraction runs under `ieee_f32`: never TF32.

The basis-decomposed hierarchy of material sweeps (`build_amg_material_setup`)
is built here; its V-cycle lives in parallel/sweep.py, as in the JAX package.

The cycle is symmetric (matched damped block-Jacobi pre/post sweeps,
adjoint transfers), hence a valid SPD preconditioner for CG.
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..errors import SolverError
from ..kernels.transfer_kernel import prolong0, restrict0
from .dia import make_dia_operator

MatVec = Callable[[torch.Tensor], torch.Tensor]

# exact coarsest solves above this are slower than extra smoothing
_DENSE_COARSE_MAX_DOF = 3072
# V-cycle damping of every block-Jacobi smoothing sweep, and the sweeps on a
# coarsest level without a dense inverse (the JAX package's defaults)
OMEGA = 0.7
COARSE_SWEEPS = 24


def amg_sweep_schedule(mixed_precision: bool, override: int = 0) -> int:
    """Pre/post smoothing sweeps per V-cycle (SolverOptions.amg_sweeps):
    `override` > 0 pins them; otherwise V(3, 3) when a cheap f32 V-cycle
    preconditions f64 CG (extra f32 sweeps cut the f64 iteration count)
    and V(1, 1) for a same-precision V-cycle, where every sweep pays full
    price."""
    if override > 0:
        return int(override)
    return 3 if mixed_precision else 1


# ============================ host setup ====================================



def _reduce_block_coo(keys, vals):
    """Sum duplicate keys: sorted unique keys + reduced block values
    (native C++ pair-sort + one accumulation pass)."""
    from ..native import sort_reduce_blocks

    if keys.size == 0:
        return keys.copy(), np.empty((0,) + vals.shape[1:])
    return sort_reduce_blocks(keys, vals)


def pair_block_fields(coords, tris, t, free, d0, d1, d2):
    """Closed-form 2x2 blocks of every element's 3x3 node pairs as scalar
    [3, 3, E] fields (k00, k01, k10, k11), BC-masked by `free` [N, 2], for
    the plane-stress D coefficients (d0, d1, d2): the numpy mirror of the
    native assembly, and the form that takes unit D-bases."""
    at = tris.astype(np.int64).T  # [3, E]
    pc = coords[at]  # [3, E, 2]
    x, y = pc[..., 0], pc[..., 1]
    beta = np.stack([y[1] - y[2], y[2] - y[0], y[0] - y[1]])
    gamma = np.stack([x[2] - x[1], x[0] - x[2], x[1] - x[0]])
    area2 = x[0] * (y[1] - y[2]) + x[1] * (y[2] - y[0]) + x[2] * (y[0] - y[1])
    coef = t / (2.0 * area2)
    ba, bb = beta[:, None, :], beta[None, :, :]  # [3,3,E]
    ga, gb = gamma[:, None, :], gamma[None, :, :]
    fxa, fya = free[at, 0], free[at, 1]  # [3, E]
    m00 = fxa[:, None, :] * fxa[None, :, :]
    m01 = fxa[:, None, :] * fya[None, :, :]
    m10 = fya[:, None, :] * fxa[None, :, :]
    m11 = fya[:, None, :] * fya[None, :, :]
    k00 = coef * (d0 * ba * bb + d2 * ga * gb) * m00
    k01 = coef * (d1 * ba * gb + d2 * ga * bb) * m01
    k10 = coef * (d1 * ga * bb + d2 * ba * gb) * m10
    k11 = coef * (d0 * ga * gb + d2 * ba * bb) * m11
    return k00, k01, k10, k11


def scatter_pair_blocks(fields, slot_ids, n_slots: int) -> np.ndarray:
    """Sum the [3, 3, E] pair fields into slot-flat [n_slots, 2, 2] storage;
    `slot_ids` [E*9] element-major (the ELL / DIA structures' order)."""
    e = fields[0].shape[-1]
    ids = (
        np.asarray(slot_ids).astype(np.int64).reshape(e, 3, 3)
        .transpose(1, 2, 0).reshape(-1)
    )
    flat = np.empty((n_slots, 4))
    for c, k in enumerate(fields):
        flat[:, c] = np.bincount(ids, weights=k.reshape(-1), minlength=n_slots)
    return flat.reshape(-1, 2, 2)


def _assemble_block_coo(coords, tris, e_mod, nu, t, free, dcoefs=None):
    """BC-masked global stiffness in block-COO, rows sorted. free: [N,2]
    float mask (1 = unknown DOF).

    Without `dcoefs`: direct sorted COO assembly in one native C++ pass.
    `dcoefs`: explicit (d0, d1, d2) plane-stress D coefficients overriding
    the (e_mod, nu) closed form -- the material-sweep basis assemblies pass
    unit vectors here; they ride the native ELL structure and a numpy
    scatter of the closed-form pair blocks. ELL padding slots emit zero
    blocks at (n, n), which every consumer treats additively."""
    from ..native import assemble_coo_blocks, ell_structure

    n = coords.shape[0]
    if dcoefs is None:
        keys, blocks = assemble_coo_blocks(coords, tris, free, e_mod, nu, t, n)
        return (
            (keys // n).astype(np.int64),
            (keys % n).astype(np.int64),
            blocks,
        )
    ell_cols, slot_ids, width = ell_structure(tris, n)
    rows = np.repeat(np.arange(n, dtype=np.int64), width)
    cols = ell_cols.reshape(-1).astype(np.int64)
    fields = pair_block_fields(coords, tris, t, free, *dcoefs)
    return rows, cols, scatter_pair_blocks(fields, slot_ids, n * width)


def _coo_to_ell(rows, cols, vals, n_rows):
    """Block-COO (rows sorted) -> padded block-ELL. Padding slots use col 0
    with zero blocks (harmless in the gather-einsum matvec)."""
    counts = np.bincount(rows, minlength=n_rows)
    width = max(int(counts.max()) if counts.size else 1, 1)
    starts = np.searchsorted(rows, np.arange(n_rows))
    ranks = np.arange(rows.size) - starts[rows]
    mi, mj = vals.shape[1], vals.shape[2]
    ell_cols = np.zeros((n_rows, width), dtype=np.int32)
    ell_vals = np.zeros((n_rows, width, mi, mj), dtype=vals.dtype)
    ell_cols[rows, ranks] = cols
    ell_vals[rows, ranks] = vals
    return ell_cols, ell_vals


def _diag_blocks(rows, cols, vals, n):
    m = vals.shape[1]
    d = np.zeros((n, m, m), dtype=vals.dtype)
    on_diag = rows == cols
    # add.at: diagonal keys may appear twice (ELL padding emits zero blocks)
    np.add.at(d, rows[on_diag], vals[on_diag])
    return d


def _guarded_inverse(d):
    """Batched m x m inverse (closed-form adjugate, m in {2, 3}); singular
    blocks (fully constrained nodes, degenerate aggregates) invert to 0 so
    the smoother leaves them alone. SVD-free: this runs per level at setup
    time and batched pinv dominated the whole setup otherwise."""
    n, m, _ = d.shape
    if m == 2:
        a, b = d[:, 0, 0], d[:, 0, 1]
        c, e = d[:, 1, 0], d[:, 1, 1]
        det = a * e - b * c
        adj = np.empty_like(d)
        adj[:, 0, 0], adj[:, 0, 1] = e, -b
        adj[:, 1, 0], adj[:, 1, 1] = -c, a
    elif m == 3:
        # adjugate (transposed cofactors)
        c00 = d[:, 1, 1] * d[:, 2, 2] - d[:, 1, 2] * d[:, 2, 1]
        c01 = d[:, 1, 2] * d[:, 2, 0] - d[:, 1, 0] * d[:, 2, 2]
        c02 = d[:, 1, 0] * d[:, 2, 1] - d[:, 1, 1] * d[:, 2, 0]
        det = d[:, 0, 0] * c00 + d[:, 0, 1] * c01 + d[:, 0, 2] * c02
        adj = np.empty_like(d)
        adj[:, 0, 0] = c00
        adj[:, 1, 0] = c01
        adj[:, 2, 0] = c02
        adj[:, 0, 1] = d[:, 0, 2] * d[:, 2, 1] - d[:, 0, 1] * d[:, 2, 2]
        adj[:, 1, 1] = d[:, 0, 0] * d[:, 2, 2] - d[:, 0, 2] * d[:, 2, 0]
        adj[:, 2, 1] = d[:, 0, 1] * d[:, 2, 0] - d[:, 0, 0] * d[:, 2, 1]
        adj[:, 0, 2] = d[:, 0, 1] * d[:, 1, 2] - d[:, 0, 2] * d[:, 1, 1]
        adj[:, 1, 2] = d[:, 0, 2] * d[:, 1, 0] - d[:, 0, 0] * d[:, 1, 2]
        adj[:, 2, 2] = d[:, 0, 0] * d[:, 1, 1] - d[:, 0, 1] * d[:, 1, 0]
    else:  # pragma: no cover - block sizes are fixed by construction
        raise ValueError(f"unsupported block size {m}")
    # relative singularity guard: |det| tiny vs the block's scale -> 0
    scale = np.abs(d).reshape(n, -1).max(axis=1)
    bad = np.abs(det) <= 1e-12 * np.maximum(scale, 1e-300) ** m
    safe = np.where(bad, 1.0, det)
    inv = adj / safe[:, None, None]
    inv[bad] = 0.0
    return inv


def _estimate_rho_dinv_a(rows, cols, vals, diag_inv, n, iters=8, seed=0):
    """rho(D^-1 A) by power iteration (host, native block matvec)."""
    from ..native import coo_matvec_blocks

    rng = np.random.default_rng(seed)
    m = vals.shape[1]
    x = rng.standard_normal((n, m))
    x /= np.linalg.norm(x)
    rho = 1.0
    keys = rows * np.int64(n) + cols
    for _ in range(iters):
        y = coo_matvec_blocks(keys, vals, n, x)
        y = np.matmul(diag_inv, y[..., None])[..., 0]
        norm = np.linalg.norm(y)
        if norm == 0:
            return 1.0
        rho = norm
        x = y / norm
    return float(rho)


# Aggregates larger than this split into index-chunked sub-aggregates. The
# cell binning targets ~cell_factor^2 nodes per aggregate on quasi-uniform
# meshes; strongly GRADED meshes (characteristic_length_min << max) can pack
# thousands of finely-meshed nodes into one median-sized cell, and the
# padded per-aggregate QR would then allocate O(n_agg * max_size) memory.
_MAX_AGG_SIZE = 64


def _aggregate_cells(coords, cell):
    """Spatial cell aggregation: agg id per node + aggregate centroids."""
    mn = coords.min(axis=0)
    ix = np.floor((coords[:, 0] - mn[0]) / cell).astype(np.int64)
    iy = np.floor((coords[:, 1] - mn[1]) / cell).astype(np.int64)
    key = iy * (ix.max() + 1) + ix
    _, agg = np.unique(key, return_inverse=True)
    counts = np.bincount(agg)
    if counts.max() > _MAX_AGG_SIZE:
        # split oversized cells by position-in-cell chunks (spatially blind
        # within the cell, but bounded -- quality degrades only locally)
        order = np.argsort(agg, kind="stable")
        starts = np.searchsorted(agg[order], np.arange(counts.size))
        pos = np.empty(agg.size, dtype=np.int64)
        pos[order] = np.arange(agg.size) - starts[agg[order]]
        sub = pos // _MAX_AGG_SIZE
        _, agg = np.unique(agg * np.int64(sub.max() + 1) + sub, return_inverse=True)
    n_agg = int(agg.max()) + 1
    counts = np.bincount(agg, minlength=n_agg).astype(np.float64)
    cx = np.bincount(agg, coords[:, 0], minlength=n_agg) / counts
    cy = np.bincount(agg, coords[:, 1], minlength=n_agg) / counts
    return agg, np.stack([cx, cy], axis=-1)


def _tentative_prolongator(agg, n_agg, bmodes):
    """P0 + coarse near-nullspace by per-aggregate batched QR.

    bmodes: [n, m, 3] near-nullspace rows per node (zeroed at fixed DOFs).
    Returns (p0_block [n, m, 3] -- each node's single block, col = agg id,
    b_coarse [n_agg, 3, 3]).
    """
    n, m, nvec = bmodes.shape
    order = np.argsort(agg, kind="stable")
    counts = np.bincount(agg, minlength=n_agg)
    smax = int(counts.max())
    # padded stack [n_agg, smax*m, 3]; zero padding rows are QR-safe (their
    # Q rows reproduce zeros whenever R is used to reconstruct them)
    stacked = np.zeros((n_agg, smax * m, nvec))
    pos_in_agg = np.arange(n) - np.searchsorted(agg[order], np.arange(n_agg))[agg[order]]
    flat_rows = (pos_in_agg[:, None] * m + np.arange(m)[None, :]).reshape(-1)
    node_rows = np.repeat(order, m)
    agg_rows = np.repeat(agg[order], m)
    stacked[agg_rows, flat_rows] = bmodes[order].reshape(n * m, nvec)
    q, r = np.linalg.qr(stacked)  # q [n_agg, smax*m, 3], r [n_agg, 3, 3]
    p0 = np.zeros((n, m, nvec))
    p0[node_rows, np.tile(np.arange(m), n)] = q[agg_rows, flat_rows]
    return p0, r


def _smooth_prolongator(rows, cols, vals, diag_inv, agg, p0_block, n_agg, omega):
    """P = (I - omega D^-1 A) P0 in block-COO keyed (fine row, coarse col)."""
    from ..native import smooth_prolongator_blocks

    n = p0_block.shape[0]
    k, v = smooth_prolongator_blocks(
        rows * np.int64(n) + cols, vals, n, diag_inv, p0_block,
        agg, n_agg, omega,
    )
    return (k // n_agg).astype(np.int64), (k % n_agg).astype(np.int64), v


def _rap(
    arows, acols, avals, prows, pcols, pvals, n_agg, n_rows, filter_zeros=True
):
    """Galerkin product P^T A P in block-COO (native two-phase SpGEMM).

    A: [nnz_a] blocks (m x m); P: [nnz_p] blocks (m x mc), rows sorted.
    `filter_zeros=False` keeps the full structural pattern -- the
    material-basis RAPs share one pattern across bases and filter on the
    combined norms afterwards."""
    from ..native import rap_blocks

    n = int(n_rows)
    ck, cv = rap_blocks(
        arows * np.int64(n) + acols, avals, n,
        prows * np.int64(n_agg) + pcols, pvals, n_agg,
    )
    if not filter_zeros:
        return (
            (ck // n_agg).astype(np.int64),
            (ck % n_agg).astype(np.int64),
            cv,
        )
    return _rap_filter(ck, cv, n_agg)


def _rap_filter(ck, cv, n_agg):
    """Drop numerically-zero fill (padding products, cancellations) to keep
    the coarse ELL width tight; diagonal blocks always survive."""
    norms = np.abs(cv).reshape(cv.shape[0], -1).max(axis=1)
    cutoff = 1e-14 * (norms.max() if norms.size else 1.0)
    keep = norms > cutoff
    keep |= (ck // n_agg) == (ck % n_agg)
    ck, cv = ck[keep], cv[keep]
    return (
        (ck // n_agg).astype(np.int64),
        (ck % n_agg).astype(np.int64),
        cv,
    )


def mesh_state_hash(coords, tris, free) -> str:
    """sha1 identity of the mesh + BC free mask (the expensive part of any
    cache fingerprint: ~0.3 s over ~60 MB at 1M elements). Computed once
    per compile and shared by the AMG-hierarchy and assembled-operator
    cache checks."""
    import hashlib

    h = hashlib.sha1()
    h.update(np.int64(coords.shape[0]).tobytes())
    h.update(np.int64(tris.shape[0]).tobytes())
    h.update(np.ascontiguousarray(coords, np.float64).tobytes())
    h.update(np.ascontiguousarray(tris, np.int64).tobytes())
    h.update(np.ascontiguousarray(free, np.float64).tobytes())
    return h.hexdigest()


def setup_fingerprint(
    coords, tris, free, e_mod, nu, t, cell_factor, mesh_hash=None
) -> str:
    """Exact identity of everything a hierarchy build depends on: the full
    mesh bytes (renumbering changes them; a deterministic re-renumber of
    the same mesh reproduces them), the BC free mask, the material, and
    the aggregation cell factor. Pass a precomputed `mesh_hash`
    (mesh_state_hash) to skip re-hashing the mesh arrays."""
    import hashlib

    if mesh_hash is None:
        mesh_hash = mesh_state_hash(coords, tris, free)
    h = hashlib.sha1()
    h.update(mesh_hash.encode())
    h.update(np.asarray([e_mod, nu, t, cell_factor], np.float64).tobytes())
    return h.hexdigest()


def setup_matches(
    setup, coords, tris, free, metadata, cell_factor, perm, mesh_hash=None
) -> bool:
    """Is a provided AMGSetup valid for THIS problem (post-renumber mesh,
    BC mask, material, aggregation size)? Fingerprint-less caches from
    older saves fall back to a conservative check (no renumbering, same
    node count). The one validity rule shared by compile_problem and the
    sharded prepare -- a mismatched-but-SPD hierarchy would silently cost
    orders of magnitude in iterations. `mesh_hash`: optional precomputed
    mesh_state_hash of (coords, tris, free) to skip the ~0.3 s re-hash."""
    if setup.fingerprint is not None:
        return setup.fingerprint == setup_fingerprint(
            coords,
            tris,
            free,
            metadata.youngs_modulus,
            metadata.poisson_ratio,
            metadata.part_thickness,
            cell_factor,
            mesh_hash=mesh_hash,
        )
    return perm is None and setup.level_sizes[0][0] == coords.shape[0]


@dataclass
class AMGSetup:
    """Host-side hierarchy. Level 0's operator is NOT stored (the solver
    injects its fast reduced matvec); levels >= 1 carry block-ELL operators.

    `fingerprint` identifies the exact (mesh, node ordering) the hierarchy
    was built for (None on caches saved before it existed).

    transfers[l]: (p_cols [n_l, wp], p_vals [n_l, wp, m_l, m_{l+1}],
                   pt_cols [n_{l+1}, wr], pt_vals [n_{l+1}, wr, m_{l+1}, m_l])
    coarse_ops[l-1] for l >= 1: (a_cols [n_l, w], a_vals [n_l, w, m, m],
                                 diag_inv [n_l, m, m])
    coarsest_inv: dense pseudo-inverse of the last level (or None).

    fast0: gather-light FACTORED form of the level-0 transfer, or None.
    P = (I - omega D^-1 A) P0 is never materialized at level 0 by the
    device V-cycle when this is present; instead P/P^T applies ride the
    solver's fast band matvec (see make_amg_preconditioner). Contents:
      (agg [n0] int32            -- aggregate id per fine node,
       p0_block [n0, 2, 3]       -- each node's single tentative block,
       pt0_cols [n1, w0] int32   -- member fine nodes per aggregate (ELL),
       pt0_vals [n1, w0, 3, 2]   -- transposed tentative blocks,
       dinv0w [n0, 2, 2]         -- omega * D^-1 (smoothing pre-folded)).
    """

    transfers: list
    coarse_ops: list
    coarsest_inv: Optional[np.ndarray]
    level_sizes: list  # [(n_l, m_l)]
    setup_info: dict
    fingerprint: Optional[str] = None
    fast0: Optional[tuple] = None


def _fast0_arrays(agg, p0_block, diag_inv, omega, n_agg):
    """Factored level-0 transfer arrays (see AMGSetup.fast0).

    P0^T is stored as a tiny ELL over COARSE rows (width = max aggregate
    size, bounded by _MAX_AGG_SIZE) so the device restriction is a gather
    of the fine residual instead of a scatter."""
    n = p0_block.shape[0]
    counts = np.bincount(agg, minlength=n_agg)
    w0 = max(int(counts.max()) if counts.size else 1, 1)
    order = np.argsort(agg, kind="stable")
    starts = np.searchsorted(agg[order], np.arange(n_agg))
    ranks = np.empty(n, dtype=np.int64)
    ranks[order] = np.arange(n) - starts[agg[order]]
    pt0_cols = np.zeros((n_agg, w0), dtype=np.int32)
    pt0_vals = np.zeros((n_agg, w0, 3, 2))
    pt0_cols[agg, ranks] = np.arange(n, dtype=np.int32)
    pt0_vals[agg, ranks] = p0_block.transpose(0, 2, 1)
    return (
        agg.astype(np.int32),
        np.ascontiguousarray(p0_block),
        pt0_cols,
        pt0_vals,
        omega * diag_inv,
    )


def build_amg_setup(
    coords: np.ndarray,
    tris: np.ndarray,
    e_mod: float,
    nu: float,
    t: float,
    free: np.ndarray,  # [N, 2] float or bool, 1 = unknown DOF
    *,
    cell_factor: float = 3.0,
    max_levels: int = 8,
    coarse_dof: int = _DENSE_COARSE_MAX_DOF,
    mesh_hash: Optional[str] = None,
) -> AMGSetup:
    """Build the SA hierarchy for one mesh + BC set (host, numpy)."""
    coords = np.asarray(coords, dtype=np.float64)
    free = np.asarray(free, dtype=np.float64)
    n = coords.shape[0]

    rows, cols, vals = _assemble_block_coo(
        coords, tris, float(e_mod), float(nu), float(t), free
    )

    # rigid-body near-nullspace, zeroed at fixed DOFs; coordinates centered
    # for conditioning of the per-aggregate QR
    c0 = coords - coords.mean(axis=0)
    bmodes = np.zeros((n, 2, 3))
    bmodes[:, 0, 0] = 1.0
    bmodes[:, 1, 1] = 1.0
    bmodes[:, 0, 2] = -c0[:, 1]
    bmodes[:, 1, 2] = c0[:, 0]
    bmodes *= free[:, :, None]

    p = coords[tris]
    h = float(
        np.median(
            np.concatenate(
                [
                    np.hypot(*(p[:, 0] - p[:, 1]).T),
                    np.hypot(*(p[:, 1] - p[:, 2]).T),
                    np.hypot(*(p[:, 2] - p[:, 0]).T),
                ]
            )
        )
    )
    cell = cell_factor * h

    transfers = []
    coarse_ops = []
    level_sizes = [(n, 2)]
    cur_coords = coords
    m = 2
    info = {"omegas": [], "rhos": []}
    fast0 = None

    while len(level_sizes) < max_levels and level_sizes[-1][0] * m > coarse_dof:
        n_l = level_sizes[-1][0]
        agg, centroids = _aggregate_cells(cur_coords, cell)
        n_agg = centroids.shape[0]
        if n_agg * 3 >= n_l * m:  # coarsening stalled; stop here
            break
        p0_block, b_coarse = _tentative_prolongator(agg, n_agg, bmodes)
        diag_inv = _guarded_inverse(_diag_blocks(rows, cols, vals, n_l))
        rho = _estimate_rho_dinv_a(rows, cols, vals, diag_inv, n_l)
        omega = 4.0 / 3.0 / max(rho, 1e-12)
        info["rhos"].append(rho)
        info["omegas"].append(omega)
        if len(level_sizes) == 1:
            fast0 = _fast0_arrays(agg, p0_block, diag_inv, omega, n_agg)
        prows, pcols, pvals = _smooth_prolongator(
            rows, cols, vals, diag_inv, agg, p0_block, n_agg, omega
        )
        p_cols, p_vals = _coo_to_ell(prows, pcols, pvals, n_l)
        # P^T in ELL by coarse row: transpose the COO and re-sort
        tk, tv = _reduce_block_coo(
            pcols * np.int64(n_l) + prows, pvals.transpose(0, 2, 1)
        )
        pt_cols, pt_vals = _coo_to_ell(
            (tk // n_l).astype(np.int64), (tk % n_l).astype(np.int64), tv, n_agg
        )
        transfers.append((p_cols, p_vals, pt_cols, pt_vals))

        rows, cols, vals = _rap(
            rows, cols, vals, prows, pcols, pvals, n_agg, n_rows=n_l
        )
        a_cols, a_vals = _coo_to_ell(rows, cols, vals, n_agg)
        d_inv = _guarded_inverse(_diag_blocks(rows, cols, vals, n_agg))
        coarse_ops.append((a_cols, a_vals, d_inv))

        bmodes = b_coarse
        cur_coords = centroids
        m = 3
        level_sizes.append((n_agg, m))
        cell *= cell_factor

    coarsest_inv = None
    nl, ml = level_sizes[-1]
    # also when the mesh never coarsened (tiny meshes, n*2 <= coarse_dof):
    # rows/cols/vals then hold the level-0 BC-masked assembly and the
    # "hierarchy" is one exact dense inverse -- CG converges in ~2
    # iterations instead of the O(1/h) block-Jacobi counts
    # (make_amg_preconditioner's single-level ci branch)
    if nl * ml <= coarse_dof:
        dense = np.zeros((nl, ml, nl, ml))
        dense[rows, :, cols, :] = vals
        dense = dense.reshape(nl * ml, nl * ml)
        # degenerate coarse DOFs (fully-constrained/empty aggregates) have
        # ~zero rows; invert the ACTIVE submatrix and leave those DOFs at
        # exactly 0 -- matching _guarded_inverse semantics. (A jittered
        # full inverse would carry ~1/jitter-scale entries there, which
        # amplify f32 V-cycle roundoff instead of annihilating it.)
        diag = np.diagonal(dense)
        active = diag > 1e-12 * max(float(diag.max()), 1e-300)
        coarsest_inv = np.zeros_like(dense)
        try:
            # SPD block: Cholesky-based inversion (potrf+potri) is ~2x
            # np.linalg.inv's LU path at the ~1.5k-DOF coarse size
            from scipy.linalg.lapack import dpotrf, dpotri

            sub = dense[np.ix_(active, active)]
            chol, rc = dpotrf(sub, lower=1, overwrite_a=0)
            if rc != 0:
                raise np.linalg.LinAlgError
            inv, rc = dpotri(chol, lower=1)
            if rc != 0:
                raise np.linalg.LinAlgError
            # dpotri fills one triangle; mirror it
            inv = np.tril(inv) + np.tril(inv, -1).T
            coarsest_inv[np.ix_(active, active)] = inv
        except (np.linalg.LinAlgError, ImportError):
            try:
                coarsest_inv[np.ix_(active, active)] = np.linalg.inv(
                    dense[np.ix_(active, active)]
                )
            except np.linalg.LinAlgError:
                # truly singular active block: iterative smoothing instead
                coarsest_inv = None

    info["levels"] = level_sizes
    return AMGSetup(
        transfers=transfers,
        coarse_ops=coarse_ops,
        coarsest_inv=coarsest_inv,
        level_sizes=level_sizes,
        setup_info=info,
        fingerprint=setup_fingerprint(
            coords, tris, free, float(e_mod), float(nu), float(t),
            float(cell_factor), mesh_hash=mesh_hash,
        ),
        fast0=fast0,
    )


# ------------------- material-basis hierarchy (sweeps) ----------------------
#
# True (E, nu, t) material sweeps on unstructured meshes: the plane-stress
# D matrix is linear in (d0, d1, d2), so THREE basis stiffness operators
# (unit d0 / d1 / d2, t = 1) span every material:
#     K(E, nu, t) = wa*Ka + wb*Kb + wc*Kc,
#     wa = t*E/(1-nu^2), wb = nu*wa, wc = (1-nu)/2*wa.
# Transfers P are built ONCE at a reference material (P quality only
# affects preconditioner efficiency, never correctness), and the Galerkin
# product is linear in A, so RAP-ing each basis with the same P carries the
# decomposition down every level EXACTLY: each lane's coarse operator is
# wa*PtAaP + wb*PtAbP + wc*PtAcP. Per-lane diagonal-block inverses are
# formed on the fly in the lane smoother (parallel/sweep.py).

_UNIT_DCOEFS = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


@dataclass
class AMGMaterialSetup:
    """Basis-decomposed hierarchy for material-lane sweeps.

    transfers: as AMGSetup (shared by all bases).
    coarse_basis[l] for coarse level l: (a_cols [n,w],
        (av_a, av_b, av_c) each [n, w, m, m] basis operator values on ONE
        shared pattern, (d_a, d_b, d_c) each [n, m, m] basis diagonals).
    No dense coarsest inverse (it would be material-dependent); the
    coarsest level smooths.
    """

    transfers: list
    coarse_basis: list
    level_sizes: list
    setup_info: dict
    fingerprint: Optional[str] = None


def build_amg_material_setup(
    coords: np.ndarray,
    tris: np.ndarray,
    free: np.ndarray,  # [N, 2] float or bool, 1 = unknown DOF
    *,
    nu_ref: float = 0.3,
    cell_factor: float = 3.0,
    max_levels: int = 8,
    coarse_dof: int = _DENSE_COARSE_MAX_DOF,
) -> AMGMaterialSetup:
    """Build the shared-transfer basis hierarchy (host, numpy).

    `nu_ref` fixes the reference material for prolongator smoothing and
    aggregation; absolute stiffness scale cancels (rho(D^-1 A) is
    scale-invariant), so only the Poisson ratio matters and mild lane
    deviations cost a few extra CG iterations, never correctness."""
    coords = np.asarray(coords, dtype=np.float64)
    free = np.asarray(free, dtype=np.float64)
    n = coords.shape[0]

    triples = [
        _assemble_block_coo(coords, tris, 0.0, 0.0, 1.0, free, dcoefs=dc)
        for dc in _UNIT_DCOEFS
    ]
    rows, cols = triples[0][0], triples[0][1]
    vals3 = [t[2] for t in triples]
    d0r = 1.0 / (1.0 - nu_ref * nu_ref)
    wref = (d0r, nu_ref * d0r, 0.5 * (1.0 - nu_ref) * d0r)

    c0 = coords - coords.mean(axis=0)
    bmodes = np.zeros((n, 2, 3))
    bmodes[:, 0, 0] = 1.0
    bmodes[:, 1, 1] = 1.0
    bmodes[:, 0, 2] = -c0[:, 1]
    bmodes[:, 1, 2] = c0[:, 0]
    bmodes *= free[:, :, None]

    p = coords[tris]
    h = float(
        np.median(
            np.concatenate(
                [
                    np.hypot(*(p[:, 0] - p[:, 1]).T),
                    np.hypot(*(p[:, 1] - p[:, 2]).T),
                    np.hypot(*(p[:, 2] - p[:, 0]).T),
                ]
            )
        )
    )
    cell = cell_factor * h

    transfers = []
    coarse_basis = []
    level_sizes = [(n, 2)]
    cur_coords = coords
    m = 2
    info = {"omegas": [], "rhos": []}

    while len(level_sizes) < max_levels and level_sizes[-1][0] * m > coarse_dof:
        n_l = level_sizes[-1][0]
        vals_ref = wref[0] * vals3[0] + wref[1] * vals3[1] + wref[2] * vals3[2]
        agg, centroids = _aggregate_cells(cur_coords, cell)
        n_agg = centroids.shape[0]
        if n_agg * 3 >= n_l * m:
            break
        p0_block, b_coarse = _tentative_prolongator(agg, n_agg, bmodes)
        diag_inv = _guarded_inverse(_diag_blocks(rows, cols, vals_ref, n_l))
        rho = _estimate_rho_dinv_a(rows, cols, vals_ref, diag_inv, n_l)
        omega = 4.0 / 3.0 / max(rho, 1e-12)
        info["rhos"].append(rho)
        info["omegas"].append(omega)
        prows, pcols, pvals = _smooth_prolongator(
            rows, cols, vals_ref, diag_inv, agg, p0_block, n_agg, omega
        )
        p_cols, p_vals = _coo_to_ell(prows, pcols, pvals, n_l)
        tk, tv = _reduce_block_coo(
            pcols * np.int64(n_l) + prows, pvals.transpose(0, 2, 1)
        )
        pt_cols, pt_vals = _coo_to_ell(
            (tk // n_l).astype(np.int64), (tk % n_l).astype(np.int64), tv, n_agg
        )
        transfers.append((p_cols, p_vals, pt_cols, pt_vals))

        # basis RAPs on ONE shared pattern (filtering on combined norms)
        raps = [
            _rap(
                rows, cols, v, prows, pcols, pvals, n_agg, n_rows=n_l,
                filter_zeros=False,
            )
            for v in vals3
        ]
        crows, ccols = raps[0][0], raps[0][1]
        for r2, c2, _ in raps[1:]:
            assert np.array_equal(crows, r2) and np.array_equal(ccols, c2)
        cvals3 = [r[2] for r in raps]
        comb = wref[0] * cvals3[0] + wref[1] * cvals3[1] + wref[2] * cvals3[2]
        norms = np.abs(comb).reshape(comb.shape[0], -1).max(axis=1)
        keep = norms > 1e-14 * (norms.max() if norms.size else 1.0)
        keep |= crows == ccols
        rows, cols = crows[keep], ccols[keep]
        vals3 = [v[keep] for v in cvals3]

        a_cols = None
        a_vals3 = []
        diag3 = []
        for v in vals3:
            ac, av = _coo_to_ell(rows, cols, v, n_agg)
            a_cols = ac
            a_vals3.append(av)
            diag3.append(_diag_blocks(rows, cols, v, n_agg))
        coarse_basis.append((a_cols, tuple(a_vals3), tuple(diag3)))

        bmodes = b_coarse
        cur_coords = centroids
        m = 3
        level_sizes.append((n_agg, m))
        cell *= cell_factor

    info["levels"] = level_sizes
    return AMGMaterialSetup(
        transfers=transfers,
        coarse_basis=coarse_basis,
        level_sizes=level_sizes,
        setup_info=info,
        fingerprint=setup_fingerprint(
            coords, tris, free, 0.0, float(nu_ref), 1.0, float(cell_factor)
        ),
    )


# =========================== device V-cycle =================================


# distinct (col - row) offsets a coarse level may use before falling back
# to the gather ELL path; bands cost D*m*m*n floats of HBM, so a cap keeps
# pathological (band-hostile) coarse graphs from exploding the upload
_COARSE_MAX_DIAGS = 80


def _ell_to_bands(a_cols, a_vals, max_diags: int = _COARSE_MAX_DIAGS):
    """Block-ELL -> (offsets, DIA bands [D, m, m, n]), or None if the
    graph needs more than max_diags distinct (col - row) offsets.

    Aggregate ids are spatially row-major (_aggregate_cells keys cells by
    iy*nx+ix), so coarse graphs inherit the fine level's bandedness; the
    gather-bound ELL matvec then has a gather-free DIA equivalent, which
    the m = 3 band kernel runs (kernels/dia_kernel.py, csrc/dia_matvec.cu;
    its times beside cuSPARSE's are in PERF.md).
    Zero blocks (ELL padding sits at col 0) are dropped -- they contribute
    nothing and would otherwise smear padding offsets into the band set.
    """
    n, w = a_cols.shape[:2]
    m = a_vals.shape[2]
    rows = np.arange(n, dtype=np.int64)[:, None]
    offs = a_cols.astype(np.int64) - rows
    nz = np.abs(a_vals).reshape(n, w, -1).max(axis=2) > 0.0
    uniq = np.unique(offs[nz])
    if uniq.size == 0 or uniq.size > max_diags:
        return None
    bands = np.zeros((uniq.size, m, m, n), dtype=a_vals.dtype)
    d_idx = np.searchsorted(uniq, offs[nz])
    r_idx = np.broadcast_to(rows, offs.shape)[nz]
    # add.at, not assignment: nothing above guarantees (row, col) slots
    # are unique in the ELL
    np.add.at(bands, (d_idx, slice(None), slice(None), r_idx), a_vals[nz])
    return tuple(int(o) for o in uniq), bands


# ============================ persistence ===================================


def setup_to_arrays(setup: AMGSetup) -> dict:
    """Flatten an AMGSetup into a {name: array} dict (npz-friendly).

    The hierarchy build is the dominant host cost for large unstructured
    meshes (~50 s at 1M elements on one core); persisting it with the case
    checkpoint makes re-runs start solving immediately."""
    out = {
        "amg_n_transfers": np.int64(len(setup.transfers)),
        "amg_level_sizes": np.asarray(setup.level_sizes, dtype=np.int64),
    }
    if setup.fingerprint is not None:
        out["amg_fingerprint"] = np.asarray(setup.fingerprint)
    for l, (pc, pv, tc, tv) in enumerate(setup.transfers):
        out[f"amg_t{l}_pcols"] = pc
        out[f"amg_t{l}_pvals"] = pv
        out[f"amg_t{l}_ptcols"] = tc
        out[f"amg_t{l}_ptvals"] = tv
    for l, (ac, av, di) in enumerate(setup.coarse_ops):
        out[f"amg_c{l}_acols"] = ac
        out[f"amg_c{l}_avals"] = av
        out[f"amg_c{l}_dinv"] = di
    if setup.coarsest_inv is not None:
        out["amg_coarsest_inv"] = setup.coarsest_inv
    if setup.fast0 is not None:
        agg, p0, ptc, ptv, dw = setup.fast0
        out["amg_f0_agg"] = agg
        out["amg_f0_p0"] = p0
        out["amg_f0_ptcols"] = ptc
        out["amg_f0_ptvals"] = ptv
        out["amg_f0_dinvw"] = dw
    return out


def setup_from_arrays(data: dict) -> AMGSetup:
    """Inverse of `setup_to_arrays`."""
    n = int(data["amg_n_transfers"])
    transfers = [
        (
            data[f"amg_t{l}_pcols"],
            data[f"amg_t{l}_pvals"],
            data[f"amg_t{l}_ptcols"],
            data[f"amg_t{l}_ptvals"],
        )
        for l in range(n)
    ]
    coarse = [
        (data[f"amg_c{l}_acols"], data[f"amg_c{l}_avals"], data[f"amg_c{l}_dinv"])
        for l in range(n)
    ]
    sizes = [tuple(int(v) for v in row) for row in data["amg_level_sizes"]]
    fp = data.get("amg_fingerprint")
    fast0 = None
    if "amg_f0_agg" in data:
        fast0 = (
            data["amg_f0_agg"],
            data["amg_f0_p0"],
            data["amg_f0_ptcols"],
            data["amg_f0_ptvals"],
            data["amg_f0_dinvw"],
        )
    return AMGSetup(
        transfers=transfers,
        coarse_ops=coarse,
        coarsest_inv=data.get("amg_coarsest_inv"),
        level_sizes=sizes,
        setup_info={"loaded": True},
        fingerprint=None if fp is None else str(fp),
        fast0=fast0,
    )


# =========================== device V-cycle =================================


@dataclass
class BandedOp:
    """A coarse operator in DIA form on the device: bands [D, m, m, n]."""

    bands: torch.Tensor
    offsets: tuple


@dataclass
class AMGDeviceArrays:
    """The hierarchy as device tensors, as the V-cycle applies it.

    transfers[l]: (p_cols, p_vals, pt_cols, pt_vals) between coarse levels
        l and l + 1 (the level-0 pair is applied in factored form, `fast0`).
    coarse[l]: (a_cols, a_vals, d_inv); the ELL pair is None on levels
        that run on bands (coarse_bands[l] is then a BandedOp).
    ci: dense inverse of the coarsest level, or None.
    fast0: (agg [n0] i32, p0 [n0, 2, 3], pt0_cols [n1, w0] i32,
        pt0_vals [n1, w0, 3, 2], omega*D^-1 as [2, 2, n0]), or None on a
        single-level hierarchy.
    """

    n_levels: int
    transfers: tuple
    coarse: tuple
    coarse_bands: tuple
    ci: Optional[torch.Tensor]
    fast0: Optional[tuple]


def _uploaders(dtype, device):
    """(val, idx): one host-to-device copy of a value array (cast to
    `dtype` on the host first) or of an index array. A read-only array (a
    memory-mapped cache file already in that dtype) is only read."""
    np_dtype = np.dtype(str(dtype).replace("torch.", ""))

    def upload(a, dt):
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)

    def val(a):
        return upload(a, np_dtype)

    def idx(a, dt=np.int64):
        return upload(a, dt)

    return val, idx


def amg_device_arrays(
    setup: AMGSetup,
    dtype,
    device,
    coarse_max_diags: int = _COARSE_MAX_DIAGS,
    level0: bool = True,
) -> AMGDeviceArrays:
    """Upload the hierarchy: one host-to-device copy per array (values cast
    to `dtype` on the host first). Coarse levels with at most
    `coarse_max_diags` distinct offsets are stored as bands only; the rest
    keep their block-ELL form. Lane-batched consumers (design sweeps, fields
    [2, N, B]) pass 0: every coarse level stays block-ELL and the lane axis
    rides through the gather. `level0=False` leaves out the level-0
    transfer (`fast0` None): the sharded V-cycle holds its own per shard
    (parallel/dia_shard.py) and uploads only the levels below."""
    val, idx = _uploaders(dtype, device)
    n_levels = len(setup.transfers) + 1
    if level0 and n_levels > 1 and setup.fast0 is None:
        raise SolverError(
            "AMG hierarchy lacks the factored level-0 transfers (a cache "
            "saved before they existed); the ELL level-0 transfer pair is "
            "not ported -- rebuild the hierarchy"
        )
    transfers = tuple(
        (idx(pc), val(pv), idx(tc), val(tv))
        for pc, pv, tc, tv in setup.transfers[1:]
    )
    coarse, coarse_bands = [], []
    for ac, av, di in setup.coarse_ops:
        spec = _ell_to_bands(ac, av, coarse_max_diags)
        if spec is None:
            coarse.append((idx(ac), val(av), val(di)))
            coarse_bands.append(None)
        else:
            coarse.append((None, None, val(di)))
            coarse_bands.append(BandedOp(val(spec[1]), spec[0]))
    ci = None if setup.coarsest_inv is None else val(setup.coarsest_inv)
    fast0 = None
    if level0 and setup.fast0 is not None and n_levels > 1:
        agg, p0, ptc, ptv, dw = setup.fast0
        fast0 = (
            idx(agg, np.int32),
            val(p0),
            idx(ptc, np.int32),
            val(ptv),
            val(np.asarray(dw).transpose(1, 2, 0)),
        )
    return AMGDeviceArrays(
        n_levels=n_levels,
        transfers=transfers,
        coarse=tuple(coarse),
        coarse_bands=tuple(coarse_bands),
        ci=ci,
        fast0=fast0,
    )


def material_amg_device_arrays(
    setup: AMGMaterialSetup, dtype, device
) -> tuple:
    """Upload the basis hierarchy: (transfers, coarse) with transfers[l] =
    (p_cols, p_vals, pt_cols, pt_vals) and coarse[l] = (a_cols,
    (av_a, av_b, av_c), (d_a, d_b, d_c))."""
    val, idx = _uploaders(dtype, device)
    transfers = tuple(
        (idx(pc), val(pv), idx(tc), val(tv)) for pc, pv, tc, tv in setup.transfers
    )
    coarse = tuple(
        (idx(ac), tuple(val(a) for a in av3), tuple(val(d) for d in d3))
        for ac, av3, d3 in setup.coarse_basis
    )
    return transfers, coarse


@contextmanager
def ieee_f32():
    """Matrix products inside run in full f32 (or f64), never TF32, whatever
    the caller's global setting: the JAX package asks XLA for
    precision="highest" on every contraction of the V-cycle, and a TF32
    coarse correction (~3 decimal digits) stalls CG."""
    prev = torch.get_float32_matmul_precision()
    if prev == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _block_ell_matvec(a_cols, a_vals, x):
    """y[n, i(, b)] = sum_w a_vals[n, w, i, j] x[a_cols[n, w], j(, b)]: one
    gather and one block contraction; x [n, m] or lane-batched [n, m, B]."""
    with ieee_f32():
        if x.dim() == 3:
            return torch.einsum("nwij,nwjb->nib", a_vals, x[a_cols])
        return torch.einsum("nwij,nwj->ni", a_vals, x[a_cols])


def _apply_blocks(blocks, x):
    """Per-node block products: blocks [n, i, j] times x [n, j(, B)]."""
    with ieee_f32():
        if x.dim() == 3:
            return torch.einsum("nij,njb->nib", blocks, x)
        return torch.einsum("nij,nj->ni", blocks, x)


def _dense_apply(dense, r):
    """dense [n*m, n*m] times r [n, m(, B)] in node-major flattening."""
    with ieee_f32():
        return torch.matmul(dense, r.reshape(r.shape[0] * r.shape[1], -1)).reshape(r.shape)


def make_amg_preconditioner(
    amg: AMGDeviceArrays,
    op0: MatVec,
    jac0: MatVec,
    *,
    a_op: MatVec,
    sweeps: int = 1,
) -> MatVec:
    """V(sweeps, sweeps)-cycle apply(r) ~= A^-1 r, for r in the [2, N] band
    layout or the lane-batched [2, N, B] layout of design sweeps (ONE
    hierarchy preconditions every lane; the lane axis rides minormost
    through every level).

    op0 / jac0: the REDUCED level-0 operator and its block-Jacobi inverse,
    in r's layout. a_op: the unshifted masked operator A = free * K * free,
    through which the factored smoothed prolongator P = (I - omega D^-1 A)
    P0 is applied; P^T rides the mirrored composition
    P^T r = P0^T (r - A (omega D^-1) r), so the pair stays an exact
    adjoint. Single vectors move through P0 / P0^T by the CUDA transfer
    kernels on the card; lane fields by gathers, as in the JAX package.
    """
    cycle = make_coarse_cycle(amg.transfers, amg.coarse, amg.ci, amg.coarse_bands)
    ci = amg.ci

    if amg.n_levels > 1:
        agg, p0, pt0_cols, pt0_vals, dw = amg.fast0

        def dinv_apply(v):  # omega * D^-1 in v's layout
            w = dw if v.dim() == 2 else dw[..., None]
            return torch.stack(
                [w[0, 0] * v[0] + w[0, 1] * v[1], w[1, 0] * v[0] + w[1, 1] * v[1]]
            )

        def restrict(res):  # P^T res -> [n1, 3(, B)]
            tmp = res - a_op(dinv_apply(res))
            if tmp.dim() == 2:
                return restrict0(tmp, pt0_cols, pt0_vals)
            return _block_ell_matvec(pt0_cols, pt0_vals, tmp.transpose(0, 1))

        def prolong(ec):  # P ec -> [2, N(, B)]
            if ec.dim() == 2:
                uf = prolong0(ec, agg, p0)
            else:
                uf = _apply_blocks(p0, ec[agg]).transpose(0, 1)
            return uf - dinv_apply(a_op(uf))

    def apply(r):
        if amg.n_levels == 1:
            if ci is not None:
                # single-level hierarchy with a dense inverse (small
                # problems that never coarsened): exact preconditioner,
                # applied in node-major DOF order
                return _dense_apply(ci, r.transpose(0, 1)).transpose(0, 1).contiguous()
            return OMEGA * jac0(r)
        e = OMEGA * jac0(r)
        for _ in range(sweeps - 1):
            e = e + OMEGA * jac0(r - op0(e))
        res = r - op0(e)
        ec = cycle(0, restrict(res))
        e = e + prolong(ec)
        for _ in range(sweeps):
            e = e + OMEGA * jac0(r - op0(e))
        return e

    return apply


def make_coarse_cycle(
    transfers_tail: tuple,
    coarse: tuple,
    ci: Optional[torch.Tensor],
    coarse_bands: tuple,
):
    """The V(1, 1)-cycle below the fine level: cycle(l, r) with r
    [n_{l+1}, m] (or lane-batched [n_{l+1}, m, B]) node-major at coarse
    index l (0 = the first coarse level); transfers_tail[l] connects coarse
    levels l and l + 1. Banded levels run the DIA operator (the CUDA kernel
    on the card, m = 3); lane-batched hierarchies carry no bands. Without a
    dense inverse the coarsest level takes COARSE_SWEEPS smoothing sweeps."""
    n_coarse = len(coarse)
    band_ops = [
        None if cb is None else make_dia_operator(cb.bands, cb.offsets)
        for cb in coarse_bands
    ]

    def _matvec(l, x):
        if band_ops[l] is not None:
            return band_ops[l](x.T).T
        a_cols, a_vals, _ = coarse[l]
        return _block_ell_matvec(a_cols, a_vals, x)

    def smooth(l, e, r, sweeps):
        d_inv = coarse[l][2]
        for _ in range(sweeps):
            e = e + OMEGA * _apply_blocks(d_inv, r - _matvec(l, e))
        return e

    def cycle(l, r):
        if l == n_coarse - 1:
            if ci is not None:
                return _dense_apply(ci, r)
            return smooth(l, torch.zeros_like(r), r, COARSE_SWEEPS)
        e = OMEGA * _apply_blocks(coarse[l][2], r)
        res = r - _matvec(l, e)
        tp_cols, tp_vals, tpt_cols, tpt_vals = transfers_tail[l]
        ec = cycle(l + 1, _block_ell_matvec(tpt_cols, tpt_vals, res))
        e = e + _block_ell_matvec(tp_cols, tp_vals, ec)
        return smooth(l, e, r, 1)

    return cycle
