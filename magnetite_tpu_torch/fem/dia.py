"""DIA (diagonal-band) sparse operator: host structure builders and the
PyTorch operators over them (port of magnetite_tpu/fem/dia.py).

The host builders are copies of the JAX package's, with the native C++
builder required (no numpy fallback). On the card the band matvec is the
hand-written CUDA kernel (kernels/dia_kernel.py), and the fused device
assembly (`assemble_dia_fused`, `assemble_hybrid_fused`) the assembly
kernels (kernels/assembly_kernel.py); on the CPU their plain PyTorch
versions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels.df_kernel import (  # noqa: F401
    df_dia_matvec,
    df_dia_matvec_plain,
    df_split,
    split_bands,
)
from ..kernels.assembly_kernel import assemble_pairs
from ..kernels.dia_kernel import dia_matvec, dia_matvec_blocks  # noqa: F401
from .blocks import apply_blocks, guarded_inv2, reduce_diag_blocks


@dataclass
class DiaStructure:
    """Static band pattern of the global stiffness matrix.

    offsets:  [D] int64, sorted distinct values of (col - row).
    slot_ids: [E*9] int32, destination band*N + row for each element block.
    n_nodes, n_diags: dimensions.
    """

    offsets: np.ndarray
    slot_ids: np.ndarray
    n_nodes: int
    n_diags: int


def build_dia_structure(
    tris: np.ndarray, n_nodes: int, max_diags: int = 48
) -> Optional[DiaStructure]:
    """Build the DIA pattern, or None if the mesh needs > max_diags bands."""
    from ..native import dia_structure as native_dia

    native = native_dia(np.asarray(tris), int(n_nodes), max_diags)
    if native is False:
        return None
    offsets, slot_ids = native
    return DiaStructure(
        offsets=offsets,
        slot_ids=slot_ids,
        n_nodes=int(n_nodes),
        n_diags=int(offsets.size),
    )


@dataclass
class HybridStructure:
    """DIA bands for the dominant offsets + a small COO remainder.

    offsets: [D] chosen band offsets (0 always included).
    slot_ids: [E*9] destinations: band slots in [0, D*N), remainder blocks
              at D*N + r.
    rem_rows/rem_cols: [R] node indices of the remainder blocks.
    """

    offsets: np.ndarray
    slot_ids: np.ndarray
    rem_rows: np.ndarray
    rem_cols: np.ndarray
    n_nodes: int
    n_diags: int

    @property
    def n_rem(self) -> int:
        return int(self.rem_rows.size)


def build_hybrid_structure(
    tris: np.ndarray, n_nodes: int, max_diags: int = 48
) -> HybridStructure:
    """Band + remainder pattern: top offsets by coupling count, chosen in
    SIGN-SYMMETRIC +/- pairs (every offset appears with its mirror and the
    mirror's count is identical -- ordered pair enumeration)."""
    tris = np.asarray(tris, dtype=np.int64)
    rows = np.repeat(tris, 3, axis=1).reshape(-1)
    cols = np.tile(tris, (1, 3)).reshape(-1)
    offs = cols - rows
    uniq, inverse, counts = np.unique(offs, return_inverse=True, return_counts=True)

    nonneg = np.where(uniq >= 0)[0]
    ranked = nonneg[np.argsort(-counts[nonneg], kind="stable")]
    budget = int(max_diags)
    chosen_list = []
    for idx in ranked:
        off = int(uniq[idx])
        cost = 1 if off == 0 else 2
        if budget < cost:
            continue
        chosen_list.append(off)
        if off != 0:
            chosen_list.append(-off)
        budget -= cost
    if 0 not in chosen_list:  # diagonal blocks always exist; keep offset 0
        chosen_list = [0] + chosen_list[: max_diags - 1]
    chosen_offsets = np.sort(np.array(chosen_list, dtype=uniq.dtype))

    in_band = np.isin(uniq, chosen_offsets)[inverse]
    d_idx = np.searchsorted(chosen_offsets, offs)
    band_slots = d_idx * n_nodes + rows

    # remainder: unique (row, col) blocks among out-of-band pairs
    rem_keys = rows[~in_band] * np.int64(n_nodes) + cols[~in_band]
    rem_uniq, rem_inv = np.unique(rem_keys, return_inverse=True)
    d = chosen_offsets.size
    slot_ids = np.where(in_band, band_slots, 0)
    slot_ids[~in_band] = d * n_nodes + rem_inv

    return HybridStructure(
        offsets=chosen_offsets,
        slot_ids=slot_ids.astype(np.int64),
        rem_rows=(rem_uniq // n_nodes).astype(np.int32),
        rem_cols=(rem_uniq % n_nodes).astype(np.int32),
        n_nodes=int(n_nodes),
        n_diags=int(d),
    )


def assemble_dia_fused(coords, tris, e_mod, nu, t, slot_ids, n_nodes: int, n_diags: int,
                       dtype=torch.float64) -> torch.Tensor:
    """Device assembly of the band operator from the resident mesh: f64
    coords [N, 2], int64 tris [E, 3], the structure's slot ids [E*9] ->
    bands [D, 2, 2, N] in `dtype` (summed in f64). Four scalar scatters of
    closed-form pair fields (the JAX package's `assemble_dia_fused`), the
    assembly kernels on the card."""
    return assemble_pairs(coords, tris, slot_ids, n_nodes, n_diags, e_mod, nu, t,
                          dtype=dtype)[0]


def assemble_hybrid_fused(coords, tris, e_mod, nu, t, slot_ids, n_nodes: int, n_diags: int,
                          n_rem: int, dtype=torch.float64):
    """The hybrid format's device assembly -> (bands [D, 2, 2, N], rem
    [R, 2, 2]) in `dtype`."""
    return assemble_pairs(coords, tris, slot_ids, n_nodes, n_diags, e_mod, nu, t, n_rem=n_rem,
                          dtype=dtype)


def dia_diag_blocks(bands: torch.Tensor, offsets) -> torch.Tensor:
    """The diagonal blocks, [m, m, N] (offset-0 band)."""
    return bands[tuple(offsets).index(0)]


def make_dia_operator(bands: torch.Tensor, offsets):
    """op(u [m, N]) -> K u: the CUDA kernel for card tensors, the plain
    version for CPU tensors. The int32 offsets ride along on the card once."""
    offs = tuple(int(o) for o in offsets)
    offsets_dev = (
        torch.tensor(offs, dtype=torch.int32, device=bands.device)
        if bands.is_cuda
        else None
    )

    def op(u: torch.Tensor) -> torch.Tensor:
        return dia_matvec(bands, offs, u, offsets_dev)

    return op


def make_hybrid_operator(
    bands: torch.Tensor,
    offsets,
    rem_vals: torch.Tensor,  # [R, 2, 2]
    rem_rows: torch.Tensor,  # [R]
    rem_cols: torch.Tensor,  # [R]
    dia_op=None,
):
    """op(u [2, N]) -> K u for the band + COO-remainder format: the band
    part through `dia_op` (default make_dia_operator; the double-float
    operator plugs in here), the remainder as a gather, a block product
    and an `index_add_` into the band result."""
    if dia_op is None:
        dia_op = make_dia_operator(bands, offsets)

    def op(u: torch.Tensor) -> torch.Tensor:
        y = dia_op(u)
        ug = u[:, rem_cols]  # [2, R]
        contrib = torch.einsum("rij,jr->ir", rem_vals, ug)  # [2, R]
        return y.index_add_(1, rem_rows, contrib)

    return op


def make_df_dia_operator(bands_hl: torch.Tensor, offsets):
    """op(u [2, N] f64) -> K u to ~2^-46 of the term scale, streaming the
    f32 hi/lo pairs `bands_hl` = split_bands(bands64) (made once per
    compiled problem): the CUDA kernel for card tensors, the plain version
    for CPU tensors."""
    offs = tuple(int(o) for o in offsets)
    offsets_dev = (
        torch.tensor(offs, dtype=torch.int32, device=bands_hl.device)
        if bands_hl.is_cuda
        else None
    )
    return lambda u: df_dia_matvec(bands_hl, offs, u, offsets_dev)


def block_jacobi_blocks(diag_blocks: torch.Tensor, free_mask: torch.Tensor) -> torch.Tensor:
    """The reduced diagonal's closed-form inverse blocks [2, 2, N] from
    diag_blocks [2, 2, N] and free_mask [2, N]."""
    return guarded_inv2(reduce_diag_blocks(diag_blocks, free_mask))


def block_jacobi_inverse_t(diag_blocks: torch.Tensor, free_mask: torch.Tensor):
    """Closed-form inverse of the reduced diagonal, transposed layout.

    diag_blocks [2,2,N], free_mask [2,N] -> returns apply(r [2,N]) -> [2,N].
    """
    inv = block_jacobi_blocks(diag_blocks, free_mask)
    return lambda r: apply_blocks(inv, r)
