"""Block-ELL structure and assembly (port of the JAX-free parts of
magnetite_tpu/fem/assembly.py).

The sparsity STRUCTURE (which node couples to which) depends only on the
mesh connectivity and is built once on the host: each coupled node pair is
one 2x2 block of a padded [N, K, 2, 2] layout (Delaunay meshes have ~7
neighbours per node, so the padding wastes little). The VALUES are
assembled on the host by the C++ closed-form assembly (native.amg_assemble)
into the ELL slots, as the band operators are (the port has no per-element
[E, 6, 6] stiffness tensor).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class EllStructure:
    """Static sparsity pattern of the global stiffness matrix.

    cols:     [N, K] int32. Column (node) index of each stored 2x2 block.
              Padding slots point at the row's own node (their block stays 0).
    slot_ids: [E*9] int32. For element e and local node pair (a, b), the flat
              destination n*K + k of its 2x2 contribution block.
    n_nodes, width: dimensions (width == K).
    """

    cols: np.ndarray
    slot_ids: np.ndarray
    n_nodes: int
    width: int

    @property
    def nnz_blocks(self) -> int:
        return self.n_nodes * self.width


def build_ell_structure(tris: np.ndarray, n_nodes: int) -> EllStructure:
    """Build the block-ELL pattern from triangle connectivity (host).

    For every element, all 9 ordered node pairs (a, b) couple. The unique
    pairs of each row are ranked by column index, and each of the E*9
    contributions records its destination slot. The native C++ routine is
    used when the host library loads; numpy otherwise (the same result)."""
    from .. import native

    if native.load() is not None:
        cols, slot_ids, width = native.ell_structure(np.asarray(tris), int(n_nodes))
        return EllStructure(cols=cols, slot_ids=slot_ids, n_nodes=int(n_nodes), width=width)
    tris = np.asarray(tris, dtype=np.int64)
    # rows / cols of all E*9 ordered pairs, laid out [E, 3, 3] = (a, b)
    rows_f = np.repeat(tris, 3, axis=1).reshape(-1)  # a varies on axis 1
    cols_f = np.tile(tris, (1, 3)).reshape(-1)  # b varies on axis 2

    keys = rows_f * np.int64(n_nodes) + cols_f
    uniq, inverse = np.unique(keys, return_inverse=True)
    uniq_rows = uniq // n_nodes
    uniq_cols = uniq % n_nodes

    # per-row rank of each unique pair (uniq is sorted, so the pairs of a
    # row are contiguous and sorted by column)
    row_starts = np.searchsorted(uniq_rows, np.arange(n_nodes))
    counts = np.bincount(uniq_rows, minlength=n_nodes)
    width = int(counts.max()) if counts.size else 0
    ranks = np.arange(uniq.size) - row_starts[uniq_rows]

    ell_cols = np.tile(np.arange(n_nodes, dtype=np.int64)[:, None], (1, width))
    ell_cols[uniq_rows, ranks] = uniq_cols

    slot_ids = uniq_rows[inverse] * width + ranks[inverse]
    return EllStructure(
        cols=ell_cols.astype(np.int32),
        slot_ids=slot_ids.astype(np.int32),
        n_nodes=int(n_nodes),
        width=width,
    )


def assemble_ell(coords, tris, youngs_modulus, poisson_ratio, thickness,
                 structure: EllStructure) -> torch.Tensor:
    """ell_data [N, K, 2, 2] (f64, host) of the unmasked stiffness: the C++
    closed-form element blocks scattered into the ELL slots (the JAX
    package's `assemble_ell_arrays` of its element stiffness matrices)."""
    from .. import native

    e_count = np.asarray(tris).shape[0]
    # the native assembly takes the slots pair-major: [3, 3, E]
    slots_pm = (
        np.asarray(structure.slot_ids, np.int64).reshape(e_count, 3, 3)
        .transpose(1, 2, 0).reshape(-1)
    )
    flat = native.amg_assemble(
        coords, tris, np.ones((structure.n_nodes, 2)), youngs_modulus, poisson_ratio,
        thickness, slots_pm, structure.nnz_blocks,
    )
    return torch.from_numpy(flat.reshape(structure.n_nodes, structure.width, 2, 2))


def extract_block_diagonal(ell_data: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The diagonal 2x2 block of each row: [N, 2, 2].

    It sits wherever cols[n, k] == n (exactly one real slot; padding slots
    also point at n but hold zeros, so the sum is exact)."""
    n = ell_data.shape[0]
    own = torch.arange(n, device=cols.device)[:, None] == cols  # [N, K]
    return (own.to(ell_data.dtype)[:, :, None, None] * ell_data).sum(dim=1)
