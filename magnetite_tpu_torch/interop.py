"""Moving state between the JAX package and this one: numpy in, numpy out.

A hierarchy, mesh or boundary-condition set produced by either package is
described by plain arrays (the JAX package's `setup_to_arrays` dict, the
mesh's coords / tris, the BC arrays), so it crosses over without importing
the other package -- in particular without JAX. The other direction needs
no helper: `fem.amg.setup_to_arrays` writes the dict the JAX package's
`setup_from_arrays` reads.
"""

from __future__ import annotations

import numpy as np
import torch

from .bc import BCArrays
from .fem.assembly import EllStructure
from .fem.amg import AMGMaterialSetup, AMGSetup, setup_from_arrays
from .meshing.core import Mesh


def amg_setup_from_arrays(d: dict) -> AMGSetup:
    """The port's AMGSetup from a `setup_to_arrays` dict of either package."""
    return setup_from_arrays({k: np.asarray(v) for k, v in d.items()})


def material_setup_from_arrays(
    transfers, coarse_basis, level_sizes, fingerprint=None
) -> AMGMaterialSetup:
    """The port's AMGMaterialSetup from the fields of either package's
    (as numpy arrays): transfers [(p_cols, p_vals, pt_cols, pt_vals)],
    coarse_basis [(a_cols, (av_a, av_b, av_c), (d_a, d_b, d_c))] and
    level_sizes [(n_l, m_l)]."""
    return AMGMaterialSetup(
        transfers=[tuple(np.asarray(a) for a in t) for t in transfers],
        coarse_basis=[
            (np.asarray(ac), tuple(np.asarray(a) for a in av3),
             tuple(np.asarray(d) for d in d3))
            for ac, av3, d3 in coarse_basis
        ],
        level_sizes=[tuple(int(v) for v in s) for s in level_sizes],
        setup_info={"loaded": True},
        fingerprint=fingerprint,
    )


def _tensor(a):
    return None if a is None else torch.from_numpy(np.array(a))


def stencil_sweep_setup_from_arrays(raw, reduced, levels, b_mat, d_mat) -> tuple:
    """The port's structured load-sweep setup (compile_sweep's `setup=`)
    from the arrays of either package's `_stencil_sweep_setup` (as numpy):
    the raw and reduced stencils [9, 2, 2, R, C], levels [(stencil,
    diag_inv, dense_inv or None)], B matrices [E, 3, 6] and D [3, 3]."""
    from .parallel.sweep import _LaneLevel

    return (
        _tensor(raw), _tensor(reduced),
        tuple(_LaneLevel(*(_tensor(a) for a in lv)) for lv in levels),
        _tensor(b_mat), _tensor(d_mat),
    )


def material_grid_sweep_setup_from_arrays(basis_raw, levels, b_mat) -> tuple:
    """The port's structured material-sweep setup (compile_material_sweep's
    `setup=`) from the arrays of either package's `_material_sweep_setup`
    (as numpy): three raw basis stencils, levels [(sa, sb, sc, sfix)] and
    the B matrices."""
    from .parallel.sweep import _MaterialLevel

    return (
        tuple(_tensor(a) for a in basis_raw),
        tuple(_MaterialLevel(*(_tensor(a) for a in lv)) for lv in levels),
        _tensor(b_mat),
    )


def mesh_from_arrays(coords, tris) -> Mesh:
    return Mesh(
        coords=np.asarray(coords, dtype=np.float64),
        tris=np.asarray(tris, dtype=np.int32),
    )


def bca_from_arrays(u_known, u_value, f_value) -> BCArrays:
    return BCArrays(
        u_known=np.asarray(u_known, dtype=bool),
        u_value=np.asarray(u_value, dtype=np.float64),
        f_value=np.asarray(f_value, dtype=np.float64),
    )


def ell_structure_from_arrays(cols, slot_ids, n_nodes: int, width: int) -> EllStructure:
    """The port's EllStructure from either package's fields (cols [N, K],
    slot_ids [E*9])."""
    return EllStructure(
        cols=np.ascontiguousarray(cols, np.int32),
        slot_ids=np.ascontiguousarray(slot_ids, np.int32),
        n_nodes=int(n_nodes),
        width=int(width),
    )
