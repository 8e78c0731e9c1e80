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

from .bc import BCArrays
from .fem.amg import AMGSetup, setup_from_arrays
from .meshing.core import Mesh


def amg_setup_from_arrays(d: dict) -> AMGSetup:
    """The port's AMGSetup from a `setup_to_arrays` dict of either package."""
    return setup_from_arrays({k: np.asarray(v) for k, v in d.items()})


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
