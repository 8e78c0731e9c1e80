"""Element stress recovery over all elements (port of
magnetite_tpu/fem/stress.py).

The reference's scalar stress is sign*sqrt(sx^2+sy^2) with sign = -1 iff
sx+sy < 1.0 (tau_xy excluded, threshold 1.0 not 0.0); true plane-stress von
Mises is offered beside it.
"""

from __future__ import annotations

import torch

from .element import (
    element_areas,
    gather_element_coords,
    strain_displacement_matrices,
    stress_strain_matrix,
)


def element_stress_tensors(
    coords: torch.Tensor,
    tris: torch.Tensor,
    u: torch.Tensor,
    youngs_modulus,
    poisson_ratio,
) -> torch.Tensor:
    """sigma [E,3] = D @ B @ u_e  (components [sx, sy, txy])."""
    ue = u[tris].reshape(tris.shape[0], 6)  # [E,6] interleaved [x0,y0,x1,...]
    return element_stress_from(
        gather_element_coords(coords, tris), ue, youngs_modulus, poisson_ratio
    )


def element_stress_from(ecoords, ue, youngs_modulus, poisson_ratio) -> torch.Tensor:
    """sigma [E,3] from element corner coordinates ecoords [E,3,2] and
    nodal displacements ue [E,6] ([x0, y0, x1, y1, x2, y2])."""
    areas = element_areas(ecoords)
    b = strain_displacement_matrices(ecoords, areas)  # [E,3,6]
    d = stress_strain_matrix(
        youngs_modulus, poisson_ratio, ecoords.dtype, ecoords.device
    )
    strain = torch.einsum("erj,ej->er", b, ue)  # [E,3]
    return torch.einsum("rs,es->er", d, strain)


def scalar_stress(sigma: torch.Tensor, sign_threshold: float = 1.0) -> torch.Tensor:
    """The reference's scalar 'stress': sign * sqrt(sx^2 + sy^2)."""
    sx, sy = sigma[:, 0], sigma[:, 1]
    mag = torch.sqrt(sx * sx + sy * sy)
    return torch.where(sx + sy < sign_threshold, -mag, mag)


def von_mises_stress(sigma: torch.Tensor) -> torch.Tensor:
    """True plane-stress von Mises: sqrt(sx^2 - sx sy + sy^2 + 3 txy^2)."""
    sx, sy, txy = sigma[:, 0], sigma[:, 1], sigma[:, 2]
    return torch.sqrt(sx * sx - sx * sy + sy * sy + 3.0 * txy * txy)
